"""Position-sample files — Sgf::PositionSample + PosWriter

The port's own copy of katago_tpu/dataio/poses.py
(katago_torch imports nothing of the JAX package, not even its modules
that do not import JAX).
(cpp/dataio/sgf.h:108-135, sgf.cpp:1171-1240, cpp/dataio/poswriter.{h,cpp}).

The reference's wire format for start/hint position files consumed by
selfplay (startPosesProb / hintPosesProb): one JSON object per line with
an X/O/. board string ('/'-delimited rows), short player names, board
coordinates for the context moves and hint, and a sampling weight.
This module reads and writes that exact format so pose files interop
both ways.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from katago_torch.game import board as B

COLS = "ABCDEFGHJKLMNOPQRSTUVWXYZ"


def loc_to_str(loc: int, x_size: int, y_size: int) -> str:
    """Location::toString board coords (A1..), 'pass', or 'null'."""
    if loc is None or loc < 0:
        return "null"
    if loc >= x_size * y_size:
        return "pass"
    x, y = loc % x_size, loc // x_size
    return f"{COLS[x]}{y_size - y}"


def loc_of_str(s: str, x_size: int, y_size: int) -> int:
    s = s.strip().lower()
    if s in ("", "null", "''", '""'):
        return -1
    if s == "pass":
        return x_size * y_size
    x = COLS.lower().index(s[0])
    y = y_size - int(s[1:])
    return y * x_size + x


@dataclasses.dataclass
class PositionSample:
    """One start/hint position (sgf.h:108-135)."""
    x_size: int
    y_size: int
    stones: np.ndarray            # int8[NN] 0/1/2
    next_pla: int                 # B.BLACK / B.WHITE
    moves: list                   # [(pla, loc)] context moves to replay
    initial_turn_number: int = 0
    hint_loc: int = -1            # -1 = none
    weight: float = 1.0
    metadata: str = ""
    training_weight: float = 1.0

    def to_json_line(self) -> str:
        xs, ys = self.x_size, self.y_size
        chars = {0: ".", B.BLACK: "X", B.WHITE: "O"}
        rows = ["".join(chars[int(self.stones[y * xs + x])]
                        for x in range(xs)) for y in range(ys)]
        data = {
            "xSize": xs, "ySize": ys,
            "board": "/".join(rows) + "/",
            "nextPla": "B" if self.next_pla == B.BLACK else "W",
            "moveLocs": [loc_to_str(l, xs, ys) for _, l in self.moves],
            "movePlas": ["B" if p == B.BLACK else "W"
                         for p, _ in self.moves],
            "initialTurnNumber": self.initial_turn_number,
            "hintLoc": loc_to_str(self.hint_loc, xs, ys),
            "weight": self.weight,
        }
        if self.metadata:
            data["metadata"] = self.metadata
        if self.training_weight != 1.0:
            data["trainingWeight"] = self.training_weight
        return json.dumps(data)

    @staticmethod
    def of_json_line(line: str) -> "PositionSample":
        data = json.loads(line)
        xs = int(data["xSize"])
        ys = int(data["ySize"])
        rows = [r for r in data["board"].split("/") if r]
        if len(rows) == ys + 1 and rows[0].startswith("A"):
            rows = rows[1:]   # coordinate label line (Board::parseBoard)
        stones = np.zeros((xs * ys,), np.int8)
        for y, row in enumerate(rows):
            for x, c in enumerate(row[:xs]):
                if c in ("X", "x", "b", "B"):
                    stones[y * xs + x] = B.BLACK
                elif c in ("O", "o", "w", "W"):
                    stones[y * xs + x] = B.WHITE
        next_pla = B.BLACK if data["nextPla"].upper().startswith("B") \
            else B.WHITE
        moves = [( B.BLACK if p.upper().startswith("B") else B.WHITE,
                   loc_of_str(l, xs, ys))
                 for l, p in zip(data.get("moveLocs", []),
                                 data.get("movePlas", []))]
        return PositionSample(
            x_size=xs, y_size=ys, stones=stones, next_pla=next_pla,
            moves=moves,
            initial_turn_number=int(data.get("initialTurnNumber", 0)),
            hint_loc=loc_of_str(str(data.get("hintLoc", "null")), xs, ys),
            weight=float(data.get("weight", 1.0)),
            metadata=str(data.get("metadata", "")),
            training_weight=float(data.get("trainingWeight", 1.0)))


class PosWriter:
    """Rotating pose-file writer (poswriter.h): writes JSON lines into
    outDir/<base>.<idx>.<suffix>, starting a new file every
    max_poses_per_file lines. The reference's queue+thread dissolves —
    callers here are single-threaded host loops."""

    def __init__(self, suffix: str, out_dir: str,
                 max_poses_per_file: int = 100000, base: str = "poses"):
        self.suffix = suffix
        self.out_dir = out_dir
        self.max_poses = max_poses_per_file
        self.base = base
        self._file = None
        self._count_in_file = 0
        self._file_idx = 0
        self.total = 0
        os.makedirs(out_dir, exist_ok=True)

    def _roll(self):
        if self._file is not None:
            self._file.close()
        path = os.path.join(
            self.out_dir, f"{self.base}.{self._file_idx}.{self.suffix}")
        self._file = open(path, "w")
        self._file_idx += 1
        self._count_in_file = 0

    def write_line(self, line: str):
        if self._file is None or self._count_in_file >= self.max_poses:
            self._roll()
        self._file.write(line + "\n")
        self._count_in_file += 1
        self.total += 1

    def write_pos(self, pos: PositionSample):
        self.write_line(pos.to_json_line())

    def flush_and_stop(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def load_poses(paths) -> list[PositionSample]:
    """Read pose files (selfplay startPosesFiles)."""
    out = []
    if isinstance(paths, str):
        paths = [paths]
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(PositionSample.of_json_line(line))
    return out
