"""SGF main-line scanning — port of katago_tpu/dataio/sgfscan.py.

Bulk data-mining commands (writetrainingdata, startposes,
summarize_sgfs, genboard training) read thousands of SGF files and need
only each game's main-line facts: size, komi, handicap, result, player
names, moves and setup stones, in the flat-loc conventions of
katago_torch.dataio.sgf. The JAX package scans them with a native C++
library (native/libktsgfscan.so) and falls back to its python parser;
the port keeps no native library and builds every summary on its own
parser, which gives the same fields.
"""

from __future__ import annotations

import dataclasses

from katago_torch.dataio import sgf as S


@dataclasses.dataclass
class SgfSummary:
    """Main-line facts of one game, in dataio.sgf conventions."""
    x_size: int
    y_size: int
    komi: float
    handicap: int
    result: int          # 0 unknown, 1 B+, 2 W+, 3 draw
    margin: float
    black_name: str
    white_name: str
    moves: list          # [(pla 1/2, flat x_size-stride loc; pass=x*y)]
    setup_stones: list   # [(color 1/2, flat loc)]

    @property
    def size(self):
        return (self.x_size, self.y_size)

    @property
    def result_str(self) -> str | None:
        if self.result == 1:
            return f"B+{self.margin:g}" if self.margin else "B+R"
        if self.result == 2:
            return f"W+{self.margin:g}" if self.margin else "W+R"
        if self.result == 3:
            return "0"
        return None


def _result_code(res: str) -> tuple[int, float]:
    """(0 unknown / 1 B+ / 2 W+ / 3 draw, margin) of an RE value."""
    ru = res.upper()
    result = 0
    if ru.startswith("B+"):
        result = 1
    elif ru.startswith("W+"):
        result = 2
    elif ru in ("0", "DRAW"):
        result = 3
    margin = 0.0
    if result in (1, 2):
        try:
            margin = float(res[2:])
        except ValueError:
            margin = 0.0
    return result, margin


def scan_sgf(text: str) -> SgfSummary | None:
    """Summary of the first game in text; None when it does not parse."""
    try:
        game = S.parse_sgf(text)[0]
    except Exception:
        return None
    xs, ys = game.size
    result, margin = _result_code(game.result or "")
    return SgfSummary(
        x_size=xs, y_size=ys, komi=game.komi, handicap=game.handicap,
        result=result, margin=margin,
        black_name=game.root.get("PB") or "",
        white_name=game.root.get("PW") or "",
        moves=game.moves(), setup_stones=game.setup_stones())


# the JAX package's name: its native scan with the parser behind it
scan_sgf_or_parse = scan_sgf
