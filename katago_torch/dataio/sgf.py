"""SGF parse/write — equivalent of cpp/dataio/sgf.{cpp,h}.

The port's own copy of katago_tpu/dataio/sgf.py
(katago_torch imports nothing of the JAX package, not even its modules
that do not import JAX).

Supports the reference's usage surface: game trees with variations,
multi-game files, setup stones (AB/AW/AE), moves (B/W incl. pass), board
size (SZ, incl. rectangular "w:h" — rectangular boards are a later engine
milestone), komi (KM), rules (RU), result (RE), handicap (HA), comments,
and PositionSample-style extraction of positions for startpos mining.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

# GTP/SGF column letters; SGF uses a-z coordinates (i included, unlike GTP)
_SGF_COORDS = "abcdefghijklmnopqrstuvwxyz"


class SgfError(ValueError):
    pass


@dataclasses.dataclass
class SgfNode:
    props: dict[str, list[str]] = dataclasses.field(default_factory=dict)
    children: list["SgfNode"] = dataclasses.field(default_factory=list)

    def get(self, key: str) -> str | None:
        v = self.props.get(key)
        return v[0] if v else None

    def get_all(self, key: str) -> list[str]:
        return self.props.get(key, [])


@dataclasses.dataclass
class SgfGame:
    root: SgfNode

    @property
    def size(self) -> tuple[int, int]:
        """(x_size, y_size); SZ may be 'n' or 'w:h'."""
        sz = self.root.get("SZ") or "19"
        if ":" in sz:
            w, h = sz.split(":", 1)
            return int(w), int(h)
        return int(sz), int(sz)

    @property
    def komi(self) -> float:
        km = self.root.get("KM")
        return float(km) if km else 7.5

    @property
    def rules(self) -> str | None:
        return self.root.get("RU")

    @property
    def result(self) -> str | None:
        return self.root.get("RE")

    @property
    def handicap(self) -> int:
        ha = self.root.get("HA")
        return int(ha) if ha else 0

    def main_line(self) -> list[SgfNode]:
        out = []
        node = self.root
        while True:
            out.append(node)
            if not node.children:
                return out
            node = node.children[0]

    def moves(self) -> list[tuple[int, int]]:
        """[(player 1/2, flat_loc or x*y for pass)] along the main line.

        Pass encoded as x_size*y_size. Tt-as-pass ('tt' on <=19x19) honored.
        """
        xs, ys = self.size
        nn = xs * ys
        out = []
        for node in self.main_line():
            for key, player in (("B", 1), ("W", 2)):
                if key in node.props:
                    val = node.props[key][0]
                    out.append((player, parse_sgf_loc(val, xs, ys)))
        return out

    def setup_stones(self) -> list[tuple[int, int]]:
        """[(color 1/2, flat_loc)] from AB/AW on the root/mainline setup."""
        xs, ys = self.size
        out = []
        for node in self.main_line():
            for key, color in (("AB", 1), ("AW", 2)):
                for val in node.get_all(key):
                    loc = parse_sgf_loc(val, xs, ys)
                    if loc < xs * ys:
                        out.append((color, loc))
        return out


def remap_to_grid(loc: int, x_size: int, y_size: int,
                  grid_size: int) -> int:
    """x_size-stride SGF flat loc -> max-square engine-grid loc
    (rect boards embed at rows 0..y_size-1 / cols 0..x_size-1)."""
    if loc >= x_size * y_size:
        return grid_size * grid_size
    return (loc // x_size) * grid_size + (loc % x_size)


def parse_sgf_loc(val: str, x_size: int, y_size: int) -> int:
    """SGF coordinate -> flat loc; '' or 'tt' (on small boards) -> pass."""
    nn = x_size * y_size
    if val == "":
        return nn
    if val == "tt" and x_size <= 19 and y_size <= 19:
        return nn
    if len(val) != 2:
        raise SgfError(f"bad sgf coordinate {val!r}")
    x = _SGF_COORDS.index(val[0])
    y = _SGF_COORDS.index(val[1])
    if x >= x_size or y >= y_size:
        raise SgfError(f"sgf coordinate {val!r} off {x_size}x{y_size} board")
    return y * x_size + x


def write_sgf_loc(loc: int, x_size: int, y_size: int) -> str:
    if loc >= x_size * y_size:
        return ""
    x, y = loc % x_size, loc // x_size
    return _SGF_COORDS[x] + _SGF_COORDS[y]


# ---- parsing --------------------------------------------------------------

def parse_sgf(text: str) -> list[SgfGame]:
    """Parse a (possibly multi-game) SGF file into game trees."""
    games = []
    pos = 0
    n = len(text)
    while True:
        while pos < n and text[pos] != "(":
            pos += 1
        if pos >= n:
            break
        root, pos = _parse_tree(text, pos)
        games.append(SgfGame(root=root))
    if not games:
        raise SgfError("no SGF game found")
    return games


def _parse_tree(text: str, pos: int) -> tuple[SgfNode, int]:
    assert text[pos] == "("
    pos += 1
    first: SgfNode | None = None
    cur: SgfNode | None = None
    n = len(text)
    while pos < n:
        c = text[pos]
        if c.isspace():
            pos += 1
        elif c == ";":
            node, pos = _parse_node(text, pos + 1)
            if cur is None:
                first = node
            else:
                cur.children.append(node)
            cur = node
        elif c == "(":
            if cur is None:
                raise SgfError("subtree before any node")
            sub, pos = _parse_tree(text, pos)
            cur.children.append(sub)
        elif c == ")":
            if first is None:
                raise SgfError("empty SGF tree")
            return first, pos + 1
        else:
            raise SgfError(f"unexpected char {c!r} at {pos}")
    raise SgfError("unterminated SGF tree")


def _parse_node(text: str, pos: int) -> tuple[SgfNode, int]:
    node = SgfNode()
    n = len(text)
    while pos < n:
        while pos < n and text[pos].isspace():
            pos += 1
        if pos >= n or text[pos] in ";()":
            return node, pos
        # property ident
        start = pos
        while pos < n and text[pos].isalpha():
            pos += 1
        ident = text[start:pos]
        if not ident or not ident.isupper():
            raise SgfError(f"bad property ident at {start}: {text[start:start+8]!r}")
        vals = []
        while True:
            while pos < n and text[pos].isspace():
                pos += 1
            if pos >= n or text[pos] != "[":
                break
            pos += 1
            buf = []
            while pos < n and text[pos] != "]":
                if text[pos] == "\\" and pos + 1 < n:
                    pos += 1
                buf.append(text[pos])
                pos += 1
            if pos >= n:
                raise SgfError("unterminated property value")
            pos += 1  # skip ]
            vals.append("".join(buf))
        if not vals:
            raise SgfError(f"property {ident} with no value")
        node.props.setdefault(ident, []).extend(vals)
    return node, pos


# ---- writing --------------------------------------------------------------

def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace("]", "\\]")


def write_sgf(moves: list[tuple[int, int]], x_size: int, y_size: int, *,
              komi: float = 7.5, rules: str = "koPOSITIONALscoreAREAtaxNONEsui1",
              result: str | None = None, handicap: int = 0,
              setup: list[tuple[int, int]] | None = None,
              black_name: str = "", white_name: str = "",
              comment: str = "") -> str:
    """Serialize a game the way the reference writes selfplay sgfs."""
    sz = str(x_size) if x_size == y_size else f"{x_size}:{y_size}"
    parts = [f"(;FF[4]GM[1]SZ[{sz}]KM[{komi}]RU[{_escape(rules)}]"]
    if black_name:
        parts.append(f"PB[{_escape(black_name)}]")
    if white_name:
        parts.append(f"PW[{_escape(white_name)}]")
    if handicap:
        parts.append(f"HA[{handicap}]")
    if result:
        parts.append(f"RE[{_escape(result)}]")
    if comment:
        parts.append(f"C[{_escape(comment)}]")
    if setup:
        blacks = [l for c, l in setup if c == 1]
        whites = [l for c, l in setup if c == 2]
        if blacks:
            parts.append("AB" + "".join(
                f"[{write_sgf_loc(l, x_size, y_size)}]" for l in blacks))
        if whites:
            parts.append("AW" + "".join(
                f"[{write_sgf_loc(l, x_size, y_size)}]" for l in whites))
    for player, loc in moves:
        key = "B" if player == 1 else "W"
        parts.append(f";{key}[{write_sgf_loc(loc, x_size, y_size)}]")
    parts.append(")")
    return "".join(parts)
