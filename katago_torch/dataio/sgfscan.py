"""SGF main-line scanning — port of katago_tpu/dataio/sgfscan.py.

Bulk data-mining commands (summarize_sgfs and the like) read thousands
of SGF files and need only each game's main-line facts: size, komi,
handicap, result, player names, moves and setup stones, in the flat-loc
conventions of katago_torch.dataio.sgf. `scan_sgf` scans them in the
port's own C++ library (dataio/csrc/sgfscan.cpp, built at first use by
ops/_hostbuild.py; a failed build raises). `scan_sgf_plain` builds the
summary on the port's parser and is its plain version: the library
accepts, refuses and raises on exactly what the parser does (a
malformed line such as "(;SZ[7]broken" has no summary, where the JAX
package's native library returns one). A record the library leaves to
the parser — a non-ASCII character where a property ident may stand or
inside a number, or trees nested more than 200 deep, where Python's
Unicode classes and recursion limit decide — is summarised by
scan_sgf_plain.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

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


_OK, _MALFORMED, _VALUE_ERROR, _SGF_ERROR, _PARSER = range(5)
_SIGNATURES = {"kt_sgf_scan": [
    ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64]}


def scan_sgf(text: str) -> SgfSummary | None:
    """Summary of the first game in text through the C++ scanner; None
    when it does not parse; raises where scan_sgf_plain raises (a size,
    komi or handicap that is not a number, a bad coordinate)."""
    from katago_torch.ops import _hostbuild
    lib = _hostbuild.load("sgfscan", _SIGNATURES)
    raw = text.encode("utf-8", "surrogatepass")
    n = len(raw)
    ints = np.zeros(8, np.int64)
    floats = np.zeros(2, np.float64)
    # at most one move per 3 bytes (";B[]"), one stone per 2 ("[]")
    moves = np.zeros((n // 3 + 1, 2), np.int64)
    setup = np.zeros((n // 2 + 1, 2), np.int64)
    names = ctypes.create_string_buffer(n + 1)
    rc = lib.kt_sgf_scan(raw, n, ints.ctypes.data, floats.ctypes.data,
                         moves.ctypes.data, moves.shape[0],
                         setup.ctypes.data, setup.shape[0], names, n + 1)
    if rc == _MALFORMED:
        return None
    if rc == _PARSER:
        return scan_sgf_plain(text)
    if rc == _VALUE_ERROR:
        raise ValueError("SGF size, komi, handicap or coordinate is not "
                         "valid")
    if rc == _SGF_ERROR:
        raise S.SgfError("bad sgf coordinate")
    if rc != _OK:
        raise RuntimeError(f"the sgfscan library failed (status {rc})")
    xs, ys, handicap, result, nm, ns, lb, lw = (int(v) for v in ints)
    pb = names.raw[:lb].decode("utf-8", "surrogatepass")
    pw = names.raw[lb:lb + lw].decode("utf-8", "surrogatepass")
    return SgfSummary(
        x_size=xs, y_size=ys, komi=float(floats[0]), handicap=handicap,
        result=result, margin=float(floats[1]), black_name=pb,
        white_name=pw, moves=[tuple(m) for m in moves[:nm].tolist()],
        setup_stones=[tuple(m) for m in setup[:ns].tolist()])


def scan_sgf_plain(text: str) -> SgfSummary | None:
    """Summary of the first game in text on the port's parser; None when
    it does not parse."""
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


# the JAX package's name for its native scan with the parser behind it
scan_sgf_or_parse = scan_sgf
