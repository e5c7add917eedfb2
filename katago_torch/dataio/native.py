"""Bit unpacking and dihedral symmetries of training rows.

The port's counterpart of katago_tpu/dataio/native.py. The symmetry
transforms run in the port's own C++ library (dataio/csrc/dataprep.cpp,
built at first use by ops/_hostbuild.py; a failed build raises); the
numpy functions `apply_symmetry_planes_plain` and
`apply_symmetry_policy_plain` are their plain versions, which the tests
hold the library to. Bit unpacking stays numpy: the JAX package measured
np.unpackbits faster than its C++ loop (its native.py docstring).
Symmetries are encoded 0..7 as (transpose << 2) | (flip_y << 1) |
flip_x, the reference's convention (nninputs.h:188-238).
"""

from __future__ import annotations

import ctypes

import numpy as np

_SIGNATURES = {
    "kt_symmetry_planes": [ctypes.c_void_p, ctypes.c_void_p] +
    [ctypes.c_int64] * 5 + [ctypes.c_int],
    "kt_symmetry_policy": [ctypes.c_void_p, ctypes.c_void_p] +
    [ctypes.c_int64] * 4 + [ctypes.c_int],
}


def _lib():
    from katago_torch.ops import _hostbuild
    return _hostbuild.load("dataprep", _SIGNATURES)


def unpack_bits_nchw(packed: np.ndarray, area: int) -> np.ndarray:
    """uint8 [N, C, ceil(area/8)] -> float32 [N, C, area]."""
    return np.unpackbits(packed, axis=2)[:, :, :area].astype(np.float32)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what}: the dataprep library refused its "
                         f"arguments (status {rc})")


def apply_symmetry_planes(x: np.ndarray, sym: int) -> np.ndarray:
    """[N, C, H, W] dihedral transform (the result is [N, C, W, H] when
    sym transposes); sym 0 returns x itself."""
    if sym == 0:
        return x
    x = np.ascontiguousarray(x)
    n, c, h, w = x.shape
    out = np.empty((n, c, w, h) if sym & 4 else (n, c, h, w), x.dtype)
    _check(_lib().kt_symmetry_planes(x.ctypes.data, out.ctypes.data, n, c,
                                     h, w, x.itemsize, sym),
           "apply_symmetry_planes")
    return out


def apply_symmetry_policy(p: np.ndarray, size: int, sym: int,
                          y_size: int | None = None) -> np.ndarray:
    """[N, area+1] policy rows of a size x y_size board (y_size defaults
    to size), the pass slot kept; sym 0 returns p itself."""
    if sym == 0:
        return p
    ys = size if y_size is None else y_size
    p = np.ascontiguousarray(p)
    if p.shape[1] != size * ys + 1:
        raise ValueError(f"policy rows of {p.shape[1]}, want "
                         f"{size * ys + 1}")
    out = np.empty_like(p)
    _check(_lib().kt_symmetry_policy(p.ctypes.data, out.ctypes.data,
                                     p.shape[0], size, ys, p.itemsize, sym),
           "apply_symmetry_policy")
    return out


def apply_symmetry_planes_plain(x: np.ndarray, sym: int) -> np.ndarray:
    """The numpy version of apply_symmetry_planes."""
    if sym == 0:
        return x
    out = x
    if sym & 2:
        out = out[:, :, ::-1, :]
    if sym & 1:
        out = out[:, :, :, ::-1]
    if sym & 4:
        out = out.transpose(0, 1, 3, 2)
    return np.ascontiguousarray(out)


def apply_symmetry_policy_plain(p: np.ndarray, size: int, sym: int,
                                y_size: int | None = None) -> np.ndarray:
    """The numpy version of apply_symmetry_policy."""
    if sym == 0:
        return p
    ys = size if y_size is None else y_size
    n = p.shape[0]
    board = p[:, :size * ys].reshape(n, ys, size)
    out = board
    if sym & 2:
        out = out[:, ::-1, :]
    if sym & 1:
        out = out[:, :, ::-1]
    if sym & 4:
        out = out.transpose(0, 2, 1)
    return np.ascontiguousarray(
        np.concatenate([out.reshape(n, -1), p[:, -1:]], axis=1))
