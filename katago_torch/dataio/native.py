"""Bit unpacking and dihedral symmetries of training rows, in numpy.

The port's own copy of the numpy branches of katago_tpu/dataio/native.py
(the JAX package binds an optional C++ library there; the port does not
load it). Symmetries are encoded 0..7 as
(transpose << 2) | (flip_y << 1) | flip_x, the reference's convention
(nninputs.h:188-238).
"""

from __future__ import annotations

import numpy as np


def unpack_bits_nchw(packed: np.ndarray, area: int) -> np.ndarray:
    """uint8 [N, C, ceil(area/8)] -> float32 [N, C, area]."""
    return np.unpackbits(packed, axis=2)[:, :, :area].astype(np.float32)


def apply_symmetry_planes(x: np.ndarray, sym: int) -> np.ndarray:
    """float32 [N, C, H, W] dihedral transform."""
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


def apply_symmetry_policy(p: np.ndarray, size: int, sym: int) -> np.ndarray:
    """float32 [N, area+1] policy rows (pass slot preserved)."""
    if sym == 0:
        return p
    n = p.shape[0]
    board = p[:, :size * size].reshape(n, size, size)
    out = board
    if sym & 2:
        out = out[:, ::-1, :]
    if sym & 1:
        out = out[:, :, ::-1]
    if sym & 4:
        out = out.transpose(0, 2, 1)
    return np.ascontiguousarray(
        np.concatenate([out.reshape(n, -1), p[:, -1:]], axis=1))
