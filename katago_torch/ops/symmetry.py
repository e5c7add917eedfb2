"""Dihedral board symmetries for NN eval randomization — port of
katago_tpu/ops/symmetry.py, batched over games.

Symmetry ids: bit0 transpose (applied last), bit1 flipX, bit2 flipY. A
symmetry is a location permutation; applying one per game is a gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def loc_perm_np(size: int) -> np.ndarray:
    """[8, NN+1] forward maps F[s][i] = image of flat loc i under s; the
    pass slot NN is a fixed point."""
    nn = size * size
    locs = np.arange(nn)
    y, x = locs // size, locs % size
    out = np.zeros((8, nn + 1), np.int64)
    for s in range(8):
        sx = (size - 1 - x) if (s & 2) else x
        sy = (size - 1 - y) if (s & 4) else y
        ty, tx = (sx, sy) if (s & 1) else (sy, sx)
        out[s, :nn] = ty * size + tx
        out[s, nn] = nn
    return out


@functools.lru_cache(maxsize=None)
def inv_loc_perm_np(size: int) -> np.ndarray:
    f = loc_perm_np(size)
    inv = np.zeros_like(f)
    for s in range(8):
        inv[s, f[s]] = np.arange(f.shape[1])
    return inv


@functools.lru_cache(maxsize=None)
def _tables(size: int, device: str):
    return (torch.from_numpy(loc_perm_np(size)).to(device),
            torch.from_numpy(inv_loc_perm_np(size)).to(device))


def _gather_locs(feat, idx):
    """feat [G, NN, ...] gathered along axis 1 by idx [G, NN]."""
    shape = idx.shape + feat.shape[2:]
    ix = idx.reshape(idx.shape + (1,) * (feat.dim() - 2)).expand(shape)
    return feat.gather(1, ix)


def transform_spatial(feat, sym, size: int):
    """Per-location features [G, NN, ...] of the original board -> the
    symmetry-sym[g] board: out[F[i]] = feat[i]."""
    _, inv = _tables(size, str(feat.device))
    return _gather_locs(feat, inv[sym.long(), :size * size])


def untransform_spatial(feat, sym, size: int):
    """Outputs on the symmetry board [G, NN, ...] back to the original
    orientation: out[i] = feat[F[i]]."""
    f, _ = _tables(size, str(feat.device))
    return _gather_locs(feat, f[sym.long(), :size * size])


def untransform_policy(pol, sym, size: int):
    """Policy [G, C, NN+1] (trailing pass) back to the original board."""
    f, _ = _tables(size, str(pol.device))
    idx = f[sym.long()].unsqueeze(1).expand(pol.shape)
    return pol.gather(-1, idx)
