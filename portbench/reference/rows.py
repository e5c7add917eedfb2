"""Seeded training rows in KataGo's npz schema (cpp/dataio/
trainingwrite.h:183-290), the schema's decoding, and the dihedral
symmetries of data_processing_pytorch.py (flip y if sym & 2, flip x if
sym & 1, transpose if sym & 4), all in numpy.

The rows are random but valid: the board mask is plane 0, the targets
are distributions where the loss reads distributions, and every row
differs from every other.
"""

from __future__ import annotations

import numpy as np

GLOBAL_TARGETS = 80
EXTRA_SCORE_DISTR_RADIUS = 60


def make_rows(n: int, size: int, seed: int) -> dict[str, np.ndarray]:
    """n rows as stored on disk."""
    rng = np.random.default_rng(seed)
    area = size * size
    a = area + 1
    planes = (rng.random((n, 22, area)) < 0.15).astype(np.uint8)
    planes[:, 0] = 1
    gin = rng.normal(0.0, 0.5, (n, 19)).astype(np.float32)
    pol = np.where(rng.random((n, 2, a)) < 0.1,
                   rng.integers(1, 200, (n, 2, a)), 0).astype(np.int16)
    pol[:, :, -1] += 1       # every target has some weight
    gt = np.zeros((n, GLOBAL_TARGETS), np.float32)

    def probs(k):
        p = rng.random((n, k)) + 0.05
        return p / p.sum(1, keepdims=True)

    gt[:, 0:3] = probs(3)
    gt[:, 3] = rng.normal(0.0, 10.0, n)
    for base in (4, 8, 12):
        gt[:, base:base + 3] = probs(3)
        gt[:, base + 3] = rng.normal(0.0, 10.0, n)
    gt[:, 21] = rng.normal(0.0, 10.0, n)
    gt[:, 22] = rng.random(n) * 20.0
    gt[:, 25] = 1.0                                    # row weight
    gt[:, [26, 27, 28, 29, 33, 34]] = 1.0              # term weights
    sb_len = 2 * (area + EXTRA_SCORE_DISTR_RADIUS)
    sd = np.zeros((n, sb_len), np.int8)
    at = rng.integers(sb_len // 2 - 60, sb_len // 2 + 60, n)
    frac = rng.integers(0, 101, n)
    sd[np.arange(n), at] = frac
    sd[np.arange(n), at + 1] += (100 - frac).astype(np.int8)
    vt = np.zeros((n, 5, size, size), np.int8)
    vt[:, 0:4] = rng.integers(-1, 2, (n, 4, size, size))
    vt[:, 4] = rng.integers(-120, 121, (n, size, size))
    return {
        "binaryInputNCHWPacked": np.packbits(planes, axis=2),
        "globalInputNC": gin,
        "policyTargetsNCMove": pol,
        "globalTargetsNC": gt,
        "scoreDistrN": sd,
        "valueTargetsNCHW": vt,
        "qValueTargetsNCMove": np.zeros((n, 3, a), np.int16),
    }


def decode(rows: dict, size: int) -> dict[str, np.ndarray]:
    """Stored rows -> the learner's float32 arrays."""
    area = size * size
    packed = rows["binaryInputNCHWPacked"]
    n = packed.shape[0]
    out = {k: v.astype(np.float32) for k, v in rows.items()
           if k != "binaryInputNCHWPacked"}
    out["binaryInputNCHW"] = np.unpackbits(packed, axis=2)[:, :, :area] \
        .reshape(n, 22, size, size).astype(np.float32)
    return out


def _board_sym(x: np.ndarray, sym: int) -> np.ndarray:
    """The symmetry on the last two axes (y, x)."""
    if sym & 2:
        x = x[..., ::-1, :]
    if sym & 1:
        x = x[..., :, ::-1]
    if sym & 4:
        x = np.swapaxes(x, -1, -2)
    return np.ascontiguousarray(x)


def symmetry(batch: dict, size: int, sym: int) -> dict:
    """A decoded batch under one dihedral symmetry."""
    out = dict(batch)
    out["binaryInputNCHW"] = _board_sym(batch["binaryInputNCHW"], sym)
    out["valueTargetsNCHW"] = _board_sym(batch["valueTargetsNCHW"], sym)
    for k in ("policyTargetsNCMove", "qValueTargetsNCMove"):
        p = batch[k]
        board = _board_sym(p[..., :-1].reshape(p.shape[:-1] + (size, size)),
                           sym)
        out[k] = np.concatenate([board.reshape(p.shape[:-1] + (-1,)),
                                 p[..., -1:]], axis=-1)
    return out


def match_batch(fed: dict, raw: dict, size: int):
    """Which rows of the decoded `raw` rows, under which symmetry, the
    decoded batch `fed` is: (sym, row indices, rows that differ). A row
    is found by its input planes and global inputs; then every array of
    it is compared. With no symmetry that finds every row, the sym that
    finds most is returned with the rest counted as differing."""
    n = fed["globalInputNC"].shape[0]
    gkeys = {raw["globalInputNC"][i].tobytes(): i
             for i in range(raw["globalInputNC"].shape[0])}
    best = None
    for sym in range(8):
        idx = np.array([gkeys.get(fed["globalInputNC"][i].tobytes(), -1)
                        for i in range(n)])
        ok = idx >= 0
        want = symmetry({k: v[idx.clip(0)] for k, v in raw.items()}, size,
                        sym)
        same = ok.copy()
        for k, v in fed.items():
            same &= (v.reshape(n, -1) == want[k].reshape(n, -1)).all(1)
        if best is None or same.sum() > best[2]:
            best = (sym, idx, int(same.sum()), want)
        if same.all():
            break
    sym, idx, n_same, want = best
    return sym, idx, n - n_same, want
