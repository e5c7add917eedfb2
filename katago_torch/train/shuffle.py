"""Selfplay-data shuffler — equivalent of python/shuffle.py; the port's
own copy of katago_tpu/train/shuffle.py (numpy only: with the same seed
and inputs it writes the same rows, in the same order, to the same
files).

Two-phase disk shuffle, so data far larger than RAM shuffles globally:

  phase 1 (shardify, shuffle.py:199-330): stream each input npz once,
  apply the window (newest ``window_rows`` rows survive, sampled at
  ``keep_prob``) and scatter every surviving row to one of B bucket files
  chosen uniformly at random;
  phase 2 (merge_shards, shuffle.py:340-400): load each bucket — 1/B of
  the window, sized to fit in RAM — permute it, and write fixed-size
  output shards.

A row's final position depends on (uniform bucket choice, uniform
in-bucket permutation), which is an exact uniform shuffle of the window.
The window grows as the reference's power law (compute_desired_num_rows,
shuffle.py:417-436): anchored at min_rows with initial slope
expand_window_per_row, tapering with exponent taper_window_exponent.
"""

from __future__ import annotations

import os

import numpy as np


def compute_window_size(total_rows: int, *, min_rows: int = 250_000,
                        keep_prop: float = 1.0,
                        taper_exponent: float = 0.675,
                        expand_per_row: float = 0.4,
                        taper_scale: float | None = None,
                        max_rows: int | None = None) -> int:
    """The reference's power-law data window (shuffle.py:417-436):
    anchored at min_rows, initial slope expand_per_row per data row,
    tapering with taper_exponent."""
    offset = taper_scale if taper_scale is not None else min_rows
    x = max(total_rows - min_rows + offset, offset)
    unscaled = x ** taper_exponent - offset ** taper_exponent
    scaled = unscaled / (taper_exponent * offset ** (taper_exponent - 1.0))
    window = int(scaled * expand_per_row + min_rows)
    window = max(window, min_rows)
    if max_rows is not None:
        window = min(window, max_rows)
    return int(min(total_rows, window * keep_prop))


def _count_rows(path: str) -> int:
    try:
        with np.load(path) as z:
            k = next(iter(z.keys()))
            return z[k].shape[0]
    except Exception:
        # unreadable shard (e.g. a concurrent writer mid-write, or a
        # truncated file after a crash): skip it rather than die — the
        # reference's shuffler tolerates bad files the same way
        return 0


def shuffle_npz_files(in_files: list[str], out_dir: str, *,
                      rows_per_shard: int = 32768,
                      window_rows: int | None = None,
                      keep_prob: float = 1.0,
                      rows_per_bucket: int = 1 << 20,
                      seed: int = 0) -> list[str]:
    """Two-phase shuffle of the input shards into out_dir.

    Files are ordered oldest-first; the window keeps the newest rows.
    rows_per_bucket bounds phase-2 RAM (default 1M rows/bucket).
    Returns the list of written shard paths.
    """
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)

    counts = [_count_rows(f) for f in in_files]
    total = int(sum(counts))
    if total == 0:
        return []
    if window_rows is None:
        window_rows = compute_window_size(total)
    window_rows = min(window_rows, total)
    start = total - window_rows  # global index of the first surviving row

    num_buckets = max(1, int(round(window_rows * keep_prob
                                   / rows_per_bucket)))

    # phase 1: stream inputs once, scatter surviving rows into buckets
    buckets: list[dict[str, list[np.ndarray]]] = [
        {} for _ in range(num_buckets)]
    offset = 0
    for path, n in zip(in_files, counts):
        lo = max(start - offset, 0)
        offset += n
        if lo >= n:
            continue
        with np.load(path) as z:
            arrs = {k: z[k] for k in z.keys()}
        keep = np.ones(n - lo, bool) if keep_prob >= 1.0 else (
            rng.random(n - lo) < keep_prob)
        if not keep.any():
            continue
        assign = rng.integers(0, num_buckets, size=int(keep.sum()))
        for b in range(num_buckets):
            rows = np.nonzero(keep)[0][assign == b] + lo
            if rows.size == 0:
                continue
            for k, v in arrs.items():
                buckets[b].setdefault(k, []).append(v[rows])
        del arrs

    # spill buckets to disk when there are several (RAM bound); with one
    # bucket this is just the in-RAM fast path
    tmp_paths: list[str | None] = [None] * num_buckets
    if num_buckets > 1:
        for b in range(num_buckets):
            if not buckets[b]:
                continue
            tmp = os.path.join(out_dir, f".bucket{b:04d}.npz")
            np.savez(tmp, **{k: np.concatenate(v)
                             for k, v in buckets[b].items()})
            tmp_paths[b] = tmp
            buckets[b] = {}

    # phase 2: permute each bucket, emit fixed-size output shards
    out_paths: list[str] = []
    carry: dict[str, np.ndarray] | None = None
    for b in range(num_buckets):
        if num_buckets > 1:
            if tmp_paths[b] is None:
                continue
            with np.load(tmp_paths[b]) as z:
                data = {k: z[k] for k in z.keys()}
            os.remove(tmp_paths[b])
        else:
            if not buckets[b]:
                continue
            data = {k: np.concatenate(v) for k, v in buckets[b].items()}
        n = data[next(iter(data))].shape[0]
        perm = rng.permutation(n)
        data = {k: v[perm] for k, v in data.items()}
        if carry is not None:
            data = {k: np.concatenate([carry[k], data[k]]) for k in data}
            carry = None
        n = data[next(iter(data))].shape[0]
        full = (n // rows_per_shard) * rows_per_shard
        for i in range(0, full, rows_per_shard):
            shard = {k: v[i:i + rows_per_shard] for k, v in data.items()}
            path = os.path.join(out_dir, f"data{len(out_paths):06d}.npz")
            np.savez_compressed(path, **shard)
            out_paths.append(path)
        if full < n:
            carry = {k: v[full:] for k, v in data.items()}
    if carry is not None and carry[next(iter(carry))].shape[0] > 0:
        path = os.path.join(out_dir, f"data{len(out_paths):06d}.npz")
        np.savez_compressed(path, **carry)
        out_paths.append(path)
    return out_paths
