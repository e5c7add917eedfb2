"""K2: connected-component labels — port of
katago_tpu/ops/labels_pallas.py::connected_labels_batch.

`connected_labels(values, size)` labels int32[G, NN] boards: each point
gets the smallest flat index reachable through 4-connected points of
equal value. On a CUDA tensor it launches the hand-written kernel
ops/csrc/labels.cu (one block per board, union-find in shared memory:
each horizontal run of equal values starts as one tree, runs join their
equal lower neighbours with the smaller root winning, finds halve their
paths, then every point writes its root; three block barriers whatever
the board's shape); on a CPU tensor it runs `connected_labels_plain`,
neighbour-min propagation to a fixpoint in plain torch.

Bound on an H100: latency. One [128, 361] call moves 0.37 MB (0.1 us at
3.35 TB/s) and does a few thousand integer operations per board; the
kernel keeps each board in shared memory for its whole solve, so a call
is one launch with no host round trip. The wrapper runs 17-30 times per
playout step, so its host path is kept short: the C entry point is
resolved once, and no device switch or lock is taken on the hot path.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from katago_torch.ops import _build

launches = 0          # kernel launches since the last reset (chip_smoke)
_launches_lock = threading.Lock()   # a ponder thread launches too

_SIGNATURES = {"connected_labels_launch": [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]}

_launch = None        # the C entry point, resolved at first use

_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    global launches
    launches = 0


def connected_labels_plain(values: torch.Tensor, size: int) -> torch.Tensor:
    """Plain torch version: neighbour-min propagation to a fixpoint (as
    katago_tpu/game/board.py:157-174), four rounds per convergence check."""
    g, nn = values.shape
    v = values.reshape(g, size, size)
    big = torch.full((), _INT_MAX, dtype=torch.int32, device=values.device)

    def nbr(t, fill):
        """[4, G, S, S]: value at p+size, p-size, p+1, p-1 (fill off-board)."""
        f = torch.full_like(t[:, :1, :], fill)
        fc = torch.full_like(t[:, :, :1], fill)
        return torch.stack([
            torch.cat([t[:, 1:, :], f], dim=1),
            torch.cat([f, t[:, :-1, :]], dim=1),
            torch.cat([t[:, :, 1:], fc], dim=2),
            torch.cat([fc, t[:, :, :-1]], dim=2)])

    same = nbr(v, -1) == v[None]     # off-board lanes read lab = INT_MAX
    lab = torch.arange(nn, dtype=torch.int32, device=values.device)
    lab = lab.expand(g, nn).reshape(g, size, size).clone()
    while True:
        prev = lab
        for _ in range(4):
            m = torch.where(same, nbr(lab, _INT_MAX), big).amin(dim=0)
            lab = torch.minimum(lab, m)
        if not bool((lab != prev).any()):
            return lab.reshape(g, nn)


def connected_labels(values: torch.Tensor, size: int) -> torch.Tensor:
    """int32[G, NN] component labels of int32[G, NN] values."""
    if values.dim() != 2 or values.shape[1] != size * size:
        raise ValueError(f"values must be [G, {size * size}], got "
                         f"{tuple(values.shape)}")
    if values.dtype != torch.int32:
        raise TypeError(f"values must be int32, got {values.dtype}")
    if values.device.type == "cpu":
        return connected_labels_plain(values, size)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    if size * size > 1024:
        raise ValueError("the CUDA kernel takes boards up to 32x32")
    values = values.contiguous()
    out = torch.empty_like(values)
    if values.shape[0] == 0:
        return out
    global _launch, launches
    if _launch is None:
        _launch = _build.load("labels", _SIGNATURES).connected_labels_launch
    _build.launch(_launch, values.device, "connected_labels",
                  values.data_ptr(), out.data_ptr(), values.shape[0], size)
    with _launches_lock:
        launches += 1
    return out
