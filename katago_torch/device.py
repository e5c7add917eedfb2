"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller names another device; with no
device given and no CUDA present they raise instead of quietly running on
the CPU (tests pass device="cpu" explicitly).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
