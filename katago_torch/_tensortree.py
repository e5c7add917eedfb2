"""Minimal pytree helpers over dataclasses of tensors.

The engine and search state are plain dataclasses whose leaves are
batched tensors; `tree_map` plays the role of jax.tree.map for them.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply fn leaf-wise over matching dataclass trees (None stays None)."""
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def where(cond, a, b):
    """Leaf-wise torch.where with cond [G] broadcast over trailing dims."""
    def sel(x, y):
        c = cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim()))
        return torch.where(c, x, y)

    return tree_map(sel, a, b)
