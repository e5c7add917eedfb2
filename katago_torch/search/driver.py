"""Chunked search driver — port of the visit-budget path of
katago_tpu/search/driver.py::SearchDriver.

The host runs playouts in chunks of `chunk_size`: a search of
`max_visits` first runs the chunks that budget needs without polling
(a fresh root has 1 visit; a reused tree costs one sync to learn its
least root visits), then checks the root visits (one sync per chunk) and
tops up playouts voided by superko rejections. Time management,
callbacks, pondering and AsyncSearch are not ported yet.
"""

from __future__ import annotations

import torch

from katago_torch.device import resolve_device
from katago_torch.game import history as H
from katago_torch.search import mcts


class SearchDriver:
    """Chunk-stepped search over a fixed (size, max_nodes, chunk)
    configuration; drives any [G]-batch of games on `device` (CUDA unless
    the caller names another device)."""

    def __init__(self, model: torch.nn.Module, sp, *, size: int,
                 max_nodes: int, chunk_size: int = 16, max_depth: int = 64,
                 with_ladders: bool = True, ladder_mode: str = "chase",
                 root_num_symmetries: int = 1, feature_version: int = 7,
                 device=None):
        self.device = resolve_device(device)
        self.model = model
        self.sp = sp
        self.size = size
        self.max_nodes = max_nodes
        self.chunk_size = chunk_size
        self.max_depth = max_depth
        self.with_ladders = with_ladders
        self.ladder_mode = ladder_mode
        self.root_num_symmetries = root_num_symmetries
        self.feature_version = feature_version

    def _check_device(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"roots are on {t.device}, the driver runs on "
                             f"{self.device}")

    def search(self, roots: H.GameState, gen: torch.Generator, *,
               max_visits: int, active_mask=None,
               prev_tree: mcts.Tree | None = None,
               prev_actions=None) -> mcts.SearchResult:
        """Search every game until its root has max_visits visits (the
        root's own eval counts one, as the reference's maxVisits does).
        prev_tree / prev_actions: reuse the previous search's trees,
        re-rooted at the actions then played (mcts.init_search)."""
        self._check_device(roots.hist_len)
        g = roots.hist_len.shape[0]
        ss = mcts.init_search(
            self.model, roots, self.sp, gen, size=self.size,
            max_nodes=self.max_nodes, with_ladders=self.with_ladders,
            ladder_mode=self.ladder_mode,
            root_num_symmetries=self.root_num_symmetries,
            feature_version=self.feature_version, prev_tree=prev_tree,
            prev_actions=prev_actions)
        amask = (torch.ones((g,), dtype=torch.bool, device=self.device)
                 if active_mask is None else active_mask)

        def chunk():
            mcts.run_playouts(
                self.model, ss, self.sp, gen, size=self.size,
                num_sims=self.chunk_size, max_depth=self.max_depth,
                with_ladders=self.with_ladders, ladder_mode=self.ladder_mode,
                max_visits=max_visits, active_mask=amask,
                feature_version=self.feature_version)

        # run the budget's chunks without polling, then top up playouts
        # voided by superko rejections
        visits0 = 1 if prev_tree is None else \
            int(ss.tree.visits[:, 0].min())
        n_full = max(0, max_visits - visits0 + self.chunk_size - 1) // \
            self.chunk_size
        for _ in range(n_full):
            chunk()
        while not bool(((ss.tree.visits[:, 0] >= max_visits) | ~amask).all()):
            chunk()
        return mcts.collect_results(ss)
