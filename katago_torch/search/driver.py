"""Chunked search driver: time management, streaming analysis, pondering
— port of katago_tpu/search/driver.py (the reference's
cpp/search/asyncbot.{cpp,h} and the clock checks of
Search::runWholeSearch, search.cpp:473-607).

The host runs playouts in chunks of `chunk_size` and decides between
chunks: stop on the visit budget, the wall clock, a stop event (the
ponder / analyze interrupt) or a polled condition, or emit a streaming
analysis callback. A search bounded by visits alone first runs the
chunks its budget needs without polling (a fresh root has 1 visit; a
reused tree costs one sync to learn its least root visits), then checks
the root visits once per chunk and tops up playouts voided by superko
rejections; any other bound reads the visits once per chunk.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from katago_torch.device import resolve_device
from katago_torch.game import history as H
from katago_torch.search import mcts
from katago_torch.search import timecontrols as TC

BIG_VISITS = 1 << 30


class SearchDriver:
    """Chunk-stepped search over a fixed (size, max_nodes, chunk)
    configuration; drives any [G]-batch of games on `device` (CUDA unless
    the caller names another device). feature_version: the net's input
    features (3..7); sgf_meta: the humanSL profile its evaluations are
    conditioned on (None: none). clock: the wall clock the time bounds
    and callbacks read (time.time unless a test injects one)."""

    def __init__(self, model: torch.nn.Module, sp, *, size: int,
                 max_nodes: int, chunk_size: int = 16, max_depth: int = 64,
                 with_ladders: bool = True, ladder_mode: str = "chase",
                 root_num_symmetries: int = 1, feature_version: int = 7,
                 sgf_meta=None, device=None,
                 clock: Callable[[], float] = time.time):
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
        self.sgf_meta = sgf_meta
        self.clock = clock

    def _check_device(self, t: torch.Tensor) -> None:
        if t.device.type != self.device.type:
            raise ValueError(f"roots are on {t.device}, the driver runs on "
                             f"{self.device}")

    def pv_fn(self, max_len: int = 15):
        """PVs of every game's root (mcts.extract_pv)."""
        return lambda tree: mcts.extract_pv(tree, max_len)

    def search(self, roots: H.GameState, gen: torch.Generator, *,
               max_visits: int | None = None,
               min_time: float = 0.0,
               max_time: float | None = None,
               active_mask=None,
               prev_tree: mcts.Tree | None = None,
               prev_actions=None,
               callback: Callable | None = None,
               callback_interval: float = 1.0,
               stop_event: threading.Event | None = None,
               should_stop: Callable[[], bool] | None = None,
               time_rec: float | None = None,
               time_max: float | None = None,
               turn_number: int = 0,
               host_params=None,
               root_allowed_mask=None,
               mirror=None, pattern_bonus=None,
               sp=None,
               track_moves_ownership: bool = False,
               _root_syms=None) -> mcts.SearchResult:
        """Run a time / visit / interrupt-bounded search.

        max_visits: per-game root visit cap (the root's own eval counts
        one, as the reference's maxVisits does; None = unbounded, needs
        max_time, stop_event or should_stop). max_time: wall-clock cap,
        checked between chunks. min_time: do not stop on visits before
        this much wall time. callback(result, elapsed_s): streaming
        analysis hook, called at most every callback_interval seconds.
        stop_event: external interrupt (pondering / analyze
        cancellation). should_stop(): polled between chunks after the
        first.

        time_rec / time_max with host_params (a SearchParams with the
        time-manager knobs): the planned limit is recomputed between
        chunks with midgame weighting and the obvious-move discount from
        the live root entropy and surprise, and futileVisitsThreshold
        stops the search once no alternative move can catch the leader
        in the time left (single-game searches only).

        prev_tree / prev_actions: reuse the previous search's trees,
        re-rooted at the actions then played (mcts.init_search).
        root_allowed_mask, mirror, track_moves_ownership: the root
        extras of mcts.init_search / run_playouts; pattern_bonus: the
        avoid-repeated-shapes table of mcts.run_playouts. sp: search
        params for this search instead of the driver's."""
        self._check_device(roots.hist_len)
        g = roots.hist_len.shape[0]
        if sp is None:
            sp = self.sp
        mo = track_moves_ownership
        ss = mcts.init_search(
            self.model, roots, sp, gen, size=self.size,
            max_nodes=self.max_nodes, with_ladders=self.with_ladders,
            ladder_mode=self.ladder_mode,
            root_num_symmetries=self.root_num_symmetries,
            feature_version=self.feature_version, prev_tree=prev_tree,
            prev_actions=prev_actions, root_allowed_mask=root_allowed_mask,
            mirror=mirror, track_moves_ownership=mo, sgf_meta=self.sgf_meta,
            _root_syms=_root_syms)

        if time_rec is not None and max_time is None:
            max_time = time_rec   # refined between chunks below
        if max_visits is None and max_time is None and stop_event is None \
                and should_stop is None:
            raise ValueError("search needs a visit cap, time cap, or "
                             "stop condition")
        cap = max_visits if max_visits is not None else BIG_VISITS
        amask = (torch.ones((g,), dtype=torch.bool, device=self.device)
                 if active_mask is None else active_mask)

        def chunk():
            mcts.run_playouts(
                self.model, ss, sp, gen, size=self.size,
                num_sims=self.chunk_size, max_depth=self.max_depth,
                with_ladders=self.with_ladders, ladder_mode=self.ladder_mode,
                max_visits=cap, active_mask=amask,
                feature_version=self.feature_version, mirror=mirror,
                pattern_bonus=pattern_bonus, sgf_meta=self.sgf_meta,
                track_moves_ownership=mo)

        t0 = self.clock()
        last_cb = t0
        chunks_done = 0
        # a search bounded by visits alone knows its chunk count: run
        # those chunks without polling the device, then top up below
        if (max_time is None and time_rec is None and stop_event is None
                and should_stop is None and callback is None
                and max_visits is not None and max_visits < BIG_VISITS):
            visits0 = 1 if prev_tree is None else \
                int(ss.tree.visits[:, 0].min())
            n_full = max(0, max_visits - visits0 + self.chunk_size - 1) \
                // self.chunk_size
            for _ in range(n_full):
                chunk()
                chunks_done += 1
        while True:
            if stop_event is not None and stop_event.is_set():
                break
            # always run at least one chunk so an immediately interrupted
            # analyze still reports a real (if small) search
            if should_stop is not None and chunks_done > 0 and should_stop():
                break
            elapsed = self.clock() - t0
            if (time_rec is not None and host_params is not None
                    and chunks_done > 0 and g == 1):
                ent, surprise = self._root_entropy_surprise(ss)
                max_time = TC.recompute_search_time_limit(
                    host_params, time_rec, time_max or 0.0,
                    turn_number=turn_number, board_area=self.size ** 2,
                    policy_entropy=ent, policy_surprise=surprise)
            if max_time is not None and elapsed >= max_time:
                break
            visits_done = bool(((ss.tree.visits[:, 0] >= cap)
                                | ~amask).all())
            if visits_done and elapsed >= min_time:
                break
            if (host_params is not None and max_time is not None
                    and getattr(host_params, "futile_visits_threshold",
                                0.0) > 0 and g == 1 and chunks_done > 0
                    and elapsed >= 0.1
                    and self._futile_stop(ss, host_params, elapsed,
                                          max_time, turn_number)):
                break
            chunk()
            chunks_done += 1
            if callback is not None:
                now = self.clock()
                if now - last_cb >= callback_interval:
                    last_cb = now
                    callback(mcts.collect_results(ss), now - t0)
        return mcts.collect_results(ss)

    # -- dynamic time-management helpers (host side, g == 1) ------------

    def _root_entropy_surprise(self, ss):
        """Root policy entropy and search surprise
        (Search::getPolicySurpriseAndEntropy): entropy of the raw root
        prior, and the KL-ish surprise of the visit distribution
        relative to it."""
        prior = ss.tree.policy[0, 0, :].float().cpu().numpy()
        legal = prior >= 0
        p = np.where(legal, np.maximum(prior, 1e-30), 0.0)
        p = p / max(p.sum(), 1e-30)
        ent = float(-(p[legal] * np.log(np.maximum(p[legal], 1e-30))).sum())
        cv = self._root_child_visits(ss)
        tot = cv.sum()
        if tot <= 0:
            return ent, 0.0
        q = cv / tot
        nzq = q > 0
        surprise = float((q[nzq] * (np.log(q[nzq]) -
                                    np.log(np.maximum(p[nzq], 1e-30)))).sum())
        return ent, max(surprise, 0.0)

    @staticmethod
    def _root_child_visits(ss) -> np.ndarray:
        children = ss.tree.children[0, 0, :].long().cpu().numpy()
        visits = ss.tree.visits[0].cpu().numpy()
        return np.where(children >= 0, visits[np.maximum(children, 0)],
                        0).astype(np.float64)

    def _futile_stop(self, ss, hp, elapsed, planned, turn_number) -> bool:
        """futileVisitsThreshold early stop
        (searchtimehelpers.cpp:97-140): once no alternative to the
        best-by-visits move can reach the non-futile visit requirement in
        the time left, stop."""
        root_visits = float(ss.tree.visits[0, 0])
        if root_visits <= 1:
            return False
        ub_left = (planned - elapsed) / max(elapsed, 1e-9) * root_visits
        cv = self._root_child_visits(ss)
        if cv.sum() <= 0:
            return False
        best = int(cv.argmax())
        required = TC.num_visits_needed_to_be_non_futile(
            hp, cv[best], turn_number, self.size ** 2)
        if ub_left >= required:
            return False
        alt = np.delete(cv, best)
        return bool((alt + ub_left < required).all())


def split_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator on gen's device, seeded by one draw from gen (the
    port's counterpart of jax.random.split)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
    return torch.Generator(device=gen.device).manual_seed(seed)


class AsyncSearch:
    """Background search thread — the reference's AsyncBot pondering
    (asyncbot.h:72-135). Starts driver.search on a position in a Python
    thread (with the driver's CUDA device set there); stop() sets the
    stop event, joins, and returns the final result, whose tree the
    caller can reuse. gen is the thread's own generator (split_generator
    of the caller's)."""

    def __init__(self, driver: SearchDriver, roots, gen, **kwargs):
        self._stop = threading.Event()
        self._result = None
        self._error = None
        cuda_index = None
        if driver.device.type == "cuda":
            cuda_index = driver.device.index
            if cuda_index is None:
                cuda_index = torch.cuda.current_device()

        def run():
            try:
                if cuda_index is not None:
                    torch.cuda.set_device(cuda_index)
                self._result = driver.search(roots, gen,
                                             stop_event=self._stop, **kwargs)
            except BaseException as e:  # noqa: BLE001 — re-raised in stop()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> mcts.SearchResult | None:
        self._stop.set()
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def running(self) -> bool:
        return self._thread.is_alive()
