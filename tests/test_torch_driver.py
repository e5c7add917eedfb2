"""The port's SearchDriver beyond the visit budget (katago_tpu
driver.py:113-317): time bounds read through an injected clock, min_time,
callbacks and their counts, stop_event, should_stop, the dynamic time
limit, the futile-visits stop (equal to the JAX driver's decision on the
same trees, its host-side numpy run live), AsyncSearch, and the
arguments it refuses. 5x5, b1c6 float32 on the CPU, a few visits."""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from katago_tpu.search import driver as JDRV
from katago_tpu.search import params as JP
from katago_torch.search.driver import (AsyncSearch, SearchDriver,
                                        split_generator)
from katago_torch.search.params import SearchParams

from tests import test_torch_common as C

SIZE = 5
CHUNK = 4


class StepClock:
    """A clock that advances by `step` seconds at every read."""

    def __init__(self, step=1.0):
        self.t, self.step, self.reads = -1.0, step, 0

    def __call__(self):
        self.t += self.step
        self.reads += 1
        return self.t


@pytest.fixture(scope="module")
def model():
    return C.ref_model(SIZE)


def roots(g=1):
    return C.random_games_torch(SIZE, g, 4, "tromp_taylor", seed=11)


def driver(model, clock=time.time, **kw):
    sp = dataclasses.replace(SearchParams.for_selfplay(),
                             root_noise_enabled=False).to_arr("cpu")
    return SearchDriver(model, sp, size=SIZE, max_nodes=64,
                        chunk_size=CHUNK, with_ladders=False, device="cpu",
                        clock=clock, **kw)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_max_time_stops_between_chunks(model):
    # reads: t0 = 0, then one per loop turn: 1, 2, 3 run a chunk each,
    # 4 >= 3.5 stops
    res = driver(model, StepClock()).search(roots(), gen(), max_time=3.5)
    assert int(res.root_visits[0]) == 1 + 3 * CHUNK


def test_min_time_holds_a_finished_search(model):
    clock = StepClock()
    res = driver(model, clock).search(roots(), gen(), max_visits=5,
                                      min_time=6.0)
    assert int(res.root_visits[0]) == 5
    assert clock.reads == 1 + 6        # t0, then elapsed 1..6


@pytest.mark.parametrize("interval,calls", [(2.0, 4), (3.0, 2), (0.5, 4)])
def test_callback_count_and_results(model, interval, calls):
    seen = []
    res = driver(model, StepClock()).search(
        roots(), gen(), max_visits=1 + 4 * CHUNK,
        callback=lambda r, el: seen.append((int(r.root_visits[0]), el)),
        callback_interval=interval)
    assert int(res.root_visits[0]) == 1 + 4 * CHUNK
    assert len(seen) == calls
    visits = [v for v, _ in seen]
    assert visits == sorted(visits) and visits[-1] <= 1 + 4 * CHUNK
    assert all(el > 0 for _, el in seen)


def test_stop_event_and_should_stop(model):
    d = driver(model)
    ev = threading.Event()
    ev.set()
    assert int(d.search(roots(), gen(), stop_event=ev).root_visits[0]) == 1
    # should_stop is polled only after the first chunk
    res = d.search(roots(), gen(), should_stop=lambda: True)
    assert int(res.root_visits[0]) == 1 + CHUNK
    # a stop from inside a callback ends the search after that chunk
    ev = threading.Event()
    res = d.search(roots(), gen(), stop_event=ev,
                   callback=lambda r, el: ev.set(), callback_interval=0.0)
    assert int(res.root_visits[0]) == 1 + CHUNK


def test_time_managed_search_recomputes_its_limit(model):
    hp = SearchParams(midgame_time_factor=2.0, obvious_moves_time_factor=0.5)
    res = driver(model, StepClock()).search(
        roots(), gen(), time_rec=3.5, time_max=10.0, host_params=hp,
        turn_number=40)
    assert int(res.root_visits[0]) > 1


def test_refused_arguments(model):
    d = driver(model)
    with pytest.raises(ValueError, match="visit cap"):
        d.search(roots(), gen())
    # a pattern-bonus table (once refused) is taken; one whose keys match
    # no move leaves every node's bonus at zero
    from katago_torch.search import patternbonus as PB
    empty = PB.PatternBonusTable().to_arrays("cpu")
    res = d.search(roots(), gen(), max_visits=4, pattern_bonus=empty)
    assert int(res.root_visits[0]) == 4
    assert not bool(res.ss.tree.stats[..., 17].any())
    from katago_torch import _tensortree as T
    with pytest.raises(ValueError, match="driver runs on"):
        d.search(T.tree_map(lambda t: t.to("meta"), roots()), gen(),
                 max_visits=4)


def _fake_trees(rng, n_children):
    """A root with n_children children of random visits, as numpy arrays
    (JAX driver) and torch tensors (port)."""
    a = SIZE * SIZE + 1
    n = n_children + 1
    children = np.full((1, n, a), -1, np.int16)
    acts = rng.choice(a, n_children, replace=False)
    children[0, 0, acts] = np.arange(1, n)
    visits = np.zeros((1, n), np.int64)
    visits[0, 1:] = rng.integers(0, 200, n_children)
    visits[0, 0] = visits[0, 1:].sum() + 1
    policy = np.full((1, n, a), -1.0, np.float16)
    p = rng.random(a) * (rng.random(a) < 0.7)
    policy[0, 0, p > 0] = (p[p > 0] / p.sum()).astype(np.float16)

    class NS:
        pass

    jss, tss = NS(), NS()
    jss.tree, tss.tree = NS(), NS()
    jss.tree.children, jss.tree.visits = children, visits
    jss.tree.policy = policy
    tss.tree.children = torch.from_numpy(children)
    tss.tree.visits = torch.from_numpy(visits)
    tss.tree.policy = torch.from_numpy(policy)
    return jss, tss


@pytest.mark.parametrize("seed", range(6))
def test_futile_stop_and_surprise_equal_jax(model, seed):
    rng = np.random.default_rng(seed)
    jd = object.__new__(JDRV.SearchDriver)
    jd.size = SIZE
    td = driver(model)
    for n_children in (1, 2, 5, 12):
        jss, tss = _fake_trees(rng, n_children)
        assert jd._root_entropy_surprise(jss) == \
            td._root_entropy_surprise(tss)
        for thr in (0.05, 0.3):
            kw = dict(futile_visits_threshold=thr,
                      midgame_time_factor=1.5)
            jhp, thp = JP.SearchParams(**kw), SearchParams(**kw)
            for elapsed, planned, turn in ((0.5, 1.0, 10), (2.0, 2.5, 90),
                                           (1.0, 30.0, 200)):
                assert jd._futile_stop(jss, jhp, elapsed, planned, turn) == \
                    td._futile_stop(tss, thp, elapsed, planned, turn)


def test_async_search_stop_returns_a_reusable_tree(model):
    d = driver(model)
    g = split_generator(gen(3))
    bg = AsyncSearch(d, roots(), g, max_visits=60)
    assert isinstance(bg.running, bool)
    time.sleep(0.3)
    res = bg.stop()
    assert not bg.running
    v = int(res.root_visits[0])
    assert 1 <= v <= 60
    # the stopped search's tree continues where it stopped
    again = d.search(roots(), gen(), max_visits=v + 8,
                     prev_tree=res.ss.tree)
    assert int(again.root_visits[0]) == v + 8
    assert int(again.ss.tree.num_nodes[0]) >= int(res.ss.tree.num_nodes[0])


def test_async_search_reraises_its_error(model):
    """An error in the background search (here a root mask of the wrong
    shape) is raised again by stop()."""
    bad_mask = torch.ones((1, 3), dtype=torch.bool)
    bg = AsyncSearch(driver(model), roots(), gen(), max_visits=8,
                     root_allowed_mask=bad_mask)
    with pytest.raises(RuntimeError):
        bg.stop()


def test_split_generator_is_seeded_by_its_parent():
    a = split_generator(gen(5))
    b = split_generator(gen(5))
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    p = gen(5)
    c, d = split_generator(p), split_generator(p)
    assert not torch.equal(torch.rand(4, generator=c),
                           torch.rand(4, generator=d))
