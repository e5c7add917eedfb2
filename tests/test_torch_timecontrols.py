"""The port's own copies of katago_tpu/search/timecontrols.py and
katago_tpu/utils/setup.py against the JAX package's, on seeded grids of
clocks, board areas and config files (hypothesis, derandomized): every
result equal. Both sides are pure Python; nothing here compiles."""

import dataclasses

from hypothesis import given, settings
from hypothesis import strategies as st

from katago_tpu.search import params as JP
from katago_tpu.search import timecontrols as JTC
from katago_tpu.utils import config_parser as JCP
from katago_tpu.utils import setup as JSETUP
from katago_torch.search import params as TP
from katago_torch.search import timecontrols as TTC
from katago_torch.utils import config_parser as TCP
from katago_torch.utils import setup as TSETUP

SETTINGS = settings(max_examples=60, derandomize=True, deadline=None)
times = st.floats(min_value=0.0, max_value=5000.0, allow_nan=False)
small = st.floats(min_value=0.0, max_value=120.0, allow_nan=False)
kinds = st.sampled_from(["absolute", "fischer", "fischer_capped",
                         "byo_yomi", "canadian", "default"])


def make_tc(mod, kind, a, b, c, n):
    t = mod.TimeControls
    if kind == "absolute":
        return t.absolute_time(a)
    if kind == "fischer":
        return t.fischer_time(a, b)
    if kind == "fischer_capped":
        return t.fischer_capped_time(a, b, c, -1.0 if n % 2 else b + c)
    if kind == "byo_yomi":
        return t.canadian_or_byo_yomi_time(a, b, n, 1)
    if kind == "canadian":
        return t.canadian_or_byo_yomi_time(a, b, 1, n)
    return t()


@SETTINGS
@given(kind=kinds, a=times, b=small, c=small, n=st.integers(1, 25),
       area=st.sampled_from([25, 49, 81, 169, 361]),
       stones=st.integers(0, 300), lag=st.sampled_from([0.0, 0.5, 1.0]),
       left=st.one_of(st.none(), st.tuples(times, st.integers(0, 25))))
def test_clocks_and_get_time_equal(kind, a, b, c, n, area, stones, lag, left):
    def build(mod):
        try:
            return make_tc(mod, kind, a, b, c, n), None
        except ValueError as e:        # both validate the same way
            return None, str(e)

    (j, jerr), (t, terr) = build(JTC), build(TTC)
    assert jerr == terr
    if jerr is not None:
        return
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert str(j) == str(t)
    assert j.is_effectively_unlimited() == t.is_effectively_unlimited()
    if left is not None:
        j.update_from_gtp_time_left(*left)
        t.update_from_gtp_time_left(*left)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    stones = min(stones, area)
    assert j.get_time(area, stones, lag_buffer=lag) == \
        t.get_time(area, stones, lag_buffer=lag)


@SETTINGS
@given(rec=st.floats(0.0, 1e21), pps=st.floats(0.0, 1e5),
       lo=st.sampled_from([1, 8, 16]), hi=st.sampled_from([64, 8192]))
def test_visits_for_time_budget_equal(rec, pps, lo, hi):
    assert JTC.visits_for_time_budget(rec, pps, lo, hi) == \
        TTC.visits_for_time_budget(rec, pps, lo, hi)


host = st.fixed_dictionaries({
    "overallocate_time_factor": st.floats(0.5, 2.0),
    "midgame_time_factor": st.sampled_from([1.0, 1.5, 2.0]),
    "midgame_turn_peak_time": st.floats(10.0, 200.0),
    "endgame_turn_time_decay": st.floats(10.0, 200.0),
    "obvious_moves_time_factor": st.sampled_from([1.0, 0.5, 0.2]),
    "obvious_moves_policy_entropy_tolerance": st.floats(0.0, 1.0),
    "obvious_moves_policy_surprise_tolerance": st.floats(0.0, 1.0),
    "futile_visits_threshold": st.sampled_from([0.0, 0.05, 0.2]),
})


@SETTINGS
@given(kw=host, rec=st.floats(0.0, 100.0), mx=st.floats(0.0, 200.0),
       turn=st.integers(0, 400), area=st.sampled_from([25, 81, 361]),
       ent=st.one_of(st.none(), st.floats(0.0, 5.0)),
       sur=st.one_of(st.none(), st.floats(0.0, 3.0)),
       best=st.floats(0.0, 5000.0))
def test_recompute_and_futility_equal(kw, rec, mx, turn, area, ent, sur,
                                      best):
    jp, tp = JP.SearchParams(**kw), TP.SearchParams(**kw)
    assert JTC.recompute_search_time_limit(
        jp, rec, mx, turn_number=turn, board_area=area,
        policy_entropy=ent, policy_surprise=sur) == \
        TTC.recompute_search_time_limit(
            tp, rec, mx, turn_number=turn, board_area=area,
            policy_entropy=ent, policy_surprise=sur)
    assert JTC.num_visits_needed_to_be_non_futile(jp, best, turn, area) == \
        TTC.num_visits_needed_to_be_non_futile(tp, best, turn, area)


KEYS = sorted(JSETUP._PARAM_KEYS)
VALUES = {bool: ["true", "false"], int: ["1", "4", "8"],
          float: ["0.25", "1.5", "0.9", "3"]}


def _kind(field):
    v = getattr(JP.SearchParams(), field)
    return bool if isinstance(v, bool) else int if isinstance(v, int) \
        else float


@SETTINGS
@given(picks=st.lists(st.tuples(st.sampled_from(KEYS),
                                st.integers(0, 3)), max_size=12),
       extra=st.lists(st.sampled_from(["numSearchThreads", "maxVisits",
                                       "maxTime", "lagBuffer", "bogusKey",
                                       "nnMaxBatchSize", "maxPlayouts"]),
                      max_size=4, unique=True))
def test_setup_equal(tmp_path_factory, picks, extra):
    lines = {}
    for key, i in picks:
        vals = VALUES[_kind(JSETUP._PARAM_KEYS[key])]
        lines[key] = vals[i % len(vals)]
    for key in extra:
        lines.setdefault(key, "7")
    path = tmp_path_factory.mktemp("cfg") / "a.cfg"
    path.write_text("".join(f"{k} = {v}\n" for k, v in lines.items()))
    jc, tc = JCP.ConfigParser(str(path)), TCP.ConfigParser(str(path))
    jp, tp = JSETUP.load_search_params(jc), TSETUP.load_search_params(tc)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert JSETUP.search_limits(jc) == TSETUP.search_limits(tc)
    jl, tl = [], []
    assert JSETUP.warn_unused(jc, jl.append) == \
        TSETUP.warn_unused(tc, tl.append)
    assert jl == tl
    over = {k: (v == "true" if v in ("true", "false") else v)
            for k, v in lines.items()}
    jo, ju = JSETUP.apply_overrides(JP.SearchParams(), over)
    to, tu = TSETUP.apply_overrides(TP.SearchParams(), over)
    assert dataclasses.asdict(jo) == dataclasses.asdict(to) and ju == tu
