"""The port's root extras against the JAX package's saved results
(tests/data/torch_ref/search_extras.npz): a 5x5 run_search with ladder
planes on, root_allowed_mask, root_num_symmetries=4 (the fixture's
symmetry ids) and track_moves_ownership, its extract_pv and
child_analysis_extras; and 9x9 searches of a mirrored game with and
without MirrorArrs (the b1c6 .bin.gz through DescNet). Visit counts,
node counts, PVs and ladder masks exact; floats within 1e-5 (the LCB
radii of unvisited children, near 5e8, within 1e-5 relative; the moves
ownership stdev by its square). The
anti-mirror helpers also run against the JAX functions live (numpy and
one small jit each)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from katago_tpu.search import mirror as JMIR
from katago_torch.game import history as TH
from katago_torch.models import desc as TD
from katago_torch.search import mcts
from katago_torch.search import mirror as TMIR
from katago_torch.search.params import SearchParams as TParams

from tests import test_torch_common as C

REF, META = C.load_ref("search_extras")
SIZE, VISITS = META["size"], META["visits"]
MIR = META["mirror"]
FLOATS = ("root_winloss", "root_score_mean", "root_lead", "root_utility",
          "root_score_stdev", "child_winloss", "child_score_mean",
          "root_ownership")


def games(moves, size, max_hist=64):
    t = TH.new_game(size, C.RULESETS["tromp_taylor"][1], max_hist,
                    g=len(moves), device="cpu")
    for k in range(len(moves[0])):
        mv = np.array([m[k] for m in moves], np.int64)
        t, _ = TH.step(t, torch.from_numpy(mv), size)
    return t


def check_result(res, prefix, tol=1e-5):
    for n in ("root_visits", "child_visits"):
        np.testing.assert_array_equal(C.to_np(getattr(res, n)),
                                      REF[prefix + n], err_msg=n)
    np.testing.assert_array_equal(C.to_np(res.ss.tree.num_nodes),
                                  REF[prefix + "num_nodes"])
    np.testing.assert_array_equal(C.to_np(res.ss.tree.laddered),
                                  REF[prefix + "laddered"])
    np.testing.assert_array_equal(C.to_np(res.root_policy_prior),
                                  REF[prefix + "root_policy_prior"])
    for n in FLOATS:
        np.testing.assert_allclose(C.to_np(getattr(res, n)), REF[prefix + n],
                                   atol=tol, rtol=0, err_msg=n)


@pytest.fixture(scope="module")
def extras_search():
    return _extras_search()


def _extras_search():
    sp = dataclasses.replace(TParams.for_selfplay(),
                             root_noise_enabled=False).to_arr("cpu")
    mask = torch.from_numpy(C.extras_mask(SIZE))
    res = mcts.run_search(
        C.ref_model(SIZE), games(META["moves"], SIZE), sp,
        torch.Generator().manual_seed(0), size=SIZE, num_sims=VISITS,
        max_nodes=META["max_nodes"], max_visits=META["max_visits"],
        with_ladders=True, root_allowed_mask=mask,
        root_num_symmetries=META["root_num_symmetries"],
        track_moves_ownership=True,
        _root_syms=torch.from_numpy(REF["syms"]).long())
    return res, sp, mask


def test_masked_symmetry_averaged_search_matches_jax(extras_search):
    res, _, mask = extras_search
    check_result(res, "x/")
    # the disallowed root moves were never searched and hold no prior
    off = ~mask.numpy()
    assert (C.to_np(res.child_visits)[off] == 0).all()
    assert (C.to_np(res.root_policy_prior)[off] == -1).all()


def test_moves_ownership_matches_jax(extras_search):
    res, _, _ = extras_search
    for n in ("moves_ownership", "moves_own_weight"):
        np.testing.assert_allclose(C.to_np(getattr(res, n)), REF[f"x/{n}"],
                                   atol=1e-5, rtol=0, err_msg=n)
    # the stdev is the sqrt of a difference of near-equal sums, so hold
    # its square (the variance the sums give) within 1e-5
    np.testing.assert_allclose(C.to_np(res.moves_ownership_stdev) ** 2,
                               REF["x/moves_ownership_stdev"] ** 2,
                               atol=1e-5, rtol=0)
    # every counted playout's leaf belongs to some root move
    w = C.to_np(res.moves_own_weight)
    assert (w[C.to_np(res.child_visits) == 0] == 0).all()


def test_extract_pv_matches_jax(extras_search):
    res, _, _ = extras_search
    tree = res.ss.tree
    pv, n = mcts.extract_pv(tree, 15)
    np.testing.assert_array_equal(C.to_np(pv), REF["x/pv"])
    np.testing.assert_array_equal(C.to_np(n), REF["x/pv_len"])
    top = res.child_visits.argmax(1)
    starts = tree.children[torch.arange(2), 0, top].long()
    cpv, cn = mcts.extract_pv(tree, 14, start=starts)
    np.testing.assert_array_equal(C.to_np(cpv), REF["x/child_pv"])
    np.testing.assert_array_equal(C.to_np(cn), REF["x/child_pv_len"])
    # one game's tree, several starts (the analysis engine's form)
    g1 = torch.ones(2, dtype=torch.int64)
    both, _ = mcts.extract_pv(tree, 14, start=starts[[1, 1]], games=g1)
    np.testing.assert_array_equal(C.to_np(both), REF["x/child_pv"][[1, 1]])
    empty, en = mcts.extract_pv(tree, 4, start=torch.tensor([-1, -1]))
    assert (C.to_np(empty) == -1).all() and (C.to_np(en) == 0).all()


def test_child_analysis_extras_match_jax(extras_search):
    res, sp, _ = extras_search
    ext = mcts.child_analysis_extras(res, sp)
    assert set(ext) == {k.split("/")[-1] for k in REF
                        if k.startswith("x/extras/")}
    for k, v in ext.items():
        want = REF[f"x/extras/{k}"]
        if want.dtype == bool:
            np.testing.assert_array_equal(C.to_np(v), want, err_msg=k)
        else:
            # unvisited children carry radii near 5e8: relative there
            np.testing.assert_allclose(C.to_np(v), want, atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def mirror_game():
    moves, plas = C.mirror_history(MIR["size"], 15)
    t = TH.new_game(MIR["size"], C.RULESETS["tromp_taylor"][1], 128,
                    device="cpu")
    for mv in moves:
        t, _ = TH.step(t, torch.tensor([mv]), MIR["size"])
    return t, moves, plas


@pytest.mark.parametrize("on", [True, False], ids=["mirror", "no_mirror"])
def test_mirrored_game_search_matches_jax(on, mirror_game):
    gs, moves, plas = mirror_game
    size = MIR["size"]
    stones = C.to_np(gs.pos.board.stones[0])
    det = TMIR.detect_game(moves, plas, root_pla=1, stones=stones, komi=7.5,
                           scoring_area=True, size=size)
    assert list(det) == MIR["detect"]
    marr = TMIR.MirrorArrs(
        mirroring=torch.tensor([True]), mirror_pla=torch.tensor([2]),
        advantage=torch.tensor([det[1]], dtype=torch.float32),
        center_err=torch.tensor([det[2]], dtype=torch.float32))
    net = TD.load_net(str(C.REF_DIR / MIR["model"]), "cpu")
    res = mcts.run_search(
        net, gs, TParams(root_noise_enabled=False).to_arr("cpu"),
        torch.Generator().manual_seed(0), size=size, num_sims=MIR["visits"],
        max_nodes=MIR["visits"] + 3, max_visits=MIR["max_visits"],
        with_ladders=False, mirror=marr if on else None)
    check_result(res, "m_on/" if on else "m_off/")


def test_mirror_changes_the_search():
    """The fixture itself: the anti-mirror hooks move visits to the
    center refutations (searchmirror.cpp forced exploration)."""
    center = (MIR["size"] // 2) * MIR["size"] + MIR["size"] // 2
    assert REF["m_on/child_visits"][0, center] > \
        REF["m_off/child_visits"][0, center]


def _histories():
    size = 9
    out = []
    for n in (15, 10, 7, 22):
        out.append(C.mirror_history(size, n))
    out.append(([40, 30, 41, 31, 42, 32, 50, 20, 51, 21, 52, 22, 60, 10],
                [1, 2] * 7))
    rng = np.random.default_rng(3)
    for _ in range(4):
        mv = [int(x) for x in rng.choice(81, 24, replace=False)]
        for i in range(1, 24, 2):          # white mirrors most replies
            if rng.random() < 0.8:
                p = mv[i - 1]
                mv[i] = (8 - p // 9) * 9 + (8 - p % 9)
        out.append((mv, [1, 2] * 12))
    return out


@pytest.mark.parametrize("case", range(9))
def test_detect_game_matches_jax(case):
    moves, plas = _histories()[case]
    stones = np.zeros(81, np.int32)
    for m, p in zip(moves, plas):
        stones[m] = p
    for root_pla in (1, 2):
        for area, nh, bonus in ((True, 0, 0), (False, 0, 0), (True, 3, 2)):
            kw = dict(root_pla=root_pla, stones=stones, komi=6.5,
                      scoring_area=area, size=9, num_handicap=nh,
                      handicap_bonus=bonus)
            assert TMIR.detect_game(moves, plas, **kw) == \
                JMIR.detect_game(moves, plas, **kw)


@pytest.mark.parametrize("size", [9, 8])
def test_adjust_policy_and_puct_adjust_match_jax(size):
    rng = np.random.default_rng(size)
    g, nn = 16, size * size
    a = nn + 1
    pol = rng.random((g, a)).astype(np.float32)
    pol[rng.random((g, a)) < 0.2] = -1.0
    stones = rng.integers(0, 3, (g, nn)).astype(np.int32)
    if size % 2:
        stones[:4, nn // 2] = np.array([2, 2, 1, 0])
    prev = rng.integers(-1, a, g).astype(np.int32)
    pla = rng.integers(1, 3, g).astype(np.int32)
    depth = rng.integers(0, 6, g).astype(np.int32)
    mm = rng.random(g) < 0.8
    mpla = rng.integers(1, 3, g).astype(np.int32)
    adv = rng.choice([-7.0, -2.0, 0.0, 3.0, 6.5], g).astype(np.float32)
    err = rng.choice([0.0, 0.5, 3.0], g).astype(np.float32)
    root = rng.integers(1, 3, g).astype(np.int32)
    want = jax.jit(jax.vmap(lambda *xs: JMIR.adjust_policy(*xs, size)))(
        pol, prev, pla, depth, stones, mm, mpla, adv, root)
    t = lambda x: torch.from_numpy(np.asarray(x))  # noqa: E731
    got = TMIR.adjust_policy(t(pol), t(prev).long(), t(pla).long(),
                             t(depth).long(), t(stones), t(mm),
                             t(mpla).long(), t(adv), t(root).long(), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    value = rng.standard_normal((g, a)).astype(np.float32) * 0.3
    cw = (rng.random((g, a)) * 5).astype(np.float32)
    total = cw.sum(1)
    pu = rng.standard_normal(g).astype(np.float32) * 0.3
    is_root = rng.random(g) < 0.5
    want = jax.jit(jax.vmap(lambda *xs: JMIR.puct_adjust(*xs, size)))(
        value, pol, prev, pla, cw, total, pu, stones, is_root, mm, mpla,
        adv, err, root)
    got = TMIR.puct_adjust(t(value), t(pol), t(prev).long(), t(pla).long(),
                           t(cw), t(total), t(pu), t(stones), t(is_root),
                           t(mm), t(mpla).long(), t(adv), t(err),
                           t(root).long(), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
