"""The port's featurizer vs katago_tpu.models.features.fill_features in
chase mode with cached ladder inputs (the search evaluator's path), on
seeded random 9x9 games under area and territory rules: spatial planes
exact, globals within 1e-6; the older versions V3-V6 bit for bit. The games are played on the port and handed
to JAX as the same GameState (test_torch_board.py holds the stepping
itself against JAX)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katago_tpu.game import ladder as JL
from katago_tpu.models import features as JF
from katago_torch.game import history as TH
from katago_torch.game import ladder as TL
from katago_torch.models import features as TF

from tests import test_torch_common as C

SIZE = 9


def test_fill_features_v7_chase_mode_matches_jax():
    t1 = C.random_games_torch(SIZE, 3, 30, "tromp_taylor", 21)
    t2 = C.random_games_torch(SIZE, 3, 24, "japanese", 22, pass_prob=0.2)
    t_gs = C.tree_cat(t1, t2)
    j_gs = C.jax_games_like(t_gs, SIZE)
    g = 6
    legal = TH.legal_moves(t_gs, SIZE)
    stones = t_gs.pos.board.stones
    cur = TL.ladder_map_chase_batch(stones, SIZE,
                                    ko_loc=t_gs.pos.simple_ko_loc)
    prev = TL.ladder_map_chase_batch(t_gs.pos.prev_stones.to(torch.int32),
                                     SIZE, ko_loc=t_gs.pos.prev_ko_loc)
    pprev = TL.ladder_map_chase_batch(
        t_gs.pos.prev_prev_stones.to(torch.int32), SIZE,
        ko_loc=t_gs.pos.prev_prev_ko_loc)
    params = TF.FeatureParams(torch.tensor(0.5), torch.tensor(0.25),
                              torch.tensor(False))
    sp, gl = TF.fill_features(t_gs, SIZE, params, legal,
                              ladder_mode="chase",
                              prev_laddered=prev.laddered,
                              prev_prev_laddered=pprev.laddered,
                              cur_ladder=cur)

    jcur = JL.LadderResult(*(jnp.asarray(C.to_np(getattr(cur, f.name)))
                             for f in dataclasses.fields(cur)))
    jparams = JF.FeatureParams(jnp.float32(0.5), jnp.float32(0.25),
                               jnp.bool_(False))
    jsp, jgl = jax.jit(jax.vmap(
        lambda gs_, l_, p_, pp_, cl_: JF.fill_features(
            gs_, SIZE, jparams, l_, ladder_mode="chase", prev_laddered=p_,
            prev_prev_laddered=pp_, cur_ladder=cl_)))(
        j_gs, jnp.asarray(C.to_np(legal)), jnp.asarray(C.to_np(prev.laddered)),
        jnp.asarray(C.to_np(pprev.laddered)), jcur)
    assert sp.shape == (g, SIZE * SIZE, 22) and gl.shape == (g, 19)
    np.testing.assert_array_equal(C.to_np(sp), np.asarray(jsp))
    np.testing.assert_allclose(C.to_np(gl), np.asarray(jgl), rtol=0,
                               atol=1e-6)
    # the positions exercise the interesting planes
    assert C.to_np(sp[..., 14]).any() or C.to_np(sp[..., 3]).any()
    assert C.to_np(sp[..., 18]).any()


def test_fill_features_v7_exact_mode_matches_jax():
    """The default exact ladders with no cached masks (current, previous
    and pre-previous boards solved in one batch) vs the fixture
    tests/data/torch_ref/features.npz: JAX fill_features_v7 on the same
    games."""
    ref, meta = C.load_ref("features")
    t_gs = None
    for rules, g, n, seed, pp in meta["games"]:
        t = C.random_games_torch(SIZE, g, n, rules, seed, pass_prob=pp)
        t_gs = t if t_gs is None else C.tree_cat(t_gs, t)
    params = TF.FeatureParams(*(torch.tensor(v)
                                for v in meta["feature_params"]))
    stats = {}
    sp, gl = TF.fill_features_v7(t_gs, SIZE, params, ladder_stats=stats)
    np.testing.assert_array_equal(C.to_np(sp), ref["spatial"])
    np.testing.assert_allclose(C.to_np(gl), ref["global"], rtol=0,
                               atol=1e-6)
    assert stats["calls"] == 1 and stats["lanes"] > 0
    # the boards hold laddered stones and working ladder moves
    assert ref["spatial"][..., 14].any() and ref["spatial"][..., 17].any()


def test_fill_features_rejects_unported_versions():
    """Versions outside 3..7 and unknown ladder modes raise ValueError,
    as in the JAX package (every version it has is ported)."""
    gs = TH.new_game(SIZE, C.RULESETS["tromp_taylor"][1], 8, g=1,
                     device="cpu")
    legal = TH.legal_moves(gs, SIZE)
    params = TF.FeatureParams.default("cpu")
    import pytest
    for v in (2, 8):
        with pytest.raises(ValueError, match="version"):
            TF.fill_features(gs, SIZE, params, legal, version=v)
    with pytest.raises(ValueError):
        TF.fill_features(gs, SIZE, params, legal, ladder_mode="greedy")
    assert sorted(TF.NUM_SPATIAL_BY_VERSION) == [3, 4, 5, 6, 7]
    assert TF.NUM_SPATIAL_BY_VERSION == JF.NUM_SPATIAL_BY_VERSION
    assert TF.NUM_GLOBAL_BY_VERSION == JF.NUM_GLOBAL_BY_VERSION


VERSIONS_REF, VERSIONS_META = C.load_ref("features_versions")


@pytest.mark.parametrize("version", VERSIONS_META["versions"])
def test_fill_features_older_versions_match_jax(version):
    """V3-V6 planes and globals bit for bit against JAX fill_features
    (chase ladders, no cached masks) on the features fixture's games
    (tests/data/torch_ref/features_versions.npz)."""
    t_gs = None
    for rules, g, n, seed, pp in VERSIONS_META["games"]:
        t = C.random_games_torch(SIZE, g, n, rules, seed, pass_prob=pp)
        t_gs = t if t_gs is None else C.tree_cat(t_gs, t)
    params = TF.FeatureParams(*(torch.tensor(v)
                                for v in VERSIONS_META["feature_params"]))
    sp, gl = TF.fill_features(t_gs, SIZE, params, TH.legal_moves(t_gs, SIZE),
                              version=version, ladder_mode="chase")
    want_sp = VERSIONS_REF[f"v{version}/spatial"]
    want_gl = VERSIONS_REF[f"v{version}/global"]
    assert sp.shape[-1] == TF.NUM_SPATIAL_BY_VERSION[version]
    assert gl.shape[-1] == TF.NUM_GLOBAL_BY_VERSION[version]
    np.testing.assert_array_equal(C.to_np(sp), want_sp)
    np.testing.assert_array_equal(C.to_np(gl), want_gl)
