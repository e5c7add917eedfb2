"""The port's KataGoModel vs the Flax KataGoModel in float32, weights
carried over with from_flax_params: every head within atol = rtol =
1e-4 (summation order differs between XLA and torch). The Flax
parameters are seeded random values of every leaf (zero-init betas and
fixup convs included), shaped without compiling the Flax init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katago_tpu.models import config as JC
from katago_tpu.models.model import KataGoModel as JModel
from katago_torch.models import config as TC
from katago_torch.models import model as TM
from katago_torch.models import weights as TW

from tests import test_torch_common as C

TINY_NBT = dict(
    name="b2c8nbt", trunk_num_channels=8, mid_num_channels=4,
    gpool_num_channels=2, block_kind=("bottlenest2gpool", "bottlenest2"),
    p1_num_channels=4, g1_num_channels=4, v1_num_channels=4, v2_size=8,
    sbv2_num_channels=8, num_scorebeliefs=2)


def _configs(name):
    if name == "tiny_nbt":
        return JC.ModelConfig(**TINY_NBT), TC.ModelConfig(**TINY_NBT)
    return JC.get_config(name), TC.get_config(name)


@pytest.mark.parametrize("name,size", [("b1c6", 9), ("b2c16", 7),
                                       ("tiny_nbt", 9)])
def test_forward_matches_flax(name, size):
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(7)
    b = 3
    spatial = (rng.random((b, size, size, 22)) < 0.3).astype(np.float32)
    glob = rng.standard_normal((b, 19)).astype(np.float32)
    mask = np.ones((b, size, size, 1), np.float32)
    mask[1, -2:, :, :] = 0.0          # a smaller board inside the grid
    jm = JModel(jcfg, pos_len=size, dtype=jnp.float32)
    params = C.flax_params(jm, size, seed=2)
    ref = jax.jit(jm.apply)(params, jnp.asarray(spatial), jnp.asarray(glob),
                            jnp.asarray(mask))
    tm = TM.KataGoModel(tcfg, pos_len=size, dtype=torch.float32)
    tm.load_state_dict(TW.from_flax_params(
        jax.tree.map(np.asarray, params["params"])))
    with torch.no_grad():
        out = tm(torch.from_numpy(spatial), torch.from_numpy(glob),
                 torch.from_numpy(mask))
    assert set(out) == set(ref)
    for k in ref:
        a, o = np.asarray(ref[k]), C.to_np(out[k])
        assert a.shape == o.shape, k
        np.testing.assert_allclose(o, a, atol=1e-4, rtol=1e-4, err_msg=k)


def test_seeded_init_is_deterministic_and_finite():
    cfg = TC.get_config("b2c16")
    m1 = TW.init_weights(TM.KataGoModel(cfg, 9, torch.float32), seed=5)
    m2 = TW.init_weights(TM.KataGoModel(cfg, 9, torch.float32), seed=5)
    for (k, a), (_, b) in zip(m1.state_dict().items(),
                              m2.state_dict().items()):
        assert torch.equal(a, b), k
    x = torch.zeros((2, 9, 9, 22))
    x[..., 0] = 1.0
    with torch.no_grad():
        out = m1(x, torch.zeros((2, 19)))
    assert all(torch.isfinite(v).all() for v in out.values())
    assert out["policy_logits"].shape == (2, 6, 82)


def test_unported_block_kinds_raise():
    """Every block kind of the JAX package builds (the v17 transformer
    preset here; tests/test_torch_nets.py holds each kind against JAX);
    a kind neither package has raises ValueError in both."""
    cfg = JC.get_config("b5c48h3tfr")
    import dataclasses
    tcfg = TC.ModelConfig(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(cfg)})
    model = TW.init_weights(TM.KataGoModel(tcfg, 9, torch.float32), seed=1)
    assert model.TransformerAttentionBlock_4.use_rope
    x = torch.zeros((2, 9, 9, 22))
    x[..., 0] = 1.0
    with torch.no_grad():
        out = model(x, torch.zeros((2, 19)))
    assert out["policy_logits"].shape == (2, 8, 82)
    assert all(torch.isfinite(v).all() for v in out.values())
    bad = dataclasses.replace(tcfg, block_kind=("bottle4",))
    with pytest.raises(ValueError, match="unsupported block kind"):
        TM.KataGoModel(bad, 9)
