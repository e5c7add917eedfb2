"""Every net family of the port against the JAX package, on the CPU.

- Parameter shapes: the port's KataGoModel of each of the 23 presets (on
  the meta device, nothing allocated) against jax.eval_shape of the JAX
  model (tests/data/torch_ref/model_shapes.json), exact.
- Seeded float32 forwards, one per block kind or extra (bottle1-3,
  attn/attnrope with ffng/ffnsg, QK-norm GQA, nbttf with RoPE and with
  GAB, the metadata encoder, intermediate heads tapped mid-trunk and at
  the trunk end): every output within 1e-5 of the JAX forward relative
  to the larger of the entry and the largest on-board entry of its
  output (tests/data/torch_ref/nets.npz); the weights carry across both
  ways exactly.
- The exporter: bytes equal to the JAX exporter's (pure numpy, run live)
  for an attn/ffn net and a metadata-encoder net; both refuse QK-norm
  attention and the nested-bottleneck transformer hybrids with the same
  message.
- DescNet against the saved apply_desc_model outputs
  (tests/data/torch_ref/desc_tf.npz), same tolerance: v17 files with
  fixed RoPE and a v15 file with the metadata encoder (files of the
  exporter), and v17 files with learnable RoPE, GQA and
  the trunk-tip RMSNorm, spatial and per position (files written by
  tests.test_torch_common.write_tiny_transformer_model).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from katago_tpu.models import config as JC
from katago_tpu.models import export as JEXP
from katago_torch.models import config as TC
from katago_torch.models import desc as TD
from katago_torch.models import export as TEXP
from katago_torch.models import model as TM
from katago_torch.models import weights as TW

from tests import test_torch_common as C

SHAPES = json.loads((C.REF_DIR / "model_shapes.json").read_text())["shapes"]
NETS, NETS_META = C.load_ref("nets")
SIZE = NETS_META["size"]
DESC_TF, DESC_TF_META = C.load_ref("desc_tf")
RTOL = 1e-5


def flax_shape(key: str, shape) -> tuple[str, list]:
    """A state_dict entry's Flax path and shape (OIHW -> HWIO,
    [out, in] -> [in, out])."""
    *path, leaf = key.split(".")
    shape = list(shape)
    if leaf == "kernel" and len(shape) == 4:
        shape = [shape[2], shape[3], shape[1], shape[0]]
    elif leaf == "kernel" and len(shape) == 2:
        shape = shape[::-1]
    return "/".join(path + [leaf]), shape


def assert_outputs_close(got: dict, want: dict, what: str):
    """Same keys; each entry within RTOL of the larger of itself and the
    largest entry of its output that is not an off-board -5000 mask."""
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        g = got[k].detach().float().numpy() if torch.is_tensor(got[k]) \
            else np.asarray(got[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        on = np.abs(w) < 1000.0
        scale = max(1.0, float(np.abs(w[on]).max())) if on.any() else 1.0
        tol = RTOL * np.maximum(scale, np.abs(w))
        err = np.abs(g - w)
        assert (err <= tol).all(), (what, k, float(err.max()))


def inputs():
    sp, gl, mask, meta = C.net_inputs(SIZE, NETS_META["batch"], 11)
    return tuple(torch.from_numpy(a) for a in (sp, gl, mask, meta))


def port_net(kind: str) -> TM.KataGoModel:
    model = TM.KataGoModel(C.net_config(TC, kind), SIZE, torch.float32)
    model.load_state_dict(TW.from_flax_params(C.flax_tree(NETS,
                                                          f"w_{kind}")))
    return model.eval()


@pytest.mark.parametrize("preset", sorted(JC.CONFIGS))
def test_preset_parameter_shapes_match_jax(preset):
    cfg = TC.get_config(preset)
    assert cfg == TC.ModelConfig(**JC.get_config(preset).__dict__)
    with torch.device("meta"):
        model = TM.KataGoModel(cfg, SIZE, torch.float32)
    got = dict(flax_shape(k, v.shape) for k, v in model.state_dict().items())
    assert got == SHAPES[preset]


@pytest.mark.parametrize("kind", NETS_META["kinds"])
def test_seeded_forward_matches_jax(kind):
    sp, gl, mask, meta = inputs()
    with torch.no_grad():
        out = port_net(kind)(sp, gl, mask, meta)
    want = {k.split("/", 1)[1]: v for k, v in NETS.items()
            if k.startswith(f"out_{kind}/")}
    assert_outputs_close(out, want, kind)
    if kind.startswith("intermediate"):
        assert "intermediate_policy_logits" in out


@pytest.mark.parametrize("kind", NETS_META["kinds"])
def test_weights_carry_across_both_ways(kind):
    """from_flax_params then to_flax_params gives every leaf back
    bit for bit (4-D and 2-D kernels transposed, 1-D leaves copied)."""
    back = C.flat_flax(port_net(kind).state_dict(), "w")
    ref = {"w/" + k.split("/", 1)[1]: v for k, v in NETS.items()
           if k.startswith(f"w_{kind}/")}
    assert sorted(back) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["nbttf_gab", "metadata", "qknorm_gqa"])
def test_seeded_init_covers_the_new_modules(kind):
    model = TW.init_weights(TM.KataGoModel(C.net_config(TC, kind), SIZE,
                                           torch.float32), seed=3)
    again = TW.init_weights(TM.KataGoModel(C.net_config(TC, kind), SIZE,
                                           torch.float32), seed=3)
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), k
    for name, mod in model.named_modules():
        if isinstance(mod, TM.RMSNorm):
            assert torch.equal(mod.scale, torch.ones_like(mod.scale)), name
        if isinstance(mod, TM.GABTemplates):
            f = mod.freqs.detach()
            assert float(f[0]) == 1.0 and abs(float(f[-1]) - 0.02) < 1e-6
            assert bool((f[1:] < f[:-1]).all())
    sp, gl, mask, meta = inputs()
    with torch.no_grad():
        out = model(sp, gl, mask, meta)
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize("kind", ["attn_ffn", "metadata"])
def test_export_bytes_equal_the_jax_exporters(kind, tmp_path):
    tree = TW.to_flax_params(port_net(kind).state_dict())
    TEXP.export_model(tree, C.net_config(TC, kind), str(tmp_path / "t.bin"))
    JEXP.export_model(C.flax_tree(NETS, f"w_{kind}"),
                      C.net_config(JC, kind), str(tmp_path / "j.bin"))
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()


@pytest.mark.parametrize("kind,match", [
    ("qknorm_gqa", "QK-norm attention is not exportable"),
    ("nbttf_rope", "unsupported block kind")])
def test_exporters_refuse_alike(kind, match, tmp_path):
    tree = C.flax_tree(NETS, f"w_{kind}")
    msgs = []
    for mod, cfg_mod in ((TEXP, TC), (JEXP, JC)):
        with pytest.raises(ValueError, match=match) as e:
            mod.export_model(tree, C.net_config(cfg_mod, kind),
                             str(tmp_path / "x.bin"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _desc_tf_file(case: str, tmp_path) -> str:
    if case in DESC_TF_META["exported"]:
        kind = DESC_TF_META["exported"][case]
        path = str(tmp_path / f"{case}.bin")
        TEXP.export_model(TW.to_flax_params(port_net(kind).state_dict()),
                          C.net_config(TC, kind), path)
        return path
    path = str(tmp_path / f"{case}.txt.gz")
    C.write_tiny_transformer_model(path, seed=7,
                                   spatial_rms=case.endswith("_spatial"))
    return path


@pytest.mark.parametrize("case", DESC_TF_META["cases"])
def test_descnet_on_transformer_and_metadata_files_matches_jax(case, tmp_path):
    desc = TD.load_model(_desc_tf_file(case, tmp_path))
    assert desc.sha256 == str(DESC_TF[f"{case}/sha256"])
    assert desc.version == (15 if case == "metadata" else 17)
    t = desc.trunk
    assert (t["meta_encoder"] is not None) == (case == "metadata")
    assert (t["final_rms"] is not None) == case.startswith("learnable")
    sp, gl, mask, meta = inputs()
    with torch.no_grad():
        out = TD.DescNet(desc)(sp, gl, mask, metadata=meta)
    want = {k.split("/", 1)[1]: v for k, v in DESC_TF.items()
            if k.startswith(f"{case}/") and not k.endswith("/sha256")}
    assert_outputs_close(out, want, case)
