"""The port's reference-format model reader and DescNet against the JAX
package: the parser field for field against katago_tpu.models.desc
(pure Python, run live) on the tiny models of every version 3..17 and on
a b1c6 file written by the JAX exporter; DescNet's outputs against the
saved JAX apply_desc_model outputs within 1e-5 (relative to each
output's largest value) for every key and version
(tests/data/torch_ref/desc.npz)."""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from katago_tpu.models import desc as JD
from katago_torch.models import desc as TD
from katago_torch.models import modelversion as TMV
from katago_tpu.models import modelversion as JMV

from tests import test_torch_common as C

REF, META = C.load_ref("desc")
BIN = C.REF_DIR / META["bin"]


def assert_same_desc(a, b, path="desc"):
    """Parsed descs equal: dataclasses, dicts, lists and numpy arrays."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same_desc(getattr(a, f.name), getattr(b, f.name),
                             f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            assert_same_desc(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_desc(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
        assert a.dtype == b.dtype, path
    else:
        assert a == b, path


def check_outputs(out, prefix, version):
    keys = {k[len(prefix):] for k in REF if k.startswith(prefix)} - \
        {"sha256"}
    assert set(out) - {"supports_shortterm_error"} == keys
    assert ("supports_shortterm_error" in out) == (version < 9)
    if version < 9:
        assert out["supports_shortterm_error"] is False
    for k in keys:
        want = REF[prefix + k]
        got = out[k].numpy()
        assert got.shape == want.shape, k
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{prefix}{k}")


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("desc")
    for v in META["versions"]:
        C.write_tiny_model(d / f"v{v}.txt.gz", v, seed=v)
    return d


@pytest.mark.parametrize("version", range(3, 18))
def test_parser_and_descnet_match_jax(version, tiny_dir):
    path = str(tiny_dir / f"v{version}.txt.gz")
    j, t = JD.load_model(path), TD.load_model(path)
    assert_same_desc(j, t)
    assert t.sha256 == str(REF[f"v{version}/sha256"])
    assert t.input_version == j.input_version == \
        TMV.get_inputs_version(version) == JMV.get_inputs_version(version)
    sp, gl, mask = C.desc_inputs(version, META["size"], META["batch"],
                                 seed=version)
    with torch.no_grad():
        out = TD.DescNet(t)(torch.from_numpy(sp), torch.from_numpy(gl),
                            torch.from_numpy(mask))
    check_outputs(out, f"v{version}/", version)


def test_jax_exported_b1c6_parses_and_runs_equal():
    j, t = JD.load_model(str(BIN)), TD.load_model(str(BIN))
    assert_same_desc(j, t)
    assert t.sha256 == str(REF["bin/sha256"])
    sp, gl, _ = C.desc_inputs(15, 9, META["batch"], seed=100)
    net = TD.load_net(str(BIN), "cpu")
    with torch.no_grad():
        check_outputs(net(torch.from_numpy(sp), torch.from_numpy(gl)),
                      "bin/", t.version)


def test_descnet_equals_katago_model_on_the_exported_weights():
    """The .bin.gz of weights_b1c6_s3 through DescNet and the same Flax
    weights through the port's KataGoModel: the heads both have agree."""
    size = 5
    model = C.ref_model(size)
    net = TD.load_net(str(BIN), "cpu")
    rng = np.random.default_rng(7)
    sp = torch.from_numpy((rng.random((4, size, size, 22)) < 0.3).astype(
        np.float32))
    gl = torch.from_numpy(rng.standard_normal((4, 19)).astype(np.float32))
    with torch.no_grad():
        a, b = model(sp, gl), net(sp, gl)
    # the export keeps the play and short-term optimistic channels (0, 5)
    assert b["policy_logits"].shape[1] == 2
    a["policy_logits"] = a["policy_logits"][:, [0, 5]]
    for k in ("policy_logits", "value_logits", "ownership_pretanh"):
        np.testing.assert_allclose(b[k].numpy(), a[k].float().numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(b["miscvalue"][:, :4].numpy(),
                               a["miscvalue"][:, :4].numpy(), atol=1e-5)
    np.testing.assert_allclose(b["moremiscvalue"][:, :2].numpy(),
                               a["moremiscvalue"][:, :2].numpy(), atol=1e-5)


def test_unported_blocks_raise_and_bad_files_fail_alike(tiny_dir, tmp_path):
    """Transformer blocks, the trunk-tip RMSNorm and the metadata encoder
    build (tests/test_torch_nets.py holds them against JAX); a block
    kind the format lacks and a truncated file fail alike in both
    parsers."""
    C.write_tiny_transformer_model(tmp_path / "tf.txt.gz", seed=1)
    net = TD.DescNet(TD.load_model(str(tmp_path / "tf.txt.gz")))
    assert [b["kind"] for b in net.blocks] == ["attention", "ffn"] * 2
    assert net.final_rms is not None and net.final_bn is None
    unknown = tmp_path / "unknown.txt"
    text = gzip.decompress((tiny_dir / "v15.txt.gz").read_bytes()).decode()
    unknown.write_text(text.replace("ordinary_block", "dilated_block", 1))
    for mod in (JD, TD):
        with pytest.raises(mod.ModelParseError, match="unsupported block"):
            mod.load_model(str(unknown))
    bad = tmp_path / "bad.txt"
    bad.write_text("net 2 22 19 trunk")
    for mod in (JD, TD):
        with pytest.raises(mod.ModelParseError, match="unsupported"):
            mod.load_model(str(bad))
