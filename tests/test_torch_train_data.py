"""The trainer's data path and exports in the port against the JAX
package, on the CPU: npz decoding and the dihedral symmetries bit for
bit, the resumable file server and the batch server serving identical
files and rows for a seed (both run live: they are numpy and Python
only), and the .bin.gz export byte for byte after decompression."""

from __future__ import annotations

import dataclasses
import gzip
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest

from katago_tpu.cli import train_cmd as JCMD
from katago_tpu.dataio import native as JNV
from katago_tpu.dataio import trainingwrite as JTW
from katago_tpu.models import config as JC
from katago_tpu.models import export as JEXP
from katago_tpu.models.model import KataGoModel as JModel
from katago_tpu.train.datagen import DataFileServer as JServer
from katago_torch.cli import train_cmd as TCMD
from katago_torch.dataio import native as TNV
from katago_torch.dataio import trainingwrite as TTW
from katago_torch.models import config as TC
from katago_torch.models import weights as TWT
from katago_torch.train import checkpoint as TCK
from katago_torch.train.datagen import DataFileServer as TServer

from tests import test_torch_common as C


def _assert_rows_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("size", [5, 9])
def test_decode_rows_and_read_npz_equal_jax(tmp_path, size):
    rows = C.random_rows(size, 11, size)
    _assert_rows_equal(JTW.decode_rows(rows, size),
                       TTW.decode_rows(rows, size))
    path = str(tmp_path / "rows.npz")
    np.savez_compressed(path, metadataInputNC=np.zeros((11, 3)), **rows)
    _assert_rows_equal(JTW.read_npz(path, size), TTW.read_npz(path, size))


@pytest.mark.parametrize("sym", range(8))
def test_symmetries_equal_jax(sym):
    rng = np.random.default_rng(sym)
    size = 5
    planes = rng.standard_normal((3, 4, size, size)).astype(np.float32)
    policy = rng.standard_normal((6, size * size + 1)).astype(np.float32)
    packed = rng.integers(0, 256, (3, 22, 4), dtype=np.uint8)
    np.testing.assert_array_equal(JNV.apply_symmetry_planes(planes, sym),
                                  TNV.apply_symmetry_planes(planes, sym))
    np.testing.assert_array_equal(
        JNV.apply_symmetry_policy(policy, size, sym),
        TNV.apply_symmetry_policy(policy, size, sym))
    np.testing.assert_array_equal(JNV.unpack_bits_nchw(packed, 25),
                                  TNV.unpack_bits_nchw(packed, 25))
    hb = JTW.decode_rows(C.random_rows(size, 4, 30 + sym), size)
    _assert_rows_equal(JCMD._apply_symmetry(hb, size, sym),
                       TCMD._apply_symmetry(hb, size, sym))


@pytest.mark.parametrize("no_repeat", [False, True])
def test_data_file_server_serves_the_jax_order(tmp_path, no_repeat):
    data = tmp_path / "data"
    C.write_shards(data, 5, [3] * 7, 2)
    servers = [cls({}, no_repeat_files=no_repeat, rng=random.Random(11))
               for cls in (JServer, TServer)]
    new = C.write_shards(tmp_path / "more", 5, [3], 9)[0]
    got = [[], []]
    for i, srv in enumerate(servers):
        assert srv.set_data_dir_if_has_remaining_files(str(data))
        for n in range(30):
            if n == 12:
                # a new shard arrives mid-epoch
                os.link(new, data / "shard_new.npz")
                assert srv.set_data_dir_if_has_remaining_files(str(data))
            got[i].append((srv.peek(), srv.pop(),
                           srv.has_any_remaining_data()))
        os.remove(data / "shard_new.npz")
    assert got[0] == got[1]
    assert servers[0].train_state == servers[1].train_state
    served = [p for _, p, _ in got[0] if p]
    assert len(set(served)) == 8
    if no_repeat:
        assert len(served) == 8 and got[0][-1] == (None, None, False)


def test_batch_server_serves_the_jax_rows(tmp_path):
    """Batches across file boundaries and epochs, each with its random
    symmetry, from the same seeds (the run_training loop's draws)."""
    data = tmp_path / "data"
    C.write_shards(data, 5, [9, 20, 6, 13], 4)
    batches = []
    for server, cmd in ((JServer, JCMD), (TServer, TCMD)):
        gen = server({}, no_repeat_files=False, rng=random.Random(5))
        assert gen.set_data_dir_if_has_remaining_files(str(data))
        rng = np.random.default_rng(0)
        bs = cmd._BatchServer(gen, 5, 16, rng)
        out = []
        for _ in range(9):
            hb = bs.next_batch()
            out.append(cmd._apply_symmetry(hb, 5, int(rng.integers(0, 8))))
        batches.append(out)
    for a, b in zip(*batches):
        _assert_rows_equal(a, b)
        assert a["binaryInputNCHW"].shape[0] == 16


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _nbt_config(pkg):
    return pkg.ModelConfig(
        name="t_nbt", trunk_num_channels=8, mid_num_channels=4,
        gpool_num_channels=2, block_kind=("bottlenest2", "bottlenest2gpool"),
        p1_num_channels=4, g1_num_channels=4, v1_num_channels=4, v2_size=8,
        sbv2_num_channels=8, num_scorebeliefs=2)


@pytest.mark.parametrize("which", ["b1c6", "b2c16", "nbt", "b1c6_v16"])
def test_export_bin_gz_bytes_equal_jax_export(tmp_path, which):
    if which == "nbt":
        jcfg, tcfg = _nbt_config(JC), _nbt_config(TC)
    else:
        base = which.split("_")[0]
        jcfg, tcfg = JC.get_config(base), TC.get_config(base)
        if which.endswith("v16"):
            jcfg = dataclasses.replace(jcfg, version=16)
            tcfg = dataclasses.replace(tcfg, version=16)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    flax = C.flax_params(JModel(jcfg, pos_len=5, dtype=jnp.float32), 5, 6)
    want = JEXP.export_model(flax, jcfg, str(tmp_path / "jax.bin.gz"),
                             name="net")
    state_dict = TWT.from_flax_params(_numpy_tree(flax["params"]))
    got = TCK.export_bin_gz(str(tmp_path / "port"), "net", state_dict, tcfg)
    assert got == str(tmp_path / "port" / "net.bin.gz")
    with gzip.open(want, "rb") as f:
        want_bytes = f.read()
    with gzip.open(got, "rb") as f:
        got_bytes = f.read()
    assert got_bytes == want_bytes
    assert len(got_bytes) > 1000


def test_to_flax_params_inverts_from_flax_params():
    flax = _numpy_tree(C.flax_params(
        JModel(JC.get_config("b2c16"), pos_len=5, dtype=jnp.float32), 5,
        8)["params"])
    back = TWT.to_flax_params(TWT.from_flax_params(flax))

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])
    same(flax, back)
