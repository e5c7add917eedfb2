"""Boundaries of the PyTorch port: katago_torch imports no JAX, no Flax,
no optax or orbax and nothing of katago_tpu; neither it nor chip_smoke.py
imports the JAX-side checkpoint converter (tools/jax_checkpoint_to_npz.py);
its entry points refuse to fall back to the CPU;
kernel wrappers take the plain version only for CPU tensors; built kernel
libraries are never tracked. It also checks the test harness's settings: one
CPU thread per test worker for torch, and the virtual 8-device CPU mesh of
conftest.py. That check lives here because `--dist loadfile` hands out the
files with the most tests first, so a run cut by its time limit still has it."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "katago_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "katago_tpu")


def _modules():
    return sorted(p for p in PKG.rglob("*.py") if "_build" not in p.parts)


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _modules(), ids=lambda p: str(
    p.relative_to(ROOT)))
def test_module_imports_no_jax_flax_or_katago_tpu(path):
    bad = [n for n in _imported_names(path)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _modules() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_the_jax_checkpoint_converter(path):
    names = list(_imported_names(path))
    assert not [n for n in names if n.split(".")[0] == "tools"
                or "jax_checkpoint_to_npz" in n], names


def test_every_module_imports_with_jax_blocked():
    names = [".".join(p.relative_to(ROOT).with_suffix("").parts)
             for p in _modules()]
    names = [n[:-len(".__init__")] if n.endswith(".__init__") else n
             for n in names]
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in {FORBIDDEN!r}:
            raise ImportError('blocked: ' + name)
        return None
sys.meta_path.insert(0, Block())
for n in {names!r}:
    importlib.import_module(n)
assert not any(m.split('.')[0] in {FORBIDDEN!r} for m in sys.modules)
print('ok', len({names!r}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_raise_without_cuda_and_device(monkeypatch):
    from katago_torch.device import resolve_device
    from katago_torch.game import history as TH
    from katago_torch.game import rules as TR
    from katago_torch.models import config as TC
    from katago_torch.models import model as TM
    from katago_torch.search.driver import SearchDriver
    from katago_torch.search.params import SearchParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        TH.new_game(9, TR.Rules.tromp_taylorish(), 8)
    with pytest.raises(RuntimeError):
        SearchParams().to_arr()
    model = TM.KataGoModel(TC.get_config("b1c6"), 9, torch.float32)
    with pytest.raises(RuntimeError):
        SearchDriver(model, None, size=9, max_nodes=8)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_take_plain_version_only_for_cpu_tensors():
    from katago_torch.ops import labels as K2
    vals = torch.randint(0, 3, (4, 81), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    before = K2.launches
    out = K2.connected_labels(vals, 9)
    assert K2.launches == before
    assert torch.equal(out, K2.connected_labels_plain(vals, 9))
    with pytest.raises(TypeError):
        K2.connected_labels(vals.long(), 9)
    with pytest.raises(ValueError):
        K2.connected_labels(vals, 8)
    with pytest.raises(ValueError):
        K2.connected_labels(vals.to("meta"), 9)


def test_kernel_build_directory_is_ignored_and_untracked():
    ignore = (ROOT / ".gitignore").read_text().splitlines()
    assert "katago_torch/_build/" in ignore
    out = subprocess.run(["git", "ls-files", "katago_torch"], cwd=ROOT,
                         capture_output=True, text=True)
    if out.returncode == 0:
        tracked = out.stdout.splitlines()
        assert not [f for f in tracked if "/_build/" in f
                    or f.endswith((".so", ".o"))], tracked


def test_one_cpu_thread_per_worker_and_eight_devices():
    import jax

    from tests import test_torch_common  # noqa: F401  (sets the threads)

    assert os.environ["OMP_NUM_THREADS"] == "1"
    assert torch.get_num_threads() == 1
    assert len(jax.devices()) == 8
