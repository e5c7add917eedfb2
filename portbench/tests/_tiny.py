"""A tiny nested-bottleneck configuration and a scratch copy of the
benchmark for the CPU tests: the copy gets the tiny configuration, a
selfplay and a train cell on it, and a per-layer metric of its own, all
as new files found by name, and its BENCHMARK.json names them."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import shutil
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
CFG = dict(name="tinynbt", preset="tinynbt", dtype="bfloat16", board_size=9,
           version=15, trunk=16, mid=8, gpool=4,
           blocks=[["bottlenest2", 1], ["bottlenest2gpool", 1]], p1=6, g1=6,
           v1=6, v2=8, sbv2=8, num_scorebeliefs=2, reduced=[])

NEW_METRIC = '''"""Train steps in the traced window (added by a test)."""


def read(r):
    return float(r.counts["steps"])
'''


def register_preset():
    """The tiny configuration as a preset of the program."""
    from katago_torch.models import config as MC
    MC.CONFIGS["tinynbt"] = MC.ModelConfig(
        name="tinynbt", trunk_num_channels=16, mid_num_channels=8,
        gpool_num_channels=4, block_kind=("bottlenest2", "bottlenest2gpool"),
        p1_num_channels=6, g1_num_channels=6, v1_num_channels=6, v2_size=8,
        sbv2_num_channels=8, num_scorebeliefs=2)
    return MC.CONFIGS["tinynbt"]


def fake_card(monkeypatch):
    """Let the harness run on the CPU: the card's queries answer as if
    one were there, and the kernels' build is skipped (the port runs
    their plain versions on CPU tensors)."""
    from katago_torch.ops import _build
    for name, fn in (("is_available", lambda: True),
                     ("device_count", lambda: 1),
                     ("synchronize", lambda *a, **k: None),
                     ("max_memory_allocated", lambda *a, **k: 0),
                     ("get_device_name", lambda *a, **k: "cpu"),
                     ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, fn)
    monkeypatch.setattr(_build, "build_all", lambda *a, **k: None)
    register_preset()


def scratch_copy(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and portbench/ with the tiny cells added as
    new files; returns the copy's root."""
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    pb = tmp / "portbench"
    (pb / "configs" / "tinynbt.json").write_text(json.dumps(CFG))
    sp = json.loads((pb / "workloads" / "selfplay.b18c384nbt.json")
                    .read_text())
    sp.update(name="selfplay.tinynbt", config="tinynbt", games=3, visits=20,
              chunk=4, max_opening_plies=20, trace_from=8, trace_steps=4)
    (pb / "workloads" / "selfplay.tinynbt.json").write_text(json.dumps(sp))
    tr = json.loads((pb / "workloads" / "train.b28c512nbt.json").read_text())
    tr.update(name="train.tinynbt", config="tinynbt", batch=8, rows=64,
              shards=4, trace_steps=3)
    (pb / "workloads" / "train.tinynbt.json").write_text(json.dumps(tr))
    (pb / "metrics" / "steps.train.py").write_text(NEW_METRIC)
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                w.split(".")[0] + ".tinynbt" for w in m["workloads"]]
    bench["per_layer"].append(
        {"name": "steps.train", "unit": "1", "better": "higher",
         "source": "program_counter", "layer": "trainer",
         "moves": "train_rows_per_s", "workloads": ["train.tinynbt"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def load_run(root: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_run_copy", root / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_traffic(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_traffic_{name}", ROOT / "portbench" / "traffic"
        / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Ctx:
    """A Context on the CPU for driving a traffic module directly."""

    def __init__(self, workload, cfg, seed, seconds, tmp: Path,
                 trace_on=False):
        self.workload, self.cfg, self.seed = workload, cfg, seed
        self.seconds, self.trace_on = seconds, trace_on
        self.device = torch.device("cpu")
        self.tmpdir = tmp
        self.window_start = self.window_end = self.trace = None
        self.counters = {}

    def past_deadline(self, now):
        return now - self.window_start >= self.seconds

    @contextlib.contextmanager
    def measure(self):
        self.window_start = time.time()
        yield self
        self.window_end = time.time()


def workload(kind: str) -> dict:
    name = {"selfplay": "selfplay.b18c384nbt",
            "train": "train.b28c512nbt"}[kind]
    wl = json.loads((ROOT / "portbench" / "workloads" / f"{name}.json")
                    .read_text())
    if kind == "selfplay":
        wl.update(games=3, visits=20, chunk=4, max_opening_plies=20)
    else:
        wl.update(batch=8, rows=64, shards=4)
    return wl
