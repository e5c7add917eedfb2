"""On the card: each cell's program passes its limits on a fresh seed,
and its control (the reference one precision lower) and, for the
trainer, its faults (half the batch, the EMA at a wrong decay or left
unchanged) fail at least one of them. Skips without a card."""

import json
import subprocess
import sys

import pytest

from _tiny import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell,faults", [
    ("selfplay.b18c384nbt", ("fp8",)),
    ("train.b28c512nbt", ("tf32", "half_batch", "ema_decay_099",
                          "ema_unchanged"))])
def test_control_fails_where_the_program_passes(cell, faults):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "portbench/control.py", "--workload", cell,
         "--seeds", str(2 ** 31 + 101), "--seconds", "5"], cwd=ROOT,
        capture_output=True, text=True, timeout=900, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    limits = json.loads((ROOT / "portbench" / "workloads" / f"{cell}.json")
                        .read_text())["limits"]
    for name, lim in limits.items():
        assert line["program"][name] <= lim, (name, line["program"])
    for fault in faults:
        assert any(line[fault][n] > lim for n, lim in limits.items()
                   if n in line[fault]), (fault, line[fault])
