"""The harness on the CPU: a scratch copy with a new configuration, two
new cells and a new per-layer metric, all files found by name with no
code edited, runs each cell through run.main and prints a last line of
the contract's schema; and nothing the harness loads is JAX or the JAX
package, nor does the reference load the program."""

import json
import subprocess
import sys

import pytest

from _tiny import ROOT, fake_card, load_run, scratch_copy

SCHEMA = {"correct", "attempted", "failed", "metrics", "device"}


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("cell,trace", [("selfplay.tinynbt", 0),
                                        ("selfplay.tinynbt", 1),
                                        ("train.tinynbt", 0),
                                        ("train.tinynbt", 1)])
def test_new_files_run_by_name(cell, trace, tmp_path, monkeypatch, capsys):
    fake_card(monkeypatch)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = scratch_copy(tmp_path / "copy")
    run = load_run(root)
    assert run.main(["--workload", cell, "--seed", str(2 ** 31 + 3),
                     "--seconds", "1", "--trace", str(trace)],
                    device="cpu") == 0
    out, err = capsys.readouterr()
    line = last_json(out)
    assert SCHEMA <= set(line)
    assert list(line)[-1] == "compared"
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    bench = json.loads((root / "BENCHMARK.json").read_text())
    e2e, layer = run.cell_metrics(bench, cell)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in layer}
        assert set(line["metrics"]) <= names
        if cell.startswith("train"):
            assert line["metrics"]["steps.train"]["value"] >= 1
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
        assert "setup_s" in line["metrics"]
    compared = err.strip().splitlines()[-len(line["compared"]):]
    assert all(c.startswith("compared ") for c in compared)


def test_missing_file_fails_without_a_result(tmp_path, monkeypatch, capsys):
    fake_card(monkeypatch)
    run = load_run(scratch_copy(tmp_path))
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "nosuch.cell", "--seed", "1", "--seconds",
                  "1", "--trace", "0"], device="cpu")
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_no_card_fails_without_a_result(capsys):
    run = load_run(ROOT)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "train.b28c512nbt", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def top_level(script: str) -> set:
    """Top-level module names loaded by `script` in a fresh process."""
    code = (script + "\nimport sys, json\nprint(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = top_level(
        "import sys; sys.path.insert(0, 'portbench/tests')\n"
        "import _tiny, importlib\n"
        "run = _tiny.load_run(_tiny.ROOT)\n"
        "for k in ('selfplay', 'train'): _tiny.load_traffic(k)\n"
        "import portbench.trace, portbench.roofline\n"
        "import katago_torch.search.driver, katago_torch.cli.train_cmd\n")
    assert not mods & {"jax", "jaxlib", "flax", "katago_tpu"}
    assert "katago_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = top_level("import portbench.reference.net, "
                     "portbench.reference.train, portbench.reference.go, "
                     "portbench.reference.rows, portbench.roofline")
    assert not mods & {"jax", "jaxlib", "flax", "katago_tpu", "katago_torch"}
