"""The port's contribute client (katago_torch/distributed/client.py,
cli/contribute_cmd.py) against a stub server on 127.0.0.1, as
tests/test_contribute.py tests the JAX package's: the connection and the
task, the sha256-verified model download, and one full task (download,
load, selfplay cut to a few moves, npz + SGF, upload). The server serves
the fixture net b1c6_s3.bin.gz (written by the JAX exporter); the
uploaded npz must have the pinned schema (tests/data/torch_ref/
npz_schema.json). No network beyond the local stub.

Two faults of the JAX command are not copied and are pinned here: the
task's seed does not depend on Python's salted hash, and the uploaded
SGF holds the first game's moves.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

from katago_torch.cli import contribute_cmd as TCC
from katago_torch.dataio import sgf as TS
from katago_torch.distributed.client import ClientError, Connection, ModelInfo

from tests import test_torch_common as C

MODEL_BYTES = (C.REF_DIR / "b1c6_s3.bin.gz").read_bytes()
SCHEMA = json.loads((C.REF_DIR / "npz_schema.json").read_text())["per_row"]


class StubHandler(BaseHTTPRequestHandler):
    uploads: list = []

    def log_message(self, *a):
        pass

    def _send(self, code, body, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.end_headers()
        self.wfile.write(body if isinstance(body, bytes)
                         else json.dumps(body).encode())

    def do_GET(self):
        if self.path == "/api/users/me/":
            self._send(200, {"username": "tester"})
        elif self.path == "/models/stub.bin.gz":
            self._send(200, MODEL_BYTES, "application/octet-stream")
        else:
            self._send(404, {})

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        body = json.loads(self.rfile.read(n)) if n else {}
        if self.path == "/api/tasks/":
            self._send(200, {
                "id": "t1", "kind": "selfplay", "run": {"name": "testrun"},
                "network": {
                    "name": "stub",
                    "model_file": "/models/stub.bin.gz",
                    "model_file_sha256":
                        hashlib.sha256(MODEL_BYTES).hexdigest(),
                },
            })
        elif self.path == "/api/games/training/":
            StubHandler.uploads.append(body)
            self._send(200, {"ok": True})
        else:
            self._send(404, {})


@pytest.fixture(scope="module")
def server():
    srv = HTTPServer(("127.0.0.1", 0), StubHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()
    srv.server_close()


def test_connection_and_task(server):
    conn = Connection(server, "u", "p", max_tries=2)
    me = conn.test_connection()
    assert me["username"] == "tester"
    task = conn.get_next_task()
    assert task.task_id == "t1" and not task.is_rating_task
    assert task.model_black.name == "stub"
    assert task.run_name == "testrun"


def test_model_download_sha_verified(server, tmp_path):
    conn = Connection(server, "u", "p", max_tries=2)
    task = conn.get_next_task()
    path = conn.download_model_if_not_present(task.model_black,
                                              str(tmp_path))
    assert path.endswith("stub.bin.gz")
    assert conn.is_model_present(task.model_black, str(tmp_path))
    with open(path, "rb") as f:
        assert f.read() == MODEL_BYTES
    # corrupted hash raises and leaves no file
    bad = ModelInfo(name="bad", url="/models/stub.bin.gz",
                    sha256="0" * 64)
    with pytest.raises(ClientError, match="sha256 mismatch"):
        conn.download_model_if_not_present(bad, str(tmp_path))
    assert not (tmp_path / "bad.bin.gz").exists()


def test_request_retries_then_raises(monkeypatch):
    import katago_torch.distributed.client as TCL
    monkeypatch.setattr(TCL.time, "sleep", lambda s: None)
    logs = []
    conn = Connection("http://127.0.0.1:9", "u", "p", max_tries=3,
                      log=logs.append)
    with pytest.raises(ClientError, match="after 3 tries"):
        conn.test_connection()
    assert len(logs) == 3 and all("retrying" in m for m in logs)


def test_full_contribute_task(server, tmp_path):
    conn = Connection(server, "u", "p", max_tries=2)
    task = conn.get_next_task()
    resp = TCC.run_one_task(conn, task, str(tmp_path), size=5, visits=8,
                            games=2, max_moves=6, device="cpu",
                            log=lambda *_: None)
    assert resp["ok"]
    up = StubHandler.uploads[-1]
    assert up["task_id"] == "t1" and up["run"] == "testrun"
    with np.load(io.BytesIO(base64.b64decode(up["npz_b64"]))) as z:
        arrays = {k: z[k] for k in z.files}
    want = SCHEMA["5"]
    assert sorted(arrays) == sorted(want)
    for k, (dtype, shape) in want.items():
        assert str(arrays[k].dtype) == dtype, k
        assert list(arrays[k].shape[1:]) == shape, k
    assert up["num_rows"] == arrays["globalTargetsNC"].shape[0] > 0
    # the representative SGF holds the first game's recorded moves
    game = TS.parse_sgf(up["sgf"])[0]
    assert game.size == (5, 5) and len(game.moves()) == 6


def test_task_seed_does_not_depend_on_the_hash_seed():
    code = ("import sys; sys.path.insert(0, '.');"
            "from katago_torch.cli.contribute_cmd import task_seed;"
            "print(task_seed('t1'))")
    seeds = {subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={"PYTHONHASHSEED": s, "PATH": ""}, check=True,
        cwd=str(C.REF_DIR.parents[2])).stdout.strip() for s in ("1", "2")}
    assert seeds == {str(TCC.task_seed("t1"))}


def test_contribute_main_raises_without_cuda(monkeypatch, server, tmp_path):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        TCC.main(["-server", server, "-username", "u", "-password", "p",
                  "-base-dir", str(tmp_path), "-max-tasks", "1"])
