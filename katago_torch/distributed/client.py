"""Distributed volunteer-training client — cpp/distributed/client.{h,cpp};
the port's own copy of katago_tpu/distributed/client.py.

Speaks the katagotraining.org-style HTTPS JSON protocol: task fetch
(getNextTask, client.h:98), sha256-verified model download
(downloadModelIfNotPresent, client.h:119), and training/rating game
upload (client.h:135+). stdlib urllib only (no extra deps); retries with
jittered backoff mirror contribute.cpp:1089-1111.

The engine side that plays the tasks lives in cli/contribute_cmd.py.
Files are read and written through `with` blocks.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import json
import os
import random
import time
import urllib.error
import urllib.request


@dataclasses.dataclass
class ModelInfo:
    name: str
    url: str
    sha256: str
    size_bytes: int = 0


@dataclasses.dataclass
class Task:
    task_id: str
    task_group: str
    run_name: str
    is_rating_task: bool
    config: str
    model_black: ModelInfo
    model_white: ModelInfo


class ClientError(RuntimeError):
    pass


class Connection:
    def __init__(self, server_url: str, username: str, password: str, *,
                 max_tries: int = 8, log=print, opener=None):
        self.base = server_url.rstrip("/")
        self.username = username
        self.password = password
        self.max_tries = max_tries
        self.log = log
        self._opener = opener or urllib.request.build_opener()
        auth = base64.b64encode(
            f"{username}:{password}".encode()).decode("ascii")
        self._auth_header = f"Basic {auth}"

    # ---- low-level ----
    def _request(self, path: str, data: bytes | None = None,
                 content_type: str = "application/json") -> bytes:
        last = None
        for attempt in range(self.max_tries):
            try:
                req = urllib.request.Request(self.base + path, data=data)
                req.add_header("Authorization", self._auth_header)
                if data is not None:
                    req.add_header("Content-Type", content_type)
                with self._opener.open(req, timeout=60) as resp:
                    return resp.read()
            except (urllib.error.URLError, OSError) as e:  # jittered retry
                last = e
                sleep = min(2.0 ** attempt, 60.0) * (0.5 + random.random())
                self.log(f"contribute: request {path} failed "
                         f"({e}); retrying in {sleep:.1f}s")
                time.sleep(sleep)
        raise ClientError(f"request {path} failed after "
                          f"{self.max_tries} tries: {last}")

    def _json(self, path: str, payload: dict | None = None) -> dict:
        data = json.dumps(payload).encode() if payload is not None else None
        return json.loads(self._request(path, data))

    # ---- protocol (client.h:93-140) ----
    def test_connection(self) -> dict:
        return self._json("/api/users/me/")

    def get_run_parameters(self) -> dict:
        return self._json("/api/runs/current-for-client/")

    def get_next_task(self, allow_selfplay=True, allow_rating=True) -> Task:
        resp = self._json("/api/tasks/", {
            "allowSelfplayTask": allow_selfplay,
            "allowRatingTask": allow_rating,
        })
        return self.parse_task(resp)

    @staticmethod
    def parse_task(resp: dict) -> Task:
        def model(d):
            return ModelInfo(name=d["name"], url=d.get("model_file", ""),
                             sha256=d.get("model_file_sha256", ""),
                             size_bytes=d.get("model_file_bytes", 0))

        kind = resp.get("kind", "selfplay")
        return Task(
            task_id=resp.get("id", ""),
            task_group=resp.get("task_group", ""),
            run_name=resp.get("run", {}).get("name", ""),
            is_rating_task=(kind == "rating"),
            config=resp.get("config", ""),
            model_black=model(resp.get("black_network",
                                       resp.get("network", {}))),
            model_white=model(resp.get("white_network",
                                       resp.get("network", {}))),
        )

    @staticmethod
    def model_path(info: ModelInfo, model_dir: str) -> str:
        return os.path.join(model_dir, info.name + ".bin.gz")

    def is_model_present(self, info: ModelInfo, model_dir: str) -> bool:
        path = self.model_path(info, model_dir)
        if not os.path.exists(path):
            return False
        if info.sha256:
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            return digest == info.sha256
        return True

    def download_model_if_not_present(self, info: ModelInfo,
                                      model_dir: str) -> str:
        path = self.model_path(info, model_dir)
        if self.is_model_present(info, model_dir):
            return path
        os.makedirs(model_dir, exist_ok=True)
        self.log(f"contribute: downloading {info.name}")
        if info.url.startswith("http"):
            req = urllib.request.Request(info.url)
            req.add_header("Authorization", self._auth_header)
            with self._opener.open(req, timeout=300) as resp:
                data = resp.read()
        else:
            data = self._request(info.url)
        if info.sha256:
            digest = hashlib.sha256(data).hexdigest()
            if digest != info.sha256:
                raise ClientError(
                    f"model {info.name} sha256 mismatch: got {digest}, "
                    f"want {info.sha256}")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def upload_training_game_and_data(self, task: Task, sgf_path: str,
                                      npz_path: str, num_rows: int) -> dict:
        npz = _read(npz_path, "rb")
        payload = {
            "task_id": task.task_id,
            "run": task.run_name,
            "num_rows": num_rows,
            "sgf": _read(sgf_path, "r") or "",
            "npz_b64": base64.b64encode(npz).decode("ascii")
            if npz is not None else "",
        }
        return self._json("/api/games/training/", payload)

    def upload_rating_game(self, task: Task, sgf_path: str,
                           winner: str) -> dict:
        return self._json("/api/games/rating/", {
            "task_id": task.task_id, "run": task.run_name,
            "winner": winner,
            "sgf": _read(sgf_path, "r") or "",
        })


def _read(path: str, mode: str):
    """The file's contents, or None when it does not exist."""
    if not os.path.exists(path):
        return None
    with open(path, mode) as f:
        return f.read()
