"""Multi-sink timestamped logger — equivalent of cpp/core/logger.{h,cpp};
the port's own copy of katago_tpu/utils/logger.py.

The reference Logger fans each line out to any number of sinks (stdout,
stderr, log files, arbitrary streams), prefixes wall-clock timestamps, and
is configured from the same config keys GTP/selfplay use (logFile, logDir,
logToStdout, logToStderr, logTimeStamp — cpp/core/logger.cpp + the
command setups). This one is thread-safe the same way (one lock around
the fan-out) and exposes a `write` callable so engine components can take
`log=` parameters without caring what backs them.
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
from typing import IO


class Logger:
    def __init__(self, *, log_to_stdout: bool = False,
                 log_to_stderr: bool = False, log_time: bool = True,
                 header: str | None = None):
        self.log_to_stdout = log_to_stdout
        self.log_to_stderr = log_to_stderr
        self.log_time = log_time
        self._streams: list[IO[str]] = []
        self._owned_files: list[IO[str]] = []
        self._lock = threading.Lock()
        self._disabled = False
        if header:
            self.write(header)

    @staticmethod
    def from_config(cfg: dict, *, default_stdout: bool = False,
                    default_stderr: bool = False) -> "Logger":
        """Build from reference config keys (logFile/logDir/logToStdout/
        logToStderr/logTimeStamp), e.g. a parsed gtp_example.cfg."""
        def get_bool(key, default):
            v = cfg.get(key)
            return default if v is None else str(v).lower() == "true"

        lg = Logger(
            log_to_stdout=get_bool("logToStdout", default_stdout),
            log_to_stderr=get_bool("logToStderr", default_stderr),
            log_time=get_bool("logTimeStamp", True))
        log_file = cfg.get("logFile")
        if log_file:
            lg.add_file(str(log_file))
        log_dir = cfg.get("logDir")
        if log_dir:
            stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
            lg.add_file(os.path.join(str(log_dir), f"log{stamp}.log"))
        return lg

    def add_stream(self, stream: IO[str]) -> None:
        with self._lock:
            self._streams.append(stream)

    def add_file(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        f = open(path, "a")
        with self._lock:
            self._owned_files.append(f)
            self._streams.append(f)

    def set_disabled(self, disabled: bool) -> None:
        self._disabled = disabled

    def _prefix(self) -> str:
        if not self.log_time:
            return ""
        now = datetime.datetime.now(datetime.timezone.utc)
        return now.strftime("%Y-%m-%d %H:%M:%S%z: ")

    def write(self, msg: str) -> None:
        if self._disabled:
            return
        line = self._prefix() + str(msg).rstrip("\n") + "\n"
        with self._lock:
            for s in self._streams:
                s.write(line)
                s.flush()
            if self.log_to_stdout:
                sys.stdout.write(line)
                sys.stdout.flush()
            if self.log_to_stderr:
                sys.stderr.write(line)
                sys.stderr.flush()

    # log=Logger(...) call-compatibility with the `log=print` convention
    __call__ = write

    def close(self) -> None:
        with self._lock:
            for f in self._owned_files:
                try:
                    f.close()
                except OSError:
                    pass
            self._owned_files.clear()
            self._streams.clear()
