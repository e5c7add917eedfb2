"""key=value config system — equivalent of cpp/core/config_parser.{cpp,h}.

The port's own copy of katago_tpu/utils/config_parser.py
(katago_torch imports nothing of the JAX package, not even its modules
that do not import JAX).

Reference behavior (config_parser.h:20-69): key=value lines with '#'
comments, `@include <file>` directives, later-file override semantics,
`-override-config key=value,key=value` chains, typed range-checked getters,
and warnings for keys that were never read. Used by every reference
subcommand via Setup (cpp/program/setup.cpp); here by the CLI layer.
"""

from __future__ import annotations

import os
from typing import Iterable


class ConfigError(ValueError):
    pass


class ConfigParser:
    def __init__(self, path: str | None = None,
                 contents: str | None = None):
        self._kvs: dict[str, str] = {}
        self._used: set[str] = set()
        self._files: list[str] = []
        if path is not None:
            self._read_file(path)
        if contents is not None:
            self._parse(contents, base_dir=".", source="<string>")

    # -- parsing ----------------------------------------------------------

    def _read_file(self, path: str):
        if path in self._files:
            raise ConfigError(f"circular or duplicate @include of {path}")
        self._files.append(path)
        with open(path) as f:
            self._parse(f.read(), base_dir=os.path.dirname(path) or ".",
                        source=path)

    def _parse(self, text: str, base_dir: str, source: str):
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if line.startswith("@include"):
                inc = line[len("@include"):].strip()
                if not inc:
                    raise ConfigError(f"{source}:{lineno}: empty @include")
                self._read_file(os.path.join(base_dir, inc))
                continue
            if "=" not in line:
                raise ConfigError(f"{source}:{lineno}: expected key=value, "
                                  f"got {raw!r}")
            k, v = line.split("=", 1)
            k, v = k.strip(), v.strip()
            if not k:
                raise ConfigError(f"{source}:{lineno}: empty key")
            # later occurrences override earlier ones (include chains)
            self._kvs[k] = v

    def apply_overrides(self, overrides: str):
        """-override-config 'a=1,b=2' semantics (commandline.cpp)."""
        for part in overrides.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ConfigError(f"override {part!r} is not key=value")
            k, v = part.split("=", 1)
            self._kvs[k.strip()] = v.strip()

    # -- getters ----------------------------------------------------------

    def contains(self, key: str) -> bool:
        return key in self._kvs

    def keys(self) -> Iterable[str]:
        return self._kvs.keys()

    def _raw(self, key: str) -> str:
        if key not in self._kvs:
            raise ConfigError(f"config missing required key {key!r}")
        self._used.add(key)
        return self._kvs[key]

    def get_string(self, key: str, default: str | None = None,
                   allowed: Iterable[str] | None = None) -> str:
        if default is not None and key not in self._kvs:
            return default
        v = self._raw(key)
        if allowed is not None and v not in set(allowed):
            raise ConfigError(f"{key}={v!r} not in allowed {sorted(allowed)}")
        return v

    def get_bool(self, key: str, default: bool | None = None) -> bool:
        if default is not None and key not in self._kvs:
            return default
        v = self._raw(key).lower()
        if v in ("true", "1", "yes"):
            return True
        if v in ("false", "0", "no"):
            return False
        raise ConfigError(f"{key}={v!r} is not a bool")

    def get_int(self, key: str, default: int | None = None,
                min: int | None = None, max: int | None = None) -> int:
        if default is not None and key not in self._kvs:
            return default
        raw = self._raw(key)
        try:
            v = int(raw, 0)
        except ValueError:
            raise ConfigError(f"{key}={raw!r} is not an int") from None
        self._check_range(key, v, min, max)
        return v

    _MEM_SHIFTS = {"K": 10, "KB": 10, "M": 20, "MB": 20, "G": 30,
                   "GB": 30, "T": 40, "TB": 40, "P": 50, "PB": 50, "B": 0}

    def get_mem(self, key: str, default: int | None = None) -> int:
        """Memory amount in bytes with binary K/KB/M/MB/G/GB/T/TB/P/PB/B
        suffixes (Global::readMem, core/global.cpp:643-685)."""
        if default is not None and key not in self._kvs:
            return default
        raw = self._raw(key).strip()
        shift = 0
        num = raw
        for suf in ("KB", "MB", "GB", "TB", "PB", "K", "M", "G", "T",
                    "P", "B"):
            if raw.upper().endswith(suf):
                shift = self._MEM_SHIFTS[suf]
                num = raw[:-len(suf)]
                break
        if not num.isdigit():
            raise ConfigError(f"{key}={raw!r} is not a memory amount")
        return int(num) << shift

    def get_float(self, key: str, default: float | None = None,
                  min: float | None = None, max: float | None = None) -> float:
        if default is not None and key not in self._kvs:
            return default
        raw = self._raw(key)
        try:
            v = float(raw)
        except ValueError:
            raise ConfigError(f"{key}={raw!r} is not a float") from None
        self._check_range(key, v, min, max)
        return v

    @staticmethod
    def _check_range(key, v, lo, hi):
        if lo is not None and v < lo:
            raise ConfigError(f"{key}={v} below minimum {lo}")
        if hi is not None and v > hi:
            raise ConfigError(f"{key}={v} above maximum {hi}")

    def unused_keys(self) -> list[str]:
        """Keys present but never read — the reference warns about these."""
        return sorted(set(self._kvs) - self._used)

    def warn_unused(self, log=print):
        for k in self.unused_keys():
            log(f"WARNING: unused config key {k!r}")
