"""Build and load the port's C++ host libraries (plain C interface +
ctypes) — the host-side counterpart of ops/_build.py.

Each source `dataio/csrc/<name>.cpp` (the SGF scanner, the row
transforms) is compiled at first use by g++ into
`katago_torch/_build/lib<name>-<hash>.so` (the hash is of the source,
the flags and the compiler, so an edited source rebuilds) and loaded
with ctypes. A build that fails raises: nothing falls back to another
implementation. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from katago_torch.ops._build import BUILD_DIR

CSRC = Path(__file__).resolve().parents[1] / "dataio" / "csrc"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]
NAMES = ("sgfscan", "dataprep")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def compiler() -> str:
    """Path of the C++ compiler to build with (g++ on PATH)."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH")
    return found


def _lib_path(name: str, cxx: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    key = src + " ".join([cxx] + CXX_FLAGS).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def build(name: str, cxx: str | None = None) -> Path:
    """Compile dataio/csrc/<name>.cpp with cxx (default: compiler())
    unless an up-to-date library exists; raises RuntimeError when the
    compiler cannot be run or fails."""
    cxx = cxx or compiler()
    out = _lib_path(name, cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {cxx} for {name}.cpp: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>; signatures maps each C
    function to its argtypes (restype is int, a status)."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def build_all(names=NAMES) -> float:
    """Build every host library in parallel (one g++ per source);
    returns the wall seconds taken."""
    import concurrent.futures
    import time
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        for fut in [ex.submit(build, n) for n in names]:
            fut.result()
    return time.time() - t0
