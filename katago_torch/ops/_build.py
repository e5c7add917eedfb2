"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each kernel source `ops/csrc/<name>.cu` is compiled by nvcc for sm_90a
into `katago_torch/_build/lib<name>-<hash>.so` at first use (the hash is
of the source, so an edited kernel rebuilds) and loaded with ctypes. The
C entry points take raw device pointers and the CUDA stream as integers,
launch on that stream, allocate nothing and return cudaGetLastError().
Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    """Path of the nvcc to build with."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ops/csrc/<name>.cu unless an up-to-date library exists."""
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all(names=("labels", "chase")) -> float:
    """Build every kernel in parallel (one nvcc per source); returns the
    wall seconds taken."""
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        for fut in [ex.submit(build, n) for n in names]:
            fut.result()
    return time.time() - t0


def bind(path, signatures: dict) -> ctypes.CDLL:
    """Load the library at path; signatures maps each C function to its
    argtypes (restype is int, the CUDA error code)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>."""
    with _lock:
        if name not in _libs:
            _libs[name] = bind(build(name), signatures)
        return _libs[name]


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with error {rc}")


def launch(fn, dev: torch.device, what: str, *args) -> None:
    """Call the C entry point fn(*args, stream) on dev's current stream and
    raise if the launch failed. The device is switched only when dev is
    not the current one (a kernel launches on the current device)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    check(rc, what)
