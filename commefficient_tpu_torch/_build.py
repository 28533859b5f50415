"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is a shared library with a plain C interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``_build/`` beside
this file (listed in ``.gitignore``) and loaded with ``ctypes``. A
library is built at first use, from this package's sources only, and
named by a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. ``build_all`` starts one
``nvcc`` per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``check`` turns a nonzero code into an exception. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: dict = {}
# ptxas register / shared-memory report of each build, by source stem
# (kept beside the library, so a cached build still has its report)
BUILD_LOGS: dict = {}
# kernel libraries loaded in this process and the seconds it took
COMPILES = {"events": 0, "secs": 0.0}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put it on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _target(stem: str) -> Path:
    src = SRC_DIR / f"{stem}.cu"
    h = hashlib.sha1(src.read_bytes())
    for dep in sorted(SRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:12]}.so"


def _start(stem: str):
    """Spawn nvcc for ``csrc/<stem>.cu`` unless its library exists;
    returns (process or None, tmp path, final path)."""
    out = _target(stem)
    if out.exists():
        log = out.with_suffix(".log")
        if log.exists():
            BUILD_LOGS[stem] = log.read_text()
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(SRC_DIR),
           "-o", str(tmp), str(SRC_DIR / f"{stem}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(stem: str, proc, tmp: Path, out: Path) -> Path:
    if proc is not None:
        log, _ = proc.communicate()
        BUILD_LOGS[stem] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{stem}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    return out


def build_all(stems=None) -> dict:
    """Build every (or the named) kernel source in parallel; returns
    {stem: library path}."""
    stems = stems or sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    with _LOCK:
        started = {s: _start(s) for s in stems}
        return {s: _finish(s, *started[s]) for s in stems}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use.
    Each first load in a process counts in ``COMPILES`` (the round
    ledger's compile events, telemetry/core.py), with its seconds."""
    lib = _LIBS.get(stem)
    if lib is None:
        t0 = time.perf_counter()
        path = build_all([stem])[stem]
        with _LOCK:
            lib = _LIBS.get(stem)
            if lib is None:
                lib = ctypes.CDLL(str(path))
                _LIBS[stem] = lib
                COMPILES["events"] += 1
                COMPILES["secs"] += time.perf_counter() - t0
    return lib


def bind(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """A C entry point with its argument types set: pointers and the
    stream as ``c_void_p`` (a bare Python int would be cut to 32
    bits), the return value as the launch's ``cudaError_t``."""
    fn = getattr(load(stem), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
