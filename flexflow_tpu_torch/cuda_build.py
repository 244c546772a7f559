"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled for
Hopper (``sm_90a``) into ``_build/lib<name>-<hash>.so`` at first use (the
hash covers the source, every ``csrc/*.cuh`` header and the flags, so an
edited source or header rebuilds) and loaded with ``ctypes``. A file lock
per library around its build lets threads and processes race to the first
call safely, and lets different libraries build at once (``build_all``
starts one ``nvcc`` per source, all together). Nothing here runs at
import time: the CPU-only test environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home
                  else []) + ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc")]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def _paths(name: str):
    """The source of ``name`` and the library its current build goes to:
    the digest covers the source, the headers it may include (every
    ``csrc/*.cuh``, in name order) and the flags."""
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``-I csrc/`` for its headers)
    unless its current build exists; return the shared library's path.
    nvcc's output (with ``-Xptxas -v``: the registers, shared memory and
    spills of each kernel) is kept beside it as ``.log``."""
    src, out = _paths(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f".lock-{name}", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if out.exists():
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, f"-I{SRC_DIR}", "-o", str(tmp),
                 str(src)],
                capture_output=True, text=True)
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return out


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Build several sources at once, one ``nvcc`` each, started together
    (each waits on its own compiler, so threads overlap them)."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` ('' if none)."""
    log = _paths(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
