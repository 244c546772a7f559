"""The native search core (``native/``): its build, and calls into it.

The search core is C++ behind a C ABI that takes and returns JSON strings
(``ffs_optimize``, ``ffs_simulate``, ``ffs_free``, ``ffs_version``). The
port compiles it from ``native/ffs_search.cpp`` and its headers into the
git-ignored ``flexflow_tpu_torch/_build/libffsearch-<hash>.so`` at first
use (the hash covers the sources, the compiler and the flags, so an
edited source or another compiler rebuilds), under a file lock as
``cuda_build.build`` does, so threads and processes may race to the first
call. It never loads, writes or rebuilds ``native/libffsearch.so``, which
belongs to the JAX package's loader. A failed build raises with the
compiler's log: a requested search never falls back to data parallelism.

The core carries its own copy of libstdc++, linked statically with every
symbol of it hidden (``-static-libstdc++ -Wl,--exclude-libs,ALL``). The
process already holds a libstdc++ (PyTorch's), and a compiler that links
its own libstdc++ statically but exports it (as a ``CXX`` toolchain may)
gives a core whose references bind partly to that copy and partly to its
own: on an H100 host the dynamic linker bound the core's
``std::num_put<char>::id`` to the process's libstdc++ and the locale's
facet table to the core's, and the core's first stream insertion of an
integer read a null facet and died of a segmentation fault. With the copy
hidden the core binds only to itself, whichever compiler built it.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import json
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Optional

NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCE = "ffs_search.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-static-libstdc++",
             "-static-libgcc", "-Wl,--exclude-libs,ALL")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None


def library_path() -> Path:
    """Where the current build of the search core goes: the digest covers
    ``native/ffs_search.cpp``, every ``native/*.hpp`` (in name order), the
    compiler (its path and version) and the flags."""
    h = hashlib.sha256((NATIVE_DIR / SOURCE).read_bytes())
    for header in sorted(NATIVE_DIR.glob("*.hpp")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(_compiler_id(_cxx()).encode())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libffsearch-{h.hexdigest()[:16]}.so"


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++) found: the port builds the "
                           "native search core from native/ffs_search.cpp")
    return cxx


@functools.lru_cache(maxsize=None)
def _compiler_id(cxx: str) -> str:
    """The compiler's path and the first line of its ``--version``."""
    proc = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    return cxx + "\0" + (proc.stdout.splitlines() or [""])[0]


def build() -> Path:
    """Compile the search core unless its current build exists; return
    the library's path. The compiler's output is kept beside it as
    ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock-ffsearch", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        try:
            if out.exists():
                return out
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_cxx(), *CXX_FLAGS, "-o", str(tmp),
                 str(NATIVE_DIR / SOURCE)],
                capture_output=True, text=True)
            out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"building the native search core from "
                    f"{NATIVE_DIR / SOURCE} failed (exit "
                    f"{proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock_file, fcntl.LOCK_UN)
    return out


def available() -> bool:
    """Whether the core can be had here: its sources and a C++ compiler
    are present (nothing is built)."""
    try:
        _cxx()
    except RuntimeError:
        return False
    return (NATIVE_DIR / SOURCE).is_file()


def _load() -> ctypes.CDLL:
    """The current build of the core, loaded once into this process."""
    global _lib, _lib_path
    path = build()
    with _lock:
        if _lib is None or _lib_path != path:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(
                    f"loading the native search core {path} failed: {e}"
                ) from e
            lib.ffs_version.restype = ctypes.c_char_p
            for fn in (lib.ffs_optimize, lib.ffs_simulate):
                fn.argtypes = [ctypes.c_char_p]
                fn.restype = ctypes.c_void_p
            lib.ffs_free.argtypes = [ctypes.c_void_p]
            _lib, _lib_path = lib, path
        return _lib


def _call(fn_name: str, request: Any) -> Any:
    """One JSON request through the core's C ABI; the core frees its
    answer's buffer."""
    lib = _load()
    ptr = getattr(lib, fn_name)(json.dumps(request).encode())
    try:
        out = json.loads(ctypes.string_at(ptr).decode())
    finally:
        lib.ffs_free(ptr)
    if isinstance(out, dict) and "error" in out:
        raise RuntimeError(f"ffsearch: {out['error']}")
    return out


def native_optimize(request: Dict[str, Any]) -> Dict[str, Any]:
    """One search: the request of ``unity.graph_optimize`` -> the winning
    mesh, per-op choices and specs, predicted time and memory."""
    return _call("ffs_optimize", request)


def native_simulate(request: Dict[str, Any]) -> Dict[str, Any]:
    """Price a given mesh and per-op assignment without searching."""
    return _call("ffs_simulate", request)


def ffs_version() -> str:
    return _load().ffs_version().decode()
