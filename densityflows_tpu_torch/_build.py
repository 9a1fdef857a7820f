"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library name carries a hash of the
source and of the headers beside it (``csrc/*.cuh``), so an edited source
rebuilds. Libraries go to ``build/`` at the root of the checkout. The host
loader (``csrc/loader.cpp``) is built the same way with the host compiler
(:func:`load_host_library`).

This module is imported lazily by the kernel wrappers: importing the package
on a machine without ``nvcc`` works, and a failing build raises where the
kernel was asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load_library", "load_libraries", "load_host_library", "build_dir",
           "source_path", "NVCC_FLAGS", "HOST_FLAGS"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()                      # guards _BUILD_LOCKS
_BUILD_LOCKS: dict[str, threading.Lock] = {}  # one build at a time per source


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PACKAGE_DIR), "build")


def source_path(name: str, ext: str = ".cu") -> str:
    return os.path.join(_PACKAGE_DIR, "csrc", name + ext)


def _digest(src: str, flags) -> str:
    """Hash of a source, of the headers it may include and of the flags."""
    h = hashlib.sha256()
    csrc = os.path.dirname(src)
    headers = sorted(f for f in os.listdir(csrc) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(csrc, f) for f in headers
                         if src.endswith(".cu")]:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(cmd, src, out):
    """Run a compiler that writes ``out`` (through a temporary name, so a
    concurrent process never loads a half-written library)."""
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp, src], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{cmd[0]} failed for {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        candidate = os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(candidate):
            exe = candidate
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of densityflows_tpu_torch are "
            "built from source at first use and need the CUDA toolkit")
    return exe


def load_library(name: str, *, verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, and load it."""
    with _LOCK:
        build_lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with build_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = source_path(name)
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir,
                           f"lib{name}_{_digest(src, NVCC_FLAGS)}.so")
        if not os.path.exists(out):
            cmd = [_nvcc(), *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            log = _compile(cmd, src, out)
            if verbose:
                print(log, flush=True)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
        return lib


def load_host_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cpp`` with the host C++ compiler if its library
    is missing, and load it. Raises ``RuntimeError`` where there is no
    compiler or the build fails."""
    key = name + ".cpp"
    with _LOCK:
        build_lock = _BUILD_LOCKS.setdefault(key, threading.Lock())
    with build_lock:
        lib = _LIBS.get(key)
        if lib is not None:
            return lib
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("no host C++ compiler (g++ / c++) found")
        src = source_path(name, ".cpp")
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir,
                           f"lib{name}_{_digest(src, HOST_FLAGS)}.so")
        if not os.path.exists(out):
            _compile([cxx, *HOST_FLAGS], src, out)
        lib = ctypes.CDLL(out)
        _LIBS[key] = lib
        return lib


def load_libraries(names, *, verbose: bool = False) -> dict:
    """Build and load several sources at once, one ``nvcc`` for each, all
    started together. Returns ``{name: seconds it took}``."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.time()
        load_library(name, verbose=verbose)
        return time.time() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(one, names)))
