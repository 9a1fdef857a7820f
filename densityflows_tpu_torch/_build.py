"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). The library name carries a hash of the
source, so an edited source rebuilds. Libraries go to ``build/`` at the root
of the checkout.

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

__all__ = ["load_library", "load_libraries", "build_dir", "source_path",
           "NVCC_FLAGS"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()                      # guards _BUILD_LOCKS
_BUILD_LOCKS: dict[str, threading.Lock] = {}  # one build at a time per source


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PACKAGE_DIR), "build")


def source_path(name: str) -> str:
    return os.path.join(_PACKAGE_DIR, "csrc", name + ".cu")


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
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"lib{name}_{digest}.so")
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", tmp, src]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
            if verbose:
                print(proc.stdout + proc.stderr, flush=True)
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
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
