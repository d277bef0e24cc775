"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled into a
shared library for Hopper (``sm_90a``), loaded with :mod:`ctypes`.  The
library lives under ``build/tabmat_torch/<hash>/`` next to the package, where
the hash covers the source, the shared headers and the flags, so an edited
source rebuilds and an unchanged one is reused.  Nothing is built at import time: the CPU paths
never need ``nvcc``.  :func:`build_all` runs one ``nvcc`` per source, all at
once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "tabmat_torch"
# every source of csrc/, each its own library
SOURCES = ("sandwich", "sandwich_narrow", "sandwich_tri", "sandwich_wide", "sandwich_mma",
           "sandwich_mma_tri", "gather", "segsum", "spmv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()  # guards _locks
_locks: dict = {}  # name -> lock held while that source builds and loads
_libraries: dict = {}
# name -> {"path", "seconds" (None when an earlier build was reused), "log"}
build_info: dict = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else ``nvcc`` on PATH."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: set CUDA_HOME or put nvcc on PATH to build "
            "tabmat_torch's CUDA kernels"
        )
    return found


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is built (keyed by content:
    the source, the shared headers ``csrc/*.cuh`` and the flags)."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / digest / f"lib{name}.so"


def _compile(src: Path, so: Path) -> dict:
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed building {src.name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stderr}"
        )
    log = proc.stdout + proc.stderr
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return {"path": str(so), "seconds": seconds, "log": log}


def library(name: str) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libraries.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if so.exists():
            log_file = so.with_suffix(".log")
            info = {
                "path": str(so),
                "seconds": None,
                "log": log_file.read_text() if log_file.exists() else "",
            }
        else:
            info = _compile(CSRC / f"{name}.cu", so)
        lib = ctypes.CDLL(str(so))
        _libraries[name] = lib
        build_info[name] = info
        return lib


def build_all(names=SOURCES) -> None:
    """Build and load several sources (all by default) at once: one ``nvcc``
    each, in parallel."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        for future in [pool.submit(library, name) for name in names]:
            future.result()


def bind(name: str, signatures: dict) -> ctypes.CDLL:
    """``library(name)`` with each C function of ``signatures`` typed.

    ``signatures`` maps a symbol to its ``argtypes``; every function returns
    a CUDA error code (``c_int``).  ``tabmat_cuda_error_string`` is typed too.
    """
    lib = library(name)
    for symbol, argtypes in signatures.items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tabmat_cuda_error_string.argtypes = [ctypes.c_int]
    lib.tabmat_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise ``RuntimeError`` when a C function of ``lib`` returned an error."""
    if err != 0:
        msg = lib.tabmat_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
