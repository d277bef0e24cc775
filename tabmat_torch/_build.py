"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled into a
shared library for Hopper (``sm_90a``), loaded with :mod:`ctypes`.  The
library lives under ``build/tabmat_torch/<hash>/`` next to the package, where
the hash covers the source and the flags, so an edited source rebuilds and
an unchanged one is reused.  Nothing is built at import time: the CPU paths
never need ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "tabmat_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
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
    """Where the library for ``csrc/<name>.cu`` is built (keyed by content)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
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
