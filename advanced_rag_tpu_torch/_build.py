"""Build and load the port's CUDA kernels: one nvcc call, a plain C ABI,
ctypes.

``csrc/*.cu`` include CUDA headers only, so a single command compiles them
in seconds into ``build/kernels/libart_kernels_<srchash>.so`` at the root of
the checkout (``build/`` is git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/libart_kernels_<srchash>.so csrc/*.cu

The library is built on first use and named by a hash of the sources, so an
edited source rebuilds and an unchanged one loads the cached file.  The
compiler writes to a temporary name that is then renamed into place, so two
processes building at once cannot leave a torn file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the nvcc call of this process took (None when the library for
#: these sources was already built); chip_smoke.py prints it
last_build_seconds: Optional[float] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh"))):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libart_kernels_{source_hash()}.so"


def find_nvcc() -> str:
    """nvcc from PyTorch's CUDA_HOME, then $CUDA_HOME, then PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    for home in (CUDA_HOME, os.environ.get("CUDA_HOME")):
        if home:
            cand = Path(home) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in torch's CUDA_HOME, $CUDA_HOME/bin and "
            "PATH); the CUDA kernels cannot be built")
    return found


def nvcc_command(nvcc: str, out: Path) -> List[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", str(out),
            *[str(s) for s in sources()]]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global last_build_seconds
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".tmp.so",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = nvcc_command(find_nvcc(), Path(tmp))
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    last_build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.art_dense_scores.argtypes = [p, p, i, p, p, i, i, i, i, p]
            lib.art_dense_scores.restype = i
            lib.art_sq8_scores.argtypes = [p, p, p, p, p, i, i, i, i, p]
            lib.art_sq8_scores.restype = i
            lib.art_bm25_scores.argtypes = [p, p, p, p, p, p, p,
                                            i, i, i, i, f, f, f, i, p]
            lib.art_bm25_scores.restype = i
            _lib = lib
        return _lib


__all__ = ["build", "load", "nvcc_command", "find_nvcc", "sources",
           "library_path", "BUILD_DIR", "CSRC"]
