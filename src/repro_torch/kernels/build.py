"""Build the CUDA source under ``csrc/`` with nvcc and load it with ctypes.

The source is compiled into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -Xptxas -v -o build/kernels/libflash_fwd-<hash>.so \\
        flash_fwd.cu

into ``build/kernels/`` at the root of the checkout, at first use. The file
name carries a hash of the sources and flags, so a library built from other
sources is never loaded. Nothing here runs at import: the CPU tests import
every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCE = CSRC / "flash_fwd.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return str(path)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{SOURCE.stem}-{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the source unless its library is already built.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's output (the
    ``-Xptxas -v`` register and shared-memory report), or says the library
    was built before. Raises with that output if the build fails.
    """
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0,
                "log": "built before from the same sources"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": proc.stdout}


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(build()["path"])
    return _lib
