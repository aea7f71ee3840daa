"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Every ``csrc/*.cu`` is compiled to an object file, all nvcc processes started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
        -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<name>.cu   # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
        -o build/kernels/librepro_torch_kernels-<hash>.so <objs>

into ``build/kernels/`` at the root of the checkout, at first use. The file
name carries a hash of the sources and flags, so a library built from other
sources is never loaded. Nothing here runs at import: the CPU tests import
every module. With ``txtrace.enabled``, :func:`load` records the span
``kernels.load`` (detail ``built`` or ``loaded``): the program's share of a
process's set-up.
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

from repro_torch.obs import hostspans

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
LIB_NAME = "librepro_torch_kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")
LINK_FLAGS = ARCH + ("-shared",)

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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh", ".h"):
            digest.update(src.name.encode())
            digest.update(src.read_bytes())
    return BUILD_DIR / f"{LIB_NAME}-{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the sources unless their library is already built.

    Returns ``{"path", "seconds", "log"}``; ``log`` holds nvcc's output for
    each source (the ``-Xptxas -v`` register and shared-memory report), or
    says the library was built before. Raises with that output if a build
    fails.
    """
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0,
                "log": "built before from the same sources"}
    work = out.with_name(f"{out.stem}.{os.getpid()}.d")
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = [(src, work / f"{src.stem}.o") for src in SOURCES]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in jobs]
    logs, failed = [], []
    for (src, _), proc in zip(jobs, procs):
        text = proc.communicate()[0]
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode})")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc(), *LINK_FLAGS, "-o", str(tmp),
                               *(str(obj) for _, obj in jobs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append(f"link (exit {link.returncode})")
    shutil.rmtree(work, ignore_errors=True)
    log = "".join(logs)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "log": log}


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    if _lib is None:
        span = hostspans.begin("kernels.load")
        built = build()
        lib = ctypes.CDLL(built["path"])
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        if span is not None:
            span.detail = "built" if built["seconds"] else "loaded"
        hostspans.end(span)
    return _lib


def check_launch(name: str, rc: int) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        msg = load().cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cuda error {rc} ({msg})")


def check_steps(name: str, query, want) -> None:
    """Raise unless ``query`` (a C entry point that writes a kernel's step
    constants through two int pointers) gives the ``want`` pair that the
    kernel's wrapper sizes its scratch buffers by."""
    a, b = ctypes.c_int(), ctypes.c_int()
    rc = query(ctypes.byref(a), ctypes.byref(b))
    got = (a.value, b.value)
    if rc or got != tuple(want):
        raise RuntimeError(f"{name}: the library's steps are {got} (rc {rc}), "
                           f"the wrapper's {tuple(want)}")
