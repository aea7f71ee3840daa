"""Wrapper of the Hopper WKV backward kernel, K3b (``csrc/wkv6_bwd.cu``).

The reference writes no kernel for the WKV's gradient: it takes ``jax.grad``
through ``src/repro/kernels/ref.py::rwkv6_scan_ref``. The port's gradient is
this kernel, reached from :class:`repro_torch.models.rwkv6.WKVScan`. It
recomputes the forward's states from checkpoints taken every ``CHUNK`` steps
(a scratch buffer of ``[B, H, ceil(T / CHUNK), hd, hd]`` fp32), never by
dividing by a decay. Its plain version is
:func:`repro_torch.kernels.ref.rwkv6_scan_bwd_plain`;
:func:`repro_torch.kernels.ref.rwkv6_scan_bwd_chunked_plain` repeats its
checkpoint-and-recompute scheme; :mod:`repro_torch.kernels.ops` picks between
kernel and plain version by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, rwkv6

# steps per checkpoint and per sub-chunk held in registers: L and U of
# csrc/wkv6_bwd.cu, which the wrapper checks when it loads the library
CHUNK = 16
SUB = 4

# Calls that launched the kernel since the last reset (set it to 0 to
# reset); each call is three launches: the checkpoints, the reverse walk and
# du's sum over the batch rows.
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # r, k, v, w, u, state, dy, ds_T, dr, dk, dv, dw, du, ds0, ckpt,
        # du_part; B, T, H, hd, dtype, u_dtype; stream
        lib.wkv6_scan_bwd.argtypes = [ptr] * 16 + [i32] * 6 + [ptr]
        lib.wkv6_scan_bwd.restype = i32
        lib.wkv6_scan_bwd_steps.argtypes = [ptr] * 2
        lib.wkv6_scan_bwd_steps.restype = i32
        build.check_steps("wkv6_scan_bwd", lib.wkv6_scan_bwd_steps,
                          (CHUNK, SUB))
        _lib = lib
    return _lib


def check_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 dy: torch.Tensor, ds_T: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take: the forward's
    inputs as :func:`repro_torch.kernels.rwkv6.check_inputs` takes them, dy
    fp32 of r's shape, ds_T fp32 of the state's."""
    rwkv6.check_inputs(r, k, v, w, u, state, None)
    for name, t, shape in (("dy", dy, r.shape), ("ds_T", ds_T, state.shape)):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"float32 {tuple(shape)}")
        if t.device != r.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on r's device")


def wkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                  dy: torch.Tensor, ds_T: torch.Tensor
                  ) -> Tuple[torch.Tensor, ...]:
    """Launch K3b on CUDA tensors: (dr, dk, dv, dw, du, ds0), each in its
    input's dtype. dy and ds_T are the cotangents of y and S_T."""
    global launches
    check_inputs(r, k, v, w, u, state, dy, ds_T)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan_bwd runs on CUDA tensors, not {r.device}")
    B, T, H, hd = r.shape
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du, ds0 = torch.empty_like(u), torch.empty_like(state)
    ckpt = torch.empty((B, H, math.ceil(T / CHUNK), hd, hd),
                       dtype=torch.float32, device=r.device)
    du_part = torch.empty((B, H, hd), dtype=torch.float32, device=r.device)
    lib = _library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    dtypes = rwkv6._DTYPES
    with torch.cuda.device(r.device):
        rc = lib.wkv6_scan_bwd(
            *(t.data_ptr() for t in (r, k, v, w, u, state, dy, ds_T, dr, dk,
                                     dv, dw, du, ds0, ckpt, du_part)),
            B, T, H, hd, dtypes[r.dtype], dtypes[u.dtype], stream)
    build.check_launch("wkv6_scan_bwd", rc)
    launches += 1
    return dr, dk, dv, dw, du, ds0
