"""Wrapper of the Hopper RWKV-6 WKV scan kernel (``csrc/wkv6_scan.cu``).

The kernel replaces ``src/repro/kernels/rwkv6_kernel.py::_wkv_kernel``. Its
plain version is :func:`repro_torch.kernels.ref.rwkv6_scan_plain`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64

# Launches of the kernel since the last reset (set it to 0 to reset).
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # r, k, v, w, u, state, y, state_out; B, T, H, hd, dtype, u_dtype;
        # stream
        lib.wkv6_scan.argtypes = [ptr] * 8 + [i32] * 6 + [ptr]
        lib.wkv6_scan.restype = i32
        _lib = lib
    return _lib


def check_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 state_out: Optional[torch.Tensor]) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"want r, k, v, w [B,T,H,hd]; got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    B, T, H, hd = r.shape
    if T < 1 or H < 1 or not 1 <= B <= 65535:
        raise ValueError(f"[B,T,H,hd] = {tuple(r.shape)}: want T >= 1, "
                         "1 <= B <= 65535, H >= 1")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: want 1 to {MAX_HEAD_DIM}")
    if u.shape != (H, hd) or state.shape != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)}, state {tuple(state.shape)}: "
                         f"want [{H}, {hd}], [{B}, {H}, {hd}, {hd}]")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"dtypes {r.dtype}/{k.dtype}/{v.dtype}: want r, k "
                         "and v all float32 or all bfloat16")
    if w.dtype != torch.float32:
        raise ValueError(f"w dtype {w.dtype}: want float32 (decays near 1 "
                         "lose their precision in bfloat16)")
    if u.dtype not in _DTYPES:
        raise ValueError(f"u dtype {u.dtype}: want float32 or bfloat16")
    if state.dtype != torch.float32:
        raise ValueError(f"state dtype {state.dtype}: want float32")
    tensors = [r, k, v, w, u, state]
    if state_out is not None:
        if state_out.shape != state.shape or state_out.dtype != torch.float32:
            raise ValueError("state_out must be float32 of state's shape")
        tensors.append(state_out)
    if any(t.device != r.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              state_out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: (y [B,T,H,hd] fp32, S_T fp32).
    S_T is written into ``state_out`` when one is given (it may be
    ``state``)."""
    global launches
    check_inputs(r, k, v, w, u, state, state_out)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan runs on CUDA tensors, not {r.device}")
    B, T, H, hd = r.shape
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    if state_out is None:
        state_out = torch.empty_like(state)
    lib = _library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    with torch.cuda.device(r.device):
        rc = lib.wkv6_scan(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                           w.data_ptr(), u.data_ptr(), state.data_ptr(),
                           y.data_ptr(), state_out.data_ptr(), B, T, H, hd,
                           _DTYPES[r.dtype], _DTYPES[u.dtype], stream)
    build.check_launch("wkv6_scan", rc)
    launches += 1
    return y, state_out
