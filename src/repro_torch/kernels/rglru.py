"""Wrapper of the Hopper RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The kernel replaces ``src/repro/kernels/rglru_kernel.py::_rglru_kernel``.
Its plain version is :func:`repro_torch.kernels.ref.rglru_scan_plain`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel since the last reset (set it to 0 to reset).
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load()
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        # x, r, i, a_log, h0, y, h_out; B, T, W, dtype, alog_dtype; stream
        lib.rglru_scan.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        lib.rglru_scan.restype = i32
        _lib = lib
    return _lib


def check_inputs(x: torch.Tensor, a_log: torch.Tensor, gate_r: torch.Tensor,
                 gate_i: torch.Tensor, h0: torch.Tensor,
                 h_out: Optional[torch.Tensor]) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if x.dim() != 3 or gate_r.shape != x.shape or gate_i.shape != x.shape:
        raise ValueError(f"want x, gate_r, gate_i [B,T,W]; got {tuple(x.shape)}, "
                         f"{tuple(gate_r.shape)}, {tuple(gate_i.shape)}")
    B, T, W = x.shape
    if T < 1 or W < 1 or not 1 <= B <= 65535:
        raise ValueError(f"[B,T,W] = {tuple(x.shape)}: want T, W >= 1, "
                         "1 <= B <= 65535")
    if a_log.shape != (W,) or h0.shape != (B, W):
        raise ValueError(f"a_log {tuple(a_log.shape)}, h0 {tuple(h0.shape)}: "
                         f"want [{W}], [{B}, {W}]")
    if x.dtype not in _DTYPES or gate_r.dtype != x.dtype or gate_i.dtype != x.dtype:
        raise ValueError(f"dtypes {x.dtype}/{gate_r.dtype}/{gate_i.dtype}: want "
                         "x, gate_r and gate_i all float32 or all bfloat16")
    if a_log.dtype not in _DTYPES:
        raise ValueError(f"a_log dtype {a_log.dtype}: want float32 or bfloat16")
    if h0.dtype != torch.float32:
        raise ValueError(f"h0 dtype {h0.dtype}: want float32")
    tensors = [x, a_log, gate_r, gate_i, h0]
    if h_out is not None:
        if h_out.shape != h0.shape or h_out.dtype != torch.float32:
            raise ValueError("h_out must be float32 of h0's shape")
        tensors.append(h_out)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def rglru_scan(x: torch.Tensor, a_log: torch.Tensor, gate_r: torch.Tensor,
               gate_i: torch.Tensor, h0: torch.Tensor, *,
               h_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: (y [B,T,W] fp32, h_T [B,W] fp32).
    h_T is written into ``h_out`` when one is given (it may be ``h0``)."""
    global launches
    check_inputs(x, a_log, gate_r, gate_i, h0, h_out)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA tensors, not {x.device}")
    B, T, W = x.shape
    y = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
    if h_out is None:
        h_out = torch.empty_like(h0)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.rglru_scan(x.data_ptr(), gate_r.data_ptr(), gate_i.data_ptr(),
                            a_log.data_ptr(), h0.data_ptr(), y.data_ptr(),
                            h_out.data_ptr(), B, T, W, _DTYPES[x.dtype],
                            _DTYPES[a_log.dtype], stream)
    build.check_launch("rglru_scan", rc)
    launches += 1
    return y, h_out
