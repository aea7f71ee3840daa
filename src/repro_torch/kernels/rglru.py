"""Wrapper of the Hopper RG-LRU scan kernel (``csrc/rglru_scan.cu``).

The kernel replaces ``src/repro/kernels/rglru_kernel.py::_rglru_kernel``.
It has two bodies, chosen by :func:`plan` from the shapes: a sequential one
(one thread per channel walks all T steps; decode and short T) and a
chunk-parallel one (chunks of time scanned in parallel and joined by a
decoupled look-back; prefill). Its plain version is
:func:`repro_torch.kernels.ref.rglru_scan_plain`, and
:func:`repro_torch.kernels.ref.rglru_scan_chunked_plain` repeats the chunked
body's arithmetic; :mod:`repro_torch.kernels.ops` picks between kernel and
plain version by the tensors' device. The dispatch ledger counts each body's
launches, ``rglru_scan.<body>`` (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SEQ_THREADS = 64   # sequential body: channels per CTA
CHUNK = 32         # chunked body: steps per chunk; longer T take this body
LANES = 32         # chunked body: lanes of a quarter, 16 bytes of channels each

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# x, r, i, a_log, h0, y, h_out; B, T, W, dtype, alog_dtype; stream
_SEQUENTIAL = [_ptr] * 7 + [_i32] * 5 + [_ptr]
# x, r, i, a_log, h0, y, h_out, flags, pairs; B, T, W, dtype, alog_dtype,
# chunk, vector; stream
_CHUNKED = [_ptr] * 9 + [_i32] * 7 + [_ptr]


class Plan(NamedTuple):
    body: str                      # "sequential" or "chunked"
    chunk: int                     # steps a CTA takes
    grid: Tuple[int, int, int]


def plan(B: int, T: int, W: int, dtype: torch.dtype = torch.bfloat16,
         body: Optional[str] = None) -> Plan:
    """The body, chunk length and grid for x [B,T,W] of ``dtype``: the
    sequential body for T up to one chunk, else the chunked body with one
    CTA per (chunk, batch row, block of 32 x 16 bytes of channels). ``body``
    names one instead (tests and timing run both at every shape)."""
    body = body or ("sequential" if T <= CHUNK else "chunked")
    if body == "sequential":
        return Plan(body, T, (math.ceil(W / SEQ_THREADS), B, 1))
    if body != "chunked":
        raise ValueError(f"body {body!r}: want 'sequential' or 'chunked'")
    per_cta = LANES * 16 // (torch.finfo(dtype).bits // 8)
    return Plan(body, CHUNK,
                (math.ceil(T / CHUNK) * B * math.ceil(W / per_cta), 1, 1))


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
               h_out: Optional[torch.Tensor] = None,
               body: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: (y [B,T,W] fp32, h_T [B,W] fp32).
    h_T is written into ``h_out`` when one is given (it may be ``h0``).
    :func:`plan` picks the body unless ``body`` names one."""
    check_inputs(x, a_log, gate_r, gate_i, h0, h_out)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on CUDA tensors, not {x.device}")
    B, T, W = x.shape
    y = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
    if h_out is None:
        h_out = torch.empty_like(h0)
    p = plan(B, T, W, x.dtype, body)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), gate_r.data_ptr(), gate_i.data_ptr(),
            a_log.data_ptr(), h0.data_ptr(), y.data_ptr(), h_out.data_ptr())
    with torch.cuda.device(x.device):
        if p.body == "sequential":
            rc = build.entry("rglru_scan", _SEQUENTIAL)(
                *ptrs, B, T, W, _DTYPES[x.dtype], _DTYPES[a_log.dtype],
                stream)
        else:
            n_chunks = math.ceil(T / p.chunk)
            # the look-back's flags, zero, and the ticket after them
            flags = torch.zeros(p.grid[0] + 1, dtype=torch.int32,
                                device=x.device)
            pairs = torch.empty((3, B, n_chunks, W), dtype=torch.float32,
                                device=x.device)
            vector = (W * x.element_size()) % 16 == 0 and all(
                t.data_ptr() % 16 == 0 for t in (x, gate_r, gate_i))
            rc = build.entry("rglru_scan_chunked", _CHUNKED)(
                *ptrs, flags.data_ptr(), pairs.data_ptr(), B, T, W,
                _DTYPES[x.dtype], _DTYPES[a_log.dtype], p.chunk, int(vector),
                stream)
    build.check_launch(f"rglru_scan.{p.body}", rc)
    return y, h_out
