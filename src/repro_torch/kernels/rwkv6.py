"""Wrapper of the Hopper RWKV-6 WKV scan kernel.

The kernel replaces ``src/repro/kernels/rwkv6_kernel.py::_wkv_kernel``. It
has two bodies, chosen by :func:`plan` from the shapes: a sequential one
(``csrc/wkv6_scan.cu``, the state in registers walks all T steps; decode and
short T) and the chunked matrix form (``csrc/wkv6_chunk.cu``, three launches:
chunk summaries, carry, outputs; prefill). Its plain version is
:func:`repro_torch.kernels.ref.rwkv6_scan_plain`, and
:func:`repro_torch.kernels.ref.rwkv6_scan_chunked_plain` repeats the chunked
body's arithmetic; :mod:`repro_torch.kernels.ops` picks between kernel and
plain version by the tensors' device.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
# chunked body: steps per chunk (longer T take this body) and per sub-chunk,
# L and SUB of csrc/wkv6_chunk.cu
CHUNK = 64
SUB = 16

# Launches of the kernel since the last reset (set it to 0 to reset), and of
# each body (set both entries to 0 to reset).
launches = 0
body_launches = {"sequential": 0, "chunked": 0}


class Plan(NamedTuple):
    body: str                      # "sequential" or "chunked"
    chunk: int                     # steps a CTA takes
    grid: Tuple[int, int, int]     # of the sequential body, or of the
                                   # chunked body's summary and output passes


def plan(B: int, T: int, H: int, hd: int, body: Optional[str] = None) -> Plan:
    """The body, chunk length and grid for r [B,T,H,hd]: the sequential body
    (one CTA per (b, h)) for T up to one chunk, else the chunked body (one
    CTA per (chunk, h, b)). ``body`` names one instead (tests and timing run
    both at every shape)."""
    body = body or ("sequential" if T <= CHUNK else "chunked")
    if body == "sequential":
        return Plan(body, T, (H, B, 1))
    if body != "chunked":
        raise ValueError(f"body {body!r}: want 'sequential' or 'chunked'")
    return Plan(body, CHUNK, (math.ceil(T / CHUNK), H, B))


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
        # r, k, v, w, u, state, y, state_out, scratch, decay; B, T, H, hd,
        # dtype, u_dtype, vec; stream
        lib.wkv6_scan_chunked.argtypes = [ptr] * 10 + [i32] * 7 + [ptr]
        lib.wkv6_scan_chunked.restype = i32
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
    if T < 1 or not 1 <= B * H <= 65535:
        raise ValueError(f"[B,T,H,hd] = {tuple(r.shape)}: want T >= 1 and "
                         "1 <= B * H <= 65535")
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
              state_out: Optional[torch.Tensor] = None,
              body: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors: (y [B,T,H,hd] fp32, S_T fp32).
    S_T is written into ``state_out`` when one is given (it may be
    ``state``). :func:`plan` picks the body unless ``body`` names one."""
    global launches
    check_inputs(r, k, v, w, u, state, state_out)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan runs on CUDA tensors, not {r.device}")
    B, T, H, hd = r.shape
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=r.device)
    if state_out is None:
        state_out = torch.empty_like(state)
    p = plan(B, T, H, hd, body)
    lib = _library()
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptrs = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), state.data_ptr(), y.data_ptr(), state_out.data_ptr())
    dtypes = (_DTYPES[r.dtype], _DTYPES[u.dtype])
    with torch.cuda.device(r.device):
        if p.body == "sequential":
            rc = lib.wkv6_scan(*ptrs, B, T, H, hd, *dtypes, stream)
        else:
            n = p.grid[0]
            # each chunk's ΔS, overwritten by its start state; its decay
            scratch = torch.empty((B, H, n, MAX_HEAD_DIM, MAX_HEAD_DIM),
                                  dtype=torch.float32, device=r.device)
            decay = torch.empty((B, H, n, MAX_HEAD_DIM), dtype=torch.float32,
                                device=r.device)
            vec = hd % 8 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in (r, k, v, w))
            rc = lib.wkv6_scan_chunked(*ptrs, scratch.data_ptr(),
                                       decay.data_ptr(), B, T, H, hd, *dtypes,
                                       int(vec), stream)
    build.check_launch(f"wkv6_scan ({p.body})", rc)
    launches += 1
    body_launches[p.body] += 1
    return y, state_out
