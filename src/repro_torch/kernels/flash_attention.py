"""Wrapper of the Hopper flash-attention forward kernels (``csrc/flash_fwd.cu``,
``csrc/flash_fwd_sm90.cu``).

The kernel replaces ``src/repro/kernels/flash_attention.py::_fwd_kernel``,
generalised from a contiguous ``q_offset`` to explicit int32 query and key
positions, so that it runs against the ring cache too. Its plain version is
:func:`repro_torch.kernels.ref.attention_plain`; :mod:`repro_torch.kernels.ops`
picks between the two by the tensors' device, and sends a CUDA call with one
query position to :mod:`repro_torch.kernels.flash_decode` instead. With
``return_lse=True`` (training: ``ops.attention_fwd``) it also writes the
log-sum-exp of each query row, which the backward
(:mod:`repro_torch.kernels.flash_bwd`) reads; its plain version is then
:func:`repro_torch.kernels.ref.attention_lse_plain`.

Three bodies compute that function, and :func:`body` picks one from what the
call shows, its dtype, head dim and logit cap: ``sm90``
(``csrc/flash_fwd_sm90.cu``: TMA, an mbarrier ring and wgmma, Hopper's own
units) takes bf16 at head dim 128 without a cap, which is every serving
prefill and training forward of the benchmark's models; ``mma``
(``csrc/flash_fwd.cu``'s mma.sync body) every other bf16 call (gemma2 and
recurrentgemma at 256, gemma2's cap, whisper at 64); ``simt`` (its fp32
body) fp32. The dispatch ledger counts each body's launches,
``flash_fwd.<body>`` (:mod:`repro_torch.kernels.build`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, q_pos, kv_pos, out, lse (or NULL); B, Sq, Skv, Hq, Hkv, hd,
# dtype, causal, window; logit_cap, scale; stream (the mma and simt bodies)
FWD_ARGS = [_ptr] * 7 + [_i32] * 9 + [_f32, _f32, _ptr]
# as flash_fwd's, without dtype and logit_cap
SM90_ARGS = [_ptr] * 7 + [_i32] * 8 + [_f32, _ptr]


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor,
                 window: Optional[int], logit_cap: Optional[float]) -> None:
    """Raise ValueError on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q [B,Sq,Hq,hd], k = v [B,Skv,Hkv,hd]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, hd = q.shape
    Bk, Skv, Hkv, hdk = k.shape
    if Bk != B or hdk != hd or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd}: want a multiple of 8, at most "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: want all "
                         "float32 or all bfloat16")
    if q_positions.shape != (Sq,) or kv_positions.shape != (Skv,):
        raise ValueError(f"positions {tuple(q_positions.shape)}, "
                         f"{tuple(kv_positions.shape)}: want [{Sq}], [{Skv}]")
    if q_positions.dtype != torch.int32 or kv_positions.dtype != torch.int32:
        raise ValueError("positions must be int32")
    tensors = (q, k, v, q_positions, kv_positions)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    if window is not None and window < 1:
        raise ValueError(f"window {window}: want None or >= 1")
    if logit_cap is not None and not logit_cap > 0:
        raise ValueError(f"logit_cap {logit_cap}: want None or > 0")


def body(dtype: torch.dtype, head_dim: int, logit_cap: Optional[float]) -> str:
    """The body that takes a call: ``sm90`` for bf16 at head dim 128 without
    a logit cap, ``mma`` for any other bf16 call, ``simt`` for fp32."""
    if dtype != torch.bfloat16:
        return "simt"
    return "sm90" if head_dim == 128 and logit_cap is None else "mma"


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: Optional[float] = None,
              q_positions: torch.Tensor, kv_positions: torch.Tensor,
              return_lse: bool = False
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Launch the kernel on CUDA tensors: [B,Sq,Hq,hd] out in q's dtype, and
    with ``return_lse`` (out, lse [B,Hkv,G,Sq] fp32; -inf for a row with no
    valid key). Without it no LSE is written."""
    check_inputs(q, k, v, q_positions, kv_positions, window, logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on CUDA tensors, not {q.device}")
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    o = torch.empty_like(q)
    lse = (torch.empty((B, Hkv, Hq // Hkv, Sq), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    which = body(q.dtype, hd, logit_cap)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr())
    with torch.cuda.device(q.device):
        if which == "sm90":
            rc = build.entry("flash_fwd_sm90", SM90_ARGS)(
                *ptrs, B, Sq, Skv, Hq, Hkv, hd, int(causal), window or 0,
                float(hd ** -0.5), stream)
        else:
            rc = build.entry("flash_fwd", FWD_ARGS)(
                *ptrs, B, Sq, Skv, Hq, Hkv, hd, _DTYPES[q.dtype], int(causal),
                window or 0, float(logit_cap or 0.0), float(hd ** -0.5),
                stream)
    build.check_launch(f"flash_fwd.{which}", rc)
    return (o, lse) if return_lse else o
