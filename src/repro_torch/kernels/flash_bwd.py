"""Wrapper of the Hopper flash-attention backward (``csrc/flash_bwd.cu``), K1b.

It replaces ``src/repro/models/attention.py::_flash_bwd_impl``, the jnp
custom VJP of the reference's ``flash_attention_jnp`` (no Pallas kernel
exists for it). From the forward's q, k, v and positions, its output and
the LSE that :func:`repro_torch.kernels.flash_attention.flash_fwd` writes
with ``return_lse=True``, and dout, it returns (dq, dk, dv) in the inputs'
dtype. It launches three kernels: ``delta`` (rowsum(dout * out)), ``dkdv``
and ``dq``. Its plain version is :func:`repro_torch.kernels.ref.flash_bwd_plain`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .flash_attention import _DTYPES, check_inputs as check_forward_inputs

# Calls of flash_bwd since the last reset, and launches of each of its
# kernels (set them to 0 to reset).
launches = 0
kernel_launches = {"delta": 0, "dkdv": 0, "dq": 0}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load()
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # out, dout, delta; B, Sq, Hq, hd, dtype; stream
        lib.flash_bwd_delta.argtypes = [ptr] * 3 + [i32] * 5 + [ptr]
        # q, k, v, dout, lse, delta, q_pos, kv_pos, dk, dv; B, Sq, Skv, Hq,
        # Hkv, hd, dtype, causal, window; logit_cap, scale; stream
        lib.flash_bwd_dkdv.argtypes = [ptr] * 10 + [i32] * 9 + [f32] * 2 + [ptr]
        # the same with dq in place of dk, dv
        lib.flash_bwd_dq.argtypes = [ptr] * 9 + [i32] * 9 + [f32] * 2 + [ptr]
        for fn in (lib.flash_bwd_delta, lib.flash_bwd_dkdv, lib.flash_bwd_dq):
            fn.restype = i32
        _lib = lib
    return _lib


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor,
                 window: Optional[int], logit_cap: Optional[float]) -> None:
    """Raise ValueError on anything the kernels do not take: the forward's
    checks, and out, dout like q, lse fp32 [B, Hkv, G, Sq]."""
    check_forward_inputs(q, k, v, q_positions, kv_positions, window, logit_cap)
    B, Sq, Hq, _ = q.shape
    Hkv = k.shape[2]
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want q's "
                             f"{tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, Hkv, Hq // Hkv, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want float32 "
                         f"{(B, Hkv, Hq // Hkv, Sq)}")
    if any(t.device != q.device for t in (out, lse, dout)):
        raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in (out, lse, dout)):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("out and dout must start on a 16-byte boundary")


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: Optional[float] = None, q_positions: torch.Tensor,
              kv_positions: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the three kernels on CUDA tensors: (dq, dk, dv) shaped and
    typed as (q, k, v)."""
    global launches
    check_inputs(q, k, v, out, lse, dout, q_positions, kv_positions, window,
                 logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on CUDA tensors, not {q.device}")
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    lib = _library()
    dtype = _DTYPES[q.dtype]
    window_, cap, scale = window or 0, float(logit_cap or 0.0), float(hd ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.flash_bwd_delta(out.data_ptr(), dout.data_ptr(),
                                 delta.data_ptr(), B, Sq, Hq, hd, dtype, stream)
        build.check_launch("flash_bwd delta", rc)
        kernel_launches["delta"] += 1
        rc = lib.flash_bwd_dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                dout.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), q_positions.data_ptr(),
                                kv_positions.data_ptr(), dk.data_ptr(),
                                dv.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, dtype,
                                int(causal), window_, cap, scale, stream)
        build.check_launch("flash_bwd dkdv", rc)
        kernel_launches["dkdv"] += 1
        rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              q_positions.data_ptr(), kv_positions.data_ptr(),
                              dq.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, dtype,
                              int(causal), window_, cap, scale, stream)
        build.check_launch("flash_bwd dq", rc)
        kernel_launches["dq"] += 1
    launches += 1
    return dq, dk, dv
