"""Wrapper of the Hopper flash-attention backward (``csrc/flash_bwd.cu``), K1b.

It replaces ``src/repro/models/attention.py::_flash_bwd_impl``, the jnp
custom VJP of the reference's ``flash_attention_jnp`` (no Pallas kernel
exists for it). From the forward's q, k, v and positions, its output and
the LSE that :func:`repro_torch.kernels.flash_attention.flash_fwd` writes
with ``return_lse=True``, and dout, it returns (dq, dk, dv) in the inputs'
dtype. It launches ``delta`` (rowsum(dout * out)), ``dkdv`` and ``dq``, and
``reduce`` after ``dkdv`` when :func:`plan` splits the dk/dv grid; the
dispatch ledger counts each, ``flash_bwd.<pass>``, so a call is one
``flash_bwd.dq`` (:mod:`repro_torch.kernels.build`). Its plain
version is :func:`repro_torch.kernels.ref.flash_bwd_plain`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import build
from .flash_attention import _DTYPES, check_inputs as check_forward_inputs

# The dk/dv pass is split when its grid has fewer CTAs than MIN_WAVES x the
# card's SMs.
MIN_WAVES = 2


class Plan(NamedTuple):
    keys_per_cta: int   # keys of one dk/dv CTA (Tiles<T, HDM>::KN)
    rows_per_block: int  # rows (query position x group head) of one stage
    dkdv_ctas: int      # the dk/dv grid before the split
    splits: int         # CTAs per key tile; above 1, the reduce pass runs


def dkdv_tiles(hd: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(keys a CTA, rows a stage) of the dk/dv pass, as ``Tiles<T, HDM>`` in
    ``csrc/flash_bwd.cu`` has them; the library is held to these when it is
    loaded (``flash_bwd_dkdv_tiles``)."""
    hdm = next(w for w in (32, 64, 128, 256) if hd <= w)
    return (32 if dtype == torch.float32 and hdm > 128 else 64), 32


def device_sms(device: torch.device) -> int:
    """The SMs of a CUDA device, the ``sms`` of :func:`plan`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, hd: int,
         dtype: torch.dtype, *, sms: int) -> Plan:
    """The dk/dv pass's split, from the shapes and the card's ``sms`` alone:
    ``splits`` CTAs per key tile, each taking an equal share of the tile's
    live row blocks, once the unsplit grid is below MIN_WAVES x ``sms``
    CTAs (MQA at batch 1: one kv head), at most one a row block."""
    keys, rows = dkdv_tiles(hd, dtype)
    ctas = -(-Skv // keys) * Hkv * B
    blocks = -(-Sq * (Hq // Hkv) // rows)
    want = MIN_WAVES * sms
    splits = 1 if ctas >= want else max(1, min(-(-want // max(ctas, 1)),
                                                blocks))
    return Plan(keys, rows, ctas, splits)


_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# out, dout, delta; B, Sq, Hq, hd, dtype; stream
_DELTA = [_ptr] * 3 + [_i32] * 5 + [_ptr]
# q, k, v, dout, lse, delta, q_pos, kv_pos, dk, dv, part; B, Sq, Skv, Hq,
# Hkv, hd, dtype, causal, window, splits; logit_cap, scale; stream
_DKDV = [_ptr] * 11 + [_i32] * 10 + [_f32] * 2 + [_ptr]
# part, dk, dv; n; splits, dtype; stream
_REDUCE = [_ptr] * 3 + [ctypes.c_longlong] + [_i32] * 2 + [_ptr]
# q, k, v, dout, lse, delta, q_pos, kv_pos, dq; B, Sq, Skv, Hq, Hkv, hd,
# dtype, causal, window; logit_cap, scale; stream
_DQ = [_ptr] * 9 + [_i32] * 9 + [_f32] * 2 + [_ptr]
# hd, dtype, keys out, rows out
_TILES = [_i32] * 2 + [_ptr] * 2


def _check_tiles() -> None:
    """Raise unless the library tiles the dk/dv pass as :func:`dkdv_tiles`
    says at every head dim the wrapper takes (run when the dk/dv pass is
    first bound)."""
    query = build.entry("flash_bwd_dkdv_tiles", _TILES)
    keys, rows = ctypes.c_int(), ctypes.c_int()
    for dtype, code in _DTYPES.items():
        for hd in range(8, 257, 8):
            rc = query(hd, code, ctypes.byref(keys), ctypes.byref(rows))
            got = (keys.value, rows.value)
            if rc or got != dkdv_tiles(hd, dtype):
                raise RuntimeError(
                    f"flash_bwd: the library tiles dk/dv at hd {hd} {dtype} "
                    f"as {got} (rc {rc}), plan as {dkdv_tiles(hd, dtype)}")


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
    """Launch the kernels on CUDA tensors: (dq, dk, dv) shaped and typed as
    (q, k, v); the dk/dv pass split as :func:`plan` says."""
    check_inputs(q, k, v, out, lse, dout, q_positions, kv_positions, window,
                 logit_cap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd runs on CUDA tensors, not {q.device}")
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    splits = plan(B, Sq, Skv, Hq, Hkv, hd, q.dtype,
                  sms=device_sms(q.device)).splits
    delta = torch.empty_like(lse)
    # fp32 partial dk, dv of each split: [2, splits, B*Skv*Hkv*hd]
    part = (torch.empty((2, splits, k.numel()), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    dtype = _DTYPES[q.dtype]
    window_, cap, scale = window or 0, float(logit_cap or 0.0), float(hd ** -0.5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = build.entry("flash_bwd_delta", _DELTA)(
            out.data_ptr(), dout.data_ptr(), delta.data_ptr(), B, Sq, Hq, hd,
            dtype, stream)
        build.check_launch("flash_bwd.delta", rc)
        rc = build.entry("flash_bwd_dkdv", _DKDV, _check_tiles)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if part is None else part.data_ptr(), B, Sq, Skv, Hq, Hkv,
            hd, dtype, int(causal), window_, splits, cap, scale, stream)
        build.check_launch("flash_bwd.dkdv", rc)
        if part is not None:
            rc = build.entry("flash_bwd_reduce", _REDUCE)(
                part.data_ptr(), dk.data_ptr(), dv.data_ptr(), k.numel(),
                splits, dtype, stream)
            build.check_launch("flash_bwd.reduce", rc)
        rc = build.entry("flash_bwd_dq", _DQ)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), dq.data_ptr(), B, Sq, Skv, Hq, Hkv, hd,
            dtype, int(causal), window_, cap, scale, stream)
        build.check_launch("flash_bwd.dq", rc)
    return dq, dk, dv
