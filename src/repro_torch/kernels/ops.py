"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The rule: a tensor on the CPU goes to the plain version (``ref.py``); a CUDA
tensor goes to the kernel, which launches or raises. There is no override
and no fallback. The models only ever call these functions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import flash_attention as fa
from . import flash_decode as fd
from . import ref, rglru, rwkv6


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: Optional[float] = None,
              q_positions: torch.Tensor, kv_positions: torch.Tensor
              ) -> torch.Tensor:
    """Attention with explicit int32 positions (kv position -1: empty slot).

    q: [B,Sq,Hq,hd]; k, v: [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype. On
    the card, Sq == 1 runs ``flash_decode`` and any other Sq ``flash_fwd``.
    """
    if q.device.type == "cpu":
        _same_device(q, k, v, q_positions, kv_positions)
        return ref.attention_plain(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap,
                                   q_positions=q_positions,
                                   kv_positions=kv_positions)
    # by shape: one query position (a decode step) splits the keys across
    # CTAs; more (prefill) tile the query rows
    kernel = fd.flash_decode if q.shape[1] == 1 else fa.flash_fwd
    return kernel(q, k, v, causal=causal, window=window, logit_cap=logit_cap,
                  q_positions=q_positions, kv_positions=kv_positions)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """The signature of ``repro.kernels.ops.flash_attention``: query
    positions ``q_offset + i``, key positions ``j``."""
    q_positions = q_offset + torch.arange(q.shape[1], dtype=torch.int32,
                                          device=q.device)
    kv_positions = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return attention(q, k, v, causal=causal, window=window,
                     logit_cap=logit_cap, q_positions=q_positions,
                     kv_positions=kv_positions)


def _same_device(first: torch.Tensor, *rest: Optional[torch.Tensor]) -> None:
    if any(t is not None and t.device != first.device for t in rest):
        raise ValueError("all inputs must be on one device")


def rglru_scan(x: torch.Tensor, a_log: torch.Tensor, gate_r: torch.Tensor,
               gate_i: torch.Tensor, h0: torch.Tensor, *,
               h_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU scan. x, gate_r, gate_i: [B,T,W]; a_log: [W]; h0: [B,W]
    fp32 -> (y [B,T,W] fp32, h_T [B,W] fp32), h_T written into ``h_out``
    when one is given (it may be ``h0``)."""
    if x.device.type == "cpu":
        _same_device(x, a_log, gate_r, gate_i, h0, h_out)
        return ref.rglru_scan_plain(x, a_log, gate_r, gate_i, h0, h_out=h_out)
    return rglru.rglru_scan(x, a_log, gate_r, gate_i, h0, h_out=h_out)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               state_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV scan. r, k, v, w: [B,T,H,hd]; u: [H,hd]; state [B,H,hd,hd]
    fp32 -> (y [B,T,H,hd] fp32, S_T fp32), S_T written into ``state_out``
    when one is given (it may be ``state``)."""
    if r.device.type == "cpu":
        _same_device(r, k, v, w, u, state, state_out)
        return ref.rwkv6_scan_plain(r, k, v, w, u, state, state_out=state_out)
    return rwkv6.wkv6_scan(r, k, v, w, u, state, state_out=state_out)
