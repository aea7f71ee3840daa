"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The rule: a tensor on the CPU goes to the plain version (``ref.py``); a CUDA
tensor goes to the kernel, which launches or raises. There is no override
and no fallback. The models only ever call these functions.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as fa
from . import ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: Optional[float] = None,
              q_positions: torch.Tensor, kv_positions: torch.Tensor
              ) -> torch.Tensor:
    """Attention with explicit int32 positions (kv position -1: empty slot).

    q: [B,Sq,Hq,hd]; k, v: [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype.
    """
    if q.device.type == "cpu":
        if any(t.device != q.device for t in (k, v, q_positions, kv_positions)):
            raise ValueError("all inputs must be on one device")
        return ref.attention_plain(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap,
                                   q_positions=q_positions,
                                   kv_positions=kv_positions)
    return fa.flash_fwd(q, k, v, causal=causal, window=window,
                        logit_cap=logit_cap, q_positions=q_positions,
                        kv_positions=kv_positions)


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
