"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

They are the semantics of record for the port: the CPU path runs them, the
CPU tests hold them against the JAX package, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card. Both compute in fp32 and return
``q.dtype``.
"""
from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -1e30


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Unchunked attention with explicit positions (materialises the scores).

    q: [B, Sq, Hq, hd]; k, v: [B, Skv, Hkv, hd]; positions int [Sq] / [Skv],
    kv position -1 marks an empty slot. The scale comes before the softcap,
    which comes before the mask. A row with no valid key gets the mean of V,
    as ``attention_reference`` of the JAX package gives it.
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, dtype=torch.int32, device=q.device)
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    dpos = q_positions[:, None] - kv_positions[None, :]
    valid = (kv_positions[None, :] >= 0).expand(Sq, Skv)
    if causal:
        valid = valid & (dpos >= 0)
    if window is not None:
        valid = valid & (dpos < window)
    s = torch.where(valid, s, torch.full_like(s, MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        logit_cap: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Full-materialisation attention with query positions ``q_offset + i``
    and key positions ``j`` (all keys present). q: [B,Sq,H,hd];
    k,v: [B,Skv,Hkv,hd]."""
    q_pos = q_offset + torch.arange(q.shape[1], dtype=torch.int32,
                                    device=q.device)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return attention_plain(q, k, v, causal=causal, window=window,
                           logit_cap=logit_cap, q_positions=q_pos,
                           kv_positions=kv_pos)
