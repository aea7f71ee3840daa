"""Attention for the models: the forward of ``flash_attention_jnp``'s contract.

GQA in grouped form (KV heads never repeated), explicit query and key
positions (kv position -1 marks an empty ring-cache slot), causal and window
masks and a tanh logit cap. It routes through :mod:`repro_torch.kernels.ops`:
the Hopper kernel on the card, the plain version on the CPU. The backward
comes with training (ROADMAP.md, queue 2, K1b).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor
                    ) -> torch.Tensor:
    """q: [B, Sq, Hq, hd]; k, v: [B, Skv, Hkv, hd]; int32 positions [Sq],
    [Skv] -> [B, Sq, Hq, hd] in q.dtype."""
    return ops.attention(q, k, v, causal=causal, window=window,
                         logit_cap=logit_cap, q_positions=q_positions,
                         kv_positions=kv_positions)
