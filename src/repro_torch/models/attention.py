"""Attention for the models: ``flash_attention_jnp``'s contract, with its
flash backward.

GQA in grouped form (KV heads never repeated), explicit query and key
positions (kv position -1 marks an empty ring-cache slot), causal and window
masks and a tanh logit cap. It routes through :mod:`repro_torch.kernels.ops`:
the Hopper kernels on the card, the plain versions on the CPU.

When autograd needs its gradient (grad enabled and q, k or v requiring it),
the call goes through :class:`FlashAttention`, the counterpart of the
reference's ``jax.custom_vjp`` (``src/repro/models/attention.py:80-105``):
the forward is ``flash_fwd`` with the LSE (at any Sq, one query position
too), the backward K1b. Otherwise (serving) it is ``ops.attention``, which
writes no LSE and sends one query position to ``flash_decode``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops, ref


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v); saves q, k, v, the positions, out and the
    LSE, and recomputes the scores in the backward. ``plain`` runs both
    halves' plain versions (``ref.attention_lse_plain``,
    ``ref.flash_bwd_plain``) on any device, to hold the kernels' gradients
    against them."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_positions, causal, window,
                logit_cap, plain):
        kw = dict(causal=causal, window=window, logit_cap=logit_cap,
                  q_positions=q_positions, kv_positions=kv_positions)
        fwd = ref.attention_lse_plain if plain else ops.attention_fwd
        out, lse = fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, q_positions, kv_positions, out, lse)
        ctx.opts = (causal, window, logit_cap, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_positions, kv_positions, out, lse = ctx.saved_tensors
        causal, window, logit_cap, plain = ctx.opts
        bwd = ref.flash_bwd_plain if plain else ops.attention_bwd
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), causal=causal,
                         window=window, logit_cap=logit_cap,
                         q_positions=q_positions, kv_positions=kv_positions)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """q: [B, Sq, Hq, hd]; k, v: [B, Skv, Hkv, hd]; int32 positions [Sq],
    [Skv] -> [B, Sq, Hq, hd] in q.dtype. ``plain`` sends the call to the
    plain versions whatever the device."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, q_positions, kv_positions, causal,
                                    window, logit_cap, plain)
    attend = ref.attention_plain if plain else ops.attention
    return attend(q, k, v, causal=causal, window=window, logit_cap=logit_cap,
                  q_positions=q_positions, kv_positions=kv_positions)
