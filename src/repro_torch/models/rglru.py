"""RG-LRU building blocks (Griffin / RecurrentGemma): the causal conv1d and
the scan with its gradient.

The port of ``repro.models.rglru.causal_conv1d``. The recurrent block itself
is ``Backbone._rglru_apply`` (block-diagonal gates), as in the reference,
whose ``recurrent_block`` reads leaves that its ``_leaf_specs`` never makes
and is not ported. Serving calls :func:`repro_torch.kernels.ops.rglru_scan`,
which writes the state in place; training calls :class:`RGLRUScan`, whose
backward is K2b (``kernels/rglru_bwd.py``) where the reference takes
``jax.grad`` through its ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops, ref


def causal_conv1d(params: Dict[str, torch.Tensor], x: torch.Tensor,
                  conv_state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: [B,T,W]; conv_state: [B,K-1,W] (the last
    K-1 inputs before x) -> (out [B,T,W] in x's dtype, new state [B,K-1,W])."""
    w = params["conv_w"]                                  # [K, W]
    K, T = w.shape[0], x.shape[1]
    xin = torch.cat([conv_state, x], dim=1)               # [B, T+K-1, W]
    out = sum(xin[:, i:i + T, :] * w[i] for i in range(K))
    out = out + params["conv_b"]
    new_state = xin[:, -(K - 1):, :] if K > 1 else conv_state
    return out.to(x.dtype), new_state


class RGLRUScan(torch.autograd.Function):
    """(y, h_T) = rglru_scan(x, a_log, gate_r, gate_i, h0) with its gradient:
    the counterpart of :class:`repro_torch.models.attention.FlashAttention`
    for the RG-LRU. It saves the inputs and y (the h sequence, which the
    backward reads for h_{t-1}) and writes no state in place, so remat may
    run the forward twice. ``plain`` runs both halves' plain versions
    (``ref.rglru_scan_plain``, ``ref.rglru_scan_bwd_plain``) on any device,
    to hold the kernels' gradients against them."""

    @staticmethod
    def forward(ctx, x, a_log, gate_r, gate_i, h0, plain):
        scan = ref.rglru_scan_plain if plain else ops.rglru_scan
        y, h = scan(x, a_log, gate_r, gate_i, h0)
        ctx.save_for_backward(x, a_log, gate_r, gate_i, h0, y)
        ctx.plain = plain
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        bwd = ref.rglru_scan_bwd_plain if ctx.plain else ops.rglru_scan_bwd
        grads = bwd(*ctx.saved_tensors, dy.contiguous(), dh.contiguous())
        return (*grads, None)
