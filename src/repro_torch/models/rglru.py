"""RG-LRU building block (Griffin / RecurrentGemma): the causal conv1d.

The port of ``repro.models.rglru.causal_conv1d``. The recurrent block itself
is ``Backbone._rglru_apply`` (block-diagonal gates), as in the reference,
whose ``recurrent_block`` reads leaves that its ``_leaf_specs`` never makes
and is not ported. The scan runs through
:func:`repro_torch.kernels.ops.rglru_scan`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


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
