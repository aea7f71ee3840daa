"""Feed-forward layers: gated MLPs. (The MoE layer waits for its slice.)"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def gated_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, kind: str
              ) -> torch.Tensor:
    """SwiGLU / GeGLU / GELU MLP. x: [..., D]. ``jax.nn.gelu`` is the tanh
    approximation, so GELU here is too."""
    if kind in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        up = x @ params["w_up"]
        act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
        return (act * up) @ params["w_down"]
    hidden = x @ params["w_gate"]
    if "b_gate" in params:
        hidden = hidden + params["b_gate"]
    out = F.gelu(hidden, approximate="tanh") @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"]
    return out
