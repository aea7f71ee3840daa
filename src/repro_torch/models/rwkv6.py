"""RWKV-6 ("Finch") blocks: data-dependent-decay linear attention.

The port of ``repro.models.rwkv6``. Time mixing keeps a per-head state
``S [hd, hd]`` (k-major)::

    y_t = (S_{t-1} + (u ⊙ k_t) v_tᵀ)ᵀ r_t
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

with the decay ``w_t = exp(-exp(w0 + A_w tanh(x̃_t B_w)))`` in fp32 and a
LoRA-modulated token shift (ddlerp). The recurrence runs through ``scan``,
:func:`repro_torch.kernels.ops.rwkv6_scan` unless the caller passes another:
serving one that writes the state in place, training :class:`WKVScan`, whose
backward is K3b (``kernels/rwkv6_bwd.py``) where the reference takes
``jax.grad`` through its ``lax.scan``.

JAX promotes mixed dtypes where PyTorch raises: the scan's ``y`` is fp32 and
the gate ``g`` is in the compute dtype, so JAX computes ``y * g`` and
``@ w_o`` in fp32. The port does the same explicitly, and the caller casts
the result to the residual's dtype.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

from .common import rms_norm


def _lora(x, a, b):
    """LoRA modulation: tanh(x @ a) @ b."""
    return torch.tanh(x @ a) @ b


def _ddlerp(x, x_prev, mu, a, b):
    """Finch data-dependent lerp between x_t and x_{t-1}."""
    base = x_prev + (x - x_prev) * mu
    mix = mu + _lora(base, a, b)
    return x_prev + (x - x_prev) * mix


def _shifted(x: torch.Tensor, shift_state: torch.Tensor) -> torch.Tensor:
    """x_{t-1} for every t: the state, then x without its last step."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def time_mix(params: Dict, x: torch.Tensor, shift_state: torch.Tensor,
             wkv_state: torch.Tensor, n_heads: int, head_dim: int, *,
             scan: Callable = ops.rwkv6_scan
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RWKV-6 attention analogue.

    x: [B,T,D]; shift_state: [B,D] (x_{-1}); wkv_state: [B,H,hd,hd] fp32;
    ``scan(r, k, v, w, u, state) -> (y, S_T)``. Returns (y [B,T,D] fp32, new
    shift state [B,D], new wkv state).
    """
    B, T, _ = x.shape
    H, hd = n_heads, head_dim
    x_prev = _shifted(x, shift_state)
    mixed = {n: _ddlerp(x, x_prev, params[f"mu_{n}"], params["dd_a"],
                        params[f"dd_b_{n}"])
             for n in ("r", "k", "v", "g", "w")}
    r = (mixed["r"] @ params["w_r"]).reshape(B, T, H, hd)
    k = (mixed["k"] @ params["w_k"]).reshape(B, T, H, hd)
    v = (mixed["v"] @ params["w_v"]).reshape(B, T, H, hd)
    g = F.silu(mixed["g"] @ params["w_g"])
    # data-dependent decay (the Finch mechanism), in fp32
    w_raw = params["w0"] + _lora(mixed["w"], params["wd_a"], params["wd_b"])
    w = torch.exp(-torch.exp(w_raw.float())).reshape(B, T, H, hd)
    y, wkv = scan(r, k, v, w, params["u"].reshape(H, hd), wkv_state)
    # per-head group norm, then the gate and the output projection in fp32
    y = rms_norm(y, params["ln_x"].reshape(H, hd), eps=1e-5)
    y = y.reshape(B, T, H * hd) * g.float()
    return y @ params["w_o"].float(), x[:, -1, :], wkv


def channel_mix(params: Dict, x: torch.Tensor, shift_state: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 FFN analogue (squared ReLU with a receptance gate)."""
    x_prev = _shifted(x, shift_state)
    xk = x_prev + (x - x_prev) * params["mu_k"]
    xr = x_prev + (x - x_prev) * params["mu_r"]
    rgate = torch.sigmoid(xr @ params["w_rgate"])
    hidden = torch.square(torch.relu(xk @ params["w_in"]))
    return rgate * (hidden @ params["w_out"]), x[:, -1, :]


class WKVScan(torch.autograd.Function):
    """(y, S_T) = rwkv6_scan(r, k, v, w, u, state) with its gradient: the
    counterpart of :class:`repro_torch.models.attention.FlashAttention` for
    the WKV. It saves the inputs and the initial state (the backward
    recomputes the states from them) and writes no state in place, so remat
    may run the forward twice. ``plain`` runs both halves' plain versions
    (``ref.rwkv6_scan_plain``, ``ref.rwkv6_scan_bwd_plain``) on any device."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, plain):
        scan = ref.rwkv6_scan_plain if plain else ops.rwkv6_scan
        y, s = scan(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.plain = plain
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        bwd = ref.rwkv6_scan_bwd_plain if ctx.plain else ops.rwkv6_scan_bwd
        grads = bwd(*ctx.saved_tensors, dy.contiguous(), ds.contiguous())
        return (*grads, None)
