"""Shared model building blocks: device, norms, RoPE, initialisers."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default; with no card
    it raises (it never falls back to the CPU, which must be asked for)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch path on the CPU")
    return device


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in fp32 with the ``(1 + scale)`` offset, cast back to x's
    dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def stable_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         final_cap: Optional[float] = None) -> torch.Tensor:
    """Mean token cross-entropy: fp32 logits, optional final softcap, mean
    of logsumexp - gold logit (``repro.models.common.stable_cross_entropy``).

    DTensor logits (vocab-sharded on a mesh) take the vocab-parallel form:
    each rank's logsumexp over its own shard, then the shards' log-sum-exp,
    and the gold logit as a masked sum (exact: one term is not 0); on one
    rank both equal the plain form bit for bit. DTensor would gather the
    whole vocabulary for ``torch.logsumexp``, and the backward of a gather
    makes a replicated buffer of the global logits' shape."""
    logits = softcap(logits.float(), final_cap)
    labels = labels.long()[..., None]
    if isinstance(logits, DTensor):
        places = logits.placements
        part = local_map(lambda t: torch.logsumexp(t, dim=-1, keepdim=True),
                         out_placements=(places,), in_placements=(places,),
                         device_mesh=logits.device_mesh)(logits)
        top = torch.amax(part, dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(part - top), dim=-1,
                                  keepdim=True)) + top
        vocab = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.sum(torch.where(vocab == labels, logits, 0.0), dim=-1,
                         keepdim=True)
        return torch.mean((lse - gold)[..., 0])
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels)[..., 0]
    return torch.mean(lse - gold)


# --------------------------------------------------------------------------- #
# RoPE                                                                        #
# --------------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, rotary_pct: float = 1.0,
               device=None) -> Tuple[int, torch.Tensor]:
    """Return (#rotary dims, inverse frequencies [rot/2]), in fp32 as JAX
    computes them. ``theta`` is made on the device (a fill, not a copy from
    the host), so that a CUDA graph can capture the table."""
    rot = int(head_dim * rotary_pct)
    rot -= rot % 2
    exponent = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                     device=device), exponent)
    return rot, inv


def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               rotary_pct: float = 1.0):
    """(rot, cos, sin) for ``positions`` [..., S]: cos/sin [..., S, 1, rot/2]
    in fp32, broadcasting over heads. A forward pass builds it once and
    applies it in every layer."""
    rot, inv = rope_freqs(head_dim, theta, rotary_pct, device=positions.device)
    ang = positions[..., :, None].float() * inv          # [..., S, rot/2]
    return rot, torch.cos(ang)[..., :, None, :], torch.sin(ang)[..., :, None, :]


def apply_rope_table(x: torch.Tensor, table) -> torch.Tensor:
    """Rotary embedding, split halves, from a :func:`rope_table`. ``x``:
    [..., S, H, hd]; the tail past ``rot`` passes through."""
    rot, cos, sin = table
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_pct: float = 1.0) -> torch.Tensor:
    """Rotary embedding. ``x``: [..., S, H, hd]; ``positions``: [..., S]."""
    return apply_rope_table(x, rope_table(positions, x.shape[-1], theta,
                                          rotary_pct))


# --------------------------------------------------------------------------- #
# Initialisation (a torch.Generator: it cannot reproduce jax.random, so       #
# parity tests graft the JAX init through repro_torch.bridge)                  #
# --------------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape: Tuple[int, ...], in_axis: int = -2,
               dtype=torch.float32, device=None) -> torch.Tensor:
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # in place: a stacked leaf of a wide model is tens of GB in fp32
    return x.mul_(fan_in ** -0.5).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.float32, device=None) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * 0.02).to(dtype)
