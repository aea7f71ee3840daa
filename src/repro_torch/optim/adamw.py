"""AdamW with global-norm clipping, cosine schedule, optional int8
gradient compression with error feedback.

The port of ``repro.optim.adamw`` over the same trees (nested dicts of
tensors): the optimizer state mirrors the parameters. Leaves are visited in
``jax.tree_util`` order (dict keys sorted), so :func:`global_norm` sums the
leaves in the reference's order. ``step`` is an int32 scalar tensor, and
the schedule and bias corrections are fp32 tensor arithmetic as in the
reference.

The update is functional: :func:`apply_updates` returns fresh parameter and
moment tensors and never writes into its inputs. The training state store
(``repro_torch.txstore``) publishes every step's tensors by reference, as the
reference publishes immutable jax arrays, so an update in place would change
a snapshot already taken (see ``repro_torch.txstore.store``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

Params = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # int8 gradient compression with error feedback (beyond-paper knob;
    # applies to the DP all-reduce: grads are quantized before the mean)
    compress_grads: bool = False


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """The leaves of nested dicts in ``jax.tree_util`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree: Params, *rest: Params) -> Params:
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def tree_unflatten(template: Params, leaves) -> Params:
    """Nested dicts shaped as ``template`` holding ``leaves``, given in
    :func:`tree_leaves` order."""
    return _build(template, iter(leaves))


def _build(template: Params, it) -> Params:
    # a module-level function: a recursive closure would be a reference
    # cycle holding the leaves until the cyclic garbage collector ran
    if not isinstance(template, dict):
        return next(it)
    built = {key: _build(template[key], it) for key in sorted(template)}
    return {key: built[key] for key in template}


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params: Params) -> Dict[str, Any]:
    def zeros(p):
        return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                              device=a.device), p)
    device = tree_leaves(params)[0].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": zeros(params),
        "v": zeros(params),
    }


def _quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_with_feedback(grads: Params, error: Params
                           ) -> Tuple[Params, Params]:
    """int8 quantize grads + residual error feedback (per-leaf scales)."""

    def one(g, e):
        g = g + e
        q, scale = _quantize_int8(g.float())
        deq = q.float() * scale
        return deq.to(g.dtype), (g - deq).to(g.dtype)

    flat = tree_map(one, grads, error)
    return _unzip(flat, 0), _unzip(flat, 1)


def _unzip(tree, i: int) -> Params:
    """Part ``i`` of every tuple leaf of nested dicts."""
    if isinstance(tree, tuple):
        return tree[i]
    return {key: _unzip(sub, i) for key, sub in tree.items()}


def global_norm(tree: Params) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in leaves))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Params, opt_state: Dict[str, Any],
                  grads: Params
                  ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float()
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"step": step, "m": _unzip(out, 1), "v": _unzip(out, 2)}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return _unzip(out, 0), new_state, metrics
