"""AdamW with global-norm clipping, cosine schedule, optional int8
gradient compression with error feedback.

The port of ``repro.optim.adamw`` over the same trees (nested dicts of
tensors): the optimizer state mirrors the parameters. Leaves are visited in
``jax.tree_util`` order (dict keys sorted), so :func:`global_norm` sums the
leaves in the reference's order. ``step`` is an int32 scalar tensor, and
the schedule and bias corrections are fp32 tensor arithmetic as in the
reference.

Two forms of the update. :func:`apply_updates` is functional, as the
reference's is: it returns fresh parameter and moment tensors and writes
into none of its inputs. :func:`apply_updates_` (and
:func:`compress_with_feedback_` for the error-feedback state) writes the new
values into the tensors it is given, the counterpart of the reference's
train step jitted with ``donate_argnums=(0,)``: XLA writes the new params,
m and v into the donated buffers of the old ones, so a step holds one
training state, not two (12 bytes a parameter less). The two forms do the
same operations in the same order and agree bit for bit.

An in-place function first bumps the version counter of every tensor it
will write (:func:`mark_donated`), before it issues any write, as jax marks
a donated array deleted before the computation runs. The training state
store (``repro_torch.txstore.store``) reads those counters to refuse a
snapshot of a state that a later step has begun to overwrite.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

Params = Any

# elements of a leaf's slice in the in-place update (64 MiB in fp32)
UPDATE_CHUNK = 1 << 24


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
        # zeros_like: a DTensor's moments take its placements
        return tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                        p)
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


def compress_with_feedback_(grads: Params, error: Params) -> Params:
    """:func:`compress_with_feedback` with the new residuals written into
    ``error``'s tensors; returns the dequantized grads (fresh tensors)."""
    mark_donated(error)

    def one(g, e):
        g = g + e
        q, scale = _quantize_int8(g.float())
        deq = q.float() * scale
        e.copy_(g - deq)            # (g - deq).to(g.dtype), g.dtype == e's
        return deq.to(g.dtype)

    return tree_map(one, grads, error)


def mark_donated(tree: Params) -> None:
    """Bump the version counter of every tensor of ``tree`` (of a DTensor,
    its local shard's, which an in-place op writes). An in-place update
    calls it before its first write: a reader that checks the counters after
    copying a tensor (``txstore.store.StateCell.get_host``) then sees every
    write that may have reached its copy, however soon after the write the
    op itself would bump the counter."""
    with torch.no_grad():
        torch.autograd.graph.increment_version(
            [t.to_local() if isinstance(t, DTensor) else t
             for t in tree_leaves(tree)])


def _shard_locals(ts):
    """Plain tensors as they are; DTensors of one mesh and placements as
    their local shards (a pointwise op on them is the DTensor op); else
    None."""
    if not any(isinstance(t, DTensor) for t in ts):
        return ts
    first = ts[0]
    if all(isinstance(t, DTensor) and t.device_mesh == first.device_mesh
           and t.placements == first.placements for t in ts):
        return tuple(t.to_local() for t in ts)
    return None


def _replicated_locals(ts):
    """Scalars (None, plain tensors, replicated DTensors) as plain values;
    None where a DTensor is not replicated."""
    out = []
    for t in ts:
        if isinstance(t, DTensor):
            if not all(p.is_replicate() for p in t.placements):
                return None
            t = t.to_local()
        out.append(t)
    return tuple(out)


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
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm is not None else None)
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    # The reference's operations in its order; a leaf's temporaries are
    # updated in place where they are fresh, and the clip is applied leaf by
    # leaf, so that the update of a large leaf (a 1 B-parameter embedding is
    # 4.2 GB in fp32) holds few copies of it at a time.
    def upd(p, g, m, v):
        g = (g if scale is None else g * scale).float()
        m = (cfg.b1 * m).add_((1 - cfg.b1) * g)
        v = (cfg.b2 * v).add_(torch.square(g).mul_(1 - cfg.b2))
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        return (p.float() - delta.mul_(lr)).to(p.dtype), m, v

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    new_state = {"step": step, "m": _unzip(out, 1), "v": _unzip(out, 2)}
    metrics = {"grad_norm": gnorm, "lr": lr}
    return _unzip(out, 0), new_state, metrics


@torch.no_grad()
def apply_updates_(cfg: AdamWConfig, params: Params,
                   opt_state: Dict[str, Any], grads: Params
                   ) -> Dict[str, torch.Tensor]:
    """:func:`apply_updates` written into ``params``, ``opt_state["m"]``,
    ``opt_state["v"]`` and ``opt_state["step"]``; returns the metrics. Bit
    for bit the functional update: the same operations in the same order
    (no fused op that rounds once where it rounds twice), a bf16 parameter
    cast back from fp32 by ``copy_`` as by ``.to``. Every operation after
    the norm is elementwise, so each leaf is updated in slices of
    :data:`UPDATE_CHUNK` elements (of a DTensor leaf, its local shard's,
    where the grads and moments share its placements): the update holds two
    fp32 temporaries of a slice at a time, however large the leaf."""
    mark_donated({"params": params, "opt": opt_state})
    step = opt_state["step"].add_(1)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
             if cfg.clip_norm is not None else None)
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v, scale, lr, b1c, b2c):
        g = (g if scale is None else g * scale).float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        del g
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.float())
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p.float() - delta.mul_(lr))

    consts = (scale, lr, b1c, b2c)
    local_consts = _replicated_locals(consts)
    for leaf in zip(tree_leaves(params), tree_leaves(grads),
                    tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])):
        local = _shard_locals(leaf)
        if local is None or local_consts is None or not all(
                local[i].is_contiguous() for i in (0, 2, 3)):
            upd(*leaf, *consts)
            continue
        p, g, m, v = local
        flat = (p.view(-1), g.reshape(-1), m.view(-1), v.view(-1))
        for i in range(0, p.numel(), UPDATE_CHUNK):
            upd(*(t[i:i + UPDATE_CHUNK] for t in flat), *local_consts)
    return {"grad_norm": gnorm, "lr": lr}
