"""Step functions: train_step / prefill_step / decode_step builders.

The port of ``repro.runtime.steps``: the train loop executes these. A step
takes the state ``{params, opt: {step, m, v}, error?}`` and a batch of numpy
arrays (or tensors) and returns a fresh state; it writes into none of its
inputs (see ``repro_torch.txstore.store`` for why). There is no ``jit``:
PyTorch runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.backbone import Backbone
from repro_torch.optim import adamw

Params = Any


@dataclass(frozen=True)
class StepSettings:
    """Schedule/memory knobs — the §Perf hillclimb levers.

    The reference's fields and defaults. ``zero3``, ``gather_weights`` and
    ``moe_ep`` act on a device mesh, and at world size 1 they have no effect
    here until slice 8 (distribution, ROADMAP.md). ``remat`` and
    ``remat_policy`` are read by the ``Backbone`` (its ``remat`` argument),
    as in the reference."""

    zero3: bool = True          # ZeRO-3 "data"-sharded parameters
    gather_weights: bool = True  # per-layer weight all-gather in the scan body
    remat: bool = True
    remat_policy: str = "full"  # full | dots (save matmul outputs)
    compress_grads: bool = False
    moe_ep: bool = True         # expert-parallel MoE via shard_map (§Perf)
    microbatches: int = 1       # gradient accumulation: divides the saved-
    # activation peak by k at the cost of k sequential sub-steps


def value_and_grad(bb: Backbone, params: Params, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, Params]:
    """(loss, grads) of ``bb.loss_fn`` at ``params``; grads as the params'
    tree, in their dtype. The params are not touched: autograd runs on
    detached aliases of them."""
    tracked = adamw.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = bb.loss_fn(tracked, batch)
    grads = torch.autograd.grad(loss, adamw.tree_leaves(tracked))
    return loss.detach(), adamw.tree_unflatten(params, grads)


def make_train_step(bb: Backbone, opt_cfg: adamw.AdamWConfig,
                    settings: StepSettings = StepSettings()
                    ) -> Callable:
    """(state, batch) -> (state, metrics); state = {params, opt, error?}."""

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        k = settings.microbatches
        if k > 1:
            # gradient accumulation over k microbatch slices: fp32 sums,
            # then / k, as the reference's scan over microbatches
            grads = adamw.tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), state["params"])
            loss = torch.zeros((), dtype=torch.float32, device=bb.device)
            for i in range(k):
                mb = {name: a[i * (len(a) // k):(i + 1) * (len(a) // k)]
                      for name, a in batch.items()}
                l, g = value_and_grad(bb, state["params"], mb)
                grads = adamw.tree_map(torch.add, grads, g)
                loss = loss + l
            grads = adamw.tree_map(lambda g: g / k, grads)
            loss = loss / k
        else:
            loss, grads = value_and_grad(bb, state["params"], batch)
        if settings.compress_grads:
            grads, err = adamw.compress_with_feedback(grads, state["error"])
        new_params, new_opt, metrics = adamw.apply_updates(
            opt_cfg, state["params"], state["opt"], grads)
        new_state = {"params": new_params, "opt": new_opt}
        if settings.compress_grads:
            new_state["error"] = err
        metrics = dict(metrics, loss=loss)
        return new_state, metrics

    return train_step


def init_train_state(bb: Backbone, seed: int = 0,
                     settings: StepSettings = StepSettings(), *,
                     device=None) -> Dict[str, Any]:
    """``bb.init(seed)`` and a fresh optimizer state; ``device="meta"``
    gives the state's shapes and dtypes without memory (the counterpart of
    ``train_state_specs``)."""
    params = bb.init(seed, device=device)
    state = {"params": params, "opt": adamw.init_state(params)}
    if settings.compress_grads:
        state["error"] = adamw.tree_map(
            lambda a: torch.zeros(a.shape, dtype=a.dtype, device=a.device),
            params)
    return state


def make_prefill_step(bb: Backbone, ctx: int) -> Callable:
    def prefill_step(params, batch):
        return bb.prefill(params, batch, ctx)

    return prefill_step


def make_decode_step(bb: Backbone) -> Callable:
    def decode_step(params, cache, tokens):
        return bb.decode_step(params, cache, tokens)

    return decode_step
