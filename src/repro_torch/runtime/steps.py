"""Step functions: train_step / prefill_step / decode_step builders.

The port of ``repro.runtime.steps``: the train loop executes these. A step
takes the state ``{params, opt: {step, m, v}, error?}`` and a batch of numpy
arrays (or tensors) and returns the state after it. There is no ``jit``:
PyTorch runs eagerly. The reference's step is pure, and its callers choose
donation when they jit it (``donate_argnums=(0,)``: the Trainer and the dry
run's train cells); the port's ``make_train_step`` takes that choice as
``donate``: a functional step returns fresh tensors, a donating one writes
the new state into the tensors it was given (``adamw.apply_updates_``).
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
    ``moe_ep`` act through the mesh, as the callers that build the
    ``Backbone`` and place the state read them (``launch/dryrun.py``,
    ``launch/train.py``): ZeRO-3 parameter shardings
    (``launch.shardings.param_shardings``), the per-layer gather
    (``make_param_gatherer``, the Backbone's ``param_gather``) and
    ``moe_impl="ep"``. ``remat`` and ``remat_policy`` are the ``Backbone``'s
    arguments of those names; the dry run passes both on, as the
    reference's does, and ``launch/train.py`` passes ``remat`` only (the
    policy stays "full"), as the reference's does."""

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
    with bb.dist_context():
        loss = bb.loss_fn(tracked, batch)
        grads = torch.autograd.grad(loss, adamw.tree_leaves(tracked))
    return loss.detach(), adamw.tree_unflatten(params, grads)


def make_train_step(bb: Backbone, opt_cfg: adamw.AdamWConfig,
                    settings: StepSettings = StepSettings(),
                    donate: bool = False) -> Callable:
    """(state, batch) -> (state, metrics); state = {params, opt, error?}.

    ``donate=False``: the returned state is fresh tensors, and the given
    state is left as it was. ``donate=True``, the counterpart of
    ``jax.jit(step, donate_argnums=(0,))``: the new params, m, v, step (and
    error) are written into the given state's tensors, which the step
    returns (the same dicts), bit for bit the functional step's values; the
    state before the step is gone, and the card holds one state."""

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
        with bb.dist_context():
            if donate:
                if settings.compress_grads:
                    grads = adamw.compress_with_feedback_(grads,
                                                          state["error"])
                metrics = adamw.apply_updates_(opt_cfg, state["params"],
                                               state["opt"], grads)
                return state, dict(metrics, loss=loss)
            if settings.compress_grads:
                grads, err = adamw.compress_with_feedback(grads,
                                                          state["error"])
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
