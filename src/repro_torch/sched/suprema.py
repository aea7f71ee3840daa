"""Suprema derivation for training-step transactions (DESIGN.md §2.2).

The port of ``repro.sched.suprema``. OptSVA-CF's early release depends on
*a-priori knowledge* of access counts (paper §2.2: suprema from the
programmer, a type checker, or static analysis). For a training step this
knowledge is exact and derivable from the model structure — this module is
the "static analyzer" for our domain:

* each layer-block's weights are **read** once in forward, once in backward,
  and once more when rematerialized;
* each block's gradient is **written** once, at a known point in backward
  (→ release the gradient object immediately after: the per-layer
  reduce-scatter schedule);
* the optimizer **updates** each parameter exactly once per step.

``step_suprema`` returns these bounds per parameter group; the transactional
store uses them to declare trainer transactions, and the overlap schedule in
``repro_torch.launch.shardings`` is their data-plane transcription (the
per-layer weight all-gather of ``make_param_gatherer`` = asynchronous
read-only buffering; its backward, the per-layer gradient reduce-scatter =
early release on last write).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.api import Suprema
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class StepAccessPlan:
    """Per-parameter-group access bounds for one training step."""

    weight_reads: int          # forward + backward (+ remat)
    grad_writes: int           # one per step, at last-backward-use
    optimizer_updates: int     # one per step

    def as_suprema(self) -> Suprema:
        return Suprema(reads=self.weight_reads, writes=self.grad_writes,
                       updates=self.optimizer_updates)


def step_suprema(cfg: ModelConfig, *, remat: bool = True
                 ) -> Dict[str, StepAccessPlan]:
    """Exact access bounds per group for one train step."""
    reads = 3 if remat else 2  # fwd, (remat-fwd), bwd
    plan: Dict[str, StepAccessPlan] = {}
    for gi, _ in enumerate(cfg.groups):
        plan[f"g{gi}"] = StepAccessPlan(reads, 1, 1)
    plan["embed"] = StepAccessPlan(2, 1, 1)   # in-embed + logits head (tied)
    plan["final_norm"] = StepAccessPlan(reads, 1, 1)
    return plan


def release_points(cfg: ModelConfig) -> Dict[str, str]:
    """Where each group's gradient reaches its write supremum — i.e. where
    the early-release (reduce-scatter) fires. Groups release in reverse
    group order during backward; within a group, per layer."""
    order = {}
    n = len(cfg.groups)
    for gi in range(n):
        order[f"g{gi}"] = (f"backward scan iteration of group {gi} "
                           f"(fires {n - gi}-th from step end, per layer)")
    return order
