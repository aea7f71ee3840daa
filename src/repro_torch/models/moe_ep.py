"""Expert-parallel MoE over ``torch.distributed`` (the port of
``repro.models.moe_ep``, which does it with ``shard_map``).

Experts are homed on the ranks of the model group and every token takes its
computation to its experts' home: each rank routes all of its data shard's
tokens (the router is replicated, so every rank computes the same routes and
positions), keeps the assignments to its own experts, runs them and combines
its partial output. One ``all_reduce`` over the model group sums the
partials; its backward is an ``all_reduce`` of the gradient
(:class:`AllReduce`, over ``torch.distributed._functional_collectives``).
No capacity buffer crosses ranks.

When there are fewer experts than ranks, each expert is split column-wise
into ``split`` virtual experts (tensor parallelism inside the expert), an
exact decomposition of the gated FFN:

    silu(x Wg) * (x Wu) Wd  ==  sum_h silu(x Wg_h) * (x Wu_h) Wd_h

so the parameters are stored virtualized, ``[V, D, Fe/split]``
(``Backbone._leaf_specs`` with ``moe_impl="ep"``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from .ffn import (aux_loss, combine, dispatch, expert_ffn, moe_capacity,
                  moe_mlp, route, slot_positions)


class AllReduce(torch.autograd.Function):
    """Sum over ``group``; the gradient is summed over it too (every rank's
    partial output feeds the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return funcol.all_reduce(x, "sum", group).wait()

    @staticmethod
    def backward(ctx, grad):
        return funcol.all_reduce(grad.contiguous(), "sum",
                                 ctx.group).wait(), None


def virtualization(cfg, tp: int) -> Tuple[int, int]:
    """(V, split): virtual expert count and per-expert column split."""
    E = cfg.n_experts
    if E % tp == 0:
        return E, 1
    split = -(-tp // E)
    if (E * split) % tp:
        raise ValueError(f"{cfg.name}: {E} experts split {split} ways do "
                         f"not divide over {tp} ranks")
    return E * split, split


def _local_moe(xt: torch.Tensor, router: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, *, cfg, V: int,
               split: int, tp: int, rank: int, plain: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's part. xt: [T, D], the tokens of this rank's data shard
    (the same on every rank of the model group); router [D, E]; w_*: this
    rank's V / tp virtual experts, [V/tp, D, Fe/split] and [V/tp, Fe/split,
    D]. Returns (this rank's partial y [T, D], aux): the partials of the
    model group's ranks sum to the layer's output. Unsplit experts go
    through :func:`ffn.moe_mlp` with the rank's share (its routed-rows path
    when no gradient is taken, ``plain`` as there); split ones through the
    capacity path's steps here."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    V_loc = V // tp
    base = rank * V_loc
    if split == 1:
        # whole experts: the rank holds [base, base + V_loc), which moe_mlp
        # computes on either of its paths
        y, aux = moe_mlp({"router": router, "w_gate": w_gate, "w_up": w_up,
                          "w_down": w_down}, xt[None], cfg,
                         plain=plain, held=(base, V_loc))
        return y[0], aux
    probs, gate_vals, gate_idx = route(xt, router, K)
    # expert e -> its virtuals e * split + h, in token-major order
    vflat = (gate_idx[..., None] * split
             + torch.arange(split, device=xt.device)).reshape(-1)
    wflat = gate_vals.reshape(-1).repeat_interleave(split)
    C = moe_capacity(T, E, K, cfg.capacity_factor)
    pos = slot_positions(vflat, V)        # the same on every rank
    own = (vflat >= base) & (vflat < base + V_loc)
    keep = own & (pos < C)
    slot_v = torch.where(keep, vflat - base, 0)
    slot_c = torch.where(keep, pos, 0)
    buf = dispatch(xt, keep, slot_v, slot_c, (V_loc, C, D))
    out_buf = expert_ffn(buf, w_gate, w_up, w_down)
    y = combine(out_buf, keep, slot_v, slot_c, wflat, T)
    return y, aux_loss(probs, gate_idx, E)


def moe_mlp_ep(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
               group: Optional[dist.ProcessGroup] = None,
               data_group: Optional[dist.ProcessGroup] = None, *,
               reduce: bool = True, plain: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE. x: [B, S, D] -> (y, aux).

    ``params``: router [D, E]; w_gate / w_up [V, D, Fe_v], w_down [V, Fe_v,
    D], all V virtual experts (this rank takes its own V / tp of them, a
    view) or this rank's own V / tp. ``group`` is the model group (tp = its
    size; None: tp = 1, no collective); ``data_group``, where given,
    averages aux over the data ranks, whose tokens differ. ``reduce=False``
    returns this rank's partial y, unsummed (on a DeviceMesh the backbone
    declares it a partial sum and DTensor sums it). ``plain`` sends whole
    experts' routed rows to their plain version, as :func:`ffn.moe_mlp`'s
    does (``Backbone(kernel_impl="plain")``)."""
    B, S, D = x.shape
    tp = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    V, split = virtualization(cfg, tp)
    held = params["w_gate"].shape[0]
    if held not in (V, V // tp):
        raise ValueError(f"expert leaves hold {held} virtual experts, want "
                         f"{V} (or this rank's {V // tp}) for tp {tp}")
    V_loc = V // tp
    own = (slice(rank * V_loc, (rank + 1) * V_loc) if held == V
           else slice(None))
    y, aux = _local_moe(x.reshape(B * S, D), params["router"],
                        params["w_gate"][own], params["w_up"][own],
                        params["w_down"][own], cfg=cfg, V=V, split=split,
                        tp=tp, rank=rank, plain=plain)
    if group is not None and reduce:
        y = AllReduce.apply(y, group)
    if data_group is not None:
        aux = AllReduce.apply(aux, data_group) / dist.get_world_size(
            data_group)
    return y.reshape(B, S, D), aux
