"""Feed-forward layers: gated MLPs and capacity-routed MoE.

The port of ``repro.models.ffn``. The MoE layer routes each token to its
top-k experts in fp32, gives each (token, k) assignment a position inside
its expert from a token-major cumulative count, scatters the assignments
into an ``[E, C, D]`` capacity buffer, runs the experts as batched matrix
products (``torch.bmm``: the reference leaves its einsums to XLA, so no
kernel is owed) and gathers and combines the outputs by the renormalised
gate values. Assignments past an expert's capacity ``C`` are dropped, as
the reference drops them; the router keeps the Switch load-balancing loss.
Every shape is fixed by (T, E, K, C), so the layer never syncs with the
host. :mod:`repro_torch.models.moe_ep` builds its expert-parallel form from
the same steps. With ``txtrace.enabled``, :func:`moe_mlp` records its steps
as the spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` (:mod:`repro_torch.obs.hostspans`; detail: the tokens T and
the capacity rows E·C).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.obs import hostspans, txtrace

from .remat import residual_product


def gated_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, kind: str
              ) -> torch.Tensor:
    """SwiGLU / GeGLU / GELU MLP. x: [..., D]. ``jax.nn.gelu`` is the tanh
    approximation, so GELU here is too. The down projection is the output
    product (``remat.residual_product``)."""
    if kind in ("swiglu", "geglu"):
        gate = x @ params["w_gate"]
        up = x @ params["w_up"]
        act = F.silu(gate) if kind == "swiglu" else F.gelu(gate, approximate="tanh")
        with residual_product():
            return (act * up) @ params["w_down"]
    hidden = x @ params["w_gate"]
    if "b_gate" in params:
        hidden = hidden + params["b_gate"]
    with residual_product():
        out = F.gelu(hidden, approximate="tanh") @ params["w_down"]
    if "b_down" in params:
        out = out + params["b_down"]
    return out


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Slots an expert has for ``n_tokens`` tokens: ``int()`` truncates, as
    the reference's does, and never fewer than ``top_k`` or 8."""
    cap = int(n_tokens * top_k / n_experts * capacity_factor)
    return max(cap, top_k, 8)


def _router_logits(xt: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """``xt @ router`` in full fp32 whatever the caller set for TF32: a TF32
    product moves a logit by about 1e-3, which flips routes whose top-k
    probabilities are that close. (The backward of this product runs under
    the caller's setting; it moves gradients, not routes.)"""
    xt, router = xt.float(), router.float()
    if not xt.is_cuda:
        return xt @ router
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        return xt @ router
    finally:
        matmul.allow_tf32 = before


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their indices, in
    descending order, ties to the lower index as ``jax.lax.top_k`` breaks
    them (``torch.topk`` does not promise an order among ties): the first
    ``k`` of a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(xt: torch.Tensor, router: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs [T, E] fp32, gate values [T, k] renormalised to sum 1, expert
    indices [T, k]) for tokens ``xt`` [T, D]."""
    probs = torch.softmax(_router_logits(xt, router), dim=-1)
    gate_vals, gate_idx = top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def slot_positions(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Position of each assignment inside its destination (an expert, or a
    virtual expert): the running count of earlier assignments to it, in
    the token-major flat order of ``dest`` [N]. The reference's cumulative
    one-hot, held transposed, [n_dest, N], so that the count runs along the
    innermost dimension: along the outer one CUDA's scan walks each of the
    few columns with one thread (1.5 ms a layer of mixtral's 4200-token
    prefill on an H100, against 0.03 ms this way)."""
    hits = dest[None, :] == torch.arange(n_dest, device=dest.device)[:, None]
    counts = torch.cumsum(hits, dim=1)
    return torch.gather(counts, 0, dest[None, :])[0] - 1


def dispatch(xt: torch.Tensor, keep: torch.Tensor, dest: torch.Tensor,
             slot: torch.Tensor, shape: Tuple[int, int, int]) -> torch.Tensor:
    """Scatter the N assignments of the tokens ``xt`` [T, D] (token-major,
    N / T a token) into a zero buffer ``shape`` = (E, C, D) at (``dest``,
    ``slot``). The reference adds each dropped assignment, zeroed, at a
    stand-in slot (``.at[].add``); here the dropped ones all go to one spare
    row past the buffer and the kept ones, each to a slot of its own, are
    copied, not added: the same buffer, with no sort of the indices (which
    an accumulating scatter needs) and no mask taken on the host."""
    E, C, D = shape
    src = xt.repeat_interleave(dest.shape[0] // xt.shape[0], 0)
    rows = torch.where(keep, dest * C + slot, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=src.dtype, device=src.device)
    return buf.index_put((rows,), src)[:-1].view(E, C, D)


def expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    """The batched SwiGLU experts: buf [E, C, D] -> [E, C, D]."""
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def combine(out_buf: torch.Tensor, keep: torch.Tensor, dest: torch.Tensor,
            slot: torch.Tensor, weights: torch.Tensor, n_tokens: int
            ) -> torch.Tensor:
    """Gather each assignment's expert output, zero the dropped ones, weight
    by ``weights`` [N] (cast to the activations' dtype first) and sum each
    token's N / n_tokens assignments: [n_tokens, D]."""
    gathered = out_buf[dest, slot]
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    w = weights[:, None].to(gathered.dtype)
    return (gathered * w).reshape(n_tokens, -1, gathered.shape[-1]).sum(1)


def aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor, n_experts: int
             ) -> torch.Tensor:
    """Switch load-balancing loss, E * sum(density of the top-1 choice *
    mean probability); at least 1, equal to 1 when balanced."""
    density = F.one_hot(gate_idx[:, 0], n_experts).float().mean(0)
    return torch.sum(density * probs.mean(0)) * n_experts


def moe_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
            shard=lambda a, name: a) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE. x: [B, S, D] -> (y [B, S, D], aux loss fp32).
    ``params``: router [D, E], w_gate / w_up [E, D, Fe], w_down [E, Fe, D].
    ``shard(buf, "moe_buf")`` places the capacity buffers (the backbone's
    sharder: experts over "model" on a mesh)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    C = moe_capacity(T, E, K, cfg.capacity_factor)
    traced = txtrace.enabled
    if traced:
        span = hostspans.begin("moe.route", f"T={T} EC={E * C}")
    probs, gate_vals, gate_idx = route(xt, params["router"], K)
    if traced:
        span = hostspans.then(span, "moe.dispatch")
    flat_idx = gate_idx.reshape(-1)                              # [T*K]
    pos = slot_positions(flat_idx, E)
    keep = pos < C
    safe_pos = torch.where(keep, pos, 0)
    buf = shard(dispatch(xt, keep, flat_idx, safe_pos, (E, C, D)), "moe_buf")
    if traced:
        span = hostspans.then(span, "moe.experts")
    out_buf = shard(expert_ffn(buf, params["w_gate"], params["w_up"],
                               params["w_down"]), "moe_buf")
    if traced:
        span = hostspans.then(span, "moe.combine")
    y = combine(out_buf, keep, flat_idx, safe_pos, gate_vals.reshape(-1), T)
    aux = aux_loss(probs, gate_idx, E)
    if traced:
        hostspans.end(span)
    return y.reshape(B, S, D), aux
