"""Feed-forward layers: gated MLPs and capacity-routed MoE.

The port of ``repro.models.ffn``. The MoE layer routes each token to its
top-k experts in fp32, gives each (token, k) assignment a position inside
its expert from a token-major cumulative count, and drops the assignments
past an expert's capacity ``C``, as the reference drops them; the router
keeps the Switch load-balancing loss. The experts then run on one of two
paths, which keep the same assignments and combine them alike:

* the capacity path, whenever autograd records the call: the assignments
  are scattered into an ``[E, C, D]`` capacity buffer and the experts run as
  batched matrix products (``torch.bmm``: the reference leaves its einsums
  to XLA, so no kernel is owed), E·C rows of which only the kept ones are
  routed;
* the grouped path, when no gradient is taken (serving): the kept
  assignments go to a compact ``[T·K + 1, D]`` buffer, expert after expert,
  and the experts run over those rows alone (``kernels.ops.moe_experts``:
  the grouped SwiGLU kernel ``csrc/moe_gemm.cu`` on the card, which reads
  each expert's row range on the device). The kernel has no backward, so
  training keeps the capacity path; a DTensor (a sharded mesh) keeps it too,
  and on the card so does any dtype but bf16, which is all the kernel takes.

A layer may hold a share of its experts (``held`` = (first, n): the experts
[first, first + n) of the router's E, the leaves ``[n, ...]``), as one device
of an expert-parallel deployment does: it routes every token over all E
experts and computes only what its own experts give, the assignments to the
others sent to the spare row like dropped ones. Each held expert counts its
positions, and so its drops, as the whole layer does, so the shares' outputs
sum to the whole layer's. Without a share the layer runs as it always has.

Every shape is fixed by (T, E, K, C) on both paths, so the layer never syncs
with the host. :mod:`repro_torch.models.moe_ep` builds its expert-parallel
form from these steps. The dispatch ledger counts the calls of each path,
``moe_mlp.grouped`` and ``moe_mlp.capacity``
(:mod:`repro_torch.kernels.build`); ``expert_rows``, while on, keeps each
grouped call's row ends on the device, read after the calls as its rows and
experts with rows. With ``txtrace.enabled``, :func:`moe_mlp` records its
steps as the spans ``moe.route``, ``moe.dispatch``, ``moe.experts`` and
``moe.combine`` (:mod:`repro_torch.obs.hostspans`; detail: the tokens T and
the path with the rows its experts compute, ``grouped rows=T·K`` or
``capacity EC=E·C``, and with a share ``held=n/E``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build, ops, ref
from repro_torch.obs import hostspans, txtrace

from .remat import residual_product


class ExpertRows:
    """The grouped path's work, call by call, while ``on``: each call's
    ``ends`` (the inclusive prefix of its experts' rows) kept on the device
    as it is, so that counting launches nothing; :meth:`take` reads them
    all in one host read, after the calls, and gives each call's rows and
    experts with at least one row."""

    def __init__(self):
        self.on = False
        self._calls: List[torch.Tensor] = []

    def add(self, ends: torch.Tensor) -> None:
        self._calls.append(ends)

    def take(self) -> List[Tuple[int, int]]:
        """(rows, experts with rows) of each call counted since the last
        take, in order; forgets them."""
        calls, self._calls = self._calls, []
        if not calls:
            return []
        flat = torch.cat(calls).tolist()
        out, at = [], 0
        for ends in calls:
            e = flat[at:at + ends.shape[0]]
            at += ends.shape[0]
            out.append((int(e[-1]),
                        sum(b > a for a, b in zip([0] + e[:-1], e))))
        return out


expert_rows = ExpertRows()


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


def running_counts(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """The reference's cumulative one-hot of ``dest`` [N], held transposed,
    [n_dest, N]: entry (d, i) counts the assignments to d among the first
    i + 1. The count runs along the innermost dimension: along the outer one
    CUDA's scan walks each of the few columns with one thread (1.5 ms a
    layer of mixtral's 4200-token prefill on an H100, against 0.03 ms this
    way)."""
    hits = dest[None, :] == torch.arange(n_dest, device=dest.device)[:, None]
    return torch.cumsum(hits, dim=1)


def slot_positions(dest: torch.Tensor, n_dest: int) -> torch.Tensor:
    """Position of each assignment inside its destination (an expert, or a
    virtual expert): the running count of earlier assignments to it, in
    the token-major flat order of ``dest`` [N]."""
    return torch.gather(running_counts(dest, n_dest), 0, dest[None, :])[0] - 1


def held_range(held: Optional[Tuple[int, int]], n_experts: int
               ) -> Optional[Tuple[int, int]]:
    """``held`` = (first, n) checked against the router's ``n_experts``;
    None where it holds them all (the layer without a share)."""
    if held is None:
        return None
    first, n = int(held[0]), int(held[1])
    if n < 1 or first < 0 or first + n > n_experts:
        raise ValueError(f"held experts [{first}, {first + n}) do not lie "
                         f"in the router's {n_experts}")
    return None if n == n_experts else (first, n)


def held_slots(dest: torch.Tensor, held: Tuple[int, int], capacity: int
               ) -> Tuple[torch.Tensor, ...]:
    """The assignments ``dest`` [N] (experts of the whole layer) that the
    held experts [first, first + n) take, ``held`` = (first, n): (keep [N],
    local [N], pos [N], counts [n, N]). ``counts`` is :func:`running_counts`
    over the held experts alone (an assignment to another expert is counted
    by none), so each held expert numbers its assignments as the whole
    layer does; ``local`` is an assignment's expert among the held (0 for
    the others), ``pos`` its position there, and ``keep`` marks the held
    assignments within ``capacity``."""
    first, n = held
    local = dest - first
    own = (local >= 0) & (local < n)
    counts = running_counts(local, n)
    local = torch.where(own, local, 0)
    pos = torch.gather(counts, 0, local[None, :])[0] - 1
    return own & (pos < capacity), local, pos, counts


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
    return _weighted_sum(out_buf[dest, slot], keep, weights, n_tokens)


def _weighted_sum(gathered: torch.Tensor, keep: torch.Tensor,
                  weights: torch.Tensor, n_tokens: int) -> torch.Tensor:
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device))
    w = weights[:, None].to(gathered.dtype)
    return (gathered * w).reshape(n_tokens, -1, gathered.shape[-1]).sum(1)


def grouped_path(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 plain: bool = False) -> bool:
    """Whether :func:`moe_mlp` runs its experts over the routed rows alone:
    autograd records nothing (grad mode off, or neither ``x`` nor an expert
    leaf requires grad), no tensor is a DTensor, and on the card the kernel
    takes the dtype (bf16; ``plain`` sends the experts to the plain
    version, which takes any)."""
    leaves = (x, params["w_gate"], params["w_up"], params["w_down"])
    if any(isinstance(t, DTensor) for t in leaves):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return False
    return (plain or x.device.type != "cuda"
            or all(t.dtype == torch.bfloat16 for t in leaves))


def grouped_rows(dest: torch.Tensor, n_dest: int, capacity: int,
                 held: Optional[Tuple[int, int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(keep [N], rows [N], ends [n]) of the grouped path, from the same
    cumulative count as :func:`slot_positions`, so that the same
    assignments are kept: ``ends`` is the inclusive prefix of the experts'
    kept counts min(count, C), each kept assignment's row is its expert's
    first row ends[d-1] plus its position, and every dropped one goes to the
    spare row N. With ``held`` (:func:`held_slots`) the rows and ``ends``
    are the held experts' alone, and an assignment to another expert goes
    to the spare row too, so that :func:`dispatch_rows` and
    :func:`combine_rows` take it as they take a dropped one."""
    if held is None:
        counts = running_counts(dest, n_dest)
        pos = torch.gather(counts, 0, dest[None, :])[0] - 1
        keep = pos < capacity
    else:
        keep, dest, pos, counts = held_slots(dest, held, capacity)
    kept = counts[:, -1].clamp(max=capacity)
    ends = kept.cumsum(0)
    rows = torch.where(keep, (ends - kept)[dest] + pos, dest.shape[0])
    return keep, rows, ends


def dispatch_rows(xt: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Copy the N assignments of the tokens ``xt`` [T, D] (token-major, N /
    T a token) into a compact buffer [N + 1, D] at ``rows``: the kept ones
    expert after expert, the dropped ones all into the spare last row. The
    rows that no assignment reaches (past the kept ones, where some drop)
    are left unset: nothing reads them."""
    N = rows.shape[0]
    src = xt.repeat_interleave(N // xt.shape[0], 0)
    buf = torch.empty((N + 1, xt.shape[1]), dtype=xt.dtype, device=xt.device)
    return buf.index_put_((rows,), src)


def grouped_experts(buf: torch.Tensor, ends: torch.Tensor,
                    params: Dict[str, torch.Tensor], plain: bool = False
                    ) -> torch.Tensor:
    """The SwiGLU experts over the compact buffer's routed rows
    (``ops.moe_experts``; with ``plain``, its plain version wherever the
    tensors are)."""
    experts = ref.moe_experts_plain if plain else ops.moe_experts
    return experts(buf, ends, params["w_gate"], params["w_up"],
                   params["w_down"])


def combine_rows(out: torch.Tensor, keep: torch.Tensor, rows: torch.Tensor,
                 weights: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """:func:`combine` for the grouped path: each assignment's output is row
    ``rows`` of the experts' output ``out`` [N + 1, D]."""
    return _weighted_sum(out[rows], keep, weights, n_tokens)


def aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor, n_experts: int
             ) -> torch.Tensor:
    """Switch load-balancing loss, E * sum(density of the top-1 choice *
    mean probability); at least 1, equal to 1 when balanced."""
    density = F.one_hot(gate_idx[:, 0], n_experts).float().mean(0)
    return torch.sum(density * probs.mean(0)) * n_experts


def moe_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg,
            shard=lambda a, name: a, plain: bool = False,
            held: Optional[Tuple[int, int]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE. x: [B, S, D] -> (y [B, S, D], aux loss fp32).
    ``params``: router [D, E], w_gate / w_up [n, D, Fe], w_down [n, Fe, D]:
    all E experts (n = E), or with ``held`` = (first, n) the experts [first,
    first + n), whose part of the layer y then is. ``shard(buf,
    "moe_buf")`` places the capacity buffers (the backbone's sharder:
    experts over "model" on a mesh). The grouped path runs when
    :func:`grouped_path` says so; ``plain`` sends its experts to their plain
    version (``Backbone(kernel_impl="plain")``)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    held = held_range(held, E)
    n = E if held is None else held[1]
    if params["w_gate"].shape[0] != n:
        raise ValueError(f"expert leaves hold {params['w_gate'].shape[0]} "
                         f"experts, want {n}")
    T = B * S
    xt = x.reshape(T, D)
    C = moe_capacity(T, E, K, cfg.capacity_factor)
    grouped = grouped_path(params, x, plain)
    build.DISPATCH.counter("moe_mlp.grouped" if grouped
                           else "moe_mlp.capacity").inc()
    traced = txtrace.enabled
    if traced:
        detail = (f"T={T} grouped rows={T * K}" if grouped
                  else f"T={T} capacity EC={n * C}")
        span = hostspans.begin("moe.route", detail if held is None
                               else f"{detail} held={n}/{E}")
    probs, gate_vals, gate_idx = route(xt, params["router"], K)
    if traced:
        span = hostspans.then(span, "moe.dispatch")
    flat_idx = gate_idx.reshape(-1)                              # [T*K]
    if grouped:
        keep, rows, ends = grouped_rows(flat_idx, E, C, held)
        if expert_rows.on:
            expert_rows.add(ends)
        buf = dispatch_rows(xt, rows)
        if traced:
            span = hostspans.then(span, "moe.experts")
        out = grouped_experts(buf, ends, params, plain)
        if traced:
            span = hostspans.then(span, "moe.combine")
        y = combine_rows(out, keep, rows, gate_vals.reshape(-1), T)
    else:
        if held is None:
            dest, pos = flat_idx, slot_positions(flat_idx, E)
            keep = pos < C
        else:
            keep, dest, pos, _ = held_slots(flat_idx, held, C)
        safe_pos = torch.where(keep, pos, 0)
        buf = shard(dispatch(xt, keep, dest, safe_pos, (n, C, D)),
                    "moe_buf")
        if traced:
            span = hostspans.then(span, "moe.experts")
        out_buf = shard(expert_ffn(buf, params["w_gate"], params["w_up"],
                                   params["w_down"]), "moe_buf")
        if traced:
            span = hostspans.then(span, "moe.combine")
        y = combine(out_buf, keep, dest, safe_pos, gate_vals.reshape(-1), T)
    aux = aux_loss(probs, gate_idx, E)
    if traced:
        hostspans.end(span)
    return y.reshape(B, S, D), aux
