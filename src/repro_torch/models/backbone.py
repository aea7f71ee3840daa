"""The backbone for the layer kinds ``attn``, ``local``, ``rec``, ``rwkv``,
``enc`` and ``dec``, with dense or MoE feed-forward layers.

The port of ``repro.models.backbone.Backbone`` for serving and training:
the same parameter tree (``g{i}/s{j}/<leaf>``, each group's leaves stacked
``[R, ...]`` over its repeat axis, ``x @ W`` weights ``[in, out]``), the same
cache (per attention layer ``[R,B,C,KV,hd]`` rings plus ``kpos [R,C]``, and
per ``dec`` layer the cross keys and values ``ck``/``cv [R,B,enc_seq,KV,hd]``;
per ``rec`` layer ``conv [R,B,K-1,W]`` and ``h [R,B,W]`` fp32; per ``rwkv`` layer
``shift1``/``shift2 [R,B,D]`` and ``wkv [R,B,H,hd,hd]`` fp32) and the same
entry points:

* ``loss_fn(params, batch)``             — training loss (causal LM; for an
  encoder-decoder model the decoder's, over ``batch["enc_frames"]``)
* ``prefill(params, batch, ctx)``        — run the context; last-token logits
  and a filled decode cache
* ``decode_step(params, cache, tokens)`` — one token against the cache

The repeat axis is a Python loop; with ``remat`` each layer of ``loss_fn``
runs under ``torch.utils.checkpoint`` (non-reentrant), where the reference
wraps its scan body in ``jax.checkpoint``: ``remat_policy="full"``
recomputes the whole layer in the backward, ``"dots"`` saves the products
without batch dimensions and recomputes the rest
(:mod:`repro_torch.models.remat`). Attention and the two scans go
through :mod:`repro_torch.kernels.ops` (the Hopper kernels on the card, the
plain versions on the CPU), or straight to the plain versions with
``kernel_impl="plain"``, which exists to hold the kernel path against them.
In training the gradients come from autograd Functions whose backwards are
kernels too: :class:`repro_torch.models.attention.FlashAttention` (K1b),
:class:`repro_torch.models.rglru.RGLRUScan` (K2b) and
:class:`repro_torch.models.rwkv6.WKVScan` (K3b); the recurrent layers train
from zero state and write none, as the reference's stateless ``_layer_fwd``.
The MoE layer (``ffn_kind="moe"``) is :func:`repro_torch.models.ffn.moe_mlp`
or, with ``moe_impl="ep"``, its expert-parallel form
:func:`repro_torch.models.moe_ep.moe_mlp_ep`; ``loss_fn`` adds ``AUX_COEF``
times the layers' summed load-balancing loss, and serving drops it, as the
reference does. An encoder-decoder model (whisper: ``enc`` groups, then
``dec`` groups) runs its encoder over ``batch["enc_frames"]`` plus the
learned ``embed/enc_pos``, without RoPE and without a causal mask; each
``dec`` layer adds a cross-attention sublayer (``ln_cross``, ``c_*``
leaves) over the encoder's output, non-causal. Its cache holds the decoder
groups only, as the reference's does.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import build, ops, ref
from repro_torch.obs import txtrace

from . import remat as remat_mod
from . import rwkv6
from .attention import flash_attention
from .common import (apply_rope_table, dense_init, embed_init, resolve_device,
                     rms_norm, rope_table, stable_cross_entropy)
from .config import ModelConfig
from .ffn import expert_rows, gated_mlp, held_range, moe_mlp
from .moe_ep import moe_mlp_ep, virtualization
from .partition import IDENTITY_PLAN, PartitionPlan
from .rglru import RGLRUScan, causal_conv1d

Params = Dict[str, Any]

_KINDS = ("attn", "local", "rec", "rwkv", "enc", "dec")
_RWKV_LORA = 64       # rank of the decay LoRA
_DDLERP_RANK = 32     # rank of the token-shift LoRA
AUX_COEF = 0.01       # weight of the auxiliary (MoE) loss in loss_fn


# per thread, whether Backbone.dist_context is entered
_DIST = threading.local()


def _tree(tree: Params) -> Params:
    """A copy of a cache's dicts holding the same leaves."""
    return {k: _tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def _no_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    return x


class Backbone:
    def __init__(self, cfg: ModelConfig, plan: PartitionPlan = IDENTITY_PLAN,
                 *, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                 remat: bool = True, remat_policy: str = "full",
                 device="cuda",
                 kernel_impl: str = "kernel", moe_impl: str = "gspmd",
                 model_group=None, data_group=None,
                 sharder: Callable[[torch.Tensor, str], torch.Tensor]
                 = _no_shard,
                 param_gather: Optional[Callable[[Params], Params]] = None,
                 mesh=None, dp_axes: Sequence[str] = (),
                 layer_scope: Callable[[], Any] = contextlib.nullcontext,
                 held_experts: Optional[Tuple[int, int]] = None,
                 prefill_graphs: bool = False):
        """``moe_impl``: ``"gspmd"`` (the scatter path, ``ffn.moe_mlp``) or
        ``"ep"`` (``moe_ep.moe_mlp_ep`` over ``model_group``, a
        ``torch.distributed`` group of ``plan.tp`` ranks, or none at tp 1;
        on a ``mesh`` its "model" group; the expert leaves are stored
        virtualized for ``plan.tp``, as the reference stores them;
        ``data_group`` averages the aux loss over the data ranks).

        Distribution enters as in the reference: ``sharder(x, tag)``
        redistributes the activations tagged ``act_hidden``, ``act_heads``,
        ``logits`` and ``moe_buf``; ``param_gather`` takes each layer's
        sliced, cast leaves to their placements in the layer (the ZeRO-3
        gather); ``mesh`` (a ``DeviceMesh``) and ``dp_axes`` (the axes that
        shard the batch) place the kernels' calls, which take plain tensors:
        each runs on every rank's local batch rows and heads (``local_map``).
        With the defaults none of this does anything. ``layer_scope()`` is a
        context entered around each layer (the dry run's cost counter reads
        it).

        ``remat_policy``: ``"full"`` (each layer recomputed whole in the
        backward) or ``"dots"`` (its products without batch dimensions
        saved, the rest recomputed); read only with ``remat``.

        ``held_experts`` = (first, n): the model holds the experts [first,
        first + n) of each MoE layer, as one device of an expert-parallel
        deployment does (the expert leaves ``[R, n, ...]``, the router over
        all of them); each layer routes over all its experts and passes on
        its held experts' part (``ffn.moe_mlp``'s ``held``). None: all.

        ``prefill_graphs``: on the card, ``prefill`` captures each shape it
        meets (batch, length, ctx) in a CUDA graph and replays it from then
        on, so that the host issues one launch for the whole step where the
        eager step issues about a hundred a layer (:meth:`_graph_prefill`).
        The logits and cache leaves it returns are then the graph's own,
        overwritten by the next prefill of that shape: a caller reads or
        copies them first, as the Server does. For serving: a replay takes
        no gradient and keeps the parameters of its capture."""
        plan.check(cfg)
        for kind in cfg.layer_kinds():
            if kind not in _KINDS:
                raise ValueError(f"unknown layer kind {kind!r}")
        if kernel_impl not in ("kernel", "plain"):
            raise ValueError(f"kernel_impl {kernel_impl!r}: want 'kernel' or "
                             "'plain'")
        if moe_impl not in ("gspmd", "ep"):
            raise ValueError(f"moe_impl {moe_impl!r}: want 'gspmd' or 'ep'")
        if remat_policy not in remat_mod.POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r}: want 'full' or "
                             "'dots'")
        self.moe_impl = moe_impl
        if moe_impl == "ep" and mesh is not None and model_group is None:
            model_group = mesh.get_group("model")
            axes = [a for a in dp_axes if a != "model"]
            if len(axes) == 1:
                data_group = mesh.get_group(axes[0])
        self.model_group = model_group
        self.data_group = data_group
        self.shard = sharder
        self.param_gather = param_gather
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.layer_scope = layer_scope
        self.held_experts = held_range(held_experts, cfg.n_experts)
        if self.held_experts is not None and (moe_impl == "ep"
                                              or cfg.ffn_kind != "moe"):
            raise ValueError("held_experts needs a MoE model on the "
                             "'gspmd' path (moe_mlp_ep takes its share from "
                             "its group)")
        if moe_impl == "ep" and cfg.ffn_kind == "moe":
            self.moe_V, self.moe_split = virtualization(cfg, plan.tp)
        elif self.held_experts is not None:
            self.moe_V, self.moe_split = self.held_experts[1], 1
        else:
            self.moe_V, self.moe_split = cfg.n_experts, 1
        self.cfg = cfg
        self.plan = plan
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.remat = remat
        self.remat_policy = remat_policy
        plain = kernel_impl == "plain"
        self._plain = plain
        self._rglru_scan = ref.rglru_scan_plain if plain else ops.rglru_scan
        self._wkv_scan = ref.rwkv6_scan_plain if plain else ops.rwkv6_scan
        self.H = plan.eff_heads(cfg)
        self.KV = plan.eff_kv_heads(cfg)
        self.hd = cfg.hd
        self.Vp = plan.eff_vocab(cfg)
        self.rwkv_H = plan.eff_rwkv_heads(cfg)
        self.W = cfg.rglru_width or cfg.d_model
        # RoPE on the decoder's self-attention; the encoder takes none
        self._has_attn = any(k in ("attn", "local", "dec")
                             for k in cfg.layer_kinds())
        self.prefill_graphs = prefill_graphs
        self._graphs: Dict[Tuple, Dict[str, Any]] = {}
        self._graph_params = None

    # ------------------------------------------------------------------ #
    # Parameter construction                                             #
    # ------------------------------------------------------------------ #
    def _leaf_specs(self, kind: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        cfg = self.cfg
        D, F_ = cfg.d_model, cfg.d_ff
        specs: Dict[str, Tuple[Tuple[int, ...], str]] = {"ln1": ((D,), "zero")}
        if kind == "rwkv":
            Dr = self.rwkv_H * cfg.rwkv_head_dim
            for n in ("r", "k", "v", "g", "w"):
                specs[f"mu_{n}"] = ((D,), "zero")
                specs[f"dd_b_{n}"] = ((_DDLERP_RANK, D), "zero")
            specs["dd_a"] = ((D, _DDLERP_RANK), "dense")
            for n in ("r", "k", "v", "g"):
                specs[f"w_{n}"] = ((D, Dr), "dense")
            specs["w0"] = ((Dr,), "zero")
            specs["wd_a"] = ((D, _RWKV_LORA), "dense")
            specs["wd_b"] = ((_RWKV_LORA, Dr), "zero")
            specs["u"] = ((Dr,), "zero")
            specs["ln_x"] = ((Dr,), "zero")
            specs["w_o"] = ((Dr, D), "dense")
            specs["ln2"] = ((D,), "zero")
            specs["mu_k2"] = ((D,), "zero")
            specs["mu_r2"] = ((D,), "zero")
            specs["w_in"] = ((D, F_), "dense")
            specs["w_out"] = ((F_, D), "dense")
            specs["w_rgate"] = ((D, D), "dense")
            return specs
        if kind == "rec":
            W, NB = self.W, cfg.n_heads      # NB gate blocks
            wb = W // NB
            specs["w_in"] = ((D, W), "dense")
            specs["w_gate_branch"] = ((D, W), "dense")
            specs["conv_w"] = ((cfg.conv1d_width, W), "dense")
            specs["conv_b"] = ((W,), "zero")
            specs["gw_a"] = ((NB, wb, wb), "dense")
            specs["gb_a"] = ((W,), "zero")
            specs["gw_x"] = ((NB, wb, wb), "dense")
            specs["gb_x"] = ((W,), "zero")
            specs["a_log"] = ((W,), "lru")
            specs["w_out"] = ((W, D), "dense")
        else:  # attn, local, enc, dec
            self._attn_specs(specs, "")
            if kind == "dec":
                specs["ln_cross"] = ((D,), "zero")
                self._attn_specs(specs, "c_")
        specs["ln2"] = ((D,), "zero")
        if cfg.ffn_kind == "moe" and kind != "dec":
            # the ep path stores virtualized experts [V, D, Fe/split] (an
            # exact column split, see moe_ep.py), as the reference does
            Fv = (cfg.moe_d_ff or F_) // self.moe_split
            specs["router"] = ((D, cfg.n_experts), "dense")
            specs["w_gate"] = ((self.moe_V, D, Fv), "dense")
            specs["w_up"] = ((self.moe_V, D, Fv), "dense")
            specs["w_down"] = ((self.moe_V, Fv, D), "dense")
        elif cfg.ffn_kind in ("swiglu", "geglu"):
            specs["w_gate"] = ((D, F_), "dense")
            specs["w_up"] = ((D, F_), "dense")
            specs["w_down"] = ((F_, D), "dense")
        else:  # gelu
            specs["w_gate"] = ((D, F_), "dense")
            specs["b_gate"] = ((F_,), "zero")
            specs["w_down"] = ((F_, D), "dense")
            specs["b_down"] = ((D,), "zero")
        return specs

    def _attn_specs(self, specs, prefix: str) -> None:
        cfg = self.cfg
        D, H, KV, hd = cfg.d_model, self.H, self.KV, self.hd
        specs[f"{prefix}wq"] = ((D, H * hd), "dense")
        specs[f"{prefix}wk"] = ((D, KV * hd), "dense")
        specs[f"{prefix}wv"] = ((D, KV * hd), "dense")
        specs[f"{prefix}wo"] = ((H * hd, D), "dense")
        if cfg.qkv_bias:
            specs[f"{prefix}bq"] = ((H * hd,), "zero")
            specs[f"{prefix}bk"] = ((KV * hd,), "zero")
            specs[f"{prefix}bv"] = ((KV * hd,), "zero")
        if cfg.qk_norm:
            specs[f"{prefix}q_norm"] = ((hd,), "zero")
            specs[f"{prefix}k_norm"] = ((hd,), "zero")

    def _init_leaf(self, gen: torch.Generator, shape, init: str
                   ) -> torch.Tensor:
        pd, dev = self.param_dtype, self.device
        if init == "zero":
            return torch.zeros(shape, dtype=pd, device=dev)
        if init == "embed":
            return embed_init(gen, shape, pd, dev)
        if init == "lru":
            # Λ such that softplus(Λ) is uniform in (0.05, 0.6): the inverse
            # softplus of the reference's draw
            u = torch.rand(shape, generator=gen, device=dev) * 0.55 + 0.05
            return torch.log(torch.expm1(u)).to(pd)
        return dense_init(gen, shape, dtype=pd, device=dev)

    def init(self, seed: int = 0, *, device=None) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on the
        backbone's device, in the reference's key order. ``device="meta"``
        gives the tree's shapes and dtypes without memory (the counterpart
        of ``jax.eval_shape(bb.init, key)``)."""
        cfg = self.cfg
        if device is not None and torch.device(device).type == "meta":
            def leaf(shape, init):
                return torch.empty(shape, dtype=self.param_dtype,
                                   device="meta")
        else:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)

            def leaf(shape, init):
                return self._init_leaf(gen, shape, init)
        params: Params = {"embed": {"tok": leaf((self.Vp, cfg.d_model),
                                                "embed")}}
        if cfg.is_enc_dec:
            params["embed"]["enc_pos"] = leaf((cfg.enc_seq, cfg.d_model),
                                              "embed")
        if not cfg.tie_embeddings:
            params["lm_head"] = leaf((cfg.d_model, self.Vp), "dense")
        params["final_norm"] = leaf((cfg.d_model,), "zero")
        for gi, group in enumerate(cfg.groups):
            params[f"g{gi}"] = {
                f"s{si}": {name: leaf((group.repeat,) + shape, init)
                           for name, (shape, init)
                           in self._leaf_specs(kind).items()}
                for si, kind in enumerate(group.pattern)}
        return params

    def _layer_views(self, gp: Params, repeat: int) -> List[Params]:
        """Every layer's views of a group's stacked leaves: one ``unbind``
        of each leaf. In training autograd then keeps one slot a layer for
        the leaf's gradient and stacks the slots once, where a view
        ``leaf[r]`` a layer would pad each layer's gradient to the leaf's
        size with zeros and add the ``repeat`` padded tensors."""
        views = {s: {name: leaf.unbind(0) for name, leaf in sub.items()}
                 for s, sub in gp.items()}
        return [{s: {name: v[r] for name, v in sub.items()}
                 for s, sub in views.items()} for r in range(repeat)]

    def _cast_layer(self, lp: Params) -> Params:
        """One layer's views of the stacked leaves, cast to the compute
        dtype (no copy when the dtypes agree), then gathered by
        ``param_gather`` where one is given."""
        cd = self.compute_dtype
        out = {s: {name: v.to(cd)
                   if v.is_floating_point() and v.dtype != cd else v
                   for name, v in sub.items()}
               for s, sub in lp.items()}
        if self.param_gather is not None:
            # per-layer weight all-gather (prefetch / early-release schedule)
            out = self.param_gather(out)
        return out

    # ------------------------------------------------------------------ #
    # Distribution                                                       #
    # ------------------------------------------------------------------ #
    @contextlib.contextmanager
    def dist_context(self):
        """On a mesh, plain tensors made inside the model (positions, masks,
        zero states) act as replicated DTensors beside the distributed ones;
        a train step runs its backward and update in it too. Nested entries
        on one thread are one (``implicit_replication`` does not nest)."""
        if self.mesh is None or getattr(_DIST, "depth", 0):
            yield
            return
        _DIST.depth = 1
        try:
            with implicit_replication():
                yield
        finally:
            _DIST.depth = 0

    def _placements(self, layout):
        """Placements of a tensor whose ``layout`` is (its batch dim, its
        heads or width dim), each None where there is none: the batch over
        ``dp_axes``, heads over "model" (unless the batch takes it). A None
        layout: an argument that is not a tensor."""
        if layout is None:
            return None
        batch, split = layout
        heads = "model" not in self.dp_axes
        return tuple(
            Shard(batch) if batch is not None and axis in self.dp_axes
            else Shard(split) if split is not None and axis == "model"
            and heads else Replicate()
            for axis in self.mesh.mesh_dim_names)

    def _grad_placements(self, layout):
        """Placements of the gradient of an argument of ``layout``: one
        with no batch dim (a parameter: ``a_log``, ``u``) is read by every
        rank's rows, so its local gradients are partial sums over the
        axes that do not split it."""
        places = self._placements(layout)
        if places is None or layout[0] is not None:
            return places
        return tuple(p if isinstance(p, Shard) else Partial()
                     for p in places)

    def _local(self, fn, ins, outs):
        """``fn`` on each rank's local shards where the model runs on a
        mesh: ``ins``/``outs`` give the layout (see :meth:`_placements`) of
        each tensor argument and result. The kernels take plain tensors."""
        if self.mesh is None:
            return fn
        return local_map(fn, out_placements=tuple(self._placements(o)
                                                  for o in outs),
                         in_placements=tuple(self._placements(i)
                                             for i in ins),
                         in_grad_placements=tuple(self._grad_placements(i)
                                                  for i in ins),
                         device_mesh=self.mesh, redistribute_inputs=True)

    def _whole(self, leaf: torch.Tensor, name: str) -> torch.Tensor:
        """The embedding table or the LM head, gathered by ``param_gather``
        (its ZeRO shards) where one is given."""
        if self.param_gather is None:
            return leaf
        return self.param_gather({name: leaf}, stacked=False)[name]

    def _replicated(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a replicated DTensor on a mesh: a tensor that autograd
        saves beside DTensors (a RoPE table, a mask) must be one, since the
        backward runs outside ``dist_context``."""
        if self.mesh is None:
            return t
        return DTensor.from_local(t, self.mesh,
                                  (Replicate(),) * self.mesh.ndim,
                                  run_check=False)

    def _as_input(self, a) -> torch.Tensor:
        if isinstance(a, DTensor):
            return a
        return torch.as_tensor(a, device=self.device)

    # ------------------------------------------------------------------ #
    # Sublayers                                                          #
    # ------------------------------------------------------------------ #
    def _qkv(self, p, h):
        cfg = self.cfg
        B, S, _ = h.shape
        q = h @ p["wq"]
        k = h @ p["wk"]
        v = h @ p["wv"]
        if cfg.qkv_bias:
            q = q + p["bq"]
            k = k + p["bk"]
            v = v + p["bv"]
        q = self.shard(q, "act_heads").reshape(B, S, self.H, self.hd)
        k = k.reshape(B, S, self.KV, self.hd)
        v = v.reshape(B, S, self.KV, self.hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        return q, k, v

    def _attend(self, q, k, v, kind: str, q_positions, kv_positions):
        cfg = self.cfg
        return self._flash(q, k, v, q_positions, kv_positions,
                           causal=kind != "enc",
                           window=cfg.attn_window if kind == "local" else None,
                           logit_cap=cfg.attn_logit_softcap)

    def _flash(self, q, k, v, q_positions, kv_positions, **kw):
        """``flash_attention`` on each rank's local batch rows and heads."""
        heads, rep = (0, 2), (None, None)
        return self._local(
            lambda q, k, v, qp, kp: flash_attention(
                q, k, v, q_positions=qp, kv_positions=kp, plain=self._plain,
                **kw),
            (heads, heads, heads, rep, rep), (heads,))(
                q, k, v, q_positions, kv_positions)

    def _ffn_sublayer(self, p, x):
        """(y, aux): the MoE layer's load-balancing loss, or 0.0 for a dense
        one (a Python float: serving drops it without a launch)."""
        cfg = self.cfg
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.ffn_kind != "moe":
            return self.shard(gated_mlp(p, h, cfg.ffn_kind), "act_hidden"), 0.0
        if self.moe_impl == "ep" and self.mesh is not None:
            y, aux = self._moe_ep_local(p, h)
        elif self.moe_impl == "ep":
            y, aux = moe_mlp_ep(p, h, cfg, self.model_group, self.data_group,
                                plain=self._plain)
        else:
            y, aux = moe_mlp(p, h, cfg, self.shard, plain=self._plain,
                             held=self.held_experts)
        return self.shard(y, "act_hidden"), aux

    def _moe_ep_local(self, p, h):
        """``moe_mlp_ep`` on each rank's local rows and experts: its
        partial y a partial sum over "model" (the sharder's act_hidden
        sums it). Every model rank computes its rows' whole aux, so each
        gives 1 / (its ranks) of it, a partial sum over the mesh: the mean
        over the data ranks, as the reference's pmean. The gradients of the
        router and of h are partial sums over "model" too (each rank routes
        to its own experts), and the router's and the experts' over the
        data axes."""
        names = ("router", "w_gate", "w_up", "w_down")
        rows, experts, whole = (0, None), (None, 0), (None, None)
        ins = (rows, whole) + (experts,) * 3
        grads = tuple(tuple(q if isinstance(q, Shard) else Partial()
                            for q in self._placements(layout))
                      for layout in ins)
        y_out = tuple(Partial() if axis == "model" else q for q, axis in zip(
            self._placements(rows), self.mesh.mesh_dim_names))
        share = 1.0 / self.mesh.size()

        def part(h, *w):
            y, aux = moe_mlp_ep(dict(zip(names, w)), h, self.cfg,
                                self.model_group, reduce=False,
                                plain=self._plain)
            return y, aux * share
        fn = local_map(
            part, out_placements=(y_out, (Partial(),) * self.mesh.ndim),
            in_placements=tuple(self._placements(i) for i in ins),
            in_grad_placements=grads, device_mesh=self.mesh,
            redistribute_inputs=True)
        return fn(h, *(p[n] for n in names))

    def _rope(self, positions):
        cfg = self.cfg
        rot, cos, sin = rope_table(positions, self.hd, cfg.rope_theta,
                                   cfg.rotary_pct)
        return rot, self._replicated(cos), self._replicated(sin)

    def _cross_kv(self, p, enc_out):
        """A ``dec`` layer's cross keys and values [B, Se, KV, hd] from the
        encoder's output: no bias, no norm, no RoPE, as the reference's."""
        B, Se, _ = enc_out.shape
        ck = (enc_out @ p["c_wk"]).reshape(B, Se, self.KV, self.hd)
        cv = (enc_out @ p["c_wv"]).reshape(B, Se, self.KV, self.hd)
        return ck, cv

    def _cross_sublayer(self, p, x, ck, cv, q_positions, kv_positions,
                        bias: bool = True):
        """The cross-attention residual branch of a ``dec`` layer, non-causal
        over the encoder's keys. ``bias``: add ``c_bq`` where the config has
        it; the reference's decode step adds none (ROADMAP.md, section 3)."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
        q = h @ p["c_wq"]
        if cfg.qkv_bias and bias:
            q = q + p["c_bq"]
        q = q.reshape(B, S, self.H, self.hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["c_q_norm"], cfg.norm_eps)
        o = self._flash(q, ck, cv, q_positions, kv_positions, causal=False)
        return o.reshape(B, S, self.H * self.hd) @ p["c_wo"]

    def _layer_fwd(self, p, x, kind: str, positions, rope, cross=None):
        """One attention layer over a sequence. Returns (x, k, v, aux): the
        keys (rotated, but for ``enc``) and the values, which prefill keeps
        in the cache, and the FFN's aux loss. ``cross``: a ``dec`` layer's
        (ck, cv, their positions)."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = self._qkv(p, h)
        if kind != "enc":
            q = apply_rope_table(q, rope)
            k = apply_rope_table(k, rope)
        o = self._attend(q, k, v, kind, positions, positions)
        x = x + self.shard(o.reshape(B, S, self.H * self.hd) @ p["wo"],
                           "act_hidden")
        if kind == "dec":
            ck, cv, cross_positions = cross
            x = x + self._cross_sublayer(p, x, ck, cv, positions,
                                         cross_positions)
        y, aux = self._ffn_sublayer(p, x)
        return x + y, k, v, aux

    # -- the recurrent kinds: one body per kind for prefill, decode and
    # training. Serving reads layer r's state from the cache and writes the
    # new state back in place (the scans write theirs directly); prefill
    # starts from the zero state of a fresh cache, as the reference starts
    # from zeros. Training starts from zero state too, writes none and takes
    # the scans through their autograd Functions.
    def _rglru_apply(self, p, h, conv_state, scan):
        """Griffin recurrent block with block-diagonal gates. h: [B,T,D];
        conv_state [B,K-1,W]; ``scan(x, a_log, gate_r, gate_i) -> (y,
        h_T)``.
        Returns (out [B,T,D], the new conv state)."""
        NB = self.cfg.n_heads
        wb = self.W // NB
        branch = h @ p["w_in"]
        gate = F.gelu(h @ p["w_gate_branch"], approximate="tanh")
        branch, conv_new = causal_conv1d(p, branch, conv_state)
        bb = branch.reshape(*branch.shape[:-1], NB, wb)
        r = torch.sigmoid(torch.einsum("...nw,nwv->...nv", bb, p["gw_a"])
                          .reshape(branch.shape) + p["gb_a"])
        i = torch.sigmoid(torch.einsum("...nw,nwv->...nv", bb, p["gw_x"])
                          .reshape(branch.shape) + p["gb_x"])
        y, _ = scan(branch, p["a_log"], r, i)
        return (y.to(h.dtype) * gate) @ p["w_out"], conv_new

    def _rec_body(self, p, x, conv_state, scan):
        """Returns (x, the new conv state, the FFN's aux loss)."""
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        y, conv_new = self._rglru_apply(p, h, conv_state, scan)
        x = x + y.to(x.dtype)
        y, aux = self._ffn_sublayer(p, x)
        return x + y, conv_new, aux

    def _rwkv_body(self, p, x, shift1, wkv, shift2, scan):
        """Returns (x, the new shift states 1 and 2); ``scan`` is time
        mixing's, which leaves the wkv state where it chooses."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, shift1, _ = rwkv6.time_mix(p, h, shift1, wkv, self.rwkv_H,
                                      cfg.rwkv_head_dim, scan=scan)
        x = x + y.to(x.dtype)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, shift2 = rwkv6.channel_mix(
            {"mu_k": p["mu_k2"], "mu_r": p["mu_r2"], "w_in": p["w_in"],
             "w_out": p["w_out"], "w_rgate": p["w_rgate"]}, h, shift2)
        return x + y, shift1, shift2

    def _recurrent_layer(self, p, x, kind: str, sub, r: int):
        """Serving: layer ``r`` of a group from and into the cache."""
        if kind == "rec":
            # the state is read and written in place: h_out is h0
            scan = self._rglru_local(
                lambda *a: self._rglru_scan(*a, h_out=a[-1]), (0, 1))
            x, conv, _ = self._rec_body(p, x, sub["conv"][r],
                                        lambda *a: scan(*a, sub["h"][r]))
            sub["conv"][r].copy_(conv)
            return x
        x, shift1, shift2 = self._rwkv_body(
            p, x, sub["shift1"][r], sub["wkv"][r], sub["shift2"][r],
            self._wkv_local(lambda *a: self._wkv_scan(*a, state_out=a[-1]),
                            (0, 1)))
        sub["shift1"][r].copy_(shift1)
        sub["shift2"][r].copy_(shift2)
        return x

    def _recurrent_train(self, p, x, kind: str):
        """Training: a recurrent layer from zero state (conv, h0, shifts and
        wkv), writing no state. Returns (x, aux)."""
        B = x.shape[0]
        if kind == "rec":
            # h0 from each rank's local shapes, inside the local call
            scan = self._rglru_local(
                lambda x, a_log, gr, gi: RGLRUScan.apply(
                    x, a_log, gr, gi, x.new_zeros(x.shape[0], x.shape[2],
                                                  dtype=torch.float32),
                    self._plain))
            conv0 = x.new_zeros(B, self.cfg.conv1d_width - 1, self.W)
            x, _, aux = self._rec_body(p, x, conv0, scan)
            return x, aux
        hd = self.cfg.rwkv_head_dim
        shift0 = x.new_zeros(B, self.cfg.d_model)
        scan = self._wkv_local(
            lambda r, k, v, w, u, _: rwkv6.WKVScan.apply(
                r, k, v, w, u, r.new_zeros(r.shape[0], r.shape[2], hd, hd,
                                           dtype=torch.float32),
                self._plain), None)
        return self._rwkv_body(p, x, shift0, None, shift0, scan)[0], 0.0

    def _rglru_local(self, fn, h_layout=None):
        """The RG-LRU scan ``fn(x, a_log, gate_r, gate_i[, h])`` -> (y,
        h_T) on each rank's local batch rows and width."""
        seq = (0, 2)
        ins = (seq, (None, 0), seq, seq) + ((h_layout,) if h_layout else ())
        return self._local(fn, ins, (seq, (0, 1)))

    def _wkv_local(self, fn, state_layout):
        """The WKV scan ``fn(r, k, v, w, u, state)`` -> (y, S_T) on each
        rank's local batch rows and heads; a None ``state_layout``: the
        state argument is None (training starts from zero)."""
        heads = (0, 2)
        return self._local(fn, (heads,) * 4 + ((None, 0), state_layout),
                           (heads, (0, 1)))

    def _embed_tokens(self, params, tokens) -> torch.Tensor:
        cfg = self.cfg
        tok = params["embed"]["tok"]
        if isinstance(tok, DTensor):
            # the lookup over the whole vocabulary, D over "model" (the
            # reference's untied layout): DTensor's lookup in a
            # vocab-sharded table leaves partial rows whose backward it
            # cannot add to the head's gradient
            tok = tok.redistribute(self.mesh, self._placements((None, 1)))
        x = F.embedding(tokens, tok).to(self.compute_dtype)
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(cfg.d_model,
                                            dtype=self.compute_dtype))
        return x

    def _logits(self, params, x) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"].to(self.compute_dtype),
                     cfg.norm_eps)
        head = (self._whole(params["embed"]["tok"], "tok").T
                if cfg.tie_embeddings
                else self._whole(params["lm_head"], "lm_head")
                ).to(self.compute_dtype)
        logits = self.shard(x @ head, "logits")
        if self.Vp != cfg.vocab:  # mask padded vocab columns
            mask = self._replicated(
                torch.arange(self.Vp, device=self.device) < cfg.vocab)
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, -1e30))
        return logits

    # ------------------------------------------------------------------ #
    # Training: loss                                                      #
    # ------------------------------------------------------------------ #
    def _train_layer(self, lp, pattern, x, positions, rope, enc_out=None):
        """One layer in training (and in the encoder's pass of prefill),
        from its views ``lp`` of the stacked leaves (:meth:`_layer_views`):
        its parameters cast and gathered inside (:meth:`_cast_layer`), so
        that remat recomputes the cast (and the MoE layers' routing, and a
        ``dec`` layer's cross keys and values from ``enc_out``) as the
        reference's scan body does. Returns (x, the layer's aux loss). Remat
        runs it again in the backward, hence the distribution context here
        too."""
        with self.dist_context(), self.layer_scope():
            return self._train_layer_body(lp, pattern, x, positions, rope,
                                          enc_out)

    def _train_layer_body(self, lp, pattern, x, positions, rope, enc_out):
        lp = self._cast_layer(lp)
        aux = 0.0
        last = len(pattern) - 1
        for si, kind in enumerate(pattern):
            with (remat_mod.last_sublayer() if si == last
                  else contextlib.nullcontext()):
                x, a = self._train_sublayer(lp[f"s{si}"], x, kind, positions,
                                            rope, enc_out)
            aux = aux + a
        return x, aux

    def _train_sublayer(self, p, x, kind: str, positions, rope, enc_out):
        if kind in ("rec", "rwkv"):
            return self._recurrent_train(p, x, kind)
        cross = None
        if kind == "dec":
            cross = (*self._cross_kv(p, enc_out), self._enc_positions())
        x, _, _, a = self._layer_fwd(p, x, kind, positions, rope, cross)
        return x, a

    def _groups(self, encoder: bool):
        """(index, group) of the encoder's groups, or of the others (the
        decoder's; every group of a decoder-only model)."""
        return [(gi, g) for gi, g in enumerate(self.cfg.groups)
                if ("enc" in g.pattern) == encoder]

    def _run_layers(self, params, groups, x, positions, rope, enc_out,
                    remat: bool):
        """Every layer of ``groups`` over the sequence x; each under
        ``torch.utils.checkpoint`` with ``remat``, by ``remat_policy``.
        Returns (x, summed aux). Each group's layer views are made once,
        outside the checkpoint, and counted in the dispatch ledger as
        ``layer_views.unbind``."""
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        kw = ({"context_fn": remat_mod.context}
              if self.remat_policy == "dots" else {})
        for gi, group in groups:
            build.DISPATCH.counter("layer_views.unbind").inc()
            for lp in self._layer_views(params[f"g{gi}"], group.repeat):
                args = (lp, group.pattern, x, positions, rope, enc_out)
                if remat:
                    x, a = checkpoint(self._train_layer, *args,
                                      use_reentrant=False, **kw)
                else:
                    x, a = self._train_layer(*args)
                aux = aux + a
        return x, aux

    def _enc_positions(self) -> torch.Tensor:
        return torch.arange(self.cfg.enc_seq, dtype=torch.int32,
                            device=self.device)

    def _encode(self, params, frames, remat: bool) -> torch.Tensor:
        """The encoder over the stub frontend's frames [B, enc_seq, D]: plus
        ``embed/enc_pos``, then the ``enc`` groups (non-causal, no RoPE).
        Their aux loss is dropped, as the reference drops it."""
        cd = self.compute_dtype
        x = (self._as_input(frames).to(cd)
             + params["embed"]["enc_pos"].to(cd))
        return self._run_layers(params, self._groups(encoder=True), x,
                                self._enc_positions(), None, None, remat)[0]

    def loss_fn(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean next-token cross-entropy (fp32) of ``batch["tokens"]``
        against ``batch["labels"]`` (both [B, S]), plus ``AUX_COEF`` times
        the MoE layers' summed auxiliary loss (0 without MoE). An
        encoder-decoder model reads ``batch["enc_frames"]`` too."""
        with self.dist_context():
            return self._loss(params, batch)

    def _loss(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        cfg = self.cfg
        tokens = self._as_input(batch["tokens"])
        labels = self._as_input(batch["labels"])
        enc_out = (self._encode(params, batch["enc_frames"], self.remat)
                   if cfg.is_enc_dec else None)
        x = self.shard(self._embed_tokens(params, tokens), "act_hidden")
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=self.device)
        rope = self._rope(positions) if self._has_attn else None
        x, aux = self._run_layers(params, self._groups(encoder=False), x,
                                  positions, rope, enc_out, self.remat)
        logits = self._logits(params, x)
        loss = stable_cross_entropy(logits, labels, cfg.final_logit_softcap)
        return loss + AUX_COEF * aux

    # ------------------------------------------------------------------ #
    # Serving: prefill + decode                                           #
    # ------------------------------------------------------------------ #
    def cache_len(self, kind: str, ctx: int) -> int:
        if kind == "local":
            return min(self.cfg.attn_window or ctx, ctx)
        return ctx

    def init_cache(self, B: int, ctx: int, dtype=None, *,
                   device=None) -> Params:
        """An empty cache: ``pos`` (a Python int; JAX keeps an int32 scalar);
        per attention layer ``k``/``v`` rings [R,B,C,KV,hd] with their
        positions ``kpos`` [R,C], -1 for an empty slot; per ``rec`` layer
        ``conv`` [R,B,K-1,W] and ``h`` [R,B,W] fp32; per ``rwkv`` layer
        ``shift1``/``shift2`` [R,B,D] and ``wkv`` [R,B,H,hd,hd] fp32; per
        ``dec`` layer also ``ck``/``cv`` [R,B,enc_seq,KV,hd]. The encoder's
        groups hold no cache (whisper's is ``{"pos", "g1"}``). ``device``
        overrides the backbone's (``"meta"``: shapes only). On a mesh each
        leaf is a DTensor: the batch over ``dp_axes``, heads or width over
        "model"."""
        cfg = self.cfg
        dtype = dtype or self.compute_dtype
        dev = self.device if device is None else torch.device(device)

        def zeros(shape, dt=dtype, layout=(None, None), fill=0):
            if self.mesh is None:
                return torch.full(shape, fill, dtype=dt, device=dev)
            # each rank makes its own shard: a one-element view cut to it
            d = distribute_tensor(
                torch.full((), fill, dtype=dt, device=dev).expand(shape),
                self.mesh, self._placements(layout), src_data_rank=None)
            return DTensor.from_local(d.to_local().contiguous(), self.mesh,
                                      d.placements, run_check=False,
                                      shape=d.shape, stride=d.stride())

        cache: Params = {"pos": 0}
        for gi, group in self._groups(encoder=False):
            R = group.repeat
            gc: Dict[str, Any] = {}
            for si, kind in enumerate(group.pattern):
                if kind == "rec":
                    sub = {"conv": zeros((R, B, cfg.conv1d_width - 1, self.W),
                                         layout=(1, 3)),
                           "h": zeros((R, B, self.W), torch.float32, (1, 2))}
                elif kind == "rwkv":
                    hdr = cfg.rwkv_head_dim
                    sub = {"shift1": zeros((R, B, cfg.d_model), layout=(1, None)),
                           "wkv": zeros((R, B, self.rwkv_H, hdr, hdr),
                                        torch.float32, (1, 2)),
                           "shift2": zeros((R, B, cfg.d_model), layout=(1, None))}
                else:
                    C = self.cache_len(kind, ctx)
                    heads = (1, 3)
                    sub = {"k": zeros((R, B, C, self.KV, self.hd), layout=heads),
                           "v": zeros((R, B, C, self.KV, self.hd), layout=heads),
                           "kpos": zeros((R, C), torch.int32, fill=-1)}
                    if kind == "dec":
                        Se = cfg.enc_seq
                        sub["ck"] = zeros((R, B, Se, self.KV, self.hd),
                                          layout=heads)
                        sub["cv"] = zeros((R, B, Se, self.KV, self.hd),
                                          layout=heads)
                gc[f"s{si}"] = sub
            cache[f"g{gi}"] = gc
        return cache

    def _layer_decode(self, p, x, kind: str, sub, r: int, pos: int, posv,
                      rope, enc_positions=None):
        """One-token step of attention layer ``r`` of a group. x: [B,1,D].
        Writes the token's key and value into ring slot ``pos % C`` before
        attending; a ``dec`` layer then attends across to its cached
        ``ck``/``cv``."""
        cfg = self.cfg
        B = x.shape[0]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = self._qkv(p, h)
        q = apply_rope_table(q, rope)
        k = apply_rope_table(k, rope)
        ck, cv, kpos = sub["k"][r], sub["v"][r], sub["kpos"][r]
        slot = pos % ck.shape[1]
        ck[:, slot] = k[:, 0]
        cv[:, slot] = v[:, 0]
        kpos[slot] = pos
        o = self._attend(q, ck.to(x.dtype), cv.to(x.dtype), kind, posv, kpos)
        x = x + self.shard(o.reshape(B, 1, self.H * self.hd) @ p["wo"],
                           "act_hidden")
        if kind == "dec":
            # as the reference's decode step: no c_bq on the query
            x = x + self._cross_sublayer(
                p, x, sub["ck"][r].to(x.dtype), sub["cv"][r].to(x.dtype),
                posv, enc_positions, bias=False)
        y, _ = self._ffn_sublayer(p, x)
        return x + y

    def _serve_layers(self, gp, group):
        """(r, layer r's parameters) of a group, each layer's step run
        inside ``layer_scope``."""
        for r, lp in enumerate(self._layer_views(gp, group.repeat)):
            with self.layer_scope():
                yield r, self._cast_layer(lp)

    def decode_step(self, params: Params, cache: Params, tokens
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens: [B, 1] -> (logits [B, 1, Vp], cache).

        The cache is updated in place (JAX returns a new one, which would
        cost a copy of every ring and state here): each attention layer's
        slot ``pos % C`` and ``kpos``, each recurrent layer's state, then
        ``pos + 1``.
        """
        with self.dist_context():
            return self._decode_step(params, cache, tokens)

    def _decode_step(self, params: Params, cache: Params, tokens
                     ) -> Tuple[torch.Tensor, Params]:
        pos = int(cache["pos"])
        tokens = self._as_input(tokens)
        x = self._embed_tokens(params, tokens)
        posv = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        rope = self._rope(posv) if self._has_attn else None
        epos = self._enc_positions() if self.cfg.is_enc_dec else None
        for gi, group in self._groups(encoder=False):
            gp, gc = params[f"g{gi}"], cache[f"g{gi}"]
            for r, lp in self._serve_layers(gp, group):
                for si, kind in enumerate(group.pattern):
                    p, sub = lp[f"s{si}"], gc[f"s{si}"]
                    if kind in ("rec", "rwkv"):
                        x = self._recurrent_layer(p, x, kind, sub, r)
                    else:
                        x = self._layer_decode(p, x, kind, sub, r, pos, posv,
                                               rope, epos)
        cache["pos"] = pos + 1
        return self._logits(params, x), cache

    def prefill(self, params: Params, batch: Dict[str, Any], ctx: int
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full context; return (last-token logits, filled cache).

        Each attention layer's rotated keys and values are kept from its
        forward (JAX recomputes them, with identical numbers); a ring of C
        slots keeps the last ``min(C, S)`` positions at slots
        ``position % C``. Each recurrent layer runs from the fresh cache's
        zero state and leaves its final state there. An encoder-decoder
        model encodes ``batch["enc_frames"]`` once, and each ``dec`` layer
        keeps its cross keys and values in ``ck``/``cv``.
        """
        with self.dist_context():
            if self._replays_prefill(batch):
                return self._graph_prefill(params, batch["tokens"], ctx)
            return self._prefill(params, batch, ctx)

    def _replays_prefill(self, batch: Dict[str, Any]) -> bool:
        """Whether ``prefill`` runs a captured graph: asked for, on the
        card, unsharded, tokens alone in the batch, and nothing switched on
        that reads the eager step's calls as they are made (the profiler,
        host spans, the MoE layer's row counter): a replay enters none of
        the Python code."""
        if not self.prefill_graphs or self.device.type != "cuda":
            return False
        if self.mesh is not None or set(batch) != {"tokens"}:
            return False
        return not (torch._C._autograd._profiler_enabled()
                    or txtrace.enabled or expert_rows.on)

    def _graph_prefill(self, params: Params, tokens, ctx: int
                       ) -> Tuple[torch.Tensor, Params]:
        """``_prefill`` replayed from a CUDA graph of this shape, captured
        at its first call (every graph is dropped when the parameters
        change). Returns the graph's own logits and cache leaves, in a
        cache tree of its own."""
        tokens = self._as_input(tokens)
        if params is not self._graph_params:
            self.drop_prefill_graphs()
            self._graph_params = params
        key = (tuple(tokens.shape), tokens.dtype, ctx)
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture_prefill(params, tokens,
                                                              ctx)
        entry["tokens"].copy_(tokens)
        entry["graph"].replay()
        return entry["logits"], _tree(entry["cache"])

    def _capture_prefill(self, params: Params, tokens: torch.Tensor,
                         ctx: int) -> Dict[str, Any]:
        """One eager ``_prefill`` on a side stream (the kernels' first
        builds and the libraries' handles stay out of the graph), then its
        capture; no gradient is recorded."""
        static = tokens.clone()
        batch = {"tokens": static}
        here = torch.cuda.current_stream(self.device)
        with torch.no_grad():
            side = torch.cuda.Stream(self.device)
            side.wait_stream(here)
            with torch.cuda.stream(side):
                self._prefill(params, batch, ctx)
            here.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                logits, cache = self._prefill(params, batch, ctx)
        return {"graph": graph, "tokens": static, "logits": logits,
                "cache": cache}

    def drop_prefill_graphs(self) -> None:
        """Forget the captured prefills: their memory goes back to the
        allocator once no returned leaf is held any more."""
        self._graphs.clear()
        self._graph_params = None

    def _prefill(self, params: Params, batch: Dict[str, Any], ctx: int
                 ) -> Tuple[torch.Tensor, Params]:
        tokens = self._as_input(batch["tokens"])
        B, S = tokens.shape
        enc_out = (self._encode(params, batch["enc_frames"], remat=False)
                   if self.cfg.is_enc_dec else None)
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        rope = self._rope(positions) if self._has_attn else None
        cache = self.init_cache(B, ctx, x.dtype)
        cache["pos"] = S
        for gi, group in self._groups(encoder=False):
            gp, gc = params[f"g{gi}"], cache[f"g{gi}"]
            for r, lp in self._serve_layers(gp, group):
                for si, kind in enumerate(group.pattern):
                    p, sub = lp[f"s{si}"], gc[f"s{si}"]
                    if kind in ("rec", "rwkv"):
                        x = self._recurrent_layer(p, x, kind, sub, r)
                        continue
                    cross = None
                    if kind == "dec":
                        ck, cv = self._cross_kv(p, enc_out)
                        sub["ck"][r].copy_(ck)
                        sub["cv"][r].copy_(cv)
                        cross = (ck, cv, self._enc_positions())
                    x, k, v, _ = self._layer_fwd(p, x, kind, positions, rope,
                                                 cross)
                    C = sub["kpos"].shape[1]
                    n = min(C, S)
                    sel = positions[S - n:]
                    slots = (sel % C).long()
                    sub["k"][r][:, slots] = k[:, S - n:]
                    sub["v"][r][:, slots] = v[:, S - n:]
                    sub["kpos"][r][slots] = sel
        logits = self._logits(params, x[:, -1:, :])
        return logits, cache
