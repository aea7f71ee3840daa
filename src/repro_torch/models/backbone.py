"""The decoder backbone for the layer kinds ``attn``, ``local``, ``rec`` and
``rwkv``.

The port of ``repro.models.backbone.Backbone`` for serving and training:
the same parameter tree (``g{i}/s{j}/<leaf>``, each group's leaves stacked
``[R, ...]`` over its repeat axis, ``x @ W`` weights ``[in, out]``), the same
cache (per attention layer ``[R,B,C,KV,hd]`` rings plus ``kpos [R,C]``; per
``rec`` layer ``conv [R,B,K-1,W]`` and ``h [R,B,W]`` fp32; per ``rwkv`` layer
``shift1``/``shift2 [R,B,D]`` and ``wkv [R,B,H,hd,hd]`` fp32) and the same
entry points:

* ``loss_fn(params, batch)``             — training loss (causal LM), for
  the ``attn`` and ``local`` kinds
* ``prefill(params, batch, ctx)``        — run the context; last-token logits
  and a filled decode cache
* ``decode_step(params, cache, tokens)`` — one token against the cache

The repeat axis is a Python loop; with ``remat`` each layer of ``loss_fn``
runs under ``torch.utils.checkpoint`` (non-reentrant), where the reference
wraps its scan body in ``jax.checkpoint``. Attention and the two scans go
through :mod:`repro_torch.kernels.ops` (the Hopper kernels on the card, the
plain versions on the CPU), or straight to the plain versions with
``kernel_impl="plain"``, which exists to hold the kernel path against them;
attention's gradient comes from
:class:`repro_torch.models.attention.FlashAttention`.
The encoder-decoder kinds and MoE raise ``NotImplementedError`` naming their
slice in ROADMAP.md, and so does ``loss_fn`` for the recurrent kinds.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops, ref

from . import rwkv6
from .attention import flash_attention
from .common import (apply_rope_table, dense_init, embed_init, resolve_device,
                     rms_norm, rope_table, stable_cross_entropy)
from .config import ModelConfig
from .ffn import gated_mlp
from .partition import IDENTITY_PLAN, PartitionPlan
from .rglru import causal_conv1d

Params = Dict[str, Any]

_KINDS = ("attn", "local", "rec", "rwkv")
_KIND_SLICE = {
    "enc": "slice 7 (whisper-tiny)",
    "dec": "slice 7 (whisper-tiny)",
}
_RWKV_LORA = 64       # rank of the decay LoRA
_DDLERP_RANK = 32     # rank of the token-shift LoRA
AUX_COEF = 0.01       # weight of the auxiliary (MoE) loss in loss_fn


class Backbone:
    def __init__(self, cfg: ModelConfig, plan: PartitionPlan = IDENTITY_PLAN,
                 *, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                 remat: bool = True, device="cuda",
                 kernel_impl: str = "kernel"):
        plan.check(cfg)
        for kind in cfg.layer_kinds():
            if kind not in _KINDS:
                raise NotImplementedError(
                    f"layer kind {kind!r} is not ported yet: ROADMAP.md "
                    f"queue 1, {_KIND_SLICE.get(kind, 'unknown kind')}")
        if cfg.ffn_kind not in ("swiglu", "geglu", "gelu"):
            raise NotImplementedError(
                f"ffn kind {cfg.ffn_kind!r} is not ported yet: ROADMAP.md "
                "queue 1, slice 6 (MoE)")
        if kernel_impl not in ("kernel", "plain"):
            raise ValueError(f"kernel_impl {kernel_impl!r}: want 'kernel' or "
                             "'plain'")
        self.cfg = cfg
        self.plan = plan
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.remat = remat
        plain = kernel_impl == "plain"
        self._plain_attention = plain
        self._rglru_scan = ref.rglru_scan_plain if plain else ops.rglru_scan
        self._wkv_scan = ref.rwkv6_scan_plain if plain else ops.rwkv6_scan
        self.H = plan.eff_heads(cfg)
        self.KV = plan.eff_kv_heads(cfg)
        self.hd = cfg.hd
        self.Vp = plan.eff_vocab(cfg)
        self.rwkv_H = plan.eff_rwkv_heads(cfg)
        self.W = cfg.rglru_width or cfg.d_model
        self._has_attn = any(k in ("attn", "local") for k in cfg.layer_kinds())

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
        else:  # attn, local
            H, KV, hd = self.H, self.KV, self.hd
            specs["wq"] = ((D, H * hd), "dense")
            specs["wk"] = ((D, KV * hd), "dense")
            specs["wv"] = ((D, KV * hd), "dense")
            specs["wo"] = ((H * hd, D), "dense")
            if cfg.qkv_bias:
                specs["bq"] = ((H * hd,), "zero")
                specs["bk"] = ((KV * hd,), "zero")
                specs["bv"] = ((KV * hd,), "zero")
            if cfg.qk_norm:
                specs["q_norm"] = ((hd,), "zero")
                specs["k_norm"] = ((hd,), "zero")
        specs["ln2"] = ((D,), "zero")
        if cfg.ffn_kind in ("swiglu", "geglu"):
            specs["w_gate"] = ((D, F_), "dense")
            specs["w_up"] = ((D, F_), "dense")
            specs["w_down"] = ((F_, D), "dense")
        else:  # gelu
            specs["w_gate"] = ((D, F_), "dense")
            specs["b_gate"] = ((F_,), "zero")
            specs["w_down"] = ((F_, D), "dense")
            specs["b_down"] = ((D,), "zero")
        return specs

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

    def _layer_params(self, gp: Params, r: int) -> Params:
        """Layer ``r`` of a group: views of the stacked leaves, cast to the
        compute dtype (no copy when the dtypes agree)."""
        cd = self.compute_dtype
        return {s: {name: leaf[r].to(cd)
                    if leaf.is_floating_point() and leaf.dtype != cd
                    else leaf[r]
                    for name, leaf in sub.items()}
                for s, sub in gp.items()}

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
        q = q.reshape(B, S, self.H, self.hd)
        k = k.reshape(B, S, self.KV, self.hd)
        v = v.reshape(B, S, self.KV, self.hd)
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        return q, k, v

    def _attend(self, q, k, v, kind: str, q_positions, kv_positions):
        cfg = self.cfg
        return flash_attention(q, k, v, causal=True,
                               window=cfg.attn_window if kind == "local" else None,
                               logit_cap=cfg.attn_logit_softcap,
                               q_positions=q_positions,
                               kv_positions=kv_positions,
                               plain=self._plain_attention)

    def _ffn_sublayer(self, p, x):
        h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        return gated_mlp(p, h, self.cfg.ffn_kind)

    def _rope(self, positions):
        cfg = self.cfg
        return rope_table(positions, self.hd, cfg.rope_theta, cfg.rotary_pct)

    def _layer_fwd(self, p, x, kind: str, positions, rope):
        """One attention layer over a sequence. Returns (x, k, v): the
        rotated keys and the values, which prefill keeps in the cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = self._qkv(p, h)
        q = apply_rope_table(q, rope)
        k = apply_rope_table(k, rope)
        o = self._attend(q, k, v, kind, positions, positions)
        x = x + o.reshape(B, S, self.H * self.hd) @ p["wo"]
        return x + self._ffn_sublayer(p, x), k, v

    # -- the recurrent kinds: one function for prefill and decode -----------
    # Prefill starts from the zero state of a fresh cache, as the reference
    # starts from zeros; each call reads layer r's state from the cache and
    # writes the new state back in place (the scans write theirs directly).
    def _rglru_apply(self, p, h, conv_state, h_state):
        """Griffin recurrent block with block-diagonal gates. h: [B,T,D];
        conv_state [B,K-1,W] and h_state [B,W] fp32 are updated in place."""
        NB = self.cfg.n_heads
        wb = self.W // NB
        branch = h @ p["w_in"]
        gate = F.gelu(h @ p["w_gate_branch"], approximate="tanh")
        branch, conv_new = causal_conv1d(p, branch, conv_state)
        conv_state.copy_(conv_new)
        bb = branch.reshape(*branch.shape[:-1], NB, wb)
        r = torch.sigmoid(torch.einsum("...nw,nwv->...nv", bb, p["gw_a"])
                          .reshape(branch.shape) + p["gb_a"])
        i = torch.sigmoid(torch.einsum("...nw,nwv->...nv", bb, p["gw_x"])
                          .reshape(branch.shape) + p["gb_x"])
        y, _ = self._rglru_scan(branch, p["a_log"], r, i, h_state,
                                h_out=h_state)
        return (y.to(h.dtype) * gate) @ p["w_out"]

    def _rec_layer(self, p, x, sub, r: int):
        h = rms_norm(x, p["ln1"], self.cfg.norm_eps)
        x = x + self._rglru_apply(p, h, sub["conv"][r], sub["h"][r]).to(x.dtype)
        return x + self._ffn_sublayer(p, x)

    def _rwkv_layer(self, p, x, sub, r: int):
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        wkv = sub["wkv"][r]
        y, shift1, _ = rwkv6.time_mix(p, h, sub["shift1"][r], wkv, self.rwkv_H,
                                      cfg.rwkv_head_dim, wkv_out=wkv,
                                      scan=self._wkv_scan)
        sub["shift1"][r].copy_(shift1)
        x = x + y.to(x.dtype)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        y, shift2 = rwkv6.channel_mix(
            {"mu_k": p["mu_k2"], "mu_r": p["mu_r2"], "w_in": p["w_in"],
             "w_out": p["w_out"], "w_rgate": p["w_rgate"]},
            h, sub["shift2"][r])
        sub["shift2"][r].copy_(shift2)
        return x + y

    def _recurrent_layer(self, p, x, kind: str, sub, r: int):
        if kind == "rec":
            return self._rec_layer(p, x, sub, r)
        return self._rwkv_layer(p, x, sub, r)

    def _embed_tokens(self, params, tokens) -> torch.Tensor:
        cfg = self.cfg
        tok = params["embed"]["tok"]
        x = torch.index_select(tok, 0, tokens.reshape(-1))
        x = x.reshape(*tokens.shape, cfg.d_model).to(self.compute_dtype)
        if cfg.embed_scale:
            x = x * torch.sqrt(torch.tensor(cfg.d_model,
                                            dtype=self.compute_dtype))
        return x

    def _logits(self, params, x) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, params["final_norm"].to(self.compute_dtype),
                     cfg.norm_eps)
        head = (params["embed"]["tok"].T if cfg.tie_embeddings
                else params["lm_head"]).to(self.compute_dtype)
        logits = x @ head
        if self.Vp != cfg.vocab:  # mask padded vocab columns
            mask = torch.arange(self.Vp, device=logits.device) < cfg.vocab
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, -1e30))
        return logits

    # ------------------------------------------------------------------ #
    # Training: loss                                                      #
    # ------------------------------------------------------------------ #
    def _train_layer(self, gp, r: int, pattern, x, positions, rope):
        """Layer ``r`` of a group in training: its parameters sliced and
        cast inside, so that remat recomputes the cast as the reference's
        scan body does."""
        lp = self._layer_params(gp, r)
        for si, kind in enumerate(pattern):
            x, _, _ = self._layer_fwd(lp[f"s{si}"], x, kind, positions, rope)
        return x

    def loss_fn(self, params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean next-token cross-entropy (fp32) of ``batch["tokens"]``
        against ``batch["labels"]`` (both [B, S]), plus ``AUX_COEF`` times
        the auxiliary loss, which is 0 without MoE."""
        cfg = self.cfg
        for kind in cfg.layer_kinds():
            if kind in ("rec", "rwkv"):
                raise NotImplementedError(
                    f"training the {kind!r} kind needs the backward of its "
                    "scan: ROADMAP.md queue 2, the K2 and K3 backwards, with "
                    "the slice that trains recurrentgemma and rwkv6")
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=self.device)
        rope = self._rope(positions)
        for gi, group in enumerate(cfg.groups):
            gp = params[f"g{gi}"]
            for r in range(group.repeat):
                if self.remat:
                    x = checkpoint(self._train_layer, gp, r, group.pattern, x,
                                   positions, rope, use_reentrant=False)
                else:
                    x = self._train_layer(gp, r, group.pattern, x, positions,
                                          rope)
        logits = self._logits(params, x)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        loss = stable_cross_entropy(logits, labels, cfg.final_logit_softcap)
        return loss + AUX_COEF * aux

    # ------------------------------------------------------------------ #
    # Serving: prefill + decode                                           #
    # ------------------------------------------------------------------ #
    def cache_len(self, kind: str, ctx: int) -> int:
        if kind == "local":
            return min(self.cfg.attn_window or ctx, ctx)
        return ctx

    def init_cache(self, B: int, ctx: int, dtype=None) -> Params:
        """An empty cache: ``pos`` (a Python int; JAX keeps an int32 scalar);
        per attention layer ``k``/``v`` rings [R,B,C,KV,hd] with their
        positions ``kpos`` [R,C], -1 for an empty slot; per ``rec`` layer
        ``conv`` [R,B,K-1,W] and ``h`` [R,B,W] fp32; per ``rwkv`` layer
        ``shift1``/``shift2`` [R,B,D] and ``wkv`` [R,B,H,hd,hd] fp32."""
        cfg = self.cfg
        dtype = dtype or self.compute_dtype
        dev = self.device

        def zeros(shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=dev)

        cache: Params = {"pos": 0}
        for gi, group in enumerate(cfg.groups):
            R = group.repeat
            gc: Dict[str, Any] = {}
            for si, kind in enumerate(group.pattern):
                if kind == "rec":
                    sub = {"conv": zeros((R, B, cfg.conv1d_width - 1, self.W)),
                           "h": zeros((R, B, self.W), torch.float32)}
                elif kind == "rwkv":
                    hdr = cfg.rwkv_head_dim
                    sub = {"shift1": zeros((R, B, cfg.d_model)),
                           "wkv": zeros((R, B, self.rwkv_H, hdr, hdr),
                                        torch.float32),
                           "shift2": zeros((R, B, cfg.d_model))}
                else:
                    C = self.cache_len(kind, ctx)
                    sub = {"k": zeros((R, B, C, self.KV, self.hd)),
                           "v": zeros((R, B, C, self.KV, self.hd)),
                           "kpos": torch.full((R, C), -1, dtype=torch.int32,
                                              device=dev)}
                gc[f"s{si}"] = sub
            cache[f"g{gi}"] = gc
        return cache

    def _layer_decode(self, p, x, kind: str, sub, r: int, pos: int, posv,
                      rope):
        """One-token step of attention layer ``r`` of a group. x: [B,1,D].
        Writes the token's key and value into ring slot ``pos % C`` before
        attending."""
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
        x = x + o.reshape(B, 1, self.H * self.hd) @ p["wo"]
        return x + self._ffn_sublayer(p, x)

    def decode_step(self, params: Params, cache: Params, tokens
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens: [B, 1] -> (logits [B, 1, Vp], cache).

        The cache is updated in place (JAX returns a new one, which would
        cost a copy of every ring and state here): each attention layer's
        slot ``pos % C`` and ``kpos``, each recurrent layer's state, then
        ``pos + 1``.
        """
        pos = int(cache["pos"])
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed_tokens(params, tokens)
        posv = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        rope = self._rope(posv) if self._has_attn else None
        for gi, group in enumerate(self.cfg.groups):
            gp, gc = params[f"g{gi}"], cache[f"g{gi}"]
            for r in range(group.repeat):
                lp = self._layer_params(gp, r)
                for si, kind in enumerate(group.pattern):
                    p, sub = lp[f"s{si}"], gc[f"s{si}"]
                    if kind in ("rec", "rwkv"):
                        x = self._recurrent_layer(p, x, kind, sub, r)
                    else:
                        x = self._layer_decode(p, x, kind, sub, r, pos, posv,
                                               rope)
        cache["pos"] = pos + 1
        return self._logits(params, x), cache

    def prefill(self, params: Params, batch: Dict[str, Any], ctx: int
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full context; return (last-token logits, filled cache).

        Each attention layer's rotated keys and values are kept from its
        forward (JAX recomputes them, with identical numbers); a ring of C
        slots keeps the last ``min(C, S)`` positions at slots
        ``position % C``. Each recurrent layer runs from the fresh cache's
        zero state and leaves its final state there.
        """
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        rope = self._rope(positions) if self._has_attn else None
        cache = self.init_cache(B, ctx, x.dtype)
        cache["pos"] = S
        for gi, group in enumerate(self.cfg.groups):
            gp, gc = params[f"g{gi}"], cache[f"g{gi}"]
            for r in range(group.repeat):
                lp = self._layer_params(gp, r)
                for si, kind in enumerate(group.pattern):
                    p, sub = lp[f"s{si}"], gc[f"s{si}"]
                    if kind in ("rec", "rwkv"):
                        x = self._recurrent_layer(p, x, kind, sub, r)
                        continue
                    x, k, v = self._layer_fwd(p, x, kind, positions, rope)
                    C = sub["kpos"].shape[1]
                    n = min(C, S)
                    sel = positions[S - n:]
                    slots = (sel % C).long()
                    sub["k"][r][:, slots] = k[:, S - n:]
                    sub["v"][r][:, slots] = v[:, S - n:]
                    sub["kpos"][r][slots] = sel
        logits = self._logits(params, x[:, -1:, :])
        return logits, cache
