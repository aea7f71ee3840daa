"""The decoder backbone for the attention layer kinds (``attn``, ``local``).

The port of ``repro.models.backbone.Backbone`` for serving: the same
parameter tree (``g{i}/s{j}/<leaf>``, each group's leaves stacked ``[R, ...]``
over its repeat axis, ``x @ W`` weights ``[in, out]``), the same cache
(``[R,B,C,KV,hd]`` rings plus ``kpos [R,C]``) and the same entry points:

* ``prefill(params, batch, ctx)``        — run the context; last-token logits
  and a filled decode cache
* ``decode_step(params, cache, tokens)`` — one token against the cache

The repeat axis is a Python loop. Attention goes through
:mod:`repro_torch.kernels.ops` (the Hopper kernel on the card, the plain
version on the CPU), or straight to the plain version with
``attn_impl="plain"``, which exists to hold the kernel path against it.
The other layer kinds and MoE raise ``NotImplementedError`` naming their
slice in ROADMAP.md; training comes in slice 2.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels.ref import attention_plain

from .attention import flash_attention
from .common import (apply_rope_table, dense_init, embed_init, resolve_device,
                     rms_norm, rope_table)
from .config import ModelConfig
from .ffn import gated_mlp
from .partition import IDENTITY_PLAN, PartitionPlan

Params = Dict[str, Any]

_KIND_SLICE = {
    "rec": "slice 4 (recurrentgemma-9b)",
    "rwkv": "slice 5 (rwkv6-3b)",
    "enc": "slice 7 (whisper-tiny)",
    "dec": "slice 7 (whisper-tiny)",
}


class Backbone:
    def __init__(self, cfg: ModelConfig, plan: PartitionPlan = IDENTITY_PLAN,
                 *, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                 device="cuda", attn_impl: str = "kernel"):
        plan.check(cfg)
        for kind in cfg.layer_kinds():
            if kind not in ("attn", "local"):
                raise NotImplementedError(
                    f"layer kind {kind!r} is not ported yet: ROADMAP.md "
                    f"queue 1, {_KIND_SLICE.get(kind, 'unknown kind')}")
        if cfg.ffn_kind not in ("swiglu", "geglu", "gelu"):
            raise NotImplementedError(
                f"ffn kind {cfg.ffn_kind!r} is not ported yet: ROADMAP.md "
                "queue 1, slice 6 (MoE)")
        if attn_impl not in ("kernel", "plain"):
            raise ValueError(f"attn_impl {attn_impl!r}: want 'kernel' or "
                             "'plain'")
        self.cfg = cfg
        self.plan = plan
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.param_dtype = param_dtype
        self.attn_impl = attn_impl
        self.H = plan.eff_heads(cfg)
        self.KV = plan.eff_kv_heads(cfg)
        self.hd = cfg.hd
        self.Vp = plan.eff_vocab(cfg)

    # ------------------------------------------------------------------ #
    # Parameter construction                                             #
    # ------------------------------------------------------------------ #
    def _leaf_specs(self, kind: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
        cfg = self.cfg
        D, F = cfg.d_model, cfg.d_ff
        H, KV, hd = self.H, self.KV, self.hd
        specs: Dict[str, Tuple[Tuple[int, ...], str]] = {
            "ln1": ((D,), "zero"),
            "wq": ((D, H * hd), "dense"),
            "wk": ((D, KV * hd), "dense"),
            "wv": ((D, KV * hd), "dense"),
            "wo": ((H * hd, D), "dense"),
        }
        if cfg.qkv_bias:
            specs["bq"] = ((H * hd,), "zero")
            specs["bk"] = ((KV * hd,), "zero")
            specs["bv"] = ((KV * hd,), "zero")
        if cfg.qk_norm:
            specs["q_norm"] = ((hd,), "zero")
            specs["k_norm"] = ((hd,), "zero")
        specs["ln2"] = ((D,), "zero")
        if cfg.ffn_kind in ("swiglu", "geglu"):
            specs["w_gate"] = ((D, F), "dense")
            specs["w_up"] = ((D, F), "dense")
            specs["w_down"] = ((F, D), "dense")
        else:  # gelu
            specs["w_gate"] = ((D, F), "dense")
            specs["b_gate"] = ((F,), "zero")
            specs["w_down"] = ((F, D), "dense")
            specs["b_down"] = ((D,), "zero")
        return specs

    def init(self, seed: int = 0) -> Params:
        """Random parameters from a seeded ``torch.Generator`` on the
        backbone's device, in the reference's key order."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        pd, dev = self.param_dtype, self.device
        params: Params = {"embed": {"tok": embed_init(
            gen, (self.Vp, cfg.d_model), pd, dev)}}
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model, self.Vp),
                                           dtype=pd, device=dev)
        params["final_norm"] = torch.zeros(cfg.d_model, dtype=pd, device=dev)
        for gi, group in enumerate(cfg.groups):
            gp: Dict[str, Any] = {}
            for si, kind in enumerate(group.pattern):
                sub: Dict[str, Any] = {}
                for name, (shape, init) in self._leaf_specs(kind).items():
                    shape = (group.repeat,) + shape
                    sub[name] = (torch.zeros(shape, dtype=pd, device=dev)
                                 if init == "zero" else
                                 dense_init(gen, shape, dtype=pd, device=dev))
                gp[f"s{si}"] = sub
            params[f"g{gi}"] = gp
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
        attend = attention_plain if self.attn_impl == "plain" else flash_attention
        return attend(q, k, v, causal=True,
                      window=cfg.attn_window if kind == "local" else None,
                      logit_cap=cfg.attn_logit_softcap,
                      q_positions=q_positions, kv_positions=kv_positions)

    def _ffn_sublayer(self, p, x):
        h = rms_norm(x, p["ln2"], self.cfg.norm_eps)
        return gated_mlp(p, h, self.cfg.ffn_kind)

    def _rope(self, positions):
        cfg = self.cfg
        return rope_table(positions, self.hd, cfg.rope_theta, cfg.rotary_pct)

    def _layer_fwd(self, p, x, kind: str, positions, rope):
        """One layer over a sequence. Returns (x, k, v): the rotated keys and
        the values, which prefill keeps in the cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = self._qkv(p, h)
        q = apply_rope_table(q, rope)
        k = apply_rope_table(k, rope)
        o = self._attend(q, k, v, kind, positions, positions)
        x = x + o.reshape(B, S, self.H * self.hd) @ p["wo"]
        return x + self._ffn_sublayer(p, x), k, v

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
    # Serving: prefill + decode                                           #
    # ------------------------------------------------------------------ #
    def cache_len(self, kind: str, ctx: int) -> int:
        if kind == "local":
            return min(self.cfg.attn_window or ctx, ctx)
        return ctx

    def init_cache(self, B: int, ctx: int, dtype=None) -> Params:
        """An empty cache: ``pos`` (a Python int; JAX keeps an int32 scalar)
        and per attention layer ``k``/``v`` rings [R,B,C,KV,hd] with their
        positions ``kpos`` [R,C], -1 for an empty slot."""
        dtype = dtype or self.compute_dtype
        cache: Params = {"pos": 0}
        for gi, group in enumerate(self.cfg.groups):
            R = group.repeat
            gc: Dict[str, Any] = {}
            for si, kind in enumerate(group.pattern):
                C = self.cache_len(kind, ctx)
                shape = (R, B, C, self.KV, self.hd)
                gc[f"s{si}"] = {
                    "k": torch.zeros(shape, dtype=dtype, device=self.device),
                    "v": torch.zeros(shape, dtype=dtype, device=self.device),
                    "kpos": torch.full((R, C), -1, dtype=torch.int32,
                                       device=self.device),
                }
            cache[f"g{gi}"] = gc
        return cache

    def _layer_decode(self, p, x, kind: str, sub, r: int, pos: int, posv,
                      rope):
        """One-token step of layer ``r`` of a group. x: [B,1,D]. Writes the
        token's key and value into ring slot ``pos % C`` before attending."""
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
        cost a copy of every ring here): each layer's slot ``pos % C`` and
        ``kpos``, then ``pos + 1``.
        """
        pos = int(cache["pos"])
        tokens = torch.as_tensor(tokens, device=self.device)
        x = self._embed_tokens(params, tokens)
        posv = torch.full((1,), pos, dtype=torch.int32, device=self.device)
        rope = self._rope(posv)
        for gi, group in enumerate(self.cfg.groups):
            gp, gc = params[f"g{gi}"], cache[f"g{gi}"]
            for r in range(group.repeat):
                lp = self._layer_params(gp, r)
                for si, kind in enumerate(group.pattern):
                    x = self._layer_decode(lp[f"s{si}"], x, kind,
                                           gc[f"s{si}"], r, pos, posv, rope)
        cache["pos"] = pos + 1
        return self._logits(params, x), cache

    def prefill(self, params: Params, batch: Dict[str, Any], ctx: int
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full context; return (last-token logits, filled cache).

        Each layer's rotated keys and values are kept from its forward (JAX
        recomputes them, with identical numbers); a ring of C slots keeps
        the last ``min(C, S)`` positions at slots ``position % C``.
        """
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        B, S = tokens.shape
        x = self._embed_tokens(params, tokens)
        positions = torch.arange(S, dtype=torch.int32, device=self.device)
        rope = self._rope(positions)
        cache = self.init_cache(B, ctx, x.dtype)
        cache["pos"] = S
        for gi, group in enumerate(self.cfg.groups):
            gp, gc = params[f"g{gi}"], cache[f"g{gi}"]
            for r in range(group.repeat):
                lp = self._layer_params(gp, r)
                for si, kind in enumerate(group.pattern):
                    sub = gc[f"s{si}"]
                    x, k, v = self._layer_fwd(lp[f"s{si}"], x, kind,
                                              positions, rope)
                    C = sub["kpos"].shape[1]
                    n = min(C, S)
                    sel = positions[S - n:]
                    slots = (sel % C).long()
                    sub["k"][r][:, slots] = k[:, S - n:]
                    sub["v"][r][:, slots] = v[:, S - n:]
                    sub["kpos"][r][slots] = sel
        logits = self._logits(params, x[:, -1:, :])
        return logits, cache
