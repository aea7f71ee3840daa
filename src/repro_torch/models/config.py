"""Model / shape configuration (a copy of the JAX package's, for the port).

A :class:`ModelConfig` fully describes one architecture. Heterogeneous layer
stacks are expressed as *segments*: an ordered list of
``LayerGroup(pattern, repeat)`` where ``pattern`` is a tuple of layer kinds.
Each group's parameters are stacked along the repeat axis.

Layer kinds:
  ``attn``    full-attention transformer block
  ``local``   sliding-window attention block
  ``rec``     RG-LRU recurrent block (recurrentgemma)
  ``rwkv``    RWKV-6 time/channel mixing block
  ``enc``     whisper encoder block (full self-attn, no causal mask)
  ``dec``     whisper decoder block (causal self-attn + cross-attn)

FFN kinds: ``swiglu`` | ``geglu`` | ``gelu`` | ``moe`` | ``rwkv_cmix``.

All ten of the reference's architectures are registered (``ARCH_NAMES``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class LayerGroup:
    """``repeat`` consecutive copies of the ``pattern`` of layer kinds."""

    pattern: Tuple[str, ...]
    repeat: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeat


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    groups: Tuple[LayerGroup, ...]
    head_dim: Optional[int] = None   # default d_model // n_heads
    ffn_kind: str = "swiglu"
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_window: Optional[int] = None      # for "local" layers
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0                # partial rotary (phi4)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None         # per-expert hidden dim
    capacity_factor: float = 1.25
    # recurrent mixers
    rwkv_head_dim: int = 64
    rglru_width: Optional[int] = None      # recurrent state width (default d_model)
    conv1d_width: int = 4
    # encoder-decoder (whisper)
    enc_seq: int = 0                       # frontend frames fed to the encoder
    enc_d_model: Optional[int] = None
    # embeddings / misc
    tie_embeddings: bool = True
    embed_scale: bool = False              # gemma-style sqrt(d) embedding scale
    norm_eps: float = 1e-6
    # frontend stub: "none" | "audio" (precomputed frames) | "patch" (vlm)
    frontend: str = "none"

    # ---- derived -----------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.groups)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def is_enc_dec(self) -> bool:
        return any("dec" in g.pattern or "enc" in g.pattern for g in self.groups)

    @property
    def sub_quadratic(self) -> bool:
        """True iff no layer needs an unbounded-window attention KV cache."""
        for g in self.groups:
            for kind in g.pattern:
                if kind in ("attn", "enc", "dec"):
                    return False
        return True

    def layer_kinds(self) -> List[str]:
        out: List[str] = []
        for g in self.groups:
            out.extend(list(g.pattern) * g.repeat)
        return out

    # ---- parameter count ---------------------------------------------------
    def param_count(self, *, active_only: bool = False) -> int:
        d, hd = self.d_model, self.hd
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d
        if self.qkv_bias:
            attn += (nq + 2 * nkv) * hd
        if self.qk_norm:
            attn += 2 * hd
        dense_ffn = 3 * d * self.d_ff if self.ffn_kind in ("swiglu", "geglu") else 2 * d * self.d_ff
        eff = self.moe_d_ff or self.d_ff
        n_e = self.top_k if active_only else self.n_experts
        moe_ffn = 3 * d * eff * max(n_e, 1) + d * self.n_experts  # experts + router
        rwkv_tmix = 6 * d * d + 6 * d  # r,k,v,g,w,o projections + decay params (approx)
        rwkv_cmix = 2 * d * int(self.d_ff)
        w = self.rglru_width or d
        rglru = d * w * 2 + w * self.conv1d_width + 2 * w + w * d  # in/gate, conv, Λ/gates, out
        norms = 2 * d
        kind_params = {
            "attn": attn + (moe_ffn if self.ffn_kind == "moe" else dense_ffn) + norms,
            "local": attn + (moe_ffn if self.ffn_kind == "moe" else dense_ffn) + norms,
            "enc": attn + dense_ffn + norms,
            "dec": 2 * attn + dense_ffn + 3 * d,  # self + cross attention
            "rwkv": rwkv_tmix + rwkv_cmix + norms,
            "rec": rglru + dense_ffn + norms,
        }
        total = 0
        for kind in self.layer_kinds():
            total += kind_params[kind]
        total += self.vocab * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab * d
        total += d  # final norm
        return int(total)


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what gets run and with which step fn."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family config for CPU smoke tests."""
    groups = []
    for g in cfg.groups:
        groups.append(LayerGroup(g.pattern, repeat=1))
    small = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=512,
        groups=tuple(groups[:2]) if len(groups) > 2 else tuple(groups),
        attn_window=min(cfg.attn_window, 32) if cfg.attn_window else None,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_d_ff=32 if cfg.moe_d_ff else None,
        # drop-free routing so smoke tests compare decode against prefill
        # exactly (capacity drops are order-dependent by design)
        capacity_factor=8.0 if cfg.n_experts else cfg.capacity_factor,
        rwkv_head_dim=16,
        rglru_width=64 if cfg.rglru_width else None,
        enc_seq=16 if cfg.enc_seq else 0,
        enc_d_model=64 if cfg.enc_d_model else None,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


# ---------------------------------------------------------------------------
# Registry: populated by repro_torch.configs.<arch> modules.
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, ModelConfig] = {}

# The architectures the port runs: all ten of the reference's.
ARCH_NAMES = ["qwen3-4b", "gemma2-2b", "qwen2-7b", "phi4-mini-3.8b",
              "chameleon-34b", "recurrentgemma-9b", "rwkv6-3b",
              "mixtral-8x22b", "qwen3-moe-235b-a22b", "whisper-tiny"]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_NAMES:
        raise KeyError(f"unknown architecture {name!r}; known: {ARCH_NAMES}")
    load_all_configs()
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    load_all_configs()
    return dict(_REGISTRY)


def load_all_configs() -> None:
    import importlib

    for name in ARCH_NAMES:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
