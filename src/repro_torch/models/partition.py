"""Partition plan: TP-alignment padding (a copy of the JAX package's).

Query heads are zero-padded up to a multiple of TP, KV heads replicated up
to TP when fewer, and the vocab zero-padded to ``vocab_align`` and masked in
the logits. Each padding is exact: the padded model computes the same
function. A single-card model uses ``IDENTITY_PLAN``; on a mesh the plan
takes the "model" axis' size (``launch/dryrun.py``, ``launch/train.py``), so
that the backbone derives its head and vocab sizes exactly as the
reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

from .config import ModelConfig


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class PartitionPlan:
    """Mesh-derived padding/replication decisions for one model."""

    tp: int = 1                  # size of the "model" mesh axis
    vocab_align: int = 128

    def eff_heads(self, cfg: ModelConfig) -> int:
        return _round_up(cfg.n_heads, self.tp)

    def eff_kv_heads(self, cfg: ModelConfig) -> int:
        """TP-aligned KV head count, chosen so replication stays *exact*.

        Consecutive replication by ``rep`` is exact iff ``rep`` divides the
        original group size and no query padding is needed; otherwise fall
        back to one KV head per query head.
        """
        kv, h, tp = cfg.n_kv_heads, cfg.n_heads, self.tp
        if kv % tp == 0:
            return kv
        g_orig = h // kv
        rep = _round_up(kv, tp) // kv
        if h % tp == 0 and g_orig % rep == 0:
            return kv * rep                      # consecutive replication
        return self.eff_heads(cfg)               # per-query KV (G_new = 1)

    def kv_replication(self, cfg: ModelConfig) -> int:
        return self.eff_kv_heads(cfg) // cfg.n_kv_heads

    def kv_graft_map(self, cfg: ModelConfig):
        """``map[j]`` = original kv head whose weights fill padded slot ``j``
        (None = zero slot for padded query heads)."""
        kv = cfg.n_kv_heads
        h = cfg.n_heads
        eff_kv = self.eff_kv_heads(cfg)
        g_orig = h // kv
        if eff_kv == kv:
            return list(range(kv))
        if eff_kv == self.eff_heads(cfg):        # per-query KV
            return [i // g_orig if i < h else None for i in range(eff_kv)]
        rep = eff_kv // kv                       # consecutive replication
        return [j // rep for j in range(eff_kv)]

    def eff_vocab(self, cfg: ModelConfig) -> int:
        return _round_up(cfg.vocab, max(self.vocab_align, self.tp))

    def eff_rwkv_heads(self, cfg: ModelConfig) -> int:
        h = cfg.d_model // cfg.rwkv_head_dim
        return _round_up(h, self.tp)

    def check(self, cfg: ModelConfig) -> None:
        if cfg.d_model % self.tp:
            raise ValueError(f"{cfg.name}: d_model % tp != 0")
        if cfg.d_ff % self.tp:
            raise ValueError(f"{cfg.name}: d_ff % tp != 0")
        if cfg.moe_d_ff and cfg.moe_d_ff % self.tp:
            raise ValueError(f"{cfg.name}: moe_d_ff % tp != 0")


IDENTITY_PLAN = PartitionPlan(tp=1, vocab_align=1)
