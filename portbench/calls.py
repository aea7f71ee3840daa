"""Which calls into the port the traced run puts ranges around, and the
least time of an attention call from its shapes and positions.

Ranges (the names the per-layer metrics and the breakdown use):

* ``ops.attention flash_fwd`` / ``ops.attention flash_decode``: the
  serving entry of K1, split by the port's own rule (one query position is
  a decode step);
* ``ops.attention_fwd`` (K1 with its LSE) and ``ops.attention_bwd`` (K1b):
  training's entries;
* ``moe_mlp``: the MoE layer (``models.backbone.moe_mlp``);
* ``Backbone.prefill``, ``Backbone.decode_step`` (serving);
* ``VersionedStateStore.commit_step`` and ``Trainer step`` (training).

A kernel's roofline share is the least time of the calls' work over the
device time inside their ranges, so that whatever implements an entry
later (another kernel, a library call) is held to the same work.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import counts
from .tracing import Ranges


class AttentionName:
    """The range of an ``ops.attention`` call: flash_decode for one query
    position, flash_fwd otherwise (``kernels/ops.py``'s dispatch)."""

    names = ["ops.attention flash_fwd", "ops.attention flash_decode"]

    def __call__(self, q, *args, **kwargs) -> str:
        return self.names[1] if q.shape[1] == 1 else self.names[0]


def attention_note(kind: str):
    """Record a call's shapes and its positions (copied after the range
    closes: the decode ring's positions are written again later)."""
    def note(args, kwargs, out) -> Dict:
        q, k = args[0], args[1]
        return {"kind": kind, "q": tuple(q.shape), "k": tuple(k.shape),
                "elem": q.element_size(), "causal": kwargs.get("causal", True),
                "window": kwargs.get("window"),
                "qpos": kwargs["q_positions"].clone(),
                "kpos": kwargs["kv_positions"].clone()}
    return note


def tokens_note(args, kwargs, out) -> int:
    x = args[1]                      # moe_mlp(params, x [B, S, D], cfg, ...)
    return int(x.shape[0] * x.shape[1])


def attention_least_s(rec: Dict) -> float:
    """The least time of a recorded call: 4 hd (forward) or 10 hd
    (backward) per valid (query, key) pair and query head at the bf16
    peak, or every input and output byte once at HBM's rate."""
    qp = rec["qpos"].long().cpu()
    kp = rec["kpos"].long().cpu()
    d = qp[:, None] - kp[None, :]
    ok = (kp[None, :] >= 0).expand(d.shape)
    if rec["causal"]:
        ok = ok & (d >= 0)
    if rec["window"] is not None:
        ok = ok & (d < rec["window"])
    pairs = int(ok.sum())
    live = int(ok.any(0).sum())
    B, Sq, H, hd = rec["q"]
    KV = rec["k"][2]
    bwd = rec["kind"] == "bwd"
    flops = counts.attention_flops(
        B, H, hd, pairs,
        counts.ATTN_BWD_PER_PAIR if bwd else counts.ATTN_FWD_PER_PAIR)
    nbytes = counts.attention_bytes(batch=B, sq=Sq, heads=H, kv_heads=KV,
                                    hd=hd, live_keys=live, elem=rec["elem"],
                                    lse=rec["kind"] == "lse", backward=bwd)
    return counts.least_seconds(flops, nbytes)


def serve_ranges(bb) -> Ranges:
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    return (Ranges()
            .add(ops, "attention", AttentionName(), attention_note("fwd"),
                 bracket=True)
            .add(backbone, "moe_mlp", "moe_mlp", tokens_note, bracket=True)
            .add(bb, "prefill", "Backbone.prefill")
            .add(bb, "decode_step", "Backbone.decode_step"))


def train_ranges(trainer) -> Ranges:
    from repro_torch.kernels import ops
    from repro_torch.models import backbone
    return (Ranges()
            .add(ops, "attention_fwd", "ops.attention_fwd",
                 attention_note("lse"), bracket=True)
            .add(ops, "attention_bwd", "ops.attention_bwd",
                 attention_note("bwd"), bracket=True)
            .add(backbone, "moe_mlp", "moe_mlp", tokens_note, bracket=True)
            .add(trainer, "_step", "Trainer step")
            .add(trainer.store, "commit_step",
                 "VersionedStateStore.commit_step"))


def least_by_range(calls: Dict[str, list]) -> Dict[str, float]:
    """Summed least seconds of the recorded attention calls, by range."""
    return {name: sum(attention_least_s(r) for r in recs)
            for name, recs in calls.items()
            if recs and isinstance(recs[0], dict) and "qpos" in recs[0]}


def roofline_share(record: Dict, range_name: str):
    """The least time of the calls in one entry's ranges over the device
    time inside them in the profiled stretch, in %; None without both."""
    st = record.get("stretch") or {}
    least = st.get("least_s", {}).get(range_name)
    device = st.get("range_device_s", {}).get(range_name)
    if not least or not device:
        return None
    return least / device * 100
