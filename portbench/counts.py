"""The yardstick's arithmetic: peaks, operations and bytes, model FLOPs.

Frozen here so that a change to the program cannot move it. The operation
counts follow the convention of the port's kernel bounds: 4 hd per valid
(query, key) pair and query head for attention's forward, 10 hd for its
backward; bytes count every input read once and every output written once.
The model FLOPs are ``launch/roofline.py::model_flops``'s (2 N_active a
token served, 6 N_active a token trained, plus the LM head), to which this
copy adds attention's pairs, which that function leaves out.
"""
from __future__ import annotations

from typing import Dict, Optional

# one NVIDIA H100 SXM5 80GB, NVIDIA's data sheet: dense rates, no sparsity,
# at the 700 W limit
PEAK_FLOPS_BF16 = 989e12
PEAK_BYTES = 3.35e12

ATTN_FWD_PER_PAIR = 4    # x hd: q.k and p.v, a multiply-add each
ATTN_BWD_PER_PAIR = 10   # x hd: s again, dp, dv, dq, dk


def causal_pairs(sq: int, skv: int, window: Optional[int]) -> int:
    """Valid (query, key) pairs of queries at positions skv - sq .. skv - 1
    over keys 0 .. skv - 1, causal; a query sees at most ``window`` keys
    (itself included), as the port's mask ``q - k < window`` gives."""
    off = skv - sq
    total = 0
    # query i (position off + i) sees min(off + i + 1, window) keys; summed
    # in closed form over the part below the window and the part at it
    cap = sq if window is None else min(max(window - off, 0), sq)
    total += cap * (off + 1) + cap * (cap - 1) // 2
    total += (sq - cap) * (window or 0)
    return total


def attention_flops(batch: int, heads: int, hd: int, pairs: int,
                    per_pair: int = ATTN_FWD_PER_PAIR) -> float:
    return float(per_pair * hd * heads * batch * pairs)


def attention_bytes(*, batch: int, sq: int, heads: int, kv_heads: int,
                    hd: int, live_keys: int, elem: int, lse: bool = False,
                    backward: bool = False) -> float:
    """q and out (and, backward, dout, dq and the LSE), K and V of the keys
    some query sees (backward: with dk and dv), the int32 positions."""
    q = batch * sq * heads * hd * elem
    kv = batch * live_keys * kv_heads * hd * elem
    pos = 4 * (sq + live_keys)
    lse_bytes = 4 * batch * heads * sq
    if backward:
        # q, out, dout, dq; k, v, dk, dv; lse read
        return 4 * q + 4 * kv + pos + lse_bytes
    return 2 * q + 2 * kv + pos + (lse_bytes if lse else 0)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations at the bf16 peak or
    bytes at HBM's, whichever is longer."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_BYTES)


# --------------------------------------------------------------------------- #
# Model FLOPs                                                                  #
# --------------------------------------------------------------------------- #
def active_params(shapes: Dict[str, tuple], top_k: int, n_experts: int
                  ) -> int:
    """Non-embedding parameters a token multiplies by, from the leaf shapes
    (``weights.leaf_shapes``): the expert leaves ``[L, E, ...]`` count
    ``top_k / n_experts`` of theirs; the embedding and the LM head are out
    (the head is :func:`model_flops`' own term)."""
    n = 0
    for path, shape in shapes.items():
        name = path.split("/")[-1]
        if path.startswith("embed/") or name == "lm_head":
            continue
        size = 1
        for d in shape:
            size *= d
        if n_experts and len(shape) == 4 and name in ("w_gate", "w_up",
                                                        "w_down"):
            size = size * top_k // n_experts
        n += size
    return n


def model_flops(active: int, d_model: int, vocab: int, *, tokens: int,
                head_tokens: int, attn_pairs: int, heads: int, hd: int,
                train: bool) -> float:
    """2 (serve) or 6 (train) x (N_active x tokens + d x V x head_tokens),
    plus attention's forward (x 3 in training: forward and backward) over
    ``attn_pairs`` valid pairs summed over sequences and layers."""
    mult = 6.0 if train else 2.0
    attn = attention_flops(1, heads, hd, attn_pairs) * (3 if train else 1)
    return mult * (active * tokens + d_model * vocab * head_tokens) + attn
