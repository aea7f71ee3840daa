"""Wrapper of the Hopper split-KV decode kernel (``csrc/flash_decode.cu``).

It computes the function of :func:`repro_torch.kernels.flash_attention.flash_fwd`
for one query position, which is what every decode step asks of attention:
the keys are cut into ``n_splits`` contiguous chunks, one CTA each per
(slot, kv head), and a second pass combines the chunks' partial softmax
statistics. :mod:`repro_torch.kernels.ops` sends a CUDA call with
``Sq == 1`` here and every other CUDA call to ``flash_fwd``. Its plain
versions are :func:`repro_torch.kernels.ref.attention_plain` (the function)
and :func:`repro_torch.kernels.ref.attention_split_plain` (the two passes).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build
from .flash_attention import _DTYPES, check_inputs

SPLIT_TILE = 64        # keys per tile of the kernel; a split is whole tiles
ROWS_PER_CTA = 16      # query heads of one kv head that a CTA takes
SMS = 132              # streaming multiprocessors of an H100 SXM
CTAS_PER_SM = 2        # the split count aims at about two CTAs per SM

_ptr, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# q, k, v, q_pos, kv_pos, part, out; B, Skv, Hq, Hkv, hd, dtype, causal,
# window, n_splits, split_keys; logit_cap, scale; stream
_ARGS = [_ptr] * 7 + [_i32] * 10 + [_f32, _f32, _ptr]


def split_plan(B: int, Hkv: int, G: int, Skv: int) -> Tuple[int, int]:
    """(n_splits, keys per split) from the shapes alone: enough CTAs for
    about two per SM, each split at least one 64-key tile, no split empty."""
    tiles = max(1, math.ceil(Skv / SPLIT_TILE))
    ctas = B * Hkv * math.ceil(G / ROWS_PER_CTA)
    want = max(1, math.ceil(CTAS_PER_SM * SMS / ctas))
    per_split = math.ceil(tiles / min(tiles, want))
    return math.ceil(tiles / per_split), per_split * SPLIT_TILE


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: Optional[int] = None,
                 logit_cap: Optional[float] = None,
                 q_positions: torch.Tensor, kv_positions: torch.Tensor
                 ) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with one query position:
    q [B,1,Hq,hd] -> [B,1,Hq,hd] in q's dtype."""
    check_inputs(q, k, v, q_positions, kv_positions, window, logit_cap)
    if q.shape[1] != 1:
        raise ValueError(f"flash_decode takes one query position, got "
                         f"{q.shape[1]}")
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on CUDA tensors, not {q.device}")
    B, _, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    n_splits, split_keys = split_plan(B, Hkv, Hq // Hkv, Skv)
    part = torch.empty((B, Hkv, n_splits, Hq // Hkv, hd + 2),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = build.entry("flash_decode", _ARGS)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
            kv_positions.data_ptr(), part.data_ptr(), o.data_ptr(), B, Skv,
            Hq, Hkv, hd, _DTYPES[q.dtype], int(causal), window or 0, n_splits,
            split_keys, float(logit_cap or 0.0), float(hd ** -0.5), stream)
    build.check_launch("flash_decode", rc)
    return o
