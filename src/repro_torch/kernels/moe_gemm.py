"""Wrapper of the grouped SwiGLU expert kernel (``csrc/moe_gemm.cu``).

The MoE layer's routed-rows path (``models/ffn.py``) dispatches each kept
(token, k) assignment into a compact buffer ``a`` [R, D], expert by expert:
expert e owns rows ``[ends[e-1], ends[e])``, where ``ends`` [E] (int64, on
the device) is the inclusive prefix of the experts' kept counts. Two
launches compute the experts over those rows alone, reading ``ends`` on the
card, so that no count is read on the host:

* ``moe_gate_up``: h = silu(a Wg[e]) * (a Wu[e]), both products in fp32 in
  one CTA, rounded to bf16 once;
* ``moe_down``: out = h Wd[e].

Rows at or past ``ends[E-1]`` are left as they are (``torch.empty``): the
layer's combine reads only kept rows. The dispatch ledger counts each
entry's launches, ``moe_gemm.gate_up`` and ``moe_gemm.down``
(:mod:`repro_torch.kernels.build`). The plain version is
:func:`repro_torch.kernels.ref.moe_experts_plain`; ``kernels/ops.py`` sends
a CPU call there and a CUDA call here. The kernel takes bf16 only.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from . import build

BM = 128               # rows of a tile (csrc/moe_gemm.cu)
BN = {"gate_up": 128, "down": 256}  # columns of a tile, held against the library
MAX_E = 256

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# in, weight(s), ends, out; rows, E, K, N, grid; stream
_ARGS = {"gate_up": [_ptr] * 5 + [_i32] * 5 + [_ptr],
         "down": [_ptr] * 4 + [_i32] * 5 + [_ptr]}
# run when each entry is first bound
_check_tiles = partial(build.check_steps, "moe_gemm_tiles",
                       (BN["gate_up"], BN["down"]))


def grid(rows: int, n_experts: int, n: int, bn: int, sms: int) -> int:
    """Persistent CTAs for R ``rows`` over ``n_experts``: one per SM, or as
    many as there can be tiles, from the shapes alone. An expert of k rows
    has ceil(k / BM) row tiles, so all of them together have at most
    floor(R / BM) + E."""
    n_tiles = -(-n // bn)
    return max(1, min(sms, (rows // BM + n_experts) * n_tiles))


def _check(x: torch.Tensor, ends: torch.Tensor, *weights: torch.Tensor
           ) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the MoE expert kernel runs on CUDA tensors, not "
                         f"{x.device}")
    for t in (x,) + weights:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the MoE expert kernel takes bf16, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the MoE expert kernel takes contiguous tensors")
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    E, K = weights[0].shape[0], x.shape[1]
    if ends.dtype != torch.int64 or ends.shape != (E,) or \
            ends.device != x.device:
        raise ValueError(f"ends: int64 [{E}] on {x.device}, got "
                         f"{ends.dtype} {tuple(ends.shape)} on {ends.device}")
    if not 1 <= E <= MAX_E:
        raise ValueError(f"the MoE expert kernel takes 1..{MAX_E} experts, "
                         f"got {E}")
    for w in weights:
        if w.dim() != 3 or w.shape[:2] != (E, K):
            raise ValueError(f"weights [{E}, {K}, N], got {tuple(w.shape)}")
    if K % 8 or weights[0].shape[2] % 8:
        raise ValueError("the MoE expert kernel takes widths that are "
                         "multiples of 8 (16-byte rows for the TMA)")


def _launch(name: str, x, weights, ends, n: int) -> torch.Tensor:
    rows = x.shape[0]
    out = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    E = weights[0].shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = build.entry(f"moe_{name}", _ARGS[name], _check_tiles)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), *(w.data_ptr() for w in weights),
                ends.data_ptr(), out.data_ptr(), rows, E, x.shape[1], n,
                grid(rows, E, n, BN[name], sms), stream)
    build.check_launch(f"moe_gemm.{name}", rc)
    return out


def moe_gate_up(a: torch.Tensor, ends: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor) -> torch.Tensor:
    """a [R, D] bf16, ``ends`` int64 [E], w_gate / w_up [E, D, Fe] bf16 ->
    h [R, Fe] bf16: silu(a Wg[e]) * (a Wu[e]) on expert e's rows."""
    _check(a, ends, w_gate, w_up)
    if w_up.shape != w_gate.shape:
        raise ValueError("w_gate and w_up differ in shape")
    return _launch("gate_up", a, (w_gate, w_up), ends, w_gate.shape[2])


def moe_down(h: torch.Tensor, ends: torch.Tensor, w_down: torch.Tensor
             ) -> torch.Tensor:
    """h [R, Fe] bf16, ``ends`` int64 [E], w_down [E, Fe, D] bf16 -> out
    [R, D] bf16: h Wd[e] on expert e's rows."""
    _check(h, ends, w_down)
    return _launch("down", h, (w_down,), ends, w_down.shape[2])
