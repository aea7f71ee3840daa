"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The rule: a tensor on the CPU goes to the plain version (``ref.py``); a CUDA
tensor goes to the kernel, which launches or raises. There is no override
and no fallback. The models only ever call these functions.

A ``meta`` tensor (the dry run's shapes without memory) goes to the
kernel's shape function: empty outputs of the kernel's shapes and dtypes,
and the kernel's operations and bytes charged to every sink in ``SINKS``
(the dry run's cost counter, ``repro_torch.launch.cost``). The operations
are the bounds' counts in chip_smoke.py: 4 hd per valid (query, key) pair
and query head for K1, 10 hd for K1b, 9 per element of x for K2 and 20 for
K2b, 5 hd + 5 per element of r for K3 and 14 hd for K3b; 4 D Fe (gate-up)
and 2 Fe D (down) a row for the MoE experts, every row of the compact
buffer counted as routed (the most the kernel can compute there). A meta
position holds no value, so the pairs are counted for query i at position
Skv - Sq + i over keys 0..Skv-1, every slot full. The bytes are the inputs' and
outputs' sizes. The plain versions are never the shape functions: the
attention's materialises [B, H, Sq, Skv] and the RG-LRU's loops over T.

A DTensor raises: the kernels take each rank's local tensors
(``Backbone._local`` calls them through ``local_map``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from . import flash_attention as fa
from . import flash_bwd as fb
from . import flash_decode as fd
from . import moe_gemm, ref, rglru, rglru_bwd, rwkv6, rwkv6_bwd


# callables (kernel name, operations, bytes) charged by the shape functions
SINKS: List[Callable[[str, float, float], None]] = []


def _device(*tensors: Optional[torch.Tensor]) -> str:
    """The route of a call: "cpu", "meta" or "cuda" (after the DTensor
    check)."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                "a kernel wrapper takes plain tensors, not DTensors: call it "
                "on each rank's local shards (torch.distributed.tensor."
                "experimental.local_map, as Backbone._local does)")
    return tensors[0].device.type


def _charge(name: str, flops: float, inputs, outputs) -> None:
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*inputs, *outputs) if t is not None)
    for sink in SINKS:
        sink(name, float(flops), float(nbytes))


def _pairs(Sq: int, Skv: int, causal: bool, window: Optional[int]) -> int:
    """Valid (query, key) pairs for query i at position Skv - Sq + i over
    keys 0..Skv-1."""
    if not causal:
        return Sq * Skv
    # query i sees off + 1 + i keys, at most ``window``
    off = Skv - Sq
    cap = Sq if window is None else min(max(window - off, 0), Sq)
    return (cap * (off + 1) + cap * (cap - 1) // 2
            + (Sq - cap) * (window or 0))


def _attention_flops(q, k, causal, window, per_pair: int) -> float:
    B, Sq, Hq, hd = q.shape
    return per_pair * hd * Hq * B * _pairs(Sq, k.shape[1], causal, window)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              logit_cap: Optional[float] = None,
              q_positions: torch.Tensor, kv_positions: torch.Tensor
              ) -> torch.Tensor:
    """Attention with explicit int32 positions (kv position -1: empty slot).

    q: [B,Sq,Hq,hd]; k, v: [B,Skv,Hkv,hd] -> [B,Sq,Hq,hd] in q's dtype. On
    the card, Sq == 1 runs ``flash_decode`` and any other Sq ``flash_fwd``.
    """
    route = _device(q, k, v, q_positions, kv_positions)
    if route == "meta":
        out = torch.empty_like(q)
        _charge("flash_decode" if q.shape[1] == 1 else "flash_fwd",
                _attention_flops(q, k, causal, window, 4), (q, k, v), (out,))
        return out
    if route == "cpu":
        _same_device(q, k, v, q_positions, kv_positions)
        return ref.attention_plain(q, k, v, causal=causal, window=window,
                                   logit_cap=logit_cap,
                                   q_positions=q_positions,
                                   kv_positions=kv_positions)
    # by shape: one query position (a decode step) splits the keys across
    # CTAs; more (prefill) tile the query rows
    kernel = fd.flash_decode if q.shape[1] == 1 else fa.flash_fwd
    return kernel(q, k, v, causal=causal, window=window, logit_cap=logit_cap,
                  q_positions=q_positions, kv_positions=kv_positions)


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  logit_cap: Optional[float] = None,
                  q_positions: torch.Tensor, kv_positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (out, lse [B,Hkv,G,Sq] fp32), which
    :func:`attention_bwd` takes. On the card it is always ``flash_fwd``,
    whatever Sq."""
    route = _device(q, k, v, q_positions, kv_positions)
    if route == "meta":
        B, Sq, Hq, _ = q.shape
        Hkv = k.shape[2]
        out = torch.empty_like(q)
        lse = torch.empty((B, Hkv, Hq // Hkv, Sq), dtype=torch.float32,
                          device=q.device)
        _charge("flash_fwd", _attention_flops(q, k, causal, window, 4),
                (q, k, v), (out, lse))
        return out, lse
    if route == "cpu":
        _same_device(q, k, v, q_positions, kv_positions)
        return ref.attention_lse_plain(q, k, v, causal=causal, window=window,
                                       logit_cap=logit_cap,
                                       q_positions=q_positions,
                                       kv_positions=kv_positions)
    return fa.flash_fwd(q, k, v, causal=causal, window=window,
                        logit_cap=logit_cap, q_positions=q_positions,
                        kv_positions=kv_positions, return_lse=True)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  logit_cap: Optional[float] = None,
                  q_positions: torch.Tensor, kv_positions: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of :func:`attention_fwd`: (dq, dk, dv) in the dtypes of
    (q, k, v); K1b (``flash_bwd``) on the card."""
    kw = dict(causal=causal, window=window, logit_cap=logit_cap,
              q_positions=q_positions, kv_positions=kv_positions)
    route = _device(q, k, v, out, lse, dout, q_positions, kv_positions)
    if route == "meta":
        grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        _charge("flash_bwd", _attention_flops(q, k, causal, window, 10),
                (q, k, v, out, lse, dout), grads)
        return grads
    if route == "cpu":
        _same_device(q, k, v, out, lse, dout, q_positions, kv_positions)
        return ref.flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    return fb.flash_bwd(q, k, v, out, lse, dout, **kw)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """The signature of ``repro.kernels.ops.flash_attention``: query
    positions ``q_offset + i``, key positions ``j``."""
    q_positions = q_offset + torch.arange(q.shape[1], dtype=torch.int32,
                                          device=q.device)
    kv_positions = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return attention(q, k, v, causal=causal, window=window,
                     logit_cap=logit_cap, q_positions=q_positions,
                     kv_positions=kv_positions)


def _same_device(first: torch.Tensor, *rest: Optional[torch.Tensor]) -> None:
    if any(t is not None and t.device != first.device for t in rest):
        raise ValueError("all inputs must be on one device")


def rglru_scan(x: torch.Tensor, a_log: torch.Tensor, gate_r: torch.Tensor,
               gate_i: torch.Tensor, h0: torch.Tensor, *,
               h_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU scan. x, gate_r, gate_i: [B,T,W]; a_log: [W]; h0: [B,W]
    fp32 -> (y [B,T,W] fp32, h_T [B,W] fp32), h_T written into ``h_out``
    when one is given (it may be ``h0``)."""
    route = _device(x, a_log, gate_r, gate_i, h0, h_out)
    if route == "meta":
        B, T, W = x.shape
        y = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
        h = h_out if h_out is not None else torch.empty_like(h0)
        _charge("rglru_scan", 9 * B * T * W, (x, a_log, gate_r, gate_i, h0),
                (y, h))
        return y, h
    if route == "cpu":
        _same_device(x, a_log, gate_r, gate_i, h0, h_out)
        return ref.rglru_scan_plain(x, a_log, gate_r, gate_i, h0, h_out=h_out)
    return rglru.rglru_scan(x, a_log, gate_r, gate_i, h0, h_out=h_out)


def rglru_scan_bwd(x: torch.Tensor, a_log: torch.Tensor,
                   gate_r: torch.Tensor, gate_i: torch.Tensor,
                   h0: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                   dh_T: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`rglru_scan`: y is its h sequence, dy and dh_T
    the cotangents of y and h_T -> (dx, da_log, dgate_r, dgate_i, dh0), each
    in its input's dtype; K2b (``rglru_bwd``) on the card."""
    args = (x, a_log, gate_r, gate_i, h0, y, dy, dh_T)
    route = _device(*args)
    if route == "meta":
        grads = tuple(torch.empty_like(t) for t in args[:5])
        _charge("rglru_bwd", 20 * x.numel(), args, grads)
        return grads
    if route == "cpu":
        _same_device(*args)
        return ref.rglru_scan_bwd_plain(*args)
    return rglru_bwd.rglru_scan_bwd(*args)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               state_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The WKV scan. r, k, v, w: [B,T,H,hd]; u: [H,hd]; state [B,H,hd,hd]
    fp32 -> (y [B,T,H,hd] fp32, S_T fp32), S_T written into ``state_out``
    when one is given (it may be ``state``)."""
    route = _device(r, k, v, w, u, state, state_out)
    if route == "meta":
        y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
        s = state_out if state_out is not None else torch.empty_like(state)
        _charge("wkv6_scan", (5 * r.shape[-1] + 5) * r.numel(),
                (r, k, v, w, u, state), (y, s))
        return y, s
    if route == "cpu":
        _same_device(r, k, v, w, u, state, state_out)
        return ref.rwkv6_scan_plain(r, k, v, w, u, state, state_out=state_out)
    return rwkv6.wkv6_scan(r, k, v, w, u, state, state_out=state_out)


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                   dy: torch.Tensor, ds_T: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`rwkv6_scan`: dy and ds_T are the cotangents of
    y and S_T -> (dr, dk, dv, dw, du, ds0), each in its input's dtype; K3b
    (``rwkv6_bwd``) on the card."""
    args = (r, k, v, w, u, state, dy, ds_T)
    route = _device(*args)
    if route == "meta":
        grads = tuple(torch.empty_like(t) for t in args[:6])
        _charge("wkv6_bwd", 14 * r.shape[-1] * r.numel(), args, grads)
        return grads
    if route == "cpu":
        _same_device(*args)
        return ref.rwkv6_scan_bwd_plain(*args)
    return rwkv6_bwd.wkv6_scan_bwd(*args)


def moe_experts(a: torch.Tensor, ends: torch.Tensor, w_gate: torch.Tensor,
                w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over a compact buffer of routed rows: a [R, D],
    expert e's rows [ends[e-1], ends[e]) (``ends`` int64 [E], the inclusive
    prefix of the kept counts, on a's device); w_gate / w_up [E, D, Fe],
    w_down [E, Fe, D] -> [R, D] in a's dtype, rows past ``ends[-1]``
    unspecified. On the card two launches (``moe_gemm.moe_gate_up``, then
    ``moe_gemm.moe_down``), which read ``ends`` there: bf16 only."""
    route = _device(a, ends, w_gate, w_up, w_down)
    if route == "meta":
        (R, D), Fe = a.shape, w_gate.shape[2]
        h = a.new_empty((R, Fe))
        out = a.new_empty((R, D))
        _charge("moe_gate_up", 4 * R * D * Fe, (a, ends, w_gate, w_up), (h,))
        _charge("moe_down", 2 * R * Fe * D, (h, ends, w_down), (out,))
        return out
    if route == "cpu":
        _same_device(a, ends, w_gate, w_up, w_down)
        return ref.moe_experts_plain(a, ends, w_gate, w_up, w_down)
    return moe_gemm.moe_down(moe_gemm.moe_gate_up(a, ends, w_gate, w_up), ends,
                             w_down)
