#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; each one that fails raises, and the process exits non-zero:

1. The card: nvidia-smi's name and power limit, torch's device name. TF32
   is switched off, so fp32 matrix products are full fp32.
2. Build the kernels with nvcc from the checkout's sources, one nvcc per
   source, all started together; print the seconds and ``-Xptxas -v``.
3. Hold each kernel against its plain PyTorch version on the card, in fp32
   and bf16 inputs, and time each (CUDA events, after warm-up, inputs
   rotated through copies larger than the L2 cache) beside the plain
   version, a library call where one computes the same function (never
   called by the port) and the bound computed from the inputs:
   K1 as flash_fwd (more than one query position) at tests/test_kernels.py's
   FLASH_CASES shapes and the prefills of qwen3-4b and recurrentgemma-9b
   (hd 256, MQA 16/1, window 2048), and as flash_decode (one query position,
   split over the keys) at their ring decodes, a half-empty ring and a ring
   where every split but one is empty; K2 (rglru_scan) at RGLRU_CASES shapes,
   a ragged chunked shape and recurrentgemma's prefill and decode; K3
   (wkv6_scan) at RWKV_CASES shapes, a ragged chunked shape, rwkv6-3b's
   prefill and decode; each scan case through both bodies (sequential and
   chunked, the plan's choice and the other), against the sequential plain
   version; and state chaining for both scans.
4. Each model at full width and reduced depth (qwen3-4b and rwkv6-3b 2
   layers, recurrentgemma-9b one (rec, rec, local) group with a prompt past
   its window): in fp32, decode matches a longer prefill; in bf16, the
   kernel path matches the all-plain path with the same weights.
5. Serve each model at full depth (bf16 weights and compute, weights from a
   seeded torch.Generator) through ``Server``, two synchronised waves of
   16 requests (see SERVES). Every launch counter is set to 0 just before
   the run and read just after: each kernel must have launched exactly
   (its layers) x (its calls) times: flash_fwd once a request (prefill),
   flash_decode once a decode step, the scans once each, the prefills
   through the scans' chunked bodies and the decode steps through their
   sequential bodies (each body counts its own launches). The first tokens must
   equal a direct prefill's; a torch.profiler trace shows where a prefill's
   and a decode step's time goes. Each model is freed before the next.
6. Print the kernels line, the card line and the result line.

It exits 2 without a CUDA device, and fails where the repo's sources are
absent.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
DEVICE = "cuda"
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12                                         # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20
# kernel vs plain, (atol, rtol): |got - want| <= atol + rtol * |want|. fp32
# sums in another order. In bf16 both round an fp32 result that differs by
# about 1e-6 to bf16 once, so they differ by at most one bf16 ulp of |want|
# (2**-7 of it); the limit allows two, over a floor far above fp32's error.
TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (1e-4, 2.0 ** -6)}
# The bf16 attention bodies run P V on the tensor cores with P rounded to
# bf16 (the plain version and the fp32 Pallas kernel keep it fp32): each
# probability moves by at most 2**-8 of itself, so an output moves by at
# most 2**-8 of the probability-weighted mean of |v|, which the plain side
# computes as attention_plain(q, k, |v|). The bf16 limit adds that term.
P_ROUND = 2.0 ** -8
# The scans return fp32 whatever their input type, and both sides see the
# same input values, so bf16 inputs keep the fp32 limit (atol = rtol), the
# JAX tests' limits for the two kernels: 1e-5 for K2 (the sequential body
# does the plain version's operations in its order, only expf, log1pf and
# sqrtf round differently; the chunked body composes the same a_t, b_t into
# chunk maps and a carry, which regroups the chain's products and sums by a
# few fp32 ulps), 2e-4 for K3 (the sequential body sums y's 64 products in
# another order; the chunked body runs its products in 3xTF32 and its
# decays as exp of sums of log w).
SCAN_TOL = {"rglru_scan": 1e-5, "wkv6_scan": 2e-4}
MODEL_FP32_TOL = 2e-3      # decode vs longer prefill (tests/test_models.py)
MODEL_BF16_TOL = 0.125     # kernel vs plain path: a few bf16 ulps of a logit

# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap) of FLASH_CASES
FLASH_SHAPES = [
    (1, 64, 64, 4, 4, 32, True, None, None),
    (2, 96, 96, 4, 2, 32, True, None, None),
    (2, 64, 64, 8, 1, 16, True, None, None),
    (1, 80, 80, 4, 2, 32, True, 16, None),
    (1, 64, 64, 4, 2, 32, True, None, 30.0),
    (1, 64, 64, 4, 2, 32, False, None, None),
    (1, 72, 72, 4, 2, 24, True, 32, 50.0),
    (2, 64, 64, 4, 2, 32, True, None, None),
]
# Serving runs: two synchronised waves of `requests / slots` requests each.
# recurrentgemma's prompt is longer than its 2048-token window, so its local
# ring wraps in prefill and in decode.
SERVES = {
    "qwen3-4b": dict(slots=8, ctx=1024, requests=16, prompt_len=512, max_new=32),
    "recurrentgemma-9b": dict(slots=8, ctx=4096, requests=16, prompt_len=2560,
                              max_new=32),
    "rwkv6-3b": dict(slots=8, ctx=1024, requests=16, prompt_len=512, max_new=32),
}
SERVE = SERVES["qwen3-4b"]
RG = SERVES["recurrentgemma-9b"]
RW = SERVES["rwkv6-3b"]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# Phase 3: the kernel against its plain version                               #
# --------------------------------------------------------------------------- #
def _valid(qp, kp, causal, window):
    dpos = qp[:, None].long() - kp[None, :].long()
    ok = (kp[None, :] >= 0).expand(dpos.shape)
    if causal:
        ok = ok & (dpos >= 0)
    if window is not None:
        ok = ok & (dpos < window)
    return ok


def attention_bound(q, k, qp, kp, causal, window):
    """(ms, 'bytes' | 'operations'): the least time for this call's work.
    Operations: 4*hd per valid (query, key) pair per query head. Bytes: q and
    out, K and V of the keys some query sees, and the positions."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    ok = _valid(qp, kp, causal, window)
    pairs = int(ok.sum())
    live = int(ok.any(0).sum())
    flops = 4.0 * hd * Hq * B * pairs
    nbytes = (q.element_size() * (2 * q.numel() + 2 * B * live * Hkv * hd)
              + 4 * (Sq + kp.numel()))
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rotating(fn, inputs):
    """A call of ``fn`` that takes the next set of ``inputs`` each time."""
    i = [0]

    def call():
        i[0] = (i[0] + 1) % len(inputs)
        return fn(*inputs[i[0]])
    return call


def n_buffers(nbytes: int) -> int:
    """Sets of inputs to rotate through so that they exceed the L2 twice."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def kernel_case(name, kernel, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap,
                dtype, qpos=None, kpos=None):
    """K1 as ``kernel`` (flash_fwd or flash_decode) against attention_plain."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref

    fn = {"flash_fwd": fa.flash_fwd, "flash_decode": fd.flash_decode}[kernel]

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    in_bytes = (B * Sq * Hq + 2 * B * Skv * Hkv) * hd * (4 if dtype == torch.float32 else 2)
    nbuf = n_buffers(in_bytes)
    bufs = [tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                                (B, Skv, Hkv, hd)))
            for _ in range(nbuf)]
    qp = (torch.arange(Sq, dtype=torch.int32) if qpos is None
          else torch.as_tensor(qpos, dtype=torch.int32)).to(dev)
    kp = (torch.arange(Skv, dtype=torch.int32) if kpos is None
          else torch.as_tensor(kpos, dtype=torch.int32)).to(dev)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_positions=qp,
              kv_positions=kp)
    q, k, v = bufs[0]
    got = fn(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.attention_plain(q, k, v, **kw).float()
    err = (got.float() - want).abs()
    atol, rtol = TOL[dtype]
    limit = atol + rtol * want.abs()
    if dtype == torch.bfloat16:
        limit += P_ROUND * ref.attention_plain(q.float(), k.float(),
                                               v.float().abs(), **kw)
    max_err = float(err.max())
    if not bool((err <= limit).all()):
        raise AssertionError(f"{name} {kernel} {dtype}: kernel disagrees with "
                             f"the plain version, max abs err {max_err} (atol "
                             f"{atol}, rtol {rtol}, P rounding "
                             f"{P_ROUND if dtype == torch.bfloat16 else 0})")
    del want, limit, err

    ms = time_ms(rotating(lambda a, b, c: fn(a, b, c, **kw), bufs))
    plain_ms = time_ms(rotating(
        lambda a, b, c: ref.attention_plain(a, b, c, **kw), bufs), iters=5)
    library_ms = None
    if cap is None:  # SDPA has no softcap
        # [B,H,S,hd] views with KV repeated to Hq heads, made before timing
        G = Hq // Hkv
        lib_bufs = [(a.transpose(1, 2), b.repeat_interleave(G, 2).transpose(1, 2),
                     c.repeat_interleave(G, 2).transpose(1, 2))
                    for a, b, c in bufs]
        aligned = qpos is None and kpos is None and window is None and causal
        mask = None if aligned else _valid(qp, kp, causal, window)
        library_ms = time_ms(rotating(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, attn_mask=mask, is_causal=aligned), lib_bufs))
        del lib_bufs
    bound_ms, bound_by = attention_bound(q, k, qp, kp, causal, window)
    row = dict(kernel=kernel, case=name,
               dtype=str(dtype).replace("torch.", ""),
               shape=[B, Sq, Skv, Hq, Hkv, hd], causal=causal, window=window,
               logit_cap=cap, max_abs_err=max_err, atol=atol, rtol=rtol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    log(f"[kernel] {kernel} {name:>22} {row['dtype']:>8} err {max_err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


def _ring(C, first, last):
    """kv positions of a C-slot ring holding first..last at slots p % C."""
    ring = np.full((C,), -1, np.int32)
    for p in range(first, last + 1):
        ring[p % C] = p
    return ring


def phase_flash():
    qw = dict(Hq=32, Hkv=8, hd=128)
    C, first, last = SERVE["ctx"], 600, 1500   # wrapped at 1024, 123 empty
    ring = _ring(C, first, last)
    # recurrentgemma's local layers: window 2048, MQA 16/1, hd 256; decode
    # at the last step of a wave, the 2048-slot ring full and wrapped
    rg_last = RG["prompt_len"] + RG["max_new"] - 2
    rg_ring = _ring(2048, rg_last - 2047, rg_last)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap) in enumerate(
                FLASH_SHAPES):
            rows.append(kernel_case(f"flash_case_{i}", "flash_fwd", B, Sq, Skv,
                                    Hq, Hkv, hd, causal, window, cap, dtype))
        rows.append(kernel_case("qwen3_prefill", "flash_fwd", 1,
                                SERVE["prompt_len"], SERVE["prompt_len"],
                                qw["Hq"], qw["Hkv"], qw["hd"], True, None,
                                None, dtype))
        rows.append(kernel_case("qwen3_decode", "flash_decode", SERVE["slots"],
                                1, C, qw["Hq"], qw["Hkv"], qw["hd"], True,
                                None, None, dtype, qpos=[last], kpos=ring))
        # positions 0..200 only: every split but the first is empty
        rows.append(kernel_case("qwen3_decode_one_split", "flash_decode",
                                SERVE["slots"], 1, C, qw["Hq"], qw["Hkv"],
                                qw["hd"], True, None, None, dtype, qpos=[200],
                                kpos=_ring(C, 0, 200)))
        rows.append(kernel_case("rgemma_prefill", "flash_fwd", 1,
                                RG["prompt_len"], RG["prompt_len"], 16, 1, 256,
                                True, 2048, None, dtype))
        rows.append(kernel_case("rgemma_decode", "flash_decode", RG["slots"],
                                1, 2048, 16, 1, 256, True, 2048, None, dtype,
                                qpos=[rg_last], kpos=rg_ring))
        rows.append(kernel_case("rgemma_decode_half_ring", "flash_decode",
                                RG["slots"], 1, 2048, 16, 1, 256, True, 2048,
                                None, dtype, qpos=[1023],
                                kpos=_ring(2048, 0, 1023)))
    return rows


def scan_case(kernel, name, dtype, make, run, plain, nbytes, flops, body,
              planned):
    """Hold one body of a scan kernel against the sequential plain version
    on ``make(seed)``'s inputs and time both; the bound is the larger of
    ``nbytes`` over the memory rate and ``flops`` of fp32 over the fp32
    rate. ``planned`` is the body the plan picks at this shape."""
    atol = rtol = SCAN_TOL[kernel]
    args = make(0)
    got = run(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    max_err = 0.0
    for g, w in zip(got, want):
        err = (g - w).abs()
        max_err = max(max_err, float(err.max()))
        if g.dtype != torch.float32 or not bool(
                (err <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"{kernel} {name} {dtype} {body}: kernel disagrees "
                                 f"with the plain version, max abs err "
                                 f"{max_err} (atol = rtol = {atol})")
    bufs = [args] + [make(s) for s in range(1, n_buffers(nbytes))]
    ms = time_ms(rotating(run, bufs))
    plain_ms = time_ms(rotating(plain, bufs), iters=3, warmup=1)
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = dict(kernel=kernel, case=name, dtype=str(dtype).replace("torch.", ""),
               body=body, planned=body == planned,
               shape=list(args[0].shape), max_abs_err=max_err, atol=atol,
               rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by)
    mark = "" if body == planned else " (not the plan's)"
    log(f"[kernel] {kernel} {name:>15} {row['dtype']:>8} {body}{mark} "
        f"err {max_err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library none "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


def _gen(seed):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1000 + seed)
    return gen


BODIES = ("sequential", "chunked")


def phase_rglru():
    """K2 at RGLRU_CASES shapes, a ragged chunked shape (T and W not whole
    chunks and vectors) and recurrentgemma's prefill and decode, through both
    bodies: random gates in (0, 1), random a_log, nonzero h0; then state
    chaining at the prefill shape."""
    from repro_torch.kernels import ref, rglru

    shapes = [("rglru_case_0", 1, 32, 64), ("rglru_case_1", 2, 50, 96),
              ("rglru_case_2", 2, 64, 128), ("rglru_case_3", 1, 33, 48),
              ("rglru_ragged", 2, 131, 100),
              ("rgemma_prefill", 1, RG["prompt_len"], 4096),
              ("rgemma_decode", RG["slots"], 1, 4096)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, W in shapes:
            def make(seed, B=B, T=T, W=W):
                g = _gen(seed)
                rnd = lambda *s: torch.randn(s, generator=g, device=DEVICE)
                return (rnd(B, T, W).to(dtype), rnd(W).to(dtype),
                        torch.sigmoid(rnd(B, T, W)).to(dtype),
                        torch.sigmoid(rnd(B, T, W)).to(dtype), rnd(B, W))
            es = torch.finfo(dtype).bits // 8
            nbytes = es * (3 * B * T * W + W) + 4 * (B * T * W + 2 * B * W)
            for body in BODIES:
                rows.append(scan_case(
                    "rglru_scan", name, dtype, make,
                    lambda *a, body=body: rglru.rglru_scan(*a, body=body),
                    ref.rglru_scan_plain, nbytes, 9 * B * T * W, body,
                    rglru.plan(B, T, W, dtype).body))
    # two half-length calls that hand the state on equal one full call
    g = _gen(98)
    T, W = RG["prompt_len"], 4096
    x, gr, gi = (torch.randn(1, T, W, generator=g, device=DEVICE)
                 .to(torch.bfloat16) for _ in range(3))
    gr, gi = torch.sigmoid(gr), torch.sigmoid(gi)
    a_log, h0 = (torch.randn(*s, generator=g, device=DEVICE) for s in ((W,), (1, W)))
    y_full, h_full = rglru.rglru_scan(x, a_log, gr, gi, h0)
    half = T // 2
    parts = [t[:, :half].contiguous() for t in (x, gr, gi)]
    y1, h1 = rglru.rglru_scan(parts[0], a_log, parts[1], parts[2], h0)
    parts = [t[:, half:].contiguous() for t in (x, gr, gi)]
    y2, h2 = rglru.rglru_scan(parts[0], a_log, parts[1], parts[2], h1)
    _check_chaining("rglru_scan", half, torch.cat([y1, y2], 1), y_full, h2,
                    h_full)
    return rows


def _check_chaining(kernel, half, y_two, y_full, s_two, s_full):
    tol = SCAN_TOL[kernel]
    err = max(float((y_two - y_full).abs().max()),
              float((s_two - s_full).abs().max()))
    log(f"[kernel] {kernel} state chaining: 2 x {half} steps vs {2 * half}, "
        f"max abs err {err:.3e}")
    torch.testing.assert_close(y_two, y_full, atol=tol, rtol=tol)
    torch.testing.assert_close(s_two, s_full, atol=tol, rtol=tol)


def phase_wkv():
    """K3 at RWKV_CASES shapes, a ragged chunked shape (hd 24, T not whole
    chunks) and rwkv6's prefill and decode, through both bodies: random u, w
    in (0, 1) in fp32 as the model passes it, a nonzero state; then state
    chaining at the prefill shape."""
    from repro_torch.kernels import ref, rwkv6

    shapes = [("wkv_case_0", 1, 32, 2, 16), ("wkv_case_1", 2, 50, 4, 32),
              ("wkv_case_2", 2, 64, 1, 8), ("wkv_case_3", 1, 33, 2, 16),
              ("wkv_ragged", 2, 131, 3, 24),
              ("rwkv6_prefill", 1, RW["prompt_len"], 40, 64),
              ("rwkv6_decode", RW["slots"], 1, 40, 64)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, H, hd in shapes:
            def make(seed, B=B, T=T, H=H, hd=hd):
                g = _gen(seed)
                rnd = lambda *s: torch.randn(s, generator=g, device=DEVICE)
                return (rnd(B, T, H, hd).to(dtype), rnd(B, T, H, hd).to(dtype),
                        rnd(B, T, H, hd).to(dtype),
                        torch.sigmoid(rnd(B, T, H, hd)), rnd(H, hd).to(dtype),
                        rnd(B, H, hd, hd))
            es = torch.finfo(dtype).bits // 8
            n = B * T * H * hd
            nbytes = es * (3 * n + H * hd) + 4 * (2 * n + 2 * B * H * hd * hd)
            # the u-term factors out of y (see wkv6_scan.cu): 2 operations
            # per state element for S^T r, 3 for w S + k v^T, 5 per element
            # of r for u, k, r and v
            for body in BODIES:
                rows.append(scan_case(
                    "wkv6_scan", name, dtype, make,
                    lambda *a, body=body: rwkv6.wkv6_scan(*a, body=body),
                    ref.rwkv6_scan_plain, nbytes, (5 * hd + 5) * n, body,
                    rwkv6.plan(B, T, H, hd).body))
    # two half-length calls that hand the state on equal one full call
    g = _gen(99)
    r, k, v, w = (torch.randn(1, RW["prompt_len"], 40, 64, generator=g,
                              device=DEVICE) for _ in range(4))
    w, u = torch.sigmoid(w), torch.randn(40, 64, generator=g, device=DEVICE)
    s0 = torch.randn(1, 40, 64, 64, generator=g, device=DEVICE)
    half = RW["prompt_len"] // 2
    y_full, s_full = rwkv6.wkv6_scan(r, k, v, w, u, s0)
    parts = [t[:, :half].contiguous() for t in (r, k, v, w)]
    y1, s1 = rwkv6.wkv6_scan(*parts, u, s0)
    parts = [t[:, half:].contiguous() for t in (r, k, v, w)]
    y2, s2 = rwkv6.wkv6_scan(*parts, u, s1)
    _check_chaining("wkv6_scan", half, torch.cat([y1, y2], 1), y_full, s2,
                    s_full)
    return rows


# --------------------------------------------------------------------------- #
# Phase 4: each model at full width, reduced depth                             #
# --------------------------------------------------------------------------- #
# arch -> (layer groups, fp32 prefill length, bf16 prompt length, ctx)
MODEL_CHECKS = {
    "qwen3-4b": (((("attn",), 2),), 64, SERVE["prompt_len"], SERVE["ctx"]),
    "recurrentgemma-9b": (((("rec", "rec", "local"), 1),), 2100, 2100,
                          RG["ctx"]),
    "rwkv6-3b": (((("rwkv",), 2),), 64, RW["prompt_len"], RW["ctx"]),
}


def phase_model(arch):
    from repro_torch.models import Backbone, LayerGroup, get_config

    groups, n32, n16, ctx = MODEL_CHECKS[arch]
    cfg = dataclasses.replace(get_config(arch), groups=tuple(
        LayerGroup(pattern, repeat) for pattern, repeat in groups))
    depth = f"{cfg.n_layers} layers {'+'.join(cfg.layer_kinds())}"
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, n32 + 1),
                                         dtype=np.int32)).to(DEVICE)

    bb = Backbone(cfg, compute_dtype=torch.float32, param_dtype=torch.float32,
                  device=DEVICE)
    params = bb.init(SEED + 1)
    _, cache = bb.prefill(params, {"tokens": toks[:, :n32]}, ctx)
    got, _ = bb.decode_step(params, cache, toks[:, n32:])
    want, _ = bb.prefill(params, {"tokens": toks}, ctx)
    if got.shape != (2, 1, bb.Vp) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{arch} fp32 decode logits {tuple(got.shape)} "
                             "not finite")
    fp32_err = float((got - want).abs().max())
    log(f"[model] {arch} full width, {depth}, fp32: decode after {n32} vs "
        f"prefill of {n32 + 1}, max abs err {fp32_err:.3e} "
        f"(tol {MODEL_FP32_TOL})")
    if fp32_err > MODEL_FP32_TOL:
        raise AssertionError(f"{arch}: fp32 decode disagrees with the longer "
                             "prefill")
    del bb, params, cache, got, want

    kern = Backbone(cfg, compute_dtype=torch.bfloat16,
                    param_dtype=torch.bfloat16, device=DEVICE)
    plain = Backbone(cfg, compute_dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, kernel_impl="plain",
                     device=DEVICE)
    params = kern.init(SEED + 2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n16 + 4),
                                           dtype=np.int32)).to(DEVICE)
    errs = []
    lk, ck = kern.prefill(params, {"tokens": prompt[:, :n16]}, ctx)
    lp, cp = plain.prefill(params, {"tokens": prompt[:, :n16]}, ctx)
    errs.append(float((lk.float() - lp.float()).abs().max()))
    for i in range(4):
        t = prompt[:, n16 + i:n16 + i + 1]
        lk, ck = kern.decode_step(params, ck, t)
        lp, cp = plain.decode_step(params, cp, t)
        errs.append(float((lk.float() - lp.float()).abs().max()))
    log(f"[model] {arch} full width, {depth}, bf16 (allow_bf16_reduced_"
        f"precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f"): kernels vs plain versions, max abs logit err prefill of {n16} "
        f"{errs[0]:.3e}, decode {max(errs[1:]):.3e} (tol {MODEL_BF16_TOL})")
    if max(errs) > MODEL_BF16_TOL:
        raise AssertionError(f"{arch}: bf16 kernel path disagrees with the "
                             "plain path")
    del kern, plain, params, ck, cp
    torch.cuda.empty_cache()
    return {"fp32_decode_vs_prefill_err": fp32_err,
            "bf16_kernel_vs_plain_err": max(errs)}


# --------------------------------------------------------------------------- #
# Phase 5: serve each model at full depth                                      #
# --------------------------------------------------------------------------- #
def _counters():
    from repro_torch.kernels import flash_attention, flash_decode, rglru, rwkv6
    return {"flash_fwd": flash_attention, "flash_decode": flash_decode,
            "rglru_scan": rglru, "wkv6_scan": rwkv6}


def phase_serve(arch):
    from repro_torch.models import Backbone, get_config
    from repro_torch.runtime.serve_loop import Request, Server

    spec = SERVES[arch]
    cfg = get_config(arch)
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                  device=DEVICE)
    t0 = time.perf_counter()
    params = bb.init(SEED)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params in bf16, init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (spec["requests"], spec["prompt_len"]),
                           dtype=np.int32)

    warm = Server(bb, params, slots=spec["slots"], ctx=spec["ctx"])
    warm.submit(Request(rid=-1, prompt=prompts[0], max_new=2))
    warm.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    srv = Server(bb, params, slots=spec["slots"], ctx=spec["ctx"])
    reqs = [Request(rid=i, prompt=prompts[i], max_new=spec["max_new"])
            for i in range(spec["requests"])]
    for r in reqs:
        srv.submit(r)
    counters = _counters()
    for mod in counters.values():
        mod.launches = 0
        for body in getattr(mod, "body_launches", {}):
            mod.body_launches[body] = 0
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in counters.items()}
    bodies = {name: dict(mod.body_launches) for name, mod in counters.items()
              if hasattr(mod, "body_launches")}
    peak = torch.cuda.max_memory_allocated()

    steps = srv.stats["steps"]
    waves = spec["requests"] // spec["slots"]
    if not all(r.done.is_set() and len(r.out) == spec["max_new"] for r in reqs):
        raise AssertionError("not every request finished with max_new tokens")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    if steps != waves * (spec["max_new"] - 1):
        raise AssertionError(f"{steps} decode steps, want "
                             f"{waves * (spec['max_new'] - 1)}")
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "local") for k in kinds)
    # kernel -> (layers that run it, calls of each layer, how they count)
    req, both = spec["requests"], spec["requests"] + steps
    expect = {"flash_fwd": (n_attn, req, f"{req} requests"),
              "flash_decode": (n_attn, steps, f"{steps} decode steps"),
              "rglru_scan": (kinds.count("rec"), both, f"({req} + {steps})"),
              "wkv6_scan": (kinds.count("rwkv"), both, f"({req} + {steps})")}
    for name, (n, calls, why) in expect.items():
        if launches[name] != n * calls:
            raise AssertionError(f"{arch}: {name} launched {launches[name]} "
                                 f"times on the main path, want {n} x {why}")
    # the scans: every prefill through the chunked body, every decode step
    # through the sequential one
    for name, n in (("rglru_scan", kinds.count("rec")),
                    ("wkv6_scan", kinds.count("rwkv"))):
        want = {"chunked": n * req, "sequential": n * steps}
        if bodies[name] != want:
            raise AssertionError(f"{arch}: {name} bodies launched "
                                 f"{bodies[name]}, want {want}")
    # the first token of a request is the argmax of a direct prefill
    for r in reqs[:2]:
        logits, _ = bb.prefill(params, {"tokens": torch.from_numpy(
            r.prompt[None, :]).to(DEVICE)}, spec["ctx"])
        if logits.shape != (1, 1, bb.Vp) or not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits not finite")
        if r.out[0] != int(torch.argmax(logits[0, -1, :cfg.vocab])):
            raise AssertionError("served first token != direct prefill argmax")
    tokens = sum(len(r.out) for r in reqs)
    out = {
        "arch": arch, "requests": len(reqs), "prompt_len": spec["prompt_len"],
        "decode_steps": steps, "launches": launches,
        "body_launches": bodies,
        "prefill_ms_per_request": srv.timing["prefill_s"] / len(reqs) * 1e3,
        "decode_ms_per_step": srv.timing["decode_s"] / steps * 1e3,
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "max_memory_allocated_gb": peak / 1e9,
    }
    counts = ", ".join(
        f"{name} {launches[name]} = {n} x {why}"
        + (f" ({bodies[name]['chunked']} chunked, {bodies[name]['sequential']}"
           " sequential)" if name in bodies else "")
        for name, (n, _, why) in expect.items() if n)
    log(f"[serve] {arch}: {len(reqs)} requests of {spec['prompt_len']} tokens, "
        f"{steps} decode steps, {tokens} tokens in {wall:.3f} s "
        f"({out['tokens_per_s']:.1f} tok/s); prefill "
        f"{out['prefill_ms_per_request']:.2f} ms/request, decode "
        f"{out['decode_ms_per_step']:.2f} ms/step; launches {counts}; peak "
        f"memory {out['max_memory_allocated_gb']:.2f} GB")
    log("[serve] " + json.dumps(out))
    out["trace"] = phase_trace(bb, params, prompts, spec)
    del srv, warm, bb, params
    torch.cuda.empty_cache()
    return out


def phase_trace(bb, params, prompts, spec):
    """Where the time goes: torch.profiler over 3 batch-1 prefills and over
    3 decode steps of all slots. Device busy time is the union of the CUDA
    activity intervals; the idle share is 1 - busy / host wall time."""
    from torch.profiler import ProfilerActivity, profile

    slots, ctx = spec["slots"], spec["ctx"]
    _, cache = bb.prefill(params, {"tokens": torch.from_numpy(
        prompts[:slots]).to(DEVICE)}, ctx)
    tok = torch.zeros((slots, 1), dtype=torch.int32, device=DEVICE)
    one = torch.from_numpy(prompts[:1]).to(DEVICE)
    bb.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    result = {}
    for name, fn in (("prefill", lambda: bb.prefill(params, {"tokens": one}, ctx)),
                     ("decode", lambda: bb.decode_step(params, cache, tok))):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        try:
            prof.start()
        except RuntimeError as e:  # the profiler could not attach to the card
            result[name] = f"not measured ({e})"
            continue
        # the calls and their errors stay outside any handler
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.stop()
        spans, by_name = [], {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            spans.append((e.time_range.start, e.time_range.end))
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        if not spans:
            result[name] = "not measured (no device activity in the trace)"
            continue
        busy, end = 0.0, -math.inf
        for s, e in sorted(spans):
            if e > end:
                busy += e - max(s, end)
                end = e
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
        # the top 8, and the port's own kernels wherever they rank
        shown = ranked[:8] + [kv for kv in ranked[8:] if any(
            k in kv[0] for k in TRACE_NAMES)]
        result[name] = {
            "host_ms_per_call": wall_us / 3e3,
            "device_busy_ms_per_call": busy / 3e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "top_kernels_ms_per_call": {
                k[:80]: [t / 3e3, n // 3] for k, (t, n) in shown},
        }
        r = result[name]
        log(f"[trace] {bb.cfg.name} {name}: host {r['host_ms_per_call']:.3f} "
            f"ms/call, device busy {r['device_busy_ms_per_call']:.3f} ms, idle "
            f"share {r['device_idle_share']:.3f}")
        for k, (t, n) in r["top_kernels_ms_per_call"].items():
            log(f"[trace]   {t:9.4f} ms  x{n:<5d} {k}")
    return result


# The row of each kernel that stands for it in the kernels line, and the TPU
# kernel it replaces
HEADLINE = {
    "flash_fwd": ("qwen3_prefill", "src/repro/kernels/flash_attention.py:28"),
    "flash_decode": ("qwen3_decode", "src/repro/kernels/flash_attention.py:28"),
    "rglru_scan": ("rgemma_prefill", "src/repro/kernels/rglru_kernel.py:22"),
    "wkv6_scan": ("rwkv6_prefill", "src/repro/kernels/rwkv6_kernel.py:26"),
}
# the source of each kernel's headline body, and every source of the kernel
SOURCE = {"flash_fwd": "flash_fwd.cu", "flash_decode": "flash_decode.cu",
          "rglru_scan": "rglru_scan.cu", "wkv6_scan": "wkv6_chunk.cu"}
SOURCES = {"wkv6_scan": ("wkv6_chunk.cu", "wkv6_scan.cu")}
# the port's kernel names in a profiler trace start with one of these
TRACE_NAMES = ("flash_", "rglru_", "wkv")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} | devices {torch.cuda.device_count()} | allow_tf32 False")

    b = build.build()
    log(f"[build] {', '.join(src.name for src in build.SOURCES)}: "
        f"{b['seconds']:.2f} s -> {b['path']}\n{b['log']}")

    rows = phase_flash() + phase_rglru() + phase_wkv()
    model = {arch: phase_model(arch) for arch in SERVES}
    serve = {arch: phase_serve(arch) for arch in SERVES}

    kernels = []
    for name, (case, replaces) in HEADLINE.items():
        head = next(r for r in rows if r["kernel"] == name and r["case"] == case
                    and r["dtype"] == "bfloat16" and r.get("planned", True))
        by_path = {arch: s["launches"][name] for arch, s in serve.items()
                   if s["launches"][name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCE[name]}",
            "sources": [f"src/repro_torch/kernels/csrc/{f}"
                        for f in SOURCES.get(name, (SOURCE[name],))],
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_by_body": {arch: s["body_launches"][name]
                                 for arch, s in serve.items()
                                 if name in s["body_launches"] and by_path.get(arch)},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "at": f"{case} bfloat16 {head['shape']}"
                  + (f" ({head['body']} body)" if "body" in head else ""),
            "cases": [r for r in rows if r["kernel"] == name],
        })
    log("[summary] " + json.dumps({"model": model, "serve": serve,
                                   "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
