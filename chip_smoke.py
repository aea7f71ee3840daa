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
6. Train qwen3-4b at full width, depth 8 (see TRAIN): K1 with its LSE
   against the plain LSE; K1b (flash_bwd: delta, dkdv, dq) against
   flash_bwd_plain in fp32 and bf16 (causal, GQA 32/8 and 16/1, softcap 50,
   window 2048 at hd 256, empty kv slots) and timed at the training shape
   beside the plain version, SDPA forward + backward and the bound; one
   microbatch of [1, 512] through loss_fn and the backward on the kernel
   path and on the plain path from the same fp32 parameters (bf16 compute,
   remat on), the loss and every leaf's gradient compared; then the
   ``Trainer`` of launch/train.py takes 6 steps of 4 x 2048 tokens, each
   committed through the transactional store, with exact launch counts
   (flash_fwd and each kernel of flash_bwd once a layer and step), finite
   loss and grad_norm, step ms, tokens/s, peak memory and a profiled step's
   idle share; finally a crash at step 13 of the reduced qwen3-4b and its
   restart from the step-8 checkpoint match an uninterrupted run.
7. Print the kernels line, the card line and the result line.

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
# K1's LSE against attention_lse_plain: fp32 on both sides from the same
# inputs, so the fp32 limit (atol = rtol) in both dtypes, on rows with a
# valid key. K1b against flash_bwd_plain: both take the same out, lse and
# dout and sum in fp32 (K1b does not round P), so TOL holds for each of dq,
# dk and dv (two bf16 ulps in bf16).
LSE_TOL = 5e-5
# The training model's kernel path against its plain path (bf16 compute):
# K1's tensor-core body rounds P to bf16, which moves activations by bf16
# ulps through 8 layers and back. The loss within 2**-6 of itself, each
# leaf's gradient within 2**-4 of its norm (normwise: a leaf's entries are
# sums of many terms of both signs).
TRAIN_LOSS_RTOL = 2.0 ** -6
TRAIN_GRAD_RTOL = 2.0 ** -4
TRAIN_RESTART_RTOL = 1e-4  # the embedding's backward uses atomics on the card
TRAIN = dict(depth=8, batch=4, seq=2048, steps=6, grad_seq=512)
# K1b cases: (name, B, S, Hq, Hkv, hd, causal, window, cap, empty kv slots)
BWD_CASES = [
    ("gqa_32_8", 1, 512, 32, 8, 128, True, None, None, False),
    ("softcap_50", 1, 200, 32, 8, 128, True, None, 50.0, False),
    ("window_2048_hd256", 1, 2100, 16, 1, 256, True, 2048, None, False),
    ("mqa_16_1_empty_slots", 2, 300, 16, 1, 128, True, None, None, True),
    ("qwen3_train", TRAIN["batch"], TRAIN["seq"], 32, 8, 128, True, None,
     None, False),
]

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


def attention_bound(q, k, qp, kp, causal, window, extra_bytes=0):
    """(ms, 'bytes' | 'operations'): the least time for this call's work.
    Operations: 4*hd per valid (query, key) pair per query head. Bytes: q and
    out, K and V of the keys some query sees, the positions and
    ``extra_bytes`` (the LSE where it is written)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    ok = _valid(qp, kp, causal, window)
    pairs = int(ok.sum())
    live = int(ok.any(0).sum())
    flops = 4.0 * hd * Hq * B * pairs
    nbytes = (q.element_size() * (2 * q.numel() + 2 * B * live * Hkv * hd)
              + 4 * (Sq + kp.numel()) + extra_bytes)
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
    from repro_torch.kernels import (flash_attention, flash_bwd, flash_decode,
                                     rglru, rwkv6)
    return {"flash_fwd": flash_attention, "flash_decode": flash_decode,
            "rglru_scan": rglru, "wkv6_scan": rwkv6, "flash_bwd": flash_bwd}


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
              "wkv6_scan": (kinds.count("rwkv"), both, f"({req} + {steps})"),
              "flash_bwd": (0, 0, "no backward in serving")}
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


def profile_calls(label, fn, calls=3):
    """torch.profiler over ``calls`` calls of ``fn``: host ms and device busy
    ms per call, the device idle share and the top kernels. Device busy
    time is the union of the CUDA activity intervals; the idle share is
    1 - busy / host wall time. Only the profiler's failure to start is
    caught: the calls and their errors stay outside any handler."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:  # the profiler could not attach to the card
        return f"not measured ({e})"
    t0 = time.perf_counter()
    for _ in range(calls):
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
        return "not measured (no device activity in the trace)"
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 8, and the port's own kernels wherever they rank
    shown = ranked[:8] + [kv for kv in ranked[8:] if any(
        k in kv[0] for k in TRACE_NAMES)]
    r = {
        "host_ms_per_call": wall_us / calls / 1e3,
        "device_busy_ms_per_call": busy / calls / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_ms_per_call": {
            k[:80]: [t / calls / 1e3, n // calls] for k, (t, n) in shown},
    }
    log(f"[trace] {label}: host {r['host_ms_per_call']:.3f} "
        f"ms/call, device busy {r['device_busy_ms_per_call']:.3f} ms, idle "
        f"share {r['device_idle_share']:.3f}")
    for k, (t, n) in r["top_kernels_ms_per_call"].items():
        log(f"[trace]   {t:9.4f} ms  x{n:<5d} {k}")
    return r


def phase_trace(bb, params, prompts, spec):
    """Where the time goes: 3 batch-1 prefills and 3 decode steps of all
    slots under the profiler."""
    slots, ctx = spec["slots"], spec["ctx"]
    _, cache = bb.prefill(params, {"tokens": torch.from_numpy(
        prompts[:slots]).to(DEVICE)}, ctx)
    tok = torch.zeros((slots, 1), dtype=torch.int32, device=DEVICE)
    one = torch.from_numpy(prompts[:1]).to(DEVICE)
    bb.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    return {name: profile_calls(f"{bb.cfg.name} {name}", fn) for name, fn in (
        ("prefill", lambda: bb.prefill(params, {"tokens": one}, ctx)),
        ("decode", lambda: bb.decode_step(params, cache, tok)))}


# --------------------------------------------------------------------------- #
# Phase 6: training qwen3-4b                                                   #
# --------------------------------------------------------------------------- #
def _counts():
    from repro_torch.kernels import flash_attention, flash_bwd, flash_decode
    return {"flash_fwd": flash_attention.launches,
            "flash_decode": flash_decode.launches,
            "flash_bwd": flash_bwd.launches,
            **{f"flash_bwd.{k}": n for k, n in flash_bwd.kernel_launches.items()}}


def _reset_counts():
    from repro_torch.kernels import flash_attention, flash_bwd, flash_decode
    flash_attention.launches = flash_decode.launches = flash_bwd.launches = 0
    for k in flash_bwd.kernel_launches:
        flash_bwd.kernel_launches[k] = 0


def _check_counts(what, got, layers, fwd_per_layer):
    want = {"flash_fwd": layers * fwd_per_layer, "flash_decode": 0,
            "flash_bwd": layers, "flash_bwd.delta": layers,
            "flash_bwd.dkdv": layers, "flash_bwd.dq": layers}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def lse_case(name, B, S, Hq, Hkv, hd, window, cap, dtype):
    """K1's LSE (flash_fwd with return_lse) against attention_lse_plain;
    the out it returns must equal the serving call's. Timed beside the
    plain version, SDPA's forward (KV repeated, causal cases without window
    or cap) and the bound of attention_bound plus the LSE's bytes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = _gen(300)
    q = torch.randn((B, S, Hq, hd), generator=g, device=DEVICE).to(dtype)
    k, v = (torch.randn((B, S, Hkv, hd), generator=g, device=DEVICE).to(dtype)
            for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE)
    kw = dict(causal=True, window=window, logit_cap=cap, q_positions=pos,
              kv_positions=pos)
    out, lse = fa.flash_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, fa.flash_fwd(q, k, v, **kw)):
        raise AssertionError(f"{name}: writing the LSE changed out")
    _, want = ref.attention_lse_plain(q, k, v, **kw)
    err = (lse - want).abs()
    max_err = float(err.max())
    if not bool((err <= LSE_TOL + LSE_TOL * want.abs()).all()):
        raise AssertionError(f"{name} {dtype}: K1's LSE disagrees with the "
                             f"plain LSE, max abs err {max_err}")
    del out, lse, want, err
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, return_lse=True, **kw))
    plain_ms = time_ms(lambda: ref.attention_lse_plain(q, k, v, **kw),
                       iters=2, warmup=1)
    library_ms = None
    if window is None and cap is None:
        G = Hq // Hkv
        ql, kl, vl = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, is_causal=True))
        del ql, kl, vl
    bound_ms, bound_by = attention_bound(q, k, pos, pos, True, window,
                                         extra_bytes=4 * B * Hq * S)
    log(f"[kernel] flash_fwd lse {name:>18} {str(dtype)[6:]:>8} err "
        f"{max_err:.3e} (atol = rtol = {LSE_TOL}) kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"kernel": "flash_fwd", "case": f"{name}_lse",
            "dtype": str(dtype)[6:], "shape": [B, S, S, Hq, Hkv, hd],
            "max_abs_err": max_err, "atol": LSE_TOL, "rtol": LSE_TOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def bwd_case(name, B, S, Hq, Hkv, hd, causal, window, cap, empty, dtype):
    """K1b against flash_bwd_plain on the same out, lse and dout; timed
    beside the plain version, SDPA forward + backward with KV repeated
    (aligned causal cases; never called by the port) and the bound: 10 hd
    operations per valid (query, key) pair and query head over the dtype's
    peak; bytes of q, k, v, out, dout and lse read and dq, dk, dv written."""
    from repro_torch.kernels import flash_bwd as fb
    from repro_torch.kernels import ref

    g = _gen(400)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    q, dout = rnd(B, S, Hq, hd), rnd(B, S, Hq, hd)
    k, v = rnd(B, S, Hkv, hd), rnd(B, S, Hkv, hd)
    qp = torch.arange(S, dtype=torch.int32, device=DEVICE)
    kp = qp.clone()
    if empty:  # every 7th slot empty, key 0 too: query 0 sees no key
        kp[::7] = -1
    kw = dict(causal=causal, window=window, logit_cap=cap, q_positions=qp,
              kv_positions=kp)
    out, lse = ref.attention_lse_plain(q, k, v, **kw)
    got = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    want = ref.flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    atol, rtol = TOL[dtype]
    max_err = 0.0
    for part, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - b.float()).abs()
        max_err = max(max_err, float(err.max()))
        if a.dtype != b.dtype or not bool(
                (err <= atol + rtol * b.float().abs()).all()):
            raise AssertionError(f"flash_bwd {name} {dtype} {part}: kernel "
                                 f"disagrees with the plain version, max abs "
                                 f"err {float(err.max())} (atol {atol}, rtol "
                                 f"{rtol})")
    again = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_bwd {name}: two runs differ")
    del want, again
    # every input set of the timed shapes exceeds the L2 (q alone 64 MB at
    # the training shape), so no rotation
    ms = time_ms(lambda: fb.flash_bwd(q, k, v, out, lse, dout, **kw), iters=10)
    plain_ms = time_ms(lambda: ref.flash_bwd_plain(q, k, v, out, lse, dout,
                                                   **kw), iters=2, warmup=1)
    library_ms = None
    if causal and window is None and cap is None and not empty:
        G = Hq // Hkv
        ql = q.transpose(1, 2).detach().requires_grad_()
        kl, vl = (t.repeat_interleave(G, 2).transpose(1, 2).detach()
                  .requires_grad_() for t in (k, v))
        dl = dout.transpose(1, 2)

        def sdpa():
            ql.grad = kl.grad = vl.grad = None
            F.scaled_dot_product_attention(ql, kl, vl, is_causal=True
                                           ).backward(dl)
        library_ms = time_ms(sdpa, iters=10)
        del ql, kl, vl
    ok = _valid(qp, kp, causal, window)
    pairs = int(ok.sum())
    flops = 10.0 * hd * Hq * B * pairs
    es = q.element_size()
    nbytes = es * (4 * B * S * Hq * hd + 4 * B * S * Hkv * hd) + 4 * B * Hq * S
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = dict(kernel="flash_bwd", case=name, dtype=str(dtype)[6:],
               shape=[B, S, S, Hq, Hkv, hd], causal=causal, window=window,
               logit_cap=cap, empty_slots=empty, max_abs_err=max_err,
               atol=atol, rtol=rtol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               gflop=flops / 1e9)
    log(f"[kernel] flash_bwd {name:>22} {row['dtype']:>8} err {max_err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP)")
    return row


def phase_train_kernels():
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(lse_case("qwen3_prefill", 1, SERVE["prompt_len"], 32, 8,
                             128, None, None, dtype))
        rows.append(lse_case("window_softcap", 2, 300, 8, 2, 64, 64, 30.0,
                             dtype))
        rows.append(lse_case("qwen3_train", TRAIN["batch"], TRAIN["seq"], 32,
                             8, 128, None, None, dtype))
        for case in BWD_CASES:
            rows.append(bwd_case(*case, dtype))
    torch.cuda.empty_cache()
    return rows


def _train_config():
    from repro_torch.models import LayerGroup, get_config
    return dataclasses.replace(get_config("qwen3-4b"), groups=(
        LayerGroup(("attn",), TRAIN["depth"]),))


def train_grads_check():
    """One microbatch [1, 512] through loss_fn and the backward, kernel path
    against plain path, from the same fp32 parameters; remat on, so K1
    runs twice a layer."""
    from repro_torch.models import Backbone
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad

    cfg, depth = _train_config(), TRAIN["depth"]
    kern = Backbone(cfg, compute_dtype=torch.bfloat16,
                    param_dtype=torch.float32, remat=True, device=DEVICE)
    plain = Backbone(cfg, compute_dtype=torch.bfloat16,
                     param_dtype=torch.float32, remat=True, device=DEVICE,
                     kernel_impl="plain")
    params = kern.init(SEED + 3)
    toks = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (1, TRAIN["grad_seq"] + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _reset_counts()
    lk, gk = value_and_grad(kern, params, batch)
    torch.cuda.synchronize()
    _check_counts("qwen3-4b loss_fn + backward (remat)", _counts(), depth, 2)
    lp, gp = value_and_grad(plain, params, batch)
    loss_err = abs(float(lk) - float(lp))
    grad_err = max(float((a - b).norm() / b.norm())
                   for a, b in zip(tree_leaves(gk), tree_leaves(gp)))
    finite = all(bool(torch.isfinite(a).all()) for a in tree_leaves(gk))
    log(f"[train] qwen3-4b full width, {depth} layers, [1, {TRAIN['grad_seq']}]"
        f" bf16 compute: kernel path vs plain path, loss {float(lk):.5f} vs "
        f"{float(lp):.5f} (err {loss_err:.3e}, tol {TRAIN_LOSS_RTOL} x loss), "
        f"worst leaf gradient err {grad_err:.3e} of its norm (tol "
        f"{TRAIN_GRAD_RTOL}), {len(tree_leaves(gk))} leaves")
    if not finite or not math.isfinite(float(lk)):
        raise AssertionError("train: a gradient or the loss is not finite")
    if loss_err > TRAIN_LOSS_RTOL * abs(float(lp)) or grad_err > TRAIN_GRAD_RTOL:
        raise AssertionError("train: the kernel path's loss or gradients "
                             "disagree with the plain path's")
    del kern, plain, params, gk, gp
    torch.cuda.empty_cache()
    return {"loss_kernel": float(lk), "loss_plain": float(lp),
            "loss_err": loss_err, "worst_grad_rel_err": grad_err}


def train_run():
    """The Trainer of launch/train.py at full width, depth 8: 6 steps of
    4 x 2048 tokens, bf16 compute, fp32 params and state, no remat."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import Backbone
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import StepSettings, make_train_step
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg, depth, steps = _train_config(), TRAIN["depth"], TRAIN["steps"]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                  remat=False, device=DEVICE)
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                          global_batch=TRAIN["batch"], seed=SEED)
    settings = StepSettings(remat=False)
    with tempfile.TemporaryDirectory() as d:
        # ckpt_every above the run: the 19 GB state is not written to disk
        tr = Trainer(bb, opt_cfg, data_cfg,
                     TrainerConfig(total_steps=steps, ckpt_every=steps + 1,
                                   log_every=1, ckpt_dir=d), settings)
        try:
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            # no reference to the initial state: each step replaces it
            state = tr.run(tr.init_or_restore(SEED))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _counts()
            peak = torch.cuda.max_memory_allocated()
            cursor = tr.store.snapshot(("data_cursor",))["data_cursor"]
            log_ = list(tr.metrics_log)
        finally:
            tr.shutdown()
    _check_counts(f"qwen3-4b Trainer, {steps} steps", counts, depth * steps, 1)
    if cursor != steps or len(log_) != steps:
        raise AssertionError(f"train: {len(log_)} steps logged, cursor "
                             f"{cursor}, want {steps}")
    for m in log_:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"train: step {m['step']} not finite: {m}")
        log(f"[train] step {m['step']}: loss {m['loss']:.5f} grad_norm "
            f"{m['grad_norm']:.5f} {m['dt'] * 1e3:.1f} ms "
            f"{tokens / m['dt']:.0f} tokens/s")
    steady = [m["dt"] for m in log_[1:]]
    out = {"steps": steps, "tokens_per_step": tokens, "log": log_,
           "launches": counts, "wall_s": wall,
           "step_ms_after_first": [t * 1e3 for t in steady],
           "tokens_per_s_after_first": tokens * len(steady) / sum(steady),
           "max_memory_allocated_gb": peak / 1e9,
           "params": sum(int(t.numel()) for t in
                         adamw.tree_leaves(state["params"]))}
    log(f"[train] qwen3-4b {depth} layers: {steps} Trainer steps of {tokens} "
        f"tokens in {wall:.3f} s; after the first, "
        f"{out['tokens_per_s_after_first']:.0f} tokens/s; launches {counts}; "
        f"peak memory {out['max_memory_allocated_gb']:.2f} GB")
    # one more step of the same function under the profiler
    step_fn = make_train_step(bb, opt_cfg, settings)
    batch = make_batch(data_cfg, steps)
    out["trace"] = profile_calls(
        f"qwen3-4b train step ({depth} layers, {tokens} tokens)",
        lambda: float(step_fn(state, batch)[1]["loss"]), calls=1)
    del state, bb, tr
    torch.cuda.empty_cache()
    return out


def train_restart_check():
    """Crash at step 13 of 24 at the reduced qwen3-4b (fp32), restart from
    the step-8 checkpoint: the losses of steps 8..23 match an uninterrupted
    run's within TRAIN_RESTART_RTOL."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import Backbone, get_config, reduced
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import StepSettings
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg = reduced(get_config("qwen3-4b"))

    def trainer(d):
        bb = Backbone(cfg, compute_dtype=torch.float32, remat=False,
                      device=DEVICE)
        return Trainer(bb, adamw.AdamWConfig(lr=2e-3, warmup_steps=4,
                                             total_steps=24),
                       DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
                       TrainerConfig(total_steps=24, ckpt_every=8,
                                     ckpt_dir=d, log_every=1000),
                       StepSettings(remat=False))

    def run(d, crash_at=None):
        tr = trainer(d)
        try:
            state = tr.init_or_restore()
            start = tr.start_step
            tr.run(state, crash_at=crash_at)
            return start, {m["step"]: m["loss"] for m in tr.metrics_log}
        finally:
            tr.shutdown()

    with tempfile.TemporaryDirectory() as d:
        _, ref_losses = run(os.path.join(d, "a"))
        try:
            run(os.path.join(d, "b"), crash_at=13)
            raise AssertionError("train: the injected crash did not happen")
        except RuntimeError as e:
            if "injected crash" not in str(e):
                raise
        start, res_losses = run(os.path.join(d, "b"))
    err = max(abs(res_losses[s] - ref_losses[s]) / abs(ref_losses[s])
              for s in range(8, 24))
    log(f"[train] crash-restart, reduced qwen3-4b: resumed at step {start}, "
        f"losses of steps 8..23 vs the uninterrupted run, max rel err "
        f"{err:.3e} (tol {TRAIN_RESTART_RTOL})")
    if start != 8 or sorted(res_losses) != list(range(8, 24)) \
            or err > TRAIN_RESTART_RTOL:
        raise AssertionError("train: the restarted run differs from the "
                             "uninterrupted one")
    return {"resumed_at": start, "max_rel_loss_err": err}


def phase_train():
    return {"grads": train_grads_check(), "trainer": train_run(),
            "restart": train_restart_check()}


# The row of each kernel that stands for it in the kernels line, and the TPU
# kernel it replaces
HEADLINE = {
    "flash_fwd": ("qwen3_prefill", "src/repro/kernels/flash_attention.py:28"),
    "flash_decode": ("qwen3_decode", "src/repro/kernels/flash_attention.py:28"),
    "rglru_scan": ("rgemma_prefill", "src/repro/kernels/rglru_kernel.py:22"),
    "wkv6_scan": ("rwkv6_prefill", "src/repro/kernels/rwkv6_kernel.py:26"),
    "flash_bwd": ("qwen3_train", "src/repro/models/attention.py:163"),
}
# the source of each kernel's headline body, and every source of the kernel
SOURCE = {"flash_fwd": "flash_fwd.cu", "flash_decode": "flash_decode.cu",
          "rglru_scan": "rglru_scan.cu", "wkv6_scan": "wkv6_chunk.cu",
          "flash_bwd": "flash_bwd.cu"}
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
    rows += phase_train_kernels()
    train = phase_train()
    train_launches = train["trainer"]["launches"]

    kernels = []
    for name, (case, replaces) in HEADLINE.items():
        head = next(r for r in rows if r["kernel"] == name and r["case"] == case
                    and r["dtype"] == "bfloat16" and r.get("planned", True))
        by_path = {arch: s["launches"][name] for arch, s in serve.items()
                   if s["launches"].get(name)}
        if train_launches.get(name):
            by_path["qwen3-4b train"] = train_launches[name]
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
        if name == "flash_bwd":
            kernels[-1]["launches_by_kernel"] = {
                k.split(".")[1]: n for k, n in train_launches.items()
                if k.startswith("flash_bwd.")}
    log("[summary] " + json.dumps({"model": model, "serve": serve,
                                   "train": train,
                                   "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
