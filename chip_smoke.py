#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; each one that fails raises, and the process exits non-zero:

1. The card: nvidia-smi's name and power limit, torch's device name. TF32
   is switched off, so fp32 matrix products are full fp32.
2. Build the kernel with nvcc from the checkout's sources; print the
   seconds and ``-Xptxas -v``.
3. Hold each kernel against its plain PyTorch version on the card, in fp32
   and bf16, at the shapes of tests/test_kernels.py's FLASH_CASES, the
   qwen3-4b prefill shape and a decode against a wrapped ring with empty
   slots. Time each (CUDA events, after warm-up, inputs rotated through
   copies larger than the L2 cache): the kernel, the plain version,
   ``F.scaled_dot_product_attention`` with repeated KV as the library
   yardstick (never called by the port), and the bound computed from the
   inputs.
4. The model at the full qwen3-4b width and depth 2: in fp32, decode
   matches a longer prefill; in bf16, the kernel path matches the
   plain-attention path with the same weights.
5. Serve full qwen3-4b (36 layers, bf16 weights and compute, weights from
   a seeded torch.Generator) through ``Server(slots=8, ctx=1024)``: 16
   requests of 512 prompt tokens and 32 new tokens each, two synchronised
   waves. The kernel's launch count must be 36 x (requests + decode steps).
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
SERVE = dict(slots=8, ctx=1024, requests=16, prompt_len=512, max_new=32)


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


def kernel_case(name, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, dtype,
                qpos=None, kpos=None):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    in_bytes = (B * Sq * Hq + 2 * B * Skv * Hkv) * hd * (4 if dtype == torch.float32 else 2)
    nbuf = max(1, min(16, math.ceil(2 * L2_BYTES / in_bytes)))
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
    got = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.attention_plain(q, k, v, **kw)
    err = (got.float() - want.float()).abs()
    atol, rtol = TOL[dtype]
    max_err = float(err.max())
    if not bool((err <= atol + rtol * want.float().abs()).all()):
        raise AssertionError(f"{name} {dtype}: kernel disagrees with the plain "
                             f"version, max abs err {max_err} (atol {atol}, "
                             f"rtol {rtol})")

    def rotating(fn, inputs):
        i = [0]

        def call():
            i[0] = (i[0] + 1) % len(inputs)
            return fn(*inputs[i[0]])
        return call

    ms = time_ms(rotating(lambda a, b, c: fa.flash_fwd(a, b, c, **kw), bufs))
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
    row = dict(case=name, dtype=str(dtype).replace("torch.", ""),
               shape=[B, Sq, Skv, Hq, Hkv, hd], causal=causal, window=window,
               logit_cap=cap, max_abs_err=max_err, atol=atol, rtol=rtol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    log(f"[kernel] {name:>14} {row['dtype']:>8} err {max_err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


def phase_kernels():
    cfg = dict(Hq=32, Hkv=8, hd=128)
    C, first, last = SERVE["ctx"], 600, 1500   # wrapped at 1024, 123 empty
    ring = np.full((C,), -1, np.int32)
    for p in range(first, last + 1):
        ring[p % C] = p
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap) in enumerate(
                FLASH_SHAPES):
            rows.append(kernel_case(f"flash_case_{i}", B, Sq, Skv, Hq, Hkv, hd,
                                    causal, window, cap, dtype))
        rows.append(kernel_case("qwen3_prefill", 1, SERVE["prompt_len"],
                                SERVE["prompt_len"], cfg["Hq"], cfg["Hkv"],
                                cfg["hd"], True, None, None, dtype))
        rows.append(kernel_case("qwen3_decode", SERVE["slots"], 1, C,
                                cfg["Hq"], cfg["Hkv"], cfg["hd"], True, None,
                                None, dtype, qpos=[last], kpos=ring))
    return rows


# --------------------------------------------------------------------------- #
# Phase 4: the model at full width, depth 2                                    #
# --------------------------------------------------------------------------- #
def phase_model():
    from repro_torch.models import Backbone, LayerGroup, get_config

    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              groups=(LayerGroup(("attn",), 2),))
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 65),
                                         dtype=np.int32)).to(DEVICE)

    bb = Backbone(cfg, compute_dtype=torch.float32, param_dtype=torch.float32,
                  device=DEVICE)
    params = bb.init(SEED + 1)
    _, cache = bb.prefill(params, {"tokens": toks[:, :64]}, 128)
    got, _ = bb.decode_step(params, cache, toks[:, 64:])
    want, _ = bb.prefill(params, {"tokens": toks}, 128)
    if got.shape != (2, 1, bb.Vp) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"fp32 decode logits {tuple(got.shape)} not finite")
    fp32_err = float((got - want).abs().max())
    log(f"[model] full width, depth 2, fp32: decode vs longer prefill max abs "
        f"err {fp32_err:.3e} (tol {MODEL_FP32_TOL})")
    if fp32_err > MODEL_FP32_TOL:
        raise AssertionError("fp32 decode disagrees with the longer prefill")
    del bb, params, cache, got, want

    kern = Backbone(cfg, compute_dtype=torch.bfloat16,
                    param_dtype=torch.bfloat16, device=DEVICE)
    plain = Backbone(cfg, compute_dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, attn_impl="plain",
                     device=DEVICE)
    params = kern.init(SEED + 2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, SERVE["prompt_len"] + 4),
                                           dtype=np.int32)).to(DEVICE)
    S = SERVE["prompt_len"]
    errs = []
    lk, ck = kern.prefill(params, {"tokens": prompt[:, :S]}, SERVE["ctx"])
    lp, cp = plain.prefill(params, {"tokens": prompt[:, :S]}, SERVE["ctx"])
    errs.append(float((lk.float() - lp.float()).abs().max()))
    for i in range(4):
        t = prompt[:, S + i:S + i + 1]
        lk, ck = kern.decode_step(params, ck, t)
        lp, cp = plain.decode_step(params, cp, t)
        errs.append(float((lk.float() - lp.float()).abs().max()))
    log(f"[model] full width, depth 2, bf16 (allow_bf16_reduced_precision_"
        f"reduction={torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})"
        f": kernel vs plain attention, max abs logit err prefill {errs[0]:.3e}, "
        f"decode {max(errs[1:]):.3e} (tol {MODEL_BF16_TOL})")
    if max(errs) > MODEL_BF16_TOL:
        raise AssertionError("bf16 kernel path disagrees with the plain path")
    del kern, plain, params, ck, cp
    torch.cuda.empty_cache()
    return {"fp32_decode_vs_prefill_err": fp32_err,
            "bf16_kernel_vs_plain_err": max(errs)}


# --------------------------------------------------------------------------- #
# Phase 5: serve full qwen3-4b                                                 #
# --------------------------------------------------------------------------- #
def phase_serve():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Backbone, get_config
    from repro_torch.runtime.serve_loop import Request, Server

    cfg = get_config("qwen3-4b")
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                  device=DEVICE)
    t0 = time.perf_counter()
    params = bb.init(SEED)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params in bf16, init "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (SERVE["requests"], SERVE["prompt_len"]),
                           dtype=np.int32)

    warm = Server(bb, params, slots=SERVE["slots"], ctx=SERVE["ctx"])
    warm.submit(Request(rid=-1, prompt=prompts[0], max_new=2))
    warm.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    srv = Server(bb, params, slots=SERVE["slots"], ctx=SERVE["ctx"])
    reqs = [Request(rid=i, prompt=prompts[i], max_new=SERVE["max_new"])
            for i in range(SERVE["requests"])]
    for r in reqs:
        srv.submit(r)
    fa.launches = 0
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()

    steps = srv.stats["steps"]
    waves = SERVE["requests"] // SERVE["slots"]
    if not all(r.done.is_set() and len(r.out) == SERVE["max_new"] for r in reqs):
        raise AssertionError("not every request finished with max_new tokens")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    if steps != waves * (SERVE["max_new"] - 1):
        raise AssertionError(f"{steps} decode steps, want "
                             f"{waves * (SERVE['max_new'] - 1)}")
    want = cfg.n_layers * (SERVE["requests"] + steps)
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times on the "
                             f"main path, want {want}")
    # the first token of a request is the argmax of a direct prefill
    for r in reqs[:2]:
        logits, _ = bb.prefill(params, {"tokens": torch.from_numpy(
            r.prompt[None, :]).to(DEVICE)}, SERVE["ctx"])
        if logits.shape != (1, 1, bb.Vp) or not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits not finite")
        if r.out[0] != int(torch.argmax(logits[0, -1, :cfg.vocab])):
            raise AssertionError("served first token != direct prefill argmax")
    tokens = sum(len(r.out) for r in reqs)
    out = {
        "requests": len(reqs), "decode_steps": steps, "flash_launches": launches,
        "prefill_ms_per_request": srv.timing["prefill_s"] / len(reqs) * 1e3,
        "decode_ms_per_step": srv.timing["decode_s"] / steps * 1e3,
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "max_memory_allocated_gb": peak / 1e9,
    }
    log(f"[serve] {len(reqs)} requests, {steps} decode steps, {tokens} tokens "
        f"in {wall:.3f} s ({out['tokens_per_s']:.1f} tok/s); prefill "
        f"{out['prefill_ms_per_request']:.2f} ms/request, decode "
        f"{out['decode_ms_per_step']:.2f} ms/step; flash launches {launches} "
        f"= {cfg.n_layers} x ({len(reqs)} + {steps}); peak memory "
        f"{out['max_memory_allocated_gb']:.2f} GB")
    log("[serve] " + json.dumps(out))
    out["trace"] = phase_trace(bb, params, prompts)
    return out


def phase_trace(bb, params, prompts):
    """Where the time goes: torch.profiler over 3 batch-1 prefills and over
    3 decode steps of all slots. Device busy time is the union of the CUDA
    activity intervals; the idle share is 1 - busy / host wall time."""
    from torch.profiler import ProfilerActivity, profile

    slots, ctx = SERVE["slots"], SERVE["ctx"]
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
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        result[name] = {
            "host_ms_per_call": wall_us / 3e3,
            "device_busy_ms_per_call": busy / 3e3,
            "device_idle_share": 1.0 - busy / wall_us,
            "top_kernels_ms_per_call": {
                k[:80]: [t / 3e3, n // 3] for k, (t, n) in top},
        }
        r = result[name]
        log(f"[trace] {name}: host {r['host_ms_per_call']:.3f} ms/call, device "
            f"busy {r['device_busy_ms_per_call']:.3f} ms, idle share "
            f"{r['device_idle_share']:.3f}")
        for k, (t, n) in r["top_kernels_ms_per_call"].items():
            log(f"[trace]   {t:9.4f} ms  x{n:<5d} {k}")
    return result


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
    log(f"[build] {build.SOURCE.name}: {b['seconds']:.2f} s -> {b['path']}\n"
        f"{b['log']}")

    rows = phase_kernels()
    model = phase_model()
    serve = phase_serve()

    head = next(r for r in rows if r["case"] == "qwen3_prefill"
                and r["dtype"] == "bfloat16")
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:28",
        "launches": serve["flash_launches"],
        "max_abs_err": head["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "at": "qwen3_prefill bfloat16 [B,Sq,Skv,Hq,Hkv,hd]=" + str(head["shape"]),
        "cases": rows,
    }]
    log("[summary] " + json.dumps({"model": model, "serve": serve,
                                   "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
