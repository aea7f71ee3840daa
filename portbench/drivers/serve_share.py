"""The serving window of a configuration that one device holds a share of
the experts of (``experts_held`` = [first, end) in its file): ``serve``'s
window, ranges and sample, with three differences. The port's ``Backbone``
is told which experts it holds (``held_experts``); it replays each prefill
shape from a CUDA graph (``prefill_graphs``), captured when set-up serves
that prompt length, since at 12 layers the host issues an eager prefill of
945 or 1500 tokens more slowly than the card runs it, and the cell's numbers
would follow the host's speed; and the check reads the logits of
``reference/moe_share.py``, which holds the same share. Decode steps stay
eager. While the profiler runs (the traced stretch) the Backbone runs its
prefill eagerly, so that the ranges and markers see every call.

A traced run also counts, on the device, the rows and the experts with rows
of each grouped MoE call made while the profiler runs (the port's
``ffn.expert_rows``, switched on by the profiler's state at each
``Backbone.prefill`` and ``decode_step``), and reads them after the window,
with one host read, into ``record["expert_rows"]``: what
``metrics/moe_gemm_roofline.serve.py`` reckons M1's least time from.
"""
from __future__ import annotations

import gc
import sys
from typing import Dict, List

import numpy as np
import torch

from .. import counts, tracing, traffic, weights
from ..manifest import DTYPES, Cell, port_config
from ..reference import model as ref
from ..reference import moe_share
from ..tracing import sync
from . import serve

MOE_GEMM_KERNEL = "moe_gemm_kernel"     # csrc/moe_gemm.cu's kernel


def setup(cell: Cell, seed: int, device) -> Dict:
    """``serve.setup`` with the Backbone holding the file's share and
    replaying its prefills: serving one request at each prompt length
    captures that length's graph."""
    from repro_torch.models import Backbone
    from repro_torch.models.ffn import moe_capacity
    from repro_torch.runtime.serve_loop import Request, Server

    conf, mix = cell.config, cell.mix
    traffic.check_serve_mix(mix)
    cfg = port_config(conf)
    first, end = moe_share.held(conf)
    if moe_capacity(mix["slots"], cfg.n_experts, cfg.top_k,
                    cfg.capacity_factor) < mix["slots"]:
        raise ValueError("a decode step could drop assignments: the "
                         "reference cannot follow it request by request")
    dtype = DTYPES[conf["dtypes"]["weights"]]
    bb = Backbone(cfg, compute_dtype=DTYPES[conf["dtypes"]["compute"]],
                  param_dtype=dtype, remat=False, device=device,
                  held_experts=(first, end - first), prefill_graphs=True)
    meta = bb.init(device="meta")
    params = weights.make(meta, seed, dtype, device, cfg.d_model)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    for L in traffic.prompt_lengths(mix):
        srv = Server(bb, params, slots=mix["slots"], ctx=mix["ctx"])
        srv.submit(Request(rid=-1, prompt=rng.integers(
            0, cfg.vocab, L, dtype=np.int32), max_new=2))
        srv.run()
        del srv
    sync()
    return {"cell": cell, "seed": seed, "device": device, "bb": bb,
            "params": params, "meta": meta, "cfg": cfg}


class _RowsWhileProfiled:
    """Switches the port's ``ffn.expert_rows`` on for the model calls made
    while the profiler runs (``serve.window``'s stretch starts it before
    its first call and stops it before the call after its last)."""

    def __init__(self, bb):
        from repro_torch.models import ffn
        self.counter = ffn.expert_rows
        self.counter.take()
        self._prefill, self._decode = bb.prefill, bb.decode_step
        bb.prefill, bb.decode_step = self.prefill, self.decode_step

    def _switch(self) -> None:
        self.counter.on = torch._C._autograd._profiler_enabled()

    def prefill(self, *args, **kwargs):
        self._switch()
        return self._prefill(*args, **kwargs)

    def decode_step(self, *args, **kwargs):
        self._switch()
        return self._decode(*args, **kwargs)

    def remove(self, bb) -> List:
        self.counter.on = False
        del bb.prefill, bb.decode_step
        return self.counter.take()


class _Pairing:
    """Whether the profiler's trace of a stretch held a marker kernel for
    every bracketed call (``tracing._bracketed``, read through, its result
    unchanged): where it did not, the bracket-read metrics have nothing to
    read in that stretch."""

    def __enter__(self):
        self.failed = False
        self._read = tracing._bracketed
        tracing._bracketed = self._check
        return self

    def _check(self, device, marks):
        out = self._read(device, marks)
        self.failed |= out is None
        return out

    def __exit__(self, *exc):
        tracing._bracketed = self._read


TRACED_WINDOWS = 3      # a traced run's windows at most, until one pairs


def window(ctx: Dict, seconds: float, trace: bool,
           whole_passes: bool = True) -> Dict:
    """``serve.window``; traced, with the stretch's grouped MoE calls
    counted. Now and then the profiler's trace of a stretch lacks one of
    its marker kernels (one traced run in a few on the card), and the
    bracket-read metrics then read nothing: a traced window whose markers
    did not pair is served again, up to :data:`TRACED_WINDOWS` in all."""
    for attempt in range(1, TRACED_WINDOWS + 1 if trace else 2):
        rows = _RowsWhileProfiled(ctx["bb"]) if trace else None
        try:
            with _Pairing() as pairing:
                record = serve.window(ctx, seconds, trace, whole_passes)
        finally:
            calls = rows.remove(ctx["bb"]) if rows is not None else []
        if not pairing.failed:
            break
        print(f"serve_share: the stretch's markers did not pair in window "
              f"{attempt}", file=sys.stderr)
        ctx.pop("server", None)     # its cache, before the next Server's
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if trace:
        cfg = ctx["cfg"]
        record["expert_rows"] = {
            "calls": calls, "d_model": cfg.d_model, "d_ff": cfg.moe_d_ff,
            "elem": DTYPES[ctx["cell"].config["dtypes"]["compute"]].itemsize}
    return record


def moe_gemm_flops(rows: int, d_model: int, d_ff: int) -> float:
    """M1's operations for ``rows`` routed rows: gate, up and down, 2 D Fe
    each a row."""
    return 6.0 * rows * d_model * d_ff


def moe_gemm_bytes(rows: int, experts: int, d_model: int, d_ff: int,
                   elem: int) -> float:
    """M1's bytes: the three weights of each expert with rows, read once;
    each row's input (D) and hidden (Fe) read once and its hidden and
    output (D) written once."""
    return float(elem * (3 * experts * d_model * d_ff
                         + 2 * rows * (d_model + d_ff)))


def moe_gemm_least_s(calls, d_model: int, d_ff: int, elem: int) -> float:
    """Summed least seconds of the counted calls, (rows, experts) each."""
    return sum(counts.least_seconds(
        moe_gemm_flops(r, d_model, d_ff),
        moe_gemm_bytes(r, e, d_model, d_ff, elem)) for r, e in calls)


def check(ctx: Dict) -> Dict:
    """``serve.check`` against ``reference/moe_share.py``, with the
    prefill graphs' memory freed too."""
    cfg, reqs = ctx["cfg"], ctx["requests"]
    ctx.pop("server", None)
    ctx["bb"].drop_prefill_graphs()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    finished = [r for r in reqs if r.done.is_set()
                and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab for t in r.out)]
    numbers = gap_numbers(ctx, finished, ref.FP32) if finished else {}
    return {"attempted": len(reqs), "failed": len(reqs) - len(finished),
            "numbers": numbers}


def reference_logits(ctx: Dict, reqs: List, prec) -> List[torch.Tensor]:
    ref.no_tf32()
    dev = ctx["device"]
    seqs = [torch.as_tensor(np.concatenate([r.prompt, np.asarray(
        r.out[:-1], dtype=np.int32)]), device=dev) for r in reqs]
    with torch.no_grad():
        return moe_share.served_logits(ctx["cell"].config, ctx["params"],
                                       seqs, [len(r.prompt) for r in reqs],
                                       prec)


def gap_numbers(ctx: Dict, finished: List, prec) -> Dict[str, float]:
    """``serve.gap_numbers`` with this reference: by how much, in logits of
    the fp32 reference, each served token (``prec`` fp32) or each token a
    lower-precision reference puts first (the control) lies below the
    reference's best, over the sample's served positions."""
    picked = serve.sample(finished, ctx["cell"].cell["check"]["requests"],
                          ctx["seed"])
    truth = reference_logits(ctx, picked, ref.FP32)
    if prec.kind == "fp32":
        chosen = [torch.as_tensor(list(r.out), device=t.device)
                  for r, t in zip(picked, truth)]
    else:
        chosen = [c.argmax(-1) for c in reference_logits(ctx, picked, prec)]
    vocab = ctx["cfg"].vocab
    gaps = torch.cat([t[:, :vocab].amax(-1)
                      - t.gather(1, c[:, None].long())[:, 0]
                      for t, c in zip(truth, chosen)])
    return {"widest_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "mismatch_share": float((gaps > 0).float().mean())}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device) -> Dict:
    ctx = setup(cell, seed, device)
    record = window(ctx, seconds, trace)
    record["t_window"] = ctx["t_window"]
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if torch.cuda.is_available() else 0)
    record["check"] = check(ctx)
    return record
