"""The serving window: the port's ``Server`` in a closed loop of waves.

Set-up makes the weights, builds the ``Backbone`` and serves one request
at every prompt length the mix uses (a prefill at that length, its merge
and a decode step of all slots), so that the window meets no shape for the
first time. The window sends a wave, lets ``Server.run`` serve it, and
stops at the end of the first pass over the mix's prompt strata that ends
after ``seconds``: every run serves the same sizes, whatever the seed. Each served token's
arrival on the host is stamped as the Server appends it to the request's
list (:class:`TimedList`). After the window, a sample of the finished
requests, drawn from the seed with the longest among them, goes to the
plain reference, which reads the logits each served token was the argmax
of; the gaps by which the served tokens' logits lie below the
reference's best decide ``correct`` (:func:`gap_numbers`).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import calls, counts, traffic, weights
from ..manifest import DTYPES, Cell, port_config
from ..reference import model as ref
from ..tracing import Stretch, sync



class TimedList(list):
    """A request's output list that stamps each token's arrival."""

    def __init__(self):
        super().__init__()
        self.times: List[float] = []

    def append(self, tok) -> None:
        self.times.append(time.perf_counter())
        super().append(tok)


def setup(cell: Cell, seed: int, device) -> Dict:
    from repro_torch.models import Backbone
    from repro_torch.runtime.serve_loop import Request, Server

    conf, mix = cell.config, cell.mix
    traffic.check_serve_mix(mix)
    cfg = port_config(conf)
    if cfg.n_experts:
        # the reference keeps every decoded token's assignments: a decode
        # step of all the slots must never fill an expert
        from repro_torch.models.ffn import moe_capacity
        if moe_capacity(mix["slots"], cfg.n_experts, cfg.top_k,
                        cfg.capacity_factor) < mix["slots"]:
            raise ValueError("a decode step could drop assignments: the "
                             "reference cannot follow it request by request")
    dtype = DTYPES[conf["dtypes"]["weights"]]
    bb = Backbone(cfg, compute_dtype=DTYPES[conf["dtypes"]["compute"]],
                  param_dtype=dtype, remat=False, device=device)
    meta = bb.init(device="meta")
    params = weights.make(meta, seed, dtype, device, cfg.d_model)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    for L in traffic.prompt_lengths(mix):
        srv = Server(bb, params, slots=mix["slots"], ctx=mix["ctx"])
        srv.submit(Request(rid=-1, prompt=rng.integers(
            0, cfg.vocab, L, dtype=np.int32), max_new=2))
        srv.run()
    sync()
    return {"cell": cell, "seed": seed, "device": device, "bb": bb,
            "params": params, "meta": meta, "cfg": cfg}


class _StretchTrigger:
    """Starts the stretch at the last prefill of the window's first wave
    and stops it at the decode step after ``steps`` more; the seconds its
    calls take inside the Server's clocks are kept, to be left out."""

    def __init__(self, bb, ranges, wave_size: int, steps: int):
        self.stretch = Stretch(ranges)
        self.wave_size, self.steps = wave_size, steps
        self.prefills = self.decodes = 0
        self.on = False
        self.inside = {"prefill_s": 0.0, "decode_s": 0.0}
        self._prefill, self._decode = bb.prefill, bb.decode_step
        bb.prefill, bb.decode_step = self.prefill, self.decode_step

    def prefill(self, *args, **kwargs):
        self.prefills += 1
        if self.prefills == self.wave_size:
            self.inside["prefill_s"] += self.stretch.start()
            self.on = True
        return self._prefill(*args, **kwargs)

    def decode_step(self, *args, **kwargs):
        if self.on:
            self.decodes += 1
            if self.decodes == self.steps + 1:
                self.inside["decode_s"] += self.finish()
        return self._decode(*args, **kwargs)

    def finish(self) -> float:
        if not self.on:
            return 0.0
        self.on = False
        return self.stretch.stop()

    def remove(self, bb) -> None:
        bb.prefill, bb.decode_step = self._prefill, self._decode


def window(ctx: Dict, seconds: float, trace: bool,
           whole_passes: bool = True) -> Dict:
    """Serve waves until ``seconds`` have passed and, with
    ``whole_passes``, the pass over the prompt strata is complete; without
    it the window stops at the first wave boundary after ``seconds``."""
    from repro_torch.runtime.serve_loop import Request, Server

    cell, bb, params, cfg = ctx["cell"], ctx["bb"], ctx["params"], ctx["cfg"]
    mix = cell.mix
    ranges = trigger = None
    if trace:
        Stretch.warm()
        ranges = calls.serve_ranges(bb)
        ranges.__enter__()
        trigger = _StretchTrigger(bb, ranges, mix["wave_size"],
                                  mix["trace_decode_steps"])
    srv = Server(bb, params, slots=mix["slots"], ctx=mix["ctx"])
    gen = traffic.waves(mix, ctx["seed"], cfg.vocab)
    reqs: List = []
    sync()
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    ctx["t_window"] = time.perf_counter()
    t0 = ctx["t_window"]
    try:
        while True:
            wave = next(gen)
            batch = [Request(rid=len(reqs) + i, prompt=wave.prompts[i],
                             max_new=wave.max_new[i], out=TimedList())
                     for i in range(len(wave.max_new))]
            for r in batch:
                srv.submit(r)
            srv.run()
            reqs.extend(batch)
            if trigger is not None:
                trigger.finish()    # a wave shorter than the stretch
            if time.perf_counter() - t0 >= seconds and (
                    wave.pass_end or not whole_passes):
                break
        window_s = time.perf_counter() - t0
    finally:
        if trace:
            trigger.remove(bb)
            ranges.__exit__(None, None, None)
    gaps = np.concatenate([np.diff(r.out.times) for r in reqs
                           if len(r.out.times) > 1] or [np.zeros(0)])
    tokens = sum(len(r.out) for r in reqs)
    record = {
        "kind": "serve", "window_s": window_s,
        "served": [(len(r.prompt), len(r.out)) for r in reqs],
        "timing": dict(srv.timing), "stats": dict(srv.stats),
        "end_to_end": {
            "serve_tokens_per_s": tokens / window_s,
            "serve_itl_p95_ms": float(np.percentile(gaps, 95)) * 1e3
            if gaps.size else None,
        },
    }
    if trace:
        inside = trigger.inside
        record["profiler_s"] = sum(inside.values())
        record["timing"] = {k: v - inside.get(k, 0.0)
                            for k, v in record["timing"].items()}
        st = trigger.stretch.result
        if st is not None:
            st["least_s"] = calls.least_by_range(ranges.calls)
            st["range_tokens"] = {k: sum(v) for k, v in ranges.calls.items()
                                  if v and isinstance(v[0], int)}
        record["stretch"] = st
    record["model"] = _model_counts(ctx)
    ctx["requests"] = reqs
    ctx["server"] = srv
    return record


def _model_counts(ctx: Dict) -> Dict:
    cfg, conf = ctx["cfg"], ctx["cell"].config
    return {"active_params": counts.active_params(
                weights.leaf_shapes(ctx["meta"]), cfg.top_k, cfg.n_experts),
            "d_model": cfg.d_model, "vocab": cfg.vocab, "heads": cfg.n_heads,
            "hd": cfg.hd, "layers": cfg.n_layers,
            "window": conf.get("sliding_window")}


def served_flops(model: Dict, served, *, prompts: bool) -> float:
    """Model FLOPs of the served requests: with ``prompts``, each prompt's
    tokens and the prefill's head; and every decoded token (its layers, the
    head, attention over the keys it sees)."""
    total = 0.0
    for P, n in served:
        pairs, toks, heads = 0, 0, 0
        if prompts:
            pairs += counts.causal_pairs(P, P, model["window"])
            toks += P
            heads += 1
        for i in range(1, n):
            p = P + i - 1                       # the decoded token's position
            pairs += min(p + 1, model["window"] or p + 1)
            toks += 1
            heads += 1
        total += counts.model_flops(
            model["active_params"], model["d_model"], model["vocab"],
            tokens=toks, head_tokens=heads,
            attn_pairs=pairs * model["layers"], heads=model["heads"],
            hd=model["hd"], train=False)
    return total


def check(ctx: Dict) -> Dict:
    """After the window: the Server and its caches freed, a sample of the
    finished requests against the reference. Returns attempted, failed and
    the numbers compared with their limits."""
    cell, cfg, reqs = ctx["cell"], ctx["cfg"], ctx["requests"]
    ctx.pop("server", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    finished = [r for r in reqs if r.done.is_set()
                and len(r.out) == r.max_new
                and all(0 <= t < cfg.vocab for t in r.out)]
    failed = len(reqs) - len(finished)
    numbers = gap_numbers(ctx, finished, ref.FP32) if finished else {}
    return {"attempted": len(reqs), "failed": failed, "numbers": numbers}


def sample(finished: List, n: int, seed: int) -> List:
    """``n`` finished requests drawn from the seed, the longest among
    them."""
    longest = max(range(len(finished)),
                  key=lambda i: (len(finished[i].out), len(finished[i].prompt)))
    rest = [i for i in range(len(finished)) if i != longest]
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [finished[longest]] + [finished[rest[i]] for i in sorted(pick)]


def reference_logits(ctx: Dict, reqs: List, prec) -> List[torch.Tensor]:
    ref.no_tf32()
    dev = ctx["device"]
    seqs = [torch.as_tensor(np.concatenate([r.prompt, np.asarray(
        r.out[:-1], dtype=np.int32)]), device=dev) for r in reqs]
    with torch.no_grad():
        return ref.served_logits(ctx["cell"].config, ctx["params"], seqs,
                                 [len(r.prompt) for r in reqs], prec)


def gap_numbers(ctx: Dict, finished: List, prec) -> Dict[str, float]:
    """By how much, in logits of the fp32 reference, a token lies below the
    reference's best, at every served position of the sample: the served
    tokens (``prec`` fp32), or those a lower-precision reference puts
    first (the control). ``widest_gap``: the largest; ``mean_gap``: the
    mean over positions; ``mismatch_share``: the share of positions whose
    token is not the reference's argmax."""
    picked = sample(finished, ctx["cell"].cell["check"]["requests"],
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
