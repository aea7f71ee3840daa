"""The training window: the port's ``Trainer``, every step committed
through the transactional store.

Set-up makes the weights, builds one ``Trainer`` with the donating step and
its state, and drives it through the mix's first ``check_steps`` steps;
they warm every shape, and the check reads them: the losses from
``metrics_log``, each leaf's first gradient from the optimizer's first
moment after step 1 (``m = (1 - b1) g c``, ``c`` the clip factor of the
logged norm), and each leaf's change after the last of them (the initial
leaf made again from the seed). The window hands the same Trainer and
state on and runs a step at a time (``Trainer.run`` from ``start_step``),
stopping at the first step boundary after ``seconds``. After the window
the state is freed and the plain reference runs the same first steps from
the same weights on its own copy of the data.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import tempfile
import time
from typing import Dict

import torch

from .. import calls, counts, traffic, weights
from ..manifest import DTYPES, Cell, port_config
from ..reference import model as ref
from ..reference import train as ref_train
from ..tracing import Stretch, sync

TRACE_FROM = 1          # the window step (from 0) the stretch starts at


def build(cell: Cell, seed: int, device) -> Dict:
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import Backbone
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import StepSettings
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    conf, mix = cell.config, cell.mix
    cfg = port_config(conf)
    bb = Backbone(cfg, compute_dtype=DTYPES[conf["dtypes"]["compute"]],
                  param_dtype=DTYPES[conf["dtypes"]["weights"]],
                  remat=mix["remat"], device=device)
    meta = bb.init(device="meta")
    params = weights.make(meta, seed, DTYPES[conf["dtypes"]["weights"]],
                          device, cfg.d_model)
    state = {"params": params, "opt": adamw.init_state(params)}
    data = DataConfig(vocab=cfg.vocab, seq_len=mix["seq_len"],
                      global_batch=mix["global_batch"], seed=seed)
    tmp = tempfile.TemporaryDirectory(prefix="portbench-ckpt-")
    never = 1 << 62            # no checkpoint, no log line
    trainer = Trainer(bb, adamw.AdamWConfig(**mix["optimizer"]), data,
                      TrainerConfig(total_steps=0, ckpt_every=never,
                                    log_every=never, ckpt_dir=tmp.name),
                      StepSettings(remat=mix["remat"]))
    # what init_or_restore does for a fresh state: the cursor committed
    trainer.start_step = 0
    trainer.store.commit_step(None, None, 0)
    return {"cell": cell, "seed": seed, "device": device, "bb": bb,
            "meta": meta, "cfg": cfg, "state": state, "trainer": trainer,
            "tmp": tmp, "steps": 0}


def step(ctx: Dict) -> None:
    """One step through ``Trainer.run``, from where the last one ended."""
    tr = ctx["trainer"]
    tr.start_step = ctx["steps"]
    tr.tcfg = dataclasses.replace(tr.tcfg, total_steps=ctx["steps"] + 1)
    ctx["state"] = tr.run(ctx["state"])
    ctx["steps"] += 1


def _leaf_norms(tree) -> Dict[str, float]:
    return {path: float(t.detach().double().norm())
            for path, t in weights.flatten(tree)}


def first_steps(ctx: Dict) -> None:
    """The mix's first ``check_steps`` steps, and what the check reads of
    them."""
    mix = ctx["cell"].mix
    opt = mix["optimizer"]
    step(ctx)
    log = ctx["trainer"].metrics_log[0]
    clip = opt.get("clip_norm")
    c = min(clip / (log["grad_norm"] + 1e-9), 1.0) if clip else 1.0
    ctx["first_grad"] = {k: v / ((1 - opt["b1"]) * c) for k, v in
                         _leaf_norms(ctx["state"]["opt"]["m"]).items()}
    while ctx["steps"] < mix["check_steps"]:
        step(ctx)
    ctx["losses"] = [m["loss"] for m in ctx["trainer"].metrics_log]
    ctx["change"] = _change(ctx, ctx["state"]["params"])
    sync()


def _change(ctx: Dict, params) -> Dict[str, float]:
    conf = ctx["cell"].config
    out = {}
    for path, p0 in weights.remake(ctx["meta"], ctx["seed"],
                                   DTYPES[conf["dtypes"]["weights"]],
                                   ctx["device"], ctx["cfg"].d_model):
        out[path] = float((weights.get(params, path).double()
                           - p0.double()).norm())
        del p0
    return out


def setup(cell: Cell, seed: int, device) -> Dict:
    ctx = build(cell, seed, device)
    first_steps(ctx)
    return ctx


def window(ctx: Dict, seconds: float, trace: bool) -> Dict:
    mix = ctx["cell"].mix
    tr = ctx["trainer"]
    ranges = stretch = None
    if trace:
        Stretch.warm()
        ranges = calls.train_ranges(tr)
        ranges.__enter__()
        stretch = Stretch(ranges)
    sync()
    setup_peak = (torch.cuda.max_memory_allocated()
                  if torch.cuda.is_available() else 0)
    if torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats()
    first_log = len(tr.metrics_log)
    outside = 0.0            # the profiler's own seconds inside the window
    ctx["t_window"] = time.perf_counter()
    t0 = ctx["t_window"]
    n = 0
    try:
        while True:
            if trace and n == TRACE_FROM:
                outside += stretch.start()
            step(ctx)
            n += 1
            if trace and n == TRACE_FROM + mix["trace_steps"]:
                outside += stretch.stop()
            if (time.perf_counter() - t0 >= seconds
                    and (not trace or stretch.result is not None)):
                break
        window_s = time.perf_counter() - t0
    finally:
        if trace:
            ranges.__exit__(None, None, None)
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_available() else 0)
    logs = tr.metrics_log[first_log:]
    tokens = mix["global_batch"] * mix["seq_len"]
    record = {
        "kind": "train", "window_s": window_s, "steps": n,
        "profiler_s": outside,
        "dt": [m["dt"] for m in logs],
        "losses": [m["loss"] for m in logs],
        "end_to_end": {"train_tokens_per_s": n * tokens / window_s,
                       "train_peak_gb": peak / 1e9},
        "memory_peak_bytes": max(peak, setup_peak),
        "model": _model_counts(ctx),
    }
    if trace:
        st = stretch.result
        st["least_s"] = calls.least_by_range(ranges.calls)
        st["steps"] = mix["trace_steps"]
        record["stretch"] = st
    record["store"] = _store_check(ctx)
    return record


def _store_check(ctx: Dict) -> int:
    """Leaves the store's last commit does not hold as the step left them,
    plus one if its data cursor is not the steps taken: 0 when the
    committed state is the one the step produced."""
    snap = ctx["trainer"].store.snapshot(("params", "opt", "data_cursor"))
    bad = int(snap["data_cursor"] != ctx["steps"])
    for part in ("params", "opt"):
        mine = dict(weights.flatten(ctx["state"][part]))
        for path, leaf in weights.flatten(snap[part]):
            if path not in mine or not torch.equal(leaf, mine[path]):
                bad += 1
    return bad


def _model_counts(ctx: Dict) -> Dict:
    cfg, mix = ctx["cfg"], ctx["cell"].mix
    B, S = mix["global_batch"], mix["seq_len"]
    pairs = B * counts.causal_pairs(S, S, ctx["cell"].config.get(
        "sliding_window")) * cfg.n_layers
    active = counts.active_params(weights.leaf_shapes(ctx["meta"]),
                                  cfg.top_k, cfg.n_experts)
    return {"flops_per_step": counts.model_flops(
        active, cfg.d_model, cfg.vocab, tokens=B * S, head_tokens=B * S,
        attn_pairs=pairs, heads=cfg.n_heads, hd=cfg.hd, train=True),
        "active_params": active}


def free(ctx: Dict) -> None:
    """Drop the program's state and the Trainer (its store's threads)."""
    tr = ctx.pop("trainer", None)
    if tr is not None:
        tr.shutdown()
    ctx.pop("state", None)
    ctx.pop("bb", None)
    tmp = ctx.pop("tmp", None)
    if tmp is not None:
        tmp.cleanup()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(ctx: Dict, prec=ref.FP32, rows=None) -> Dict:
    """The plain reference's first steps from the same weights and its own
    copy of the data (``rows``: the rows of each batch it reads)."""
    ref.no_tf32()
    cell, seed, dev = ctx["cell"], ctx["seed"], ctx["device"]
    conf, mix = cell.config, cell.mix
    params = weights.make(ctx["meta"], seed, torch.float32, dev,
                          ctx["cfg"].d_model)
    batches = []
    for s in range(mix["check_steps"]):
        b = traffic.train_batch(ctx["cfg"].vocab, mix["seq_len"],
                                mix["global_batch"], seed, s)
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        batches.append({k: torch.as_tensor(v, device=dev)
                        for k, v in b.items()})
    out = ref_train.train(conf, params, batches, mix["optimizer"], prec)
    out["first_grad"] = out["first_grad"]["by_leaf"]
    out["change"] = _change(ctx, params)
    del params
    gc.collect()
    return out


def compare(ctx: Dict, truth: Dict, side: Dict) -> Dict[str, float]:
    """The numbers compared: the worst step's relative loss gap, and the
    worst leaf's gap of norms, first gradient and change, each over the
    larger of the reference leaf's norm and the median leaf's. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out: they move by round-off alone."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(side["losses"],
                                                       truth["losses"]))
    g_ref = truth["first_grad"]
    med = statistics.median(g_ref.values())
    counted = [k for k, v in g_ref.items() if v >= 1e-3 * med]

    def worst(mine: Dict[str, float], theirs: Dict[str, float]) -> float:
        m = statistics.median(theirs[k] for k in counted)
        return max(abs(mine[k] - theirs[k]) / max(theirs[k], m)
                   for k in counted)

    return {"loss_gap": loss_gap,
            "grad_gap": worst(side["first_grad"], g_ref),
            "change_gap": worst(side["change"], truth["change"])}


def program_side(ctx: Dict) -> Dict:
    return {"losses": ctx["losses"], "first_grad": ctx["first_grad"],
            "change": ctx["change"]}


def check(ctx: Dict, record: Dict) -> Dict:
    side = program_side(ctx)
    free(ctx)
    numbers = compare(ctx, reference(ctx), side)
    numbers["store_mismatches"] = record["store"]
    failed = sum(not math.isfinite(x) for x in record["losses"])
    return {"attempted": record["steps"], "failed": failed,
            "numbers": numbers}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device) -> Dict:
    ctx = setup(cell, seed, device)
    record = window(ctx, seconds, trace)
    record["t_window"] = ctx["t_window"]
    record["check"] = check(ctx, record)
    return record
