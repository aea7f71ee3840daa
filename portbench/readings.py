#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, at the cell's
own size, many seeds in one process:

    python3 portbench/readings.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13]

Each seed prints one JSON line. ``program``: the numbers the check compares
for the port (the lower readings: a serving cell's one wave, a training
cell's first steps). For a control seed also ``control``: the plain
reference in the precision below the configuration's (fp8 e4m3 products
for bf16) in the port's place, and for a training cell each fault of
``portbench/faults.py`` planted in the port (the upper readings). Each
side's numbers also go through the harness's own comparison at the cell's
committed limits: ``correct`` maps each side to what a run would report
(the control and every fault should read false). The benchmark's own runs
never run this.
"""
import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def judged(cell, out, failed=0):
    """``out`` with ``correct``: each side's numbers held to the cell's
    limits by the harness's comparison (a training cell's
    ``store_mismatches``, which the readings do not take, left out)."""
    from portbench import harness

    def table(numbers):
        return {k: v for k, v in harness.compared(cell, numbers).items()
                if k in numbers}
    out["correct"] = {
        side: harness.is_correct({"failed": failed if side == "program"
                                  else 0}, table(numbers))
        for side, numbers in out.items()}
    return out


def serve_seed(cell, seed, control, device):
    from portbench.drivers import serve
    from portbench.reference import model as ref
    ctx = serve.setup(cell, seed, device)
    serve.window(ctx, 0.0, False, whole_passes=False)      # one wave
    check = serve.check(ctx)
    out = {"program": check["numbers"]}
    if control:
        finished = [r for r in ctx["requests"] if r.done.is_set()]
        out["control"] = serve.gap_numbers(ctx, finished,
                                           ref.Precision("fp8"))
    return judged(cell, out, check["failed"])


def _program_side(cell, seed, device, fault=None):
    from portbench.drivers import train
    with fault() if fault else contextlib.nullcontext():
        ctx = train.build(cell, seed, device)
        train.first_steps(ctx)
    side = train.program_side(ctx)
    train.free(ctx)
    return ctx, side


def train_seed(cell, seed, control, device):
    from portbench import faults
    from portbench.drivers import train
    from portbench.reference import model as ref
    ctx, side = _program_side(cell, seed, device)
    truth = train.reference(ctx)
    _free()
    out = {"program": train.compare(ctx, truth, side)}
    if control:
        low = train.reference(ctx, ref.Precision("fp8"))
        _free()
        out["control"] = train.compare(ctx, truth, low)
        for name, fault in faults.TRAIN.items():
            _, bad = _program_side(cell, seed, device, fault)
            out[name] = train.compare(ctx, truth, bad)
            _free()
    return judged(cell, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from portbench.manifest import load_cell, load_manifest
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, load_manifest())
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(controls - set(seeds))
    one = serve_seed if cell.cell["kind"] == "serve" else train_seed
    for seed in seeds:
        t0 = time.perf_counter()
        out = one(cell, seed, seed in controls, "cuda")
        _free()
        out.update(seed=seed, workload=args.workload,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
