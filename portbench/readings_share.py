#!/usr/bin/env python3
"""The readings a ``serve_share`` cell's limits are set from (the kind of
``drivers/serve_share.py``: a model held as one device's share of its
experts), on the card at the cell's own size, many seeds in one process:

    python3 portbench/readings_share.py --workload <cell> \\
        --seeds 11,12,... [--control-seeds 11,12,13]

``portbench/readings.py`` for this kind. Each seed prints one JSON line.
``program``: the numbers the check compares for the port after one wave
(the lower readings), and ``check_s``, the seconds that check took. For a
control seed also ``control``, the plain reference in fp8 in the port's
place, and each serving fault of
``portbench/faults.py`` planted in the port over the same wave (the upper
readings). ``correct`` maps each side to what a run would report, its
numbers held to the cell's committed limits by the harness's comparison
(``readings.judged``). The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def share_seed(cell, seed, control, device):
    from portbench import faults, readings
    from portbench.drivers import serve_share
    from portbench.reference import model as ref
    ctx = serve_share.setup(cell, seed, device)
    serve_share.window(ctx, 0.0, False, whole_passes=False)     # one wave
    t0 = time.perf_counter()
    check = serve_share.check(ctx)
    check_s = time.perf_counter() - t0
    out = {"program": check["numbers"]}
    if control:
        finished = [r for r in ctx["requests"] if r.done.is_set()]
        out["control"] = serve_share.gap_numbers(ctx, finished,
                                                 ref.Precision("fp8"))
        for name, fault in faults.SERVE.items():
            with fault():
                serve_share.window(ctx, 0.0, False, whole_passes=False)
            out[name] = serve_share.check(ctx)["numbers"]
    out = readings.judged(cell, out, check["failed"])
    out["check_s"] = check_s
    return out


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

    from portbench import readings
    from portbench.manifest import load_cell, load_manifest
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, load_manifest())
    if cell.cell["kind"] != "serve_share":
        print(f"readings_share: {args.workload} is a {cell.cell['kind']!r} "
              "cell (portbench/readings.py reads it)", file=sys.stderr)
        return 2
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(controls - set(seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        out = share_seed(cell, seed, seed in controls, "cuda")
        readings._free()
        out.update(seed=seed, workload=args.workload,
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
