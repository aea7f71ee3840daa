"""Serving launcher of the port: config + continuous-batching server wiring.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --reduced --requests 8 --max-new 12 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch mixtral-8x22b --depth 6

The flags of ``repro.launch.serve``, plus ``--device`` (default ``cuda``;
with no card it raises unless ``--device cpu`` is given) and ``--depth N``
(full width, the first layer group's pattern repeated N times: the MoE
archs do not fit one card at full depth). whisper-tiny stops at its first
prefill with ``KeyError: 'enc_frames'``, as the reference's launcher does:
``Server`` prefills tokens only, and an encoder-decoder model is served by
``Backbone.prefill`` with the frames and then ``decode_step``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import Backbone, LayerGroup, get_config, reduced
from repro_torch.runtime.serve_loop import Request, Server


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--ctx", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=None)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.depth is not None:
        cfg = dataclasses.replace(cfg, groups=(
            LayerGroup(cfg.groups[0].pattern, args.depth),))
    bb = Backbone(cfg, compute_dtype=torch.float32, device=args.device)
    params = bb.init(0)
    srv = Server(bb, params, slots=args.slots, ctx=args.ctx)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        srv.submit(r)
    t0 = time.monotonic()
    srv.run()
    dt = time.monotonic() - t0
    done = sum(r.done.is_set() for r in reqs)
    print(f"[serve] {cfg.name} on {bb.device}: {done}/{len(reqs)} requests, "
          f"{srv.stats['tokens']} tokens in {dt:.2f}s "
          f"({srv.stats['tokens']/max(dt,1e-9):.0f} tok/s incl. kernel "
          f"build), {srv.stats['steps']} batch steps")
    print("[serve] sample:", reqs[0].out)


if __name__ == "__main__":
    main()
