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

On the card the kernel library is loaded (built, in a checkout's first run)
before the requests are served, and its seconds are printed apart. The
summary gives the Server's own account (``Server.timing``): prefill ms a
request, decode ms a step split into the token read and the host's issuing,
and the mean wait from a request's first token to its second.
``--trace PATH`` turns txtrace on (``obs.hostspans.enable``), runs the
profiler over the served run, writes one Perfetto file to PATH (the
profiler's trace with the txtrace sites on its clock,
``hostspans.write_merged``) and prints the device's idle ms by the
program's span (``hostspans.idle_by_span``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import Backbone, LayerGroup, get_config, reduced
from repro_torch.obs import hostspans
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace the run and write a Perfetto file to PATH")
    args = ap.parse_args()
    if args.trace:
        hostspans.enable()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.depth is not None:
        cfg = dataclasses.replace(cfg, groups=(
            LayerGroup(cfg.groups[0].pattern, args.depth),))
    bb = Backbone(cfg, compute_dtype=torch.float32, device=args.device)
    params = bb.init(0)
    if bb.device.type == "cuda":
        from repro_torch.kernels import build
        t0 = time.monotonic()
        build.load()
        print(f"[serve] kernel library loaded in "
              f"{time.monotonic() - t0:.2f}s")
    srv = Server(bb, params, slots=args.slots, ctx=args.ctx)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, args.prompt_len,
                                        dtype=np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    for r in reqs:
        srv.submit(r)
    prof = hostspans.start_profiler() if args.trace else None
    t0 = time.monotonic()
    srv.run()
    dt = time.monotonic() - t0
    if prof is not None:
        print(hostspans.finish_profiler(prof, args.trace))
    done = sum(r.done.is_set() for r in reqs)
    st, tm = srv.stats, srv.timing
    print(f"[serve] {cfg.name} on {bb.device}: {done}/{len(reqs)} requests, "
          f"{st['tokens']} tokens in {dt:.2f}s "
          f"({st['tokens']/max(dt,1e-9):.0f} tok/s), {st['steps']} batch "
          f"steps")
    steps = max(st["steps"], 1)
    first_gap = tm["first_gap_s"] / max(sum(len(r.out) >= 2 for r in reqs), 1)
    print(f"[serve] Server: prefill "
          f"{tm['prefill_s'] / max(st['admitted'], 1) * 1e3:.2f} ms a "
          f"request; decode {tm['decode_s'] / steps * 1e3:.2f} ms a step "
          f"(read {tm['decode_read_s'] / steps * 1e3:.2f}, host "
          f"{(tm['decode_s'] - tm['decode_read_s']) / steps * 1e3:.2f}); "
          f"first token to second {first_gap * 1e3:.2f} ms a request")
    print("[serve] sample:", reqs[0].out)


if __name__ == "__main__":
    main()
