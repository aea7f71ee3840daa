"""Training launcher of the port: config + mesh + trainer wiring.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

``--arch`` takes any of the port's architectures (``ARCH_NAMES``): the
dense ones, the recurrent recurrentgemma-9b and rwkv6-3b, whose scans
train through their backward kernels (K2b, K3b), and whisper-tiny, whose
batches carry the stub frontend's frames. The flags of
``repro.launch.train``, plus ``--device`` (default ``cuda``; with no card it
raises unless ``--device cpu`` is given). Compute is fp32, as the
reference's launcher has it.

``--mesh host`` (the default) trains on a (1, 1) ``("data", "model")`` mesh
over a one-rank process group on an in-memory store (NCCL on the card,
gloo on the CPU): the state is placed by ``launch.shardings`` (ZeRO-3 and
the per-layer gather with ``--zero3 1``) and every step runs through the
sharded path. ``--mesh production`` (256 ranks, (data 16, model 16)) and
``--mesh multipod`` (512, (pod 2, data 16, model 16)) start NCCL from the
``torchrun`` environment, one card a rank:

    torchrun --nnodes 32 --nproc-per-node 8 ... \\
        -m repro_torch.launch.train --arch qwen3-4b --mesh production

The last line gives the Trainer's per-step medians of
``obs.metrics.registry("train")``: data, commit and the host's gap outside
the step and its reads. ``--trace PATH`` turns txtrace on, trains all but
the last ``TRACE_STEPS`` steps, runs the profiler over those, writes one
Perfetto file to PATH (the profiler's trace with the txtrace sites, the
store's transactions among them, on its clock) and prints the device's idle
ms by the program's span.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import (dp_axes, make_host_mesh,
                                     make_production_mesh, production_shape,
                                     tp_size)
from repro_torch.launch.shardings import (effective_dp, full_dp_active,
                                          make_param_gatherer, make_sharder,
                                          param_shardings, state_shardings)
from repro_torch.models import (Backbone, PartitionPlan, get_config,
                                reduced)
from repro_torch.models.common import resolve_device
from repro_torch.obs import hostspans
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import adamw
from repro_torch.runtime.steps import StepSettings
from repro_torch.runtime.train_loop import Trainer, TrainerConfig

TRACE_STEPS = 3     # the steps --trace profiles: the last ones


def make_mesh(kind: str, device: str):
    """The mesh of ``--mesh`` and the device this rank runs on."""
    if kind == "host":
        device = resolve_device(device)     # raises where there is no card
        return make_host_mesh(device_type=device.type), device
    multi = kind == "multipod"
    shape, _ = production_shape(multi)
    want = 1
    for s in shape:
        want *= s
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if world != want:
        raise RuntimeError(f"--mesh {kind} needs torchrun with {want} ranks "
                           f"(WORLD_SIZE {world})")
    local = int(os.environ["LOCAL_RANK"])
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")
    return make_production_mesh(multi_pod=multi), f"cuda:{local}"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke config (CPU-sized)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "production", "multipod"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--zero3", type=int, default=0)
    ap.add_argument("--remat", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="trace the last steps and write a Perfetto file "
                         "to PATH")
    args = ap.parse_args()
    if args.trace:
        hostspans.enable()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    settings = StepSettings(zero3=bool(args.zero3), gather_weights=bool(args.zero3),
                            remat=bool(args.remat), moe_ep=False)
    mesh, device = make_mesh(args.mesh, args.device)
    fdp = full_dp_active(cfg, mesh, args.batch)
    dp = effective_dp(cfg, mesh, args.batch) if args.batch > 1 else ()
    bb = Backbone(cfg, PartitionPlan(tp=1 if fdp else tp_size(mesh)),
                  compute_dtype=torch.float32, remat=settings.remat,
                  device=device,
                  sharder=make_sharder(cfg, mesh, batch_sharded=args.batch > 1,
                                       global_batch=args.batch),
                  param_gather=(make_param_gatherer(cfg, mesh, full_dp=fdp)
                                if settings.zero3 and settings.gather_weights
                                else None),
                  mesh=mesh, dp_axes=dp)
    n = sum(leaf.numel() for leaf in adamw.tree_leaves(bb.init(device="meta")))
    print(f"[launch] {cfg.name}: {n/1e6:.1f}M params, on {bb.device}, mesh "
          f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (batch over "
          f"{dp_axes(mesh) if not fdp else dp})")

    trainer = Trainer(
        bb,
        adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                          total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch,
                   enc_seq=cfg.enc_seq, enc_dim=cfg.d_model),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10),
        settings, mesh=mesh,
        state_shardings=state_shardings(
            param_shardings(bb, mesh, zero3=settings.zero3, full_dp=fdp),
            mesh))
    try:
        state = trainer.init_or_restore()
        if args.trace:
            # the steps before the traced ones, then the traced ones
            tcfg = trainer.tcfg
            split = max(trainer.start_step, args.steps - TRACE_STEPS)
            trainer.tcfg = dataclasses.replace(tcfg, total_steps=split)
            state = trainer.run(state)
            trainer.start_step, trainer.tcfg = split, tcfg
            prof = hostspans.start_profiler()
            trainer.run(state)
            print(hostspans.finish_profiler(prof, args.trace))
        else:
            trainer.run(state)
        log = trainer.metrics_log
        print(f"[launch] done: loss {log[0]['loss']:.4f} -> "
              f"{log[-1]['loss']:.4f}; checkpoints {trainer.async_ckpt.saved}")
        hists = obs_metrics.registry("train").snapshot()["histograms"]
        print("[launch] per step, median ms: " + ", ".join(
            f"{name[:-3]} {hists[name]['p50_us'] / 1e3:.3f}"
            for name in ("data_us", "commit_us", "gap_us") if name in hists))
    finally:
        trainer.shutdown()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
