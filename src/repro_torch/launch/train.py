"""Training launcher of the port: config + trainer wiring.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --reduced --steps 50 --batch 8 --seq 128 [--device cpu]

``--arch`` takes any of the port's architectures (``ARCH_NAMES``): the
dense ones, the recurrent recurrentgemma-9b and rwkv6-3b, whose scans
train through their backward kernels (K2b, K3b), and whisper-tiny, whose
batches carry the stub frontend's frames. The flags of
``repro.launch.train``, plus ``--device`` (default ``cuda``;
with no card it raises unless ``--device cpu`` is given). Compute is fp32,
as the reference's launcher has it. ``--mesh`` takes only ``host`` (one
device) until slice 8 (distribution, ROADMAP.md).
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.data.pipeline import DataConfig
from repro_torch.models import Backbone, get_config, reduced
from repro_torch.optim import adamw
from repro_torch.runtime.steps import StepSettings
from repro_torch.runtime.train_loop import Trainer, TrainerConfig


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke config (CPU-sized)")
    ap.add_argument("--mesh", default="host", choices=["host"],
                    help="one device; the reference's production meshes "
                    "wait for slice 8")
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
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    settings = StepSettings(zero3=bool(args.zero3), gather_weights=bool(args.zero3),
                            remat=bool(args.remat), moe_ep=False)
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=settings.remat,
                  device=args.device)
    n = sum(leaf.numel() for leaf in adamw.tree_leaves(bb.init(device="meta")))
    print(f"[launch] {cfg.name}: {n/1e6:.1f}M params, on {bb.device}")

    trainer = Trainer(
        bb,
        adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                          total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch,
                   enc_seq=cfg.enc_seq, enc_dim=cfg.d_model),
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10),
        settings)
    try:
        trainer.run(trainer.init_or_restore())
        log = trainer.metrics_log
        print(f"[launch] done: loss {log[0]['loss']:.4f} -> "
              f"{log[-1]['loss']:.4f}; checkpoints {trainer.async_ckpt.saved}")
    finally:
        trainer.shutdown()


if __name__ == "__main__":
    main()
