"""The training reference: the loss and its gradients by autograd over
:mod:`portbench.reference.model`'s layers (fp32, TF32 off, each layer and
each row of the LM head recomputed in the backward so that it fits beside
the state), and a frozen copy of the port's AdamW (global-norm clipping,
linear warm-up, cosine decay, decoupled weight decay)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from . import model
from .model import FP32, Precision


def _row_loss(x: torch.Tensor, labels: torch.Tensor, norm: torch.Tensor,
              w: torch.Tensor, eps: float, prec: Precision) -> torch.Tensor:
    logits = prec.mm(model.rms_norm(x, norm, eps), w)
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def loss(conf: Dict, params: Dict, tokens: torch.Tensor,
         labels: torch.Tensor, prec: Precision = FP32) -> torch.Tensor:
    """Mean next-token cross-entropy of a dense configuration; ``params``
    holds fp32 leaves in the benchmark's tree."""
    if conf.get("num_local_experts"):
        raise NotImplementedError("the training reference is dense only")
    x = params["embed"]["tok"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    stack = params["g0"]["s0"]
    for li in range(conf["num_hidden_layers"]):
        p = {name: leaf[li] for name, leaf in stack.items()}
        x = checkpoint(model.layer, p, x, conf, positions, prec,
                       use_reentrant=False)
    w = (params["embed"]["tok"].T if conf["tie_word_embeddings"]
         else params["lm_head"])
    total = sum(checkpoint(_row_loss, x[b], labels[b].long(),
                           params["final_norm"], w, conf["rms_norm_eps"],
                           prec, use_reentrant=False)
                for b in range(x.shape[0]))
    return total / labels.numel()


def leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            out.update(leaves(sub, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = sub
    return out


def lr_at(opt: Dict, step: int) -> float:
    """The port's schedule at 1-based ``step``: linear warm-up, then cosine
    down to ``min_lr_frac`` of ``lr`` at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * t))
    return opt["lr"] * warm * cos


def train(conf: Dict, params: Dict, batches: List[Dict[str, torch.Tensor]],
          opt: Dict, prec: Precision = FP32) -> Dict:
    """AdamW steps over ``batches`` from ``params`` (updated in place).
    Returns each step's loss, the first step's gradient norm by leaf and
    the global norm."""
    flat = leaves(params)
    for t in flat.values():
        t.requires_grad_(True)
    m = {k: torch.zeros_like(t) for k, t in flat.items()}
    v = {k: torch.zeros_like(t) for k, t in flat.items()}
    losses, first = [], None
    for i, batch in enumerate(batches):
        step = i + 1
        value = loss(conf, params, batch["tokens"], batch["labels"], prec)
        grads = torch.autograd.grad(value, list(flat.values()))
        losses.append(float(value.detach()))
        gnorm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        if first is None:
            first = {"by_leaf": {k: float(g.double().norm())
                                 for k, g in zip(flat, grads)},
                     "global": gnorm}
        clip = opt.get("clip_norm")
        scale = min(clip / (gnorm + 1e-9), 1.0) if clip else 1.0
        lr = lr_at(opt, step)
        b1, b2 = opt["b1"], opt["b2"]
        b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for (k, p), g in zip(flat.items(), grads):
                g = g * scale
                m[k].mul_(b1).add_((1 - b1) * g)
                v[k].mul_(b2).add_((1 - b2) * g * g)
                delta = (m[k] / b1c) / ((v[k] / b2c).sqrt() + opt["eps"])
                p.sub_(lr * (delta + opt["weight_decay"] * p))
        del grads
    for t in flat.values():
        t.requires_grad_(False)
    return {"losses": losses, "first_grad": first}
