"""Qwen3-MoE's decoder as one device's share of its experts, in plain
PyTorch: the reference of a configuration whose file names ``experts_held``
= [first, end), the experts this device holds of each layer's
``num_local_experts``.

A layer is :mod:`reference.model`'s: ``x += wo(attention(rope(norm_q(q)),
rope(norm_k(k)), v))`` over ``rms_norm(x)`` (qk-norm per head), then ``x +=
moe(rms_norm(x))``. The router is the whole layer's: a softmax over all
``num_local_experts`` in fp32, the top ``num_experts_per_tok`` (ties to the
lower expert), gates renormalised over them to sum 1 (``norm_topk_prob``).
Only the held experts are computed, each over the tokens routed to it, with
the capacity rule of :func:`reference.model.kept` over the whole layer's
experts, each sequence's on its own (a layer's held experts compute the rows
of all the sequences at once); what the other experts would add is left out,
and that partial output goes on to the next layer, as it does on the device
that holds the share. The leaves ``w_gate``, ``w_up``, ``w_down`` hold the
held experts alone, ``[end - first, ...]``, expert ``first + i`` at index
``i``.

Weights are the benchmark's tree, read one layer at a time in fp32; every
product goes through a :class:`reference.model.Precision` (fp32 with TF32
off, or the fp8 control).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import model as ref


def held(conf: Dict) -> Tuple[int, int]:
    """[first, end) of the experts the configuration holds."""
    first, end = conf["experts_held"]
    if not 0 <= first < end <= conf["num_local_experts"]:
        raise ValueError(f"experts_held [{first}, {end}) does not lie in "
                         f"the {conf['num_local_experts']} experts")
    return int(first), int(end)


def moe_many(h: torch.Tensor, lens: Sequence[int],
             p: Dict[str, torch.Tensor], conf: Dict,
             prompt_lens: Sequence[int], prec: ref.Precision
             ) -> torch.Tensor:
    """The held experts' part of the expert layer over sequences laid end
    to end in h [sum(lens), D], each prompt first, sequence i ``lens[i]``
    tokens long with a prompt of ``prompt_lens[i]``. A token's routing and
    its assignments' capacity are its own sequence's; each held expert then
    computes the rows routed to it from every sequence at once."""
    E, K = conf["num_local_experts"], conf["num_experts_per_tok"]
    first, end = held(conf)
    gates, idx = ref.route(h, p["router"], K)
    keep = torch.cat([
        ref.kept(i, E, plen, ref.capacity(plen, E, K,
                                          conf["capacity_factor"]))
        for i, plen in zip(torch.split(idx, list(lens)), prompt_lens)])
    out = torch.zeros_like(h)
    for e in range(first, end):
        tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        i = e - first
        xe = h[tok]
        ye = prec.mm(F.silu(prec.mm(xe, p["w_gate"][i]))
                     * prec.mm(xe, p["w_up"][i]), p["w_down"][i])
        out.index_add_(0, tok, ye * gates[tok, slot][:, None])
    return out


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], conf: Dict,
        prompt_len: int, prec: ref.Precision) -> torch.Tensor:
    """The held experts' part of the expert layer over one sequence h [T,
    D] (prompt first)."""
    return moe_many(h, [len(h)], p, conf, [prompt_len], prec)


def attend(p: Dict[str, torch.Tensor], x: torch.Tensor, conf: Dict,
           positions: torch.Tensor, prec: ref.Precision) -> torch.Tensor:
    """A layer's attention half over one sequence x [1, S, D] fp32: x plus
    its attention's output."""
    B, S, _ = x.shape
    if B != 1:
        raise ValueError("the MoE reference takes one sequence")
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, eps = conf["head_dim"], conf["rms_norm_eps"]
    h = ref.rms_norm(x, p["ln1"], eps)
    q = prec.mm(h, p["wq"]).reshape(B, S, H, hd)
    k = prec.mm(h, p["wk"]).reshape(B, S, KV, hd)
    v = prec.mm(h, p["wv"]).reshape(B, S, KV, hd)
    if conf["qk_norm"]:
        q = ref.rms_norm(q, p["q_norm"], eps)
        k = ref.rms_norm(k, p["k_norm"], eps)
    q = ref.rope(q, positions, conf["rope_theta"])
    k = ref.rope(k, positions, conf["rope_theta"])
    o = ref.attention(q, k, v, conf.get("sliding_window"), prec)
    return x + prec.mm(o.reshape(B, S, H * hd), p["wo"])


def layers(p: Dict[str, torch.Tensor], xs: List[torch.Tensor], conf: Dict,
           prompt_lens: Sequence[int], prec: ref.Precision) -> None:
    """One layer over each sequence of ``xs`` ([1, S_i, D] fp32), in
    place: its attention, then its held experts' part over them all (one
    sequence's activations at a time beside the list, so that a whole
    wave's sample fits the card)."""
    lens = [x.shape[1] for x in xs]
    pos = torch.arange(max(lens), device=xs[0].device)
    h = xs[0].new_empty(sum(lens), xs[0].shape[-1])
    for i, at in enumerate(itertools.accumulate([0] + lens[:-1])):
        xs[i] = attend(p, xs[i], conf, pos[:lens[i]], prec)
        h[at:at + lens[i]] = ref.rms_norm(xs[i][0], p["ln2"],
                                          conf["rms_norm_eps"])
    ys = torch.split(moe_many(h, lens, p, conf, prompt_lens, prec), lens)
    del h
    for x, y in zip(xs, ys):
        x[0] += y


def served_logits(conf: Dict, weights: Dict,
                  seqs: Sequence[torch.Tensor], prompt_lens: Sequence[int],
                  prec: ref.Precision = ref.FP32) -> List[torch.Tensor]:
    """:func:`reference.model.served_logits` through :func:`layers`: for
    each sequence (a prompt and its served tokens but the last), the fp32
    logits [n, V] at the prompt's last position and after."""
    xs = [weights["embed"]["tok"][s.long()].float()[None] for s in seqs]
    for li in range(conf["num_hidden_layers"]):
        p = ref.layer_weights(weights, li)
        layers(p, xs, conf, prompt_lens, prec)
        del p
    w = ref.head(weights, conf)
    out = []
    for x, plen in zip(xs, prompt_lens):
        h = ref.rms_norm(x[0, plen - 1:], weights["final_norm"],
                         conf["rms_norm_eps"])
        out.append(prec.mm(h, w))
    return out
