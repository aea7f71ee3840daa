"""The decoder-only configurations (Qwen3, Mixtral) in plain PyTorch.

A layer: ``x += wo(attention(rope(norm_q(q)), rope(norm_k(k)), v))`` over
``rms_norm(x)``, then ``x += ffn(rms_norm(x))``; the norms are RMSNorm with
the scale used as ``1 + scale``, in fp32 (the port's parametrisation of the
published ``weight``); RoPE rotates split halves with the published
``rope_theta``; attention is causal, grouped-query, scaled by hd ** -0.5,
and with ``sliding_window`` a query sees the ``window`` latest keys, itself
included. The feed-forward layer is SwiGLU, or Mixtral's top-k mixture of
SwiGLU experts: softmax router in fp32, the top k (ties to the lower
expert), gates renormalised to sum 1.

The experts have the port's capacity, with the configuration file's
``capacity_factor``: the assignments of a prompt's tokens beyond
``max(int(P * k / E * capacity_factor), k, 8)`` of an expert, counted in
token order, are dropped; a decoded token's assignments never are (the
harness refuses a cell whose decode step of all its slots could fill an
expert). At ``capacity_factor = E / k``, as the shipped Mixtral file has
it, the capacity is every token and nothing is dropped, as published.

Weights are the benchmark's tree (``g0/s0/<leaf>`` stacked over layers,
``x @ W`` matrices ``[in, out]``), read one layer at a time and cast to
fp32. Every product goes through a :class:`Precision`: fp32 with TF32 off,
or, for the control, fp8 (e4m3) operands with a scale per tensor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

Q_CHUNK = 512


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """Matrix products in fp32, or with fp8 e4m3 operands (the control)."""

    FP8_MAX = 448.0

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"precision {kind!r}: want 'fp32' or 'fp8'")
        self.kind = kind

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """x rounded to fp8 at a per-tensor scale; the gradient passes
        straight through."""
        if self.kind == "fp32":
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().clamp_min(1e-30) / self.FP8_MAX
            r = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (r - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


FP32 = Precision("fp32")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (
        1.0 + scale.float())


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [..., S, H, hd], positions [S]: split halves rotated."""
    hd = x.shape[-1]
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float64),
                          torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = positions.double()[:, None].cpu() * inv[None, :]
    cos = torch.cos(ang).float().to(x.device)[:, None, :]
    sin = torch.sin(ang).float().to(x.device)[:, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int], prec: Precision) -> torch.Tensor:
    """Causal attention of one batch: q [B, S, H, hd], k, v [B, S, KV, hd],
    positions 0..S-1; queries in chunks of :data:`Q_CHUNK`."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    kpos = torch.arange(S, device=q.device)
    outs = []
    for s0 in range(0, S, Q_CHUNK):
        qc = qg[:, s0:s0 + Q_CHUNK]
        sc = torch.einsum("bqhgd,bkhd->bhgqk", prec.q(qc), prec.q(k))
        sc = sc * hd ** -0.5
        qpos = kpos[s0:s0 + Q_CHUNK]
        d = qpos[:, None] - kpos[None, :]
        ok = d >= 0
        if window is not None:
            ok = ok & (d < window)
        sc = sc.masked_fill(~ok, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        outs.append(torch.einsum("bhgqk,bkhd->bqhgd", prec.q(p), prec.q(v)))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    return max(int(n_tokens * top_k / n_experts * capacity_factor), top_k, 8)


def route(h: torch.Tensor, router: torch.Tensor, top_k: int):
    """(gates [T, k], experts [T, k]) of tokens h [T, D]; fp32 router."""
    probs = torch.softmax(h.float() @ router.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx


def kept(idx: torch.Tensor, n_experts: int, prompt_len: int, cap: int
         ) -> torch.Tensor:
    """[T, k] bool: an assignment of a prompt token is kept while its
    expert's count of earlier prompt assignments, in token-major order, is
    under ``cap``; a decoded token's always."""
    flat = idx[:prompt_len].reshape(-1)
    hits = F.one_hot(flat, n_experts)
    pos = (torch.cumsum(hits, 0) - hits).gather(1, flat[:, None])[:, 0]
    keep = torch.ones_like(idx, dtype=torch.bool)
    keep[:prompt_len] = (pos < cap).reshape(prompt_len, -1)
    return keep


def moe(h: torch.Tensor, p: Dict[str, torch.Tensor], conf: Dict,
        prompt_len: int, prec: Precision) -> torch.Tensor:
    """Mixtral's expert layer over one sequence h [T, D] (prompt first)."""
    E, K = conf["num_local_experts"], conf["num_experts_per_tok"]
    gates, idx = route(h, p["router"], K)
    keep = kept(idx, E, prompt_len,
                capacity(prompt_len, E, K, conf["capacity_factor"]))
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero((idx == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = h[tok]
        ye = prec.mm(F.silu(prec.mm(xe, p["w_gate"][e]))
                     * prec.mm(xe, p["w_up"][e]), p["w_down"][e])
        out.index_add_(0, tok, ye * gates[tok, slot][:, None])
    return out


def layer(p: Dict[str, torch.Tensor], x: torch.Tensor, conf: Dict,
          positions: torch.Tensor, prec: Precision,
          prompt_len: Optional[int] = None) -> torch.Tensor:
    """One layer over x [B, S, D] fp32 (a MoE layer takes B = 1)."""
    B, S, _ = x.shape
    H, KV = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd, eps = conf["head_dim"], conf["rms_norm_eps"]
    h = rms_norm(x, p["ln1"], eps)
    q = prec.mm(h, p["wq"]).reshape(B, S, H, hd)
    k = prec.mm(h, p["wk"]).reshape(B, S, KV, hd)
    v = prec.mm(h, p["wv"]).reshape(B, S, KV, hd)
    if conf["qk_norm"]:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    q = rope(q, positions, conf["rope_theta"])
    k = rope(k, positions, conf["rope_theta"])
    o = attention(q, k, v, conf.get("sliding_window"), prec)
    x = x + prec.mm(o.reshape(B, S, H * hd), p["wo"])
    h = rms_norm(x, p["ln2"], eps)
    if conf.get("num_local_experts"):
        if B != 1:
            raise ValueError("the MoE reference takes one sequence")
        y = moe(h[0], p, conf, S if prompt_len is None else prompt_len,
                prec)[None]
    else:
        y = prec.mm(F.silu(prec.mm(h, p["w_gate"])) * prec.mm(h, p["w_up"]),
                    p["w_down"])
    return x + y


def layer_weights(weights: Dict, index: int) -> Dict[str, torch.Tensor]:
    """Layer ``index``'s leaves in fp32 (a copy, one layer at a time)."""
    return {name: leaf[index].float()
            for name, leaf in weights["g0"]["s0"].items()}


def head(weights: Dict, conf: Dict) -> torch.Tensor:
    if conf["tie_word_embeddings"]:
        return weights["embed"]["tok"].float().T
    return weights["lm_head"].float()


def served_logits(conf: Dict, weights: Dict,
                  seqs: Sequence[torch.Tensor], prompt_lens: Sequence[int],
                  prec: Precision = FP32) -> List[torch.Tensor]:
    """For each sequence (a prompt and its served tokens but the last, on
    the device), the fp32 logits [n, V] at the prompt's last position and
    after: row i is the distribution the i-th served token was drawn from.
    Layer by layer over all the sequences, so that one layer's weights are
    in fp32 at a time."""
    xs = [weights["embed"]["tok"][s.long()].float()[None] for s in seqs]
    for li in range(conf["num_hidden_layers"]):
        p = layer_weights(weights, li)
        xs = [layer(p, x, conf, torch.arange(x.shape[1], device=x.device),
                    prec, plen) for x, plen in zip(xs, prompt_lens)]
        del p
    w = head(weights, conf)
    out = []
    for x, plen in zip(xs, prompt_lens):
        h = rms_norm(x[0, plen - 1:], weights["final_norm"],
                     conf["rms_norm_eps"])
        out.append(prec.mm(h, w))
    return out
