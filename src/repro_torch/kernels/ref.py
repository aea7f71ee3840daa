"""Plain PyTorch versions of the kernels (the ``ref.py`` contract).

They are the semantics of record for the port: the CPU path runs them, the
CPU tests hold them against the JAX package, and ``chip_smoke.py`` holds each
CUDA kernel against them on the card. All compute in fp32; attention returns
``q.dtype``, the scans return fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

MASK_VALUE = -1e30
RGLRU_C = 8.0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Unchunked attention with explicit positions (materialises the scores).

    q: [B, Sq, Hq, hd]; k, v: [B, Skv, Hkv, hd]; positions int [Sq] / [Skv],
    kv position -1 marks an empty slot. The scale comes before the softcap,
    which comes before the mask. A row with no valid key gets the mean of V,
    as ``attention_reference`` of the JAX package gives it.
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=q.device)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, dtype=torch.int32, device=q.device)
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    s = s / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    dpos = q_positions[:, None] - kv_positions[None, :]
    valid = (kv_positions[None, :] >= 0).expand(Sq, Skv)
    if causal:
        valid = valid & (dpos >= 0)
    if window is not None:
        valid = valid & (dpos < window)
    s = torch.where(valid, s, torch.full_like(s, MASK_VALUE))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          logit_cap: Optional[float] = None,
                          q_positions: torch.Tensor,
                          kv_positions: torch.Tensor, n_splits: int
                          ) -> torch.Tensor:
    """The two passes of the split-KV decode (``csrc/flash_decode.cu``),
    plainly: the keys are cut into ``n_splits`` contiguous chunks of
    ceil(Skv / n_splits); each chunk gives per row its max m, sum l and
    unnormalised acc (m = -inf, l = 0 where it holds no valid key); then
    out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s. A row with no
    valid key in any chunk gets 0, as the kernels give it. Shapes and masks
    as :func:`attention_plain`; any Sq.
    """
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    if logit_cap is not None:
        s = logit_cap * torch.tanh(s / logit_cap)
    dpos = q_positions[:, None].long() - kv_positions[None, :].long()
    valid = (kv_positions[None, :] >= 0).expand(Sq, Skv)
    if causal:
        valid = valid & (dpos >= 0)
    if window is not None:
        valid = valid & (dpos < window)
    s = s.masked_fill(~valid, -math.inf)
    chunk = -(-Skv // n_splits)
    ms, ls, accs = [], [], []
    for k0 in range(0, chunk * n_splits, chunk):
        part = s[..., k0:k0 + chunk]
        m = part.amax(-1, keepdim=True) if part.shape[-1] else torch.full_like(
            s[..., :1], -math.inf)
        p = torch.exp(part - torch.where(m == -math.inf, 0.0, m))
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhgqk,bkhd->bhgqd", p,
                                 v[:, k0:k0 + chunk].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    big = m.amax(0)
    w = torch.where(m == -math.inf, 0.0, torch.exp(m - torch.where(
        big == -math.inf, 0.0, big)))
    num, den = (w * acc).sum(0), (w * l).sum(0)
    out = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, hd).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        logit_cap: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Full-materialisation attention with query positions ``q_offset + i``
    and key positions ``j`` (all keys present). q: [B,Sq,H,hd];
    k,v: [B,Skv,Hkv,hd]."""
    q_pos = q_offset + torch.arange(q.shape[1], dtype=torch.int32,
                                    device=q.device)
    kv_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
    return attention_plain(q, k, v, causal=causal, window=window,
                           logit_cap=logit_cap, q_positions=q_pos,
                           kv_positions=kv_pos)


def rglru_scan_plain(x: torch.Tensor, a_log: torch.Tensor,
                     gate_r: torch.Tensor, gate_i: torch.Tensor,
                     h0: torch.Tensor, *, h_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential RG-LRU. x, gate_r, gate_i: [B,T,W]; a_log: [W]; h0: [B,W].

    a_t = exp(-8 softplus(a_log) r_t);  h_t = a_t h + sqrt(max(1-a_t², 0))
    (i_t x_t). Returns (y [B,T,W] fp32, h_T [B,W] fp32); h_T is copied into
    ``h_out`` when one is given (it may be ``h0`` itself). The terms that do
    not depend on h are computed for all steps at once; only the chain loops.
    """
    al = a_log.float()
    decay = torch.clamp_min(al, 0.0) + torch.log1p(torch.exp(-al.abs()))
    a = torch.exp((-RGLRU_C * decay) * gate_r.float())
    scale = torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0))
    b = scale * (gate_i.float() * x.float())
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    if h_out is not None:
        h = h_out.copy_(h)
    return torch.stack(ys, dim=1), h


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                     state_out: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV. r, k, v, w: [B,T,H,hd]; u: [H,hd]; state:
    [B,H,hd,hd], k-major.

    y_t = (S + (u⊙k_t) v_tᵀ)ᵀ r_t with S before the update; then
    S ← diag(w_t) S + k_t v_tᵀ. Returns (y [B,T,H,hd] fp32, S_T fp32); S_T is
    copied into ``state_out`` when one is given (it may be ``state`` itself).
    """
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()[..., :, None]
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # [B,H,hd,hd]
        ys.append(torch.einsum("bhkv,bhk->bhv", s + u * kv, r[:, t]))
        s = w[:, t, :, :, None] * s + kv
    if state_out is not None:
        s = state_out.copy_(s)
    return torch.stack(ys, dim=1), s
