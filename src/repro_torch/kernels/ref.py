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
# log w is clamped here before the chunked WKV form sums it: w may be exactly
# 0 (the model's exp(-exp(.)) underflows), and exp(-88) is already below
# fp32's normal range, so the clamp changes no decay by more than fp32 can
# resolve next to the other terms, and keeps every sum of log w finite
LOG_W_FLOOR = -88.0


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   window: Optional[int], logit_cap: Optional[float],
                   q_positions: Optional[torch.Tensor],
                   kv_positions: Optional[torch.Tensor]) -> torch.Tensor:
    """Scores [B, Hkv, G, Sq, Skv] in fp32, MASK_VALUE where masked."""
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
    return torch.where(valid, s, torch.full_like(s, MASK_VALUE))


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
    p = torch.softmax(_masked_scores(q, k, causal, window, logit_cap,
                                     q_positions, kv_positions), dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(q.shape).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        logit_cap: Optional[float] = None,
                        q_positions: Optional[torch.Tensor] = None,
                        kv_positions: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): :func:`attention_plain`'s out, and the log-sum-exp of each
    query row, lse [B, Hkv, G, Sq] fp32, as ``_flash_fwd_impl`` of the JAX
    package returns it: m + log(max(l, 1e-30)) with m the row's largest
    score and l = sum exp(s - m) (MASK_VALUE where masked, so a row with no
    valid key gets MASK_VALUE + log(Skv); the backward masks such a row)."""
    s = _masked_scores(q, k, causal, window, logit_cap, q_positions,
                       kv_positions)
    m = s.amax(-1, keepdim=True)
    l = torch.exp(s - m).sum(-1)
    lse = m[..., 0] + torch.log(torch.clamp_min(l, 1e-30))
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1),
                       v.float())
    return out.reshape(q.shape).to(q.dtype).contiguous(), lse.contiguous()


def _flash_bwd_blocks(q, k, v, out, lse, dout, causal, window, logit_cap,
                      q_positions, kv_positions, q_chunk, kv_chunk):
    """The (kv chunk, q chunk) blocks of ``_flash_bwd_impl``, padded as the
    reference pads: yields (qs, ks, qc, doc, kc, vc, p, ds) per block, the
    slices into the padded rows and keys, the blocks' fp32 inputs and their
    p and ds [B, Hkv, G, q_chunk, kv_chunk]. The padded shapes come first,
    as (B, Sqp, Skvp, Hkv, G)."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    dev = q.device
    scale = 1.0 / (hd ** 0.5)
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    nq, nk = -(-Sq // q_chunk), -(-Skv // kv_chunk)
    pad_q, pad_k = nq * q_chunk - Sq, nk * kv_chunk - Skv

    def pad(a, n, fill=0.0):  # along dim 1
        if not n:
            return a
        return torch.cat([a, a.new_full((a.shape[0], n) + a.shape[2:], fill)], 1)

    qp = torch.cat([q_positions.long(), torch.full((pad_q,), -(10 ** 9),
                                                   dtype=torch.long, device=dev)])
    kp = torch.cat([kv_positions.long(), torch.full((pad_k,), -1,
                                                    dtype=torch.long, device=dev)])
    qf, outf, doutf = (pad(a.float(), pad_q) for a in (q, out, dout))
    kf, vf = pad(k.float(), pad_k), pad(v.float(), pad_k)
    lsef = torch.cat([lse.float(), lse.new_zeros(B, Hkv, G, pad_q)], 3)
    Sqp = Sq + pad_q
    delta = torch.einsum("bshd,bshd->bhs", doutf, outf).reshape(B, Hkv, G, Sqp)
    qg = qf.reshape(B, Sqp, Hkv, G, hd)
    dog = doutf.reshape(B, Sqp, Hkv, G, hd)
    yield B, Sqp, Skv + pad_k, Hkv, G
    for j in range(nk):
        ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
        kc, vc, kpos = kf[:, ks], vf[:, ks], kp[ks]
        for i in range(nq):
            qs = slice(i * q_chunk, (i + 1) * q_chunk)
            qc, doc, qpos = qg[:, qs], dog[:, qs], qp[qs]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            if logit_cap is not None:
                t = torch.tanh(s / logit_cap)
                u_grad = 1.0 - t * t
                s = logit_cap * t
            dpos = qpos[:, None] - kpos[None, :]
            valid = (kpos[None, :] >= 0).expand(dpos.shape)
            if causal:
                valid = valid & (dpos >= 0)
            if window is not None:
                valid = valid & (dpos < window)
            p = torch.where(valid, torch.exp(s - lsef[..., qs, None]), 0.0)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doc, vc)
            ds = p * (dp - delta[..., qs, None])
            if logit_cap is not None:
                ds = ds * u_grad
            ds = ds * scale
            yield qs, ks, qc, doc, kc, vc, p, ds


def flash_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_cap: Optional[float] = None,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    q_chunk: int = 512, kv_chunk: int = 1024
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flash backward, chunked as ``_flash_bwd_impl`` of the JAX package
    (``src/repro/models/attention.py:163-260``): (dq, dk, dv) in the dtypes
    of (q, k, v) from the forward's inputs, its out, its lse [B,Hkv,G,Sq]
    and dout.

    delta = rowsum(dout * out) from the stored out; per (kv chunk, q chunk)
    block, p = exp(s - lse) where valid, else 0 (so a row with no valid key
    gets no gradient); dv += pᵀ dout; ds = p (dp - delta) times the softcap
    derivative 1 - t² and the scale; dq += ds k; dk += dsᵀ q. All sums in
    fp32; GQA grads summed over the group. Padded query positions are
    -10⁹, padded key positions -1, as the reference pads them.
    """
    blocks = _flash_bwd_blocks(q, k, v, out, lse, dout, causal, window,
                               logit_cap, q_positions, kv_positions, q_chunk,
                               kv_chunk)
    B, Sqp, Skvp, Hkv, G = next(blocks)
    hd = q.shape[-1]
    dq = q.new_zeros((B, Sqp, Hkv, G, hd), dtype=torch.float32)
    dk = k.new_zeros((B, Skvp, Hkv, hd), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    for qs, ks, qc, doc, kc, vc, p, ds in blocks:
        dv[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd", p, doc)
        dq[:, qs] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kc)
        dk[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc)
    Sq, Skv = q.shape[1], k.shape[1]
    return (dq.reshape(B, Sqp, Hkv * G, hd)[:, :Sq].to(q.dtype),
            dk[:, :Skv].to(k.dtype), dv[:, :Skv].to(v.dtype))


# The bf16 body of K1b rounds p and ds to bf16 (8 significant bits: each
# moves by at most 2^-8 of itself) before dv = pᵀ dout, dk = dsᵀ q and
# dq = ds k; the plain version keeps them fp32.
BF16_ROUND = 2.0 ** -8


def flash_bwd_rounding_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             logit_cap: Optional[float] = None,
                             q_positions: torch.Tensor,
                             kv_positions: torch.Tensor,
                             q_chunk: int = 512, kv_chunk: int = 1024
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """How far rounding p and ds to bf16 can move K1b's bf16 gradients from
    :func:`flash_bwd_plain`'s, fp32 (dq, dk, dv)-shaped: BF16_ROUND times
    |ds| |k|, |ds|ᵀ |q| and |p|ᵀ |dout|, from the same p and ds. For the
    checks' bf16 limit; the main path never calls it."""
    blocks = _flash_bwd_blocks(q, k, v, out, lse, dout, causal, window,
                               logit_cap, q_positions, kv_positions, q_chunk,
                               kv_chunk)
    B, Sqp, Skvp, Hkv, G = next(blocks)
    hd = q.shape[-1]
    eq = q.new_zeros((B, Sqp, Hkv, G, hd), dtype=torch.float32)
    ek = k.new_zeros((B, Skvp, Hkv, hd), dtype=torch.float32)
    ev = torch.zeros_like(ek)
    for qs, ks, qc, doc, kc, vc, p, ds in blocks:
        ds = ds.abs()
        ev[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd", p, doc.abs())
        eq[:, qs] += torch.einsum("bhgqk,bkhd->bqhgd", ds, kc.abs())
        ek[:, ks] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qc.abs())
    Sq, Skv = q.shape[1], k.shape[1]
    return (BF16_ROUND * eq.reshape(B, Sqp, Hkv * G, hd)[:, :Sq],
            BF16_ROUND * ek[:, :Skv], BF16_ROUND * ev[:, :Skv])


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


def _rglru_terms(x, a_log, gate_r, gate_i):
    """a_t and b_t of the RG-LRU for every step (neither depends on h)."""
    al = a_log.float()
    decay = torch.clamp_min(al, 0.0) + torch.log1p(torch.exp(-al.abs()))
    a = torch.exp((-RGLRU_C * decay) * gate_r.float())
    return a, torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0)) * (
        gate_i.float() * x.float())


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
    a, b = _rglru_terms(x, a_log, gate_r, gate_i)
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    if h_out is not None:
        h = h_out.copy_(h)
    return torch.stack(ys, dim=1), h


def rglru_scan_chunked_plain(x: torch.Tensor, a_log: torch.Tensor,
                             gate_r: torch.Tensor, gate_i: torch.Tensor,
                             h0: torch.Tensor, *,
                             h_out: Optional[torch.Tensor] = None,
                             chunk: int = 32
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked body of ``csrc/rglru_scan.cu``, plainly; the function of
    :func:`rglru_scan_plain`.

    Time is cut into chunks of ``chunk`` steps (the last padded with a = 1,
    b = 0, which leave h as it is), each into 4 quarters. Pass 1 scans every
    quarter from 0 for its map h -> A h + E (A = prod a, E = the local end
    state) and composes a chunk's 4 maps; the carry applies the chunk maps
    in order from h0 (the kernel's look-back may group them otherwise, the
    same maps in the same order); pass 2 rescans each quarter from its carry
    with pass 1's a_t and b_t and writes y. h_T is the last rescanned h, so
    y[:, -1] == h_T.
    """
    if chunk % 4 or chunk < 4:
        raise ValueError(f"chunk {chunk}: want a positive multiple of 4")
    a, b = _rglru_terms(x, a_log, gate_r, gate_i)
    B, T, W = x.shape
    n, sub = -(-T // chunk), chunk // 4
    pad = n * chunk - T
    a = torch.cat([a, a.new_ones(B, pad, W)], 1).reshape(B, n, 4, sub, W)
    b = torch.cat([b, b.new_zeros(B, pad, W)], 1).reshape(B, n, 4, sub, W)
    A, E = a.new_ones(B, n, 4, W), a.new_zeros(B, n, 4, W)
    for j in range(sub):                                 # pass 1
        E = a[:, :, :, j] * E + b[:, :, :, j]
        A = A * a[:, :, :, j]
    cA, cE = A[:, :, 0], E[:, :, 0]                      # the chunk's map
    for q in range(1, 4):
        cA, cE = A[:, :, q] * cA, A[:, :, q] * cE + E[:, :, q]
    h, carry = h0.float(), []
    for c in range(n):                                   # the carry
        carry.append(h)
        h = cA[:, c] * h + cE[:, c]
    h = torch.stack(carry, 1)                            # [B, n, W]
    quarters = []
    for q in range(4):
        quarters.append(h)
        h = A[:, :, q] * h + E[:, :, q]
    h = torch.stack(quarters, 2)                         # [B, n, 4, W]
    ys = []
    for j in range(sub):                                 # pass 2
        h = a[:, :, :, j] * h + b[:, :, :, j]
        ys.append(h)
    y = torch.stack(ys, 3).reshape(B, n * chunk, W)[:, :T]
    h = y[:, -1].clone()
    if h_out is not None:
        h = h_out.copy_(h)
    return y, h


def _rglru_bwd_terms(x, a_log, gate_r, gate_i):
    """(a_log, coef = -c softplus(a_log), x, r, i, a_t, b_t, the u-term
    (a_t / b_t) i_t x_t, 0 where the clamp holds), all fp32."""
    al = a_log.float()
    coef = -RGLRU_C * (torch.clamp_min(al, 0.0)
                       + torch.log1p(torch.exp(-al.abs())))
    xf, r, i = x.float(), gate_r.float(), gate_i.float()
    a = torch.exp(coef * r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0))
    ratio = torch.where(b > 0, a / b, torch.zeros_like(b))
    term = torch.where(b > 0, ratio * (i * xf), torch.zeros_like(b))
    return al, coef, xf, r, i, a, b, term


def rglru_scan_bwd_plain(x: torch.Tensor, a_log: torch.Tensor,
                         gate_r: torch.Tensor, gate_i: torch.Tensor,
                         h0: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                         dh_T: torch.Tensor
                         ) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`rglru_scan_plain`: an explicit reverse loop
    over time (not autograd), in the order of ``csrc/rglru_bwd.cu``.

    ``y`` is the forward's h sequence [B,T,W] fp32, ``dy`` its cotangent and
    ``dh_T`` that of h_T. With c = 8, d = softplus(Λ), a_t, b_t =
    sqrt(max(1 - a_t², 0)) and u_t = i_t x_t::

        g_T = dy_T + dh_T,  g_t = dy_t + a_{t+1} g_{t+1}
        dx_t = g_t b_t i_t,  di_t = g_t b_t x_t
        da_t = g_t (h_{t-1} - (a_t / b_t) u_t),  dr_t = -c d a_t da_t
        dΛ = -c sigmoid(Λ) Σ_b Σ_t r_t a_t da_t,  dh0 = a_1 g_1

    Where the clamp holds (1 - a_t² <= 0, so b_t = 0) the term
    (a_t / b_t) u_t is taken as 0, the gradient of the clamped branch; JAX's
    gradient through ``sqrt`` at 0 is not finite there. dΛ sums over t in
    reverse for each batch row, then over the rows in order.

    Returns (dx, da_log, dgate_r, dgate_i, dh0), each in its input's dtype.
    """
    al, coef, xf, r, i, a, b, term = _rglru_bwd_terms(x, a_log, gate_r, gate_i)
    dx, dr, di = (torch.empty_like(xf) for _ in range(3))
    acc = torch.zeros_like(xf[:, 0])
    g = dh_T.float()                       # a_{t+1} g_{t+1}, then g_t
    for t in reversed(range(x.shape[1])):
        g = dy[:, t].float() + g
        gb = g * b[:, t]
        dx[:, t] = gb * i[:, t]
        di[:, t] = gb * xf[:, t]
        h_prev = y[:, t - 1] if t > 0 else h0.float()
        da = g * (h_prev - term[:, t])
        dr[:, t] = (coef * a[:, t]) * da
        acc = acc + (r[:, t] * a[:, t]) * da
        g = a[:, t] * g
    total = acc[0]
    for row in acc[1:]:
        total = total + row
    dal = (-RGLRU_C * torch.sigmoid(al)) * total
    return (dx.to(x.dtype), dal.to(a_log.dtype), dr.to(gate_r.dtype),
            di.to(gate_i.dtype), g.to(h0.dtype))


def rglru_scan_bwd_chunked_plain(x: torch.Tensor, a_log: torch.Tensor,
                                 gate_r: torch.Tensor, gate_i: torch.Tensor,
                                 h0: torch.Tensor, y: torch.Tensor,
                                 dy: torch.Tensor, dh_T: torch.Tensor, *,
                                 chunk: int = 32, quarters: int = 4
                                 ) -> Tuple[torch.Tensor, ...]:
    """The chunk-parallel scheme of ``csrc/rglru_bwd.cu``, plainly; the
    function of :func:`rglru_scan_bwd_plain`.

    With c_t the carry into step t (dh_T at the last step), the reverse
    recurrence is the affine map c_{t-1} = a_t (dy_t + c_t), so chunks of
    ``chunk`` steps reduce in parallel (the last padded with a = 1, dy = 0):

    1. maps: each quarter of a chunk composes its steps' maps last to first
       (P = Π a, Q = the carry reached from 0), and the quarters' maps
       compose into the chunk's, the last quarter first;
    2. carry: from dh_T, chunk by chunk last to first: each chunk's carry
       in, then c <- P c + Q; dh0 is the last c;
    3. rescan: each chunk walks its steps last to first from its carry in,
       g_t = dy_t + c, and writes dx, di, dr as the sequential version
       does; h_{t-1} is y[t-1] (h0 at t = 0); each (batch row, chunk) sums
       its r a da;
    4. da_log: those sums over the rows and chunks in order, times
       -c sigmoid(a_log).

    The carries regroup the sequential version's products and sums, so
    the two agree to rounding, not bit for bit.
    """
    if chunk % quarters or chunk < quarters:
        raise ValueError(f"chunk {chunk}: want a positive multiple of "
                         f"{quarters}")
    al, coef, xf, r, i, a, b, term = _rglru_bwd_terms(x, a_log, gate_r, gate_i)
    B, T, W = xf.shape
    n, sub = -(-T // chunk), chunk // quarters
    pad = n * chunk - T
    h_prev = torch.cat([h0.float()[:, None], y.float()[:, :-1]], 1)

    def blocks(t, fill=0.0):  # [B,T,W] -> [B,n,chunk,W]
        t = torch.cat([t, t.new_full((B, pad, W), fill)], 1)
        return t.reshape(B, n, chunk, W)

    a, dyb = blocks(a, 1.0), blocks(dy.float())
    qa, qd = a.reshape(B, n, quarters, sub, W), dyb.reshape(B, n, quarters,
                                                             sub, W)
    P, Q = a.new_ones(B, n, quarters, W), a.new_zeros(B, n, quarters, W)
    for j in reversed(range(sub)):                       # 1. maps
        Q = qa[:, :, :, j] * (qd[:, :, :, j] + Q)
        P = qa[:, :, :, j] * P
    cP, cQ = P[:, :, -1], Q[:, :, -1]
    for q in reversed(range(quarters - 1)):
        cP, cQ = P[:, :, q] * cP, P[:, :, q] * cQ + Q[:, :, q]
    c, carry = dh_T.float(), [None] * n                  # 2. carry
    for ch in reversed(range(n)):
        carry[ch] = c
        c = cP[:, ch] * c + cQ[:, ch]
    dh0 = c
    xb, rb, ib, bb, tb, hb = (blocks(t) for t in (xf, r, i, b, term, h_prev))
    c = torch.stack(carry, 1)                            # 3. rescan
    dx, dr, di = (torch.empty_like(xb) for _ in range(3))
    part = torch.zeros_like(c)
    for j in reversed(range(chunk)):
        g = dyb[:, :, j] + c
        gb = g * bb[:, :, j]
        dx[:, :, j] = gb * ib[:, :, j]
        di[:, :, j] = gb * xb[:, :, j]
        da = g * (hb[:, :, j] - tb[:, :, j])
        dr[:, :, j] = (coef * a[:, :, j]) * da
        part = part + (rb[:, :, j] * a[:, :, j]) * da
        c = a[:, :, j] * g
    total = part.new_zeros(W)                            # 4. da_log
    for row in part.reshape(B * n, W):
        total = total + row
    dal = (-RGLRU_C * torch.sigmoid(al)) * total
    unblock = lambda t: t.reshape(B, n * chunk, W)[:, :T]
    return (unblock(dx).to(x.dtype), dal.to(a_log.dtype),
            unblock(dr).to(gate_r.dtype), unblock(di).to(gate_i.dtype),
            dh0.to(h0.dtype))


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


def _wkv_bwd_step(s, g, r, k, v, w, u, dy):
    """One reverse step of the WKV backward for every (b, h): s = S_{t-1},
    g = dL/dS_t, the step's r, k, v, w, dy [B,H,hd] and u [H,hd], in fp32.
    Returns (dr, dk, dv, dw, the step's du term, dL/dS_{t-1})."""
    vdy = (v * dy).sum(-1, keepdim=True)              # v . dy
    ruk = (r * u * k).sum(-1, keepdim=True)           # r . (u ⊙ k)
    dr = torch.einsum("bhij,bhj->bhi", s, dy) + u * k * vdy
    dk = torch.einsum("bhij,bhj->bhi", g, v) + r * u * vdy
    dv = torch.einsum("bhij,bhi->bhj", g, k) + ruk * dy
    dw = (g * s).sum(-1)
    return (dr, dk, dv, dw, r * k * vdy,
            w[..., :, None] * g + r[..., :, None] * dy[..., None, :])


def _wkv_bwd_finish(r, u, state, grads, du_rows, g):
    """(dr, dk, dv, dw, du, ds0) in their inputs' dtypes from the stacked
    step gradients, du's per-batch-row sums taken over the rows in order."""
    du = du_rows[0]
    for row in du_rows[1:]:
        du = du + row
    dr, dk, dv, dw = (torch.stack(a[::-1], 1) for a in grads)
    return (dr.to(r.dtype), dk.to(r.dtype), dv.to(r.dtype), dw,
            du.to(u.dtype), g.to(state.dtype))


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                         dy: torch.Tensor, ds_T: torch.Tensor
                         ) -> Tuple[torch.Tensor, ...]:
    """The backward of :func:`rwkv6_scan_plain`: a forward loop keeps every
    state, then an explicit reverse loop over time (not autograd). With
    G = dL/dS_t (from ``ds_T``) and S = S_{t-1}, each step::

        dr_i = Σ_j S_ij dy_j + u_i k_i (v·dy)
        dk_i = r_i u_i (v·dy) + Σ_j G_ij v_j
        dv_j = (Σ_i r_i u_i k_i) dy_j + Σ_i G_ij k_i
        du_i += r_i k_i (v·dy),  dw_i = Σ_j G_ij S_ij
        G <- diag(w) G + r dyᵀ

    and ds0 is the last G. du sums over t in reverse for each batch row,
    then over the rows in order. Returns (dr, dk, dv, dw, du, ds0): dr, dk,
    dv in r's dtype, dw fp32, du in u's dtype, ds0 fp32.
    """
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    s, states = state.float(), []
    for t in range(r.shape[1]):
        states.append(s)
        s = wf[:, t, :, :, None] * s + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    g = ds_T.float()
    grads, du_rows = ([], [], [], []), torch.zeros_like(rf[:, 0])
    for t in reversed(range(r.shape[1])):
        *step, du_t, g = _wkv_bwd_step(states[t], g, rf[:, t], kf[:, t],
                                       vf[:, t], wf[:, t], uf, dyf[:, t])
        for acc, part in zip(grads, step):
            acc.append(part)
        du_rows = du_rows + du_t
    return _wkv_bwd_finish(r, u, state, grads, du_rows, g)


def _sums_before(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ of the entries before each along ``dim`` (0 for the first)."""
    z = torch.zeros_like(a.narrow(dim, 0, 1))
    return torch.cat([z, torch.cumsum(a, dim).narrow(dim, 0, a.shape[dim] - 1)],
                     dim)


def _sums_after(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Σ of the entries after each along ``dim`` (0 for the last)."""
    return _sums_before(a.flip(dim), dim).flip(dim)


class _WKVChunks:
    """[B,T,H,hd] tensors cut into chunks of ``chunk`` steps and sub-chunks
    of ``sub`` ([B,H,n,m,sub,hd]; the last chunk padded with ``fill``), and
    the runs of lw = max(log w, LOG_W_FLOOR) that the chunked WKV kernels
    sum: p (before t in its sub-chunk), q (after t in it), g (each whole
    sub-chunk) and g's sums over the sub-chunks before and after."""

    def __init__(self, w: torch.Tensor, chunk: int, sub: int):
        if chunk % sub or sub < 1:
            raise ValueError(f"chunk {chunk}, sub {sub}: want sub | chunk")
        B, T, H, hd = w.shape
        self.shape, self.chunk, self.sub = (B, T, H, hd), chunk, sub
        self.n, self.m = -(-T // chunk), chunk // sub
        self.w = self.blocks(w, 1.0)
        self.lw = torch.clamp_min(torch.log(self.w), LOG_W_FLOOR)
        self.p, self.q = _sums_before(self.lw, 4), _sums_after(self.lw, 4)
        self.g = self.lw.sum(4)                          # [B,H,n,m,hd]
        self.g_before = _sums_before(self.g, 3)
        self.g_after = _sums_after(self.g, 3)
        self.d = torch.exp(self.g.sum(3))                # [B,H,n,hd]

    def blocks(self, a: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        B, T, H, hd = self.shape
        pad = self.n * self.chunk - T
        a = torch.cat([a.float(), a.new_full((B, pad, H, hd), fill).float()], 1)
        return a.reshape(B, self.n, self.m, self.sub, H, hd).permute(
            0, 4, 1, 2, 3, 5)

    def steps(self, a: torch.Tensor) -> torch.Tensor:
        """[B,H,n,m,sub,hd] -> [B,H,n,chunk,hd]"""
        return a.reshape(*a.shape[:3], self.chunk, a.shape[-1])

    def unblock(self, a: torch.Tensor) -> torch.Tensor:
        """[B,H,n,chunk,hd] -> [B,T,H,hd]"""
        B, T, H, hd = self.shape
        return a.permute(0, 2, 3, 1, 4).reshape(B, -1, H, hd)[:, :T]

    def k_to_end(self, k: torch.Tensor) -> torch.Tensor:
        """K̂[s] = k_s ⊙ exp(Σ lw after s to the chunk's end)."""
        return k * torch.exp(self.q + self.g_after[..., None, :])

    def r_from_start(self, r: torch.Tensor) -> torch.Tensor:
        """R̃[t] = r_t ⊙ exp(Σ lw from the chunk's start to t, exclusive)."""
        return r * torch.exp(self.g_before[..., None, :] + self.p)

    def starts(self, k: torch.Tensor, v: torch.Tensor, state: torch.Tensor):
        """Passes 1-2 of the chunked form: each chunk's start state
        [B,H,n,hd,hd] from ΔS_c = K̂ᵀ V and S_{c+1} = diag(D_c) S_c + ΔS_c,
        and S_T."""
        ds = torch.einsum("bhnjsk,bhnjsv->bhnkv", self.k_to_end(k), v)
        s, starts = state.float(), []
        for c in range(self.n):
            starts.append(s)
            s = self.d[:, :, c, :, None] * s + ds[:, :, c]
        return torch.stack(starts, 2), s

    def weights(self, r: torch.Tensor, k: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
        """A [B,H,n,chunk,chunk], A[t,s] the weight of v_s in y_t within its
        chunk: for s in an earlier sub-chunk (r_t ⊙ exp(p[t])) · (k_s ⊙
        exp(q[s] + G between)), within a sub-chunk Σ_k r_t k_s Π_{s<m<t}
        w_m (the sequential version's products), A[t,t] = Σ_k r_t u k_t
        (the u-term), 0 for s > t."""
        B, H, n, m, sub, hd = r.shape
        a = r.new_zeros(B, H, n, m, sub, m, sub)
        rh = r * torch.exp(self.p)
        for i in range(1, m):
            between = _sums_after(self.g[..., :i, :], 3)
            kh = k[..., :i, :, :] * torch.exp(self.q[..., :i, :, :]
                                              + between[..., None, :])
            a[:, :, :, i, :, :i, :] = torch.einsum(
                "bhntk,bhnjsk->bhntjs", rh[..., i, :, :], kh)
        diag = torch.diag_embed(
            (r * u.float()[:, None, None, None, :] * k).sum(-1))
        decay = torch.ones_like(self.w)                  # Π_{s<m<s+dt} w_m
        for dt in range(1, sub):
            pair = (r[..., dt:, :] * k[..., :-dt, :] * decay[..., :-dt, :]).sum(-1)
            diag = diag + torch.diag_embed(pair, -dt)
            decay = torch.cat([decay[..., :-dt, :] * self.w[..., dt:, :],
                               torch.ones_like(self.w[..., :dt, :])], 4)
        for i in range(m):
            a[:, :, :, i, :, i, :] = diag[:, :, :, i]
        return a.reshape(B, H, n, m * sub, m * sub)


def rwkv6_scan_bwd_chunked_plain(r: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, w: torch.Tensor,
                                 u: torch.Tensor, state: torch.Tensor,
                                 dy: torch.Tensor, ds_T: torch.Tensor, *,
                                 chunk: int = 64, sub: int = 16
                                 ) -> Tuple[torch.Tensor, ...]:
    """The chunk-parallel scheme of ``csrc/wkv6_bwd.cu``, plainly; the
    function of :func:`rwkv6_scan_bwd_plain`.

    Chunks of ``chunk`` steps and their sub-chunks and decays as
    :func:`rwkv6_scan_chunked_plain` cuts them; S_c is the state before the
    chunk's first step, G_{c+1} the cotangent of the state after its last.

    1. states: S_c by the forward's chunk summaries and carry;
    2. cotangents: ΔG_c = R̃ᵀ dY, R̃[t] = r_t ⊙ Π_{c0<=m<t} w_m, and from
       dS_T the reverse carry G_c = diag(D_c) G_{c+1} + ΔG_c; ds0 is the
       last G;
    3. every chunk at once: a forward walk from S_c keeps each step's state,
       then the reverse walk from G_{c+1} takes the row sums
       dr_t = S dy_t + u ⊙ k_t (v_t·dy_t), dk_t = G v_t + r_t ⊙ u (v_t·dy_t),
       dw_t = Σ_v G ⊙ S (no division by w, which reaches 0), du's terms
       r_t ⊙ k_t (v_t·dy_t), the column sums dv_t = Gᵀ k_t + (r_t·(u ⊙ k_t))
       dy_t, and G <- diag(w_t) G + r_t dy_tᵀ;
    4. du sums each (batch row, chunk)'s terms over the rows and chunks in
       order.

    The chunk states and cotangents regroup the sequential version's sums
    (the kernel's are 3xTF32 products on the tensor cores), so the two agree
    to rounding, not bit for bit.
    """
    ch = _WKVChunks(w, chunk, sub)
    B, T, H, hd = r.shape
    rb, kb, vb, dyb = (ch.blocks(a) for a in (r, k, v, dy))
    starts, _ = ch.starts(kb, vb, state)                 # 1. states
    dg = torch.einsum("bhnjsk,bhnjsv->bhnkv", ch.r_from_start(rb), dyb)
    g, ends = ds_T.float(), [None] * ch.n                # 2. cotangents
    for c in reversed(range(ch.n)):
        ends[c] = g
        g = ch.d[:, :, c, :, None] * g + dg[:, :, c]
    ends = torch.stack(ends, 2)                          # G_{c+1}
    R, K, V, Wt, DY = (ch.steps(a) for a in (rb, kb, vb, ch.w, dyb))
    uf = u.float()[None, :, None, :]
    s, states = starts, []                               # 3. the walk
    for t in range(chunk):
        states.append(s)
        s = Wt[..., t, :, None] * s + K[..., t, :, None] * V[..., t, None, :]
    G = ends
    dr, dk, dv, dw = (torch.empty_like(R) for _ in range(4))
    du_part = torch.zeros_like(R[..., 0, :])
    for t in reversed(range(chunk)):
        vdy = (V[..., t, :] * DY[..., t, :]).sum(-1, keepdim=True)
        ruk = (R[..., t, :] * uf * K[..., t, :]).sum(-1, keepdim=True)
        dr[..., t, :] = (torch.einsum("bhnij,bhnj->bhni", states[t], DY[..., t, :])
                         + uf * K[..., t, :] * vdy)
        dk[..., t, :] = (torch.einsum("bhnij,bhnj->bhni", G, V[..., t, :])
                         + R[..., t, :] * uf * vdy)
        dw[..., t, :] = (G * states[t]).sum(-1)
        dv[..., t, :] = (torch.einsum("bhnij,bhni->bhnj", G, K[..., t, :])
                         + ruk * DY[..., t, :])
        du_part = du_part + R[..., t, :] * K[..., t, :] * vdy
        G = Wt[..., t, :, None] * G + R[..., t, :, None] * DY[..., t, None, :]
    du = du_part.new_zeros(H, hd)                        # 4. du
    for row in du_part.permute(0, 2, 1, 3).reshape(B * ch.n, H, hd):
        du = du + row
    return (ch.unblock(dr).to(r.dtype), ch.unblock(dk).to(r.dtype),
            ch.unblock(dv).to(r.dtype), ch.unblock(dw), du.to(u.dtype),
            g.to(state.dtype))


def rwkv6_scan_chunked_plain(r: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                             state: torch.Tensor, *,
                             state_out: Optional[torch.Tensor] = None,
                             chunk: int = 64, sub: int = 16
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked matrix form of ``csrc/wkv6_chunk.cu``, plainly; the
    function of :func:`rwkv6_scan_plain`.

    Time is cut into chunks of ``chunk`` steps (the last padded with r, k,
    v = 0 and w = 1), each into sub-chunks of ``sub`` steps. With
    lw = max(log w, LOG_W_FLOOR), every decay from step s to step t-1 is
    exp(Σ_{s<m<t} lw_m), and the kernel sums only runs of lw inside a
    sub-chunk (p: from its start up to t, exclusive; q: after s to its end)
    and whole sub-chunks (G): sums of terms of one sign, so no decay comes
    from the difference of two large sums, which would lose the small decay
    of a short run behind a long one.

    1. summaries: D = exp(Σ G), ΔS = (k ⊙ exp(q[s] + G after s's sub-chunk))ᵀ V;
    2. carry: S_{c+1} = diag(D_c) S_c + ΔS_c from ``state``;
    3. outputs: y = (r ⊙ exp(G before + p[t])) S_c + A V, where A[t,s] for s
       in an earlier sub-chunk is (r_t ⊙ exp(p[t])) · (k_s ⊙ exp(q[s] + G
       between)), within a sub-chunk Σ_k r_t k_s Π_{s<m<t} w_m (the
       sequential version's products), and A[t,t] = Σ_k r_t u k_t (the
       u-term).
    """
    ch = _WKVChunks(w, chunk, sub)
    rb, kb, vb = (ch.blocks(a) for a in (r, k, v))
    sc, s = ch.starts(kb, vb, state)                     # 1-2.
    y = torch.einsum("bhnjtk,bhnkv->bhnjtv", ch.r_from_start(rb), sc)  # 3.
    y = ch.steps(y) + torch.einsum("bhnts,bhnsv->bhntv",
                                   ch.weights(rb, kb, u), ch.steps(vb))
    y = ch.unblock(y)
    if state_out is not None:
        s = state_out.copy_(s)
    return y, s


def _expert_rows(ends: torch.Tensor):
    """(expert, first row, end row) of each expert of a compact buffer whose
    expert e owns rows [ends[e-1], ends[e]) (one host read of ``ends``)."""
    start = 0
    for e, end in enumerate(ends.tolist()):
        yield e, start, end
        start = end


def moe_gate_up_plain(a: torch.Tensor, ends: torch.Tensor,
                      w_gate: torch.Tensor, w_up: torch.Tensor
                      ) -> torch.Tensor:
    """``moe_gemm.moe_gate_up``'s function, expert by expert: on expert e's
    rows of a [R, D], silu(a Wg[e]) * (a Wu[e]) with both products and the
    product of the two in fp32, rounded to a's dtype once: [R, Fe]. Rows at
    or past ``ends[-1]`` are 0."""
    h = torch.zeros((a.shape[0], w_gate.shape[2]), dtype=a.dtype,
                    device=a.device)
    for e, r0, r1 in _expert_rows(ends):
        x = a[r0:r1].float()
        g = x @ w_gate[e].float()
        h[r0:r1] = (g / (1.0 + torch.exp(-g)) * (x @ w_up[e].float())).to(
            a.dtype)
    return h


def moe_down_plain(h: torch.Tensor, ends: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """``moe_gemm.moe_down``'s function: h Wd[e] on expert e's rows of h
    [R, Fe] in fp32, rounded to h's dtype: [R, D], 0 at or past
    ``ends[-1]``."""
    out = torch.zeros((h.shape[0], w_down.shape[2]), dtype=h.dtype,
                      device=h.device)
    for e, r0, r1 in _expert_rows(ends):
        out[r0:r1] = (h[r0:r1].float() @ w_down[e].float()).to(h.dtype)
    return out


def moe_experts_plain(a: torch.Tensor, ends: torch.Tensor,
                      w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor) -> torch.Tensor:
    """``ops.moe_experts``' function: the two entries in turn."""
    return moe_down_plain(moe_gate_up_plain(a, ends, w_gate, w_up), ends,
                          w_down)
