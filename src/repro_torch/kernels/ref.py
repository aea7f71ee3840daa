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
    al = a_log.float()
    coef = -RGLRU_C * (torch.clamp_min(al, 0.0)
                       + torch.log1p(torch.exp(-al.abs())))
    xf, r, i = x.float(), gate_r.float(), gate_i.float()
    a = torch.exp(coef * r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 0.0))
    ratio = torch.where(b > 0, a / b, torch.zeros_like(b))
    term = torch.where(b > 0, ratio * (i * xf), torch.zeros_like(b))
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


def rwkv6_scan_bwd_chunked_plain(r: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, w: torch.Tensor,
                                 u: torch.Tensor, state: torch.Tensor,
                                 dy: torch.Tensor, ds_T: torch.Tensor, *,
                                 chunk: int = 16, sub: int = 4
                                 ) -> Tuple[torch.Tensor, ...]:
    """The checkpoint-and-recompute scheme of ``csrc/wkv6_bwd.cu``, plainly;
    the function of :func:`rwkv6_scan_bwd_plain`, whose steps it takes in
    the same order on the same states (so the same bits).

    A forward pass keeps the state at the start of every chunk of ``chunk``
    steps. The reverse takes the chunks last to first, and each chunk's
    sub-chunks of ``sub`` steps last to first: it steps a sub-chunk's start
    state forward from the chunk's checkpoint, then the ``sub`` states of
    the sub-chunk (which the kernel holds in registers), and runs their
    reverse steps. No state is recovered by dividing by w, which reaches 0.
    """
    if chunk % sub or sub < 1:
        raise ValueError(f"chunk {chunk}, sub {sub}: want sub | chunk")
    rf, kf, vf, wf, dyf = (a.float() for a in (r, k, v, w, dy))
    uf = u.float()
    T = r.shape[1]

    def step(s, t):
        return wf[:, t, :, :, None] * s + kf[:, t, :, :, None] * vf[:, t, :, None, :]

    s, checkpoints = state.float(), []
    for t in range(T):
        if t % chunk == 0:
            checkpoints.append(s)
        s = step(s, t)
    g = ds_T.float()
    grads, du_rows = ([], [], [], []), torch.zeros_like(rf[:, 0])
    for c in reversed(range(len(checkpoints))):
        t0 = c * chunk
        for j in reversed(range(-(-min(chunk, T - t0) // sub))):
            s = checkpoints[c]
            for t in range(t0, t0 + j * sub):
                s = step(s, t)
            held = []
            for t in range(t0 + j * sub, min(t0 + (j + 1) * sub, T)):
                held.append(s)
                s = step(s, t)
            for t in reversed(range(t0 + j * sub, t0 + j * sub + len(held))):
                *parts, du_t, g = _wkv_bwd_step(
                    held[t - t0 - j * sub], g, rf[:, t], kf[:, t], vf[:, t],
                    wf[:, t], uf, dyf[:, t])
                for acc, part in zip(grads, parts):
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
    if chunk % sub or sub < 1:
        raise ValueError(f"chunk {chunk}, sub {sub}: want sub | chunk")
    B, T, H, hd = r.shape
    n, m = -(-T // chunk), chunk // sub
    pad = n * chunk - T

    def blocks(a, fill):  # [B,T,H,hd] -> [B,H,n,m,sub,hd], padded with fill
        a = torch.cat([a.float(), a.new_full((B, pad, H, hd), fill).float()], 1)
        return a.reshape(B, n, m, sub, H, hd).permute(0, 4, 1, 2, 3, 5)

    r, k, v, w = blocks(r, 0), blocks(k, 0), blocks(v, 0), blocks(w, 1)
    lw = torch.clamp_min(torch.log(w), LOG_W_FLOOR)
    p, q = _sums_before(lw, 4), _sums_after(lw, 4)
    g = lw.sum(4)                                        # [B,H,n,m,hd]
    g_before, g_after = _sums_before(g, 3), _sums_after(g, 3)
    # 1. summaries
    d = torch.exp(g.sum(3))                              # [B,H,n,hd]
    kt = k * torch.exp(q + g_after[..., None, :])
    ds = torch.einsum("bhnjsk,bhnjsv->bhnkv", kt, v)
    # 2. carry
    s, starts = state.float(), []
    for c in range(n):
        starts.append(s)
        s = d[:, :, c, :, None] * s + ds[:, :, c]
    sc = torch.stack(starts, 2)                          # [B,H,n,hd,hd]
    # 3. outputs
    rt = r * torch.exp(g_before[..., None, :] + p)
    y = torch.einsum("bhnitk,bhnkv->bhnitv", rt, sc)
    rh = r * torch.exp(p)
    for i in range(1, m):
        between = _sums_after(g[..., :i, :], 3)
        kh = k[..., :i, :, :] * torch.exp(q[..., :i, :, :] + between[..., None, :])
        a = torch.einsum("bhntk,bhnjsk->bhntjs", rh[..., i, :, :], kh)
        y[..., i, :, :] += torch.einsum("bhntjs,bhnjsv->bhntv", a, v[..., :i, :, :])
    diag = torch.diag_embed((r * u.float()[:, None, None, None, :] * k).sum(-1))
    decay = torch.ones_like(w)                           # Π_{s<m<s+dt} w_m
    for dt in range(1, sub):
        pair = (r[..., dt:, :] * k[..., :-dt, :] * decay[..., :-dt, :]).sum(-1)
        diag = diag + torch.diag_embed(pair, -dt)
        decay = torch.cat([decay[..., :-dt, :] * w[..., dt:, :],
                           torch.ones_like(w[..., :dt, :])], 4)
    y = y + torch.einsum("bhnits,bhnisv->bhnitv", diag, v)
    y = y.permute(0, 2, 3, 4, 1, 5).reshape(B, n * chunk, H, hd)[:, :T]
    if state_out is not None:
        s = state_out.copy_(s)
    return y, s
