"""K1's LSE and the flash backward (K1b) of the port against the JAX package,
on the CPU: the plain versions (``ref.attention_lse_plain``,
``ref.flash_bwd_plain``) against ``_flash_fwd_impl`` / ``_flash_bwd_impl``,
and the autograd ``FlashAttention`` against ``jax.grad`` of
``attention_reference``.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: the LSE and the chunked backward against the reference's own
chunked functions at the same chunk sizes, atol = rtol = 1e-5 in fp32 (the
same algorithm, einsums summed in another order); in bf16 inputs both
compute in fp32 and round each gradient to bf16 once, so one bf16 ulp
(2**-7 of |want|) more. The Function's gradients against ``jax.grad`` of
the unchunked oracle: 5e-5, as ``tests/test_models.py`` holds the
reference's own custom VJP.

K1b's bf16 body rounds p and ds to bf16 before the products that take them
(dv = pᵀ dout, dk = dsᵀ q, dq = ds k); the card's checks add
``ref.flash_bwd_rounding_plain`` (2^-8 of |p|ᵀ|dout|, |ds|ᵀ|q|, |ds||k|)
to their bf16 limit (atol 1e-4, rtol 2^-6). An emulation of that arithmetic
in torch is held here against ``_flash_bwd_impl`` within the same limit.
"""
import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import (_flash_bwd_impl, _flash_fwd_impl,
                                    attention_reference, flash_attention_jnp)
from repro_torch.kernels import flash_bwd as fb
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import FlashAttention, flash_attention
from repro_torch.obs import metrics

# the SMs of an H100, the card the plan's splits are set for
H100_SMS = 132

# (B, Sq, Hq, Hkv, hd, causal, window, cap, empty, q_chunk, kv_chunk)
CASES = [
    (1, 64, 4, 2, 16, True, None, None, False, 16, 32),
    (2, 50, 4, 4, 8, True, None, None, False, 16, 32),     # chunks ragged
    (1, 70, 8, 2, 16, True, 24, None, False, 32, 16),      # window
    (1, 64, 4, 2, 16, True, None, 30.0, False, 64, 64),    # softcap
    (1, 64, 4, 2, 16, True, 24, 30.0, False, 16, 32),      # both
    (2, 45, 6, 1, 8, True, None, None, True, 16, 16),      # MQA, -1 slots
    (1, 40, 4, 2, 16, False, None, 20.0, True, 512, 1024),  # not causal
    (1, 33, 16, 1, 24, True, 7, 50.0, True, 8, 8),         # G 16, hd 24
]


def _inputs(case, seed=0):
    B, S, Hq, Hkv, hd, causal, window, cap, empty, qc, kc = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    dout = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    kp = np.arange(S, dtype=np.int32)
    if empty:  # every 5th slot empty, key 0 too: query 0 sees no key
        kp[::5] = -1
    return q, k, v, dout, np.arange(S, dtype=np.int32), kp


def _kw(case, qp, kp):
    _, _, _, _, _, causal, window, cap, _, _, _ = case
    return dict(causal=causal, window=window, logit_cap=cap,
                q_positions=torch.from_numpy(qp),
                kv_positions=torch.from_numpy(kp))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _jax_fwd(case, q, k, v, qp, kp):
    _, _, _, _, _, causal, window, cap, _, qc, kc = case
    return _flash_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(qp), jnp.asarray(kp), causal, window,
                           cap, qc, kc)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_attention_lse_plain_matches_flash_fwd_impl(case):
    q, k, v, _, qp, kp = _inputs(case)
    out_j, lse_j = _jax_fwd(case, q, k, v, qp, kp)
    out, lse = ref.attention_lse_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                       **_kw(case, qp, kp))
    assert lse.shape == lse_j.shape and lse.dtype == torch.float32
    assert lse.is_contiguous() and out.is_contiguous()
    _close(lse, lse_j, 1e-5)
    # rows with a valid key: the reference's out too (a row with none gets
    # the mean of V from the oracle, and 0 from the kernels; see ROADMAP)
    seen = np.asarray(lse_j > -1e29).transpose(0, 3, 1, 2).reshape(
        q.shape[0], q.shape[1], q.shape[2])
    _close(out.numpy()[seen], np.asarray(out_j)[seen], 1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_bwd_plain_matches_flash_bwd_impl(case, dtype):
    _, _, _, _, _, causal, window, cap, _, qc, kc = case
    q, k, v, dout, qp, kp = _inputs(case, seed=1)
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jq, jk, jv, jd = (jnp.asarray(a, jdt) for a in (q, k, v, dout))
    out_j, lse_j = _flash_fwd_impl(jq, jk, jv, jnp.asarray(qp),
                                   jnp.asarray(kp), causal, window, cap, qc,
                                   kc)
    want = _flash_bwd_impl(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp),
                           out_j, lse_j, jd, causal, window, cap, qc, kc)
    tq, tk, tv, td, tout = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                            .to(tdt) for a in (jq, jk, jv, jd, out_j))
    got = ref.flash_bwd_plain(tq, tk, tv, tout, torch.from_numpy(
        np.array(lse_j)), td, **_kw(case, qp, kp), q_chunk=qc, kv_chunk=kc)
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "fp32":
            _close(g, w, 1e-5)
        else:
            np.testing.assert_allclose(g.float().numpy(), w,
                                       atol=1e-5, rtol=1e-5 + 2.0 ** -7)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_bwd_plain_gives_no_gradient_to_a_row_without_keys(case):
    q, k, v, dout, qp, kp = _inputs(case, seed=2)
    kw = _kw(case, qp, kp)
    tq, tk, tv, td = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, lse = ref.attention_lse_plain(tq, tk, tv, **kw)
    dq, _, _ = ref.flash_bwd_plain(tq, tk, tv, out, lse, td, **kw)
    empty_rows = (lse < ref.MASK_VALUE / 2).any(dim=(1, 2))     # [B, Sq]
    assert bool(empty_rows.any()) == (kp[0] == -1 and case[5])
    assert float(dq[empty_rows].abs().sum()) == 0.0


@pytest.mark.parametrize("case", [
    ((1, 64, 4, 2, 16), dict(causal=True, window=24, logit_cap=30.0)),
    ((2, 48, 8, 2, 16), dict(causal=True)),
    ((1, 40, 4, 1, 8), dict(causal=False, logit_cap=20.0)),
], ids=str)
def test_function_grads_match_jax_grad_of_the_reference(case):
    """tests/test_models.py::test_flash_custom_vjp_matches_reference_grad,
    through the port's autograd Function (5e-5)."""
    (B, S, Hq, Hkv, hd), kw = case
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    ct = rng.standard_normal((B, S, Hq, hd)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(attention_reference(*a, **kw) * ct),
                    argnums=(0, 1, 2))(q, k, v)
    chunked = jax.grad(lambda *a: jnp.sum(flash_attention_jnp(
        *a, q_chunk=16, kv_chunk=32, **kw) * ct), argnums=(0, 1, 2))(q, k, v)
    pos = torch.arange(S, dtype=torch.int32)
    for plain in (False, True):
        t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = flash_attention(*t, q_positions=pos, kv_positions=pos,
                              plain=plain, **kw)
        (out * torch.from_numpy(ct)).sum().backward()
        for g, w, c in zip(t, want, chunked):
            _close(g.grad, w, 5e-5)
            _close(g.grad, c, 5e-5)


def test_function_only_when_a_gradient_is_needed():
    """Serving (no input requiring grad, or grad disabled) keeps
    ops.attention; training goes through FlashAttention; both give the same
    out."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 9, 4, 16), (1, 9, 2, 16), (1, 9, 2, 16)))
    pos = torch.arange(9, dtype=torch.int32)
    kw = dict(q_positions=pos, kv_positions=pos, window=4, logit_cap=10.0)
    served = flash_attention(q, k, v, **kw)
    assert served.grad_fn is None
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(), k, v, **kw).grad_fn is None
    trained = flash_attention(q, k, v, **kw)
    assert type(trained.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(served, trained.detach())
    assert torch.equal(served, ops.attention(q.detach(), k, v, **kw))


def test_ops_training_halves_dispatch_to_the_plain_versions_on_the_cpu():
    case = CASES[4]
    q, k, v, dout, qp, kp = _inputs(case, seed=5)
    kw = _kw(case, qp, kp)
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = ops.attention_fwd(*t[:3], **kw)
    want_out, want_lse = ref.attention_lse_plain(*t[:3], **kw)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    got = ops.attention_bwd(*t[:3], out, lse, t[3], **kw)
    want = ref.flash_bwd_plain(*t[:3], out, lse, t[3], **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="one device"):
        ops.attention_bwd(*t[:3], out, lse.to("meta"), t[3], **kw)
    # FlashAttention returns no gradient for the positions
    tq = t[0].clone().requires_grad_()
    o = FlashAttention.apply(tq, t[1], t[2], kw["q_positions"],
                             kw["kv_positions"], True, 24, 30.0, False)
    o.sum().backward()
    assert tq.grad is not None and kw["q_positions"].grad is None


def _kernel_bf16_arithmetic(q, k, v, out, lse, dout, *, causal, window,
                            logit_cap, q_positions, kv_positions):
    """K1b's bf16 body in torch: s, dp, p and ds in fp32 from the bf16
    inputs, p and ds rounded to bf16 before dv = pᵀ dout, dk = dsᵀ q and
    dq = ds k, those summed in fp32 and each rounded to bf16 once."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    G = Hq // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, hd)
    dog = dout.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * hd ** -0.5
    ug = torch.ones_like(s)
    if logit_cap is not None:
        t = torch.tanh(s / logit_cap)
        ug, s = 1.0 - t * t, logit_cap * t
    dpos = q_positions[:, None].long() - kv_positions[None, :].long()
    valid = (kv_positions[None, :] >= 0).expand(dpos.shape)
    if causal:
        valid = valid & (dpos >= 0)
    if window is not None:
        valid = valid & (dpos < window)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    delta = (dout.float() * out.float()).sum(-1).reshape(
        B, Sq, Hkv, G).permute(0, 2, 3, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta[..., None]) * ug * hd ** -0.5
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bhgqk,bqhgd->bkhd", pb, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", dsb, qg)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", dsb, k.float()).reshape(q.shape)
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_kernel_bf16_arithmetic_within_the_bf16_limit_of_flash_bwd_impl(case):
    """The bf16 limit of the card's checks, atol 1e-4 + rtol 2^-6 |want| +
    ref.flash_bwd_rounding_plain, covers rounding p and ds to bf16, and
    the limit without the term does not."""
    _, _, _, _, _, causal, window, cap, _, qc, kc = case
    q, k, v, dout, qp, kp = _inputs(case, seed=6)
    jq, jk, jv, jd = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, dout))
    out_j, lse_j = _flash_fwd_impl(jq, jk, jv, jnp.asarray(qp),
                                   jnp.asarray(kp), causal, window, cap, qc,
                                   kc)
    want = _flash_bwd_impl(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp),
                           out_j, lse_j, jd, causal, window, cap, qc, kc)
    tq, tk, tv, td, tout = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                            .bfloat16() for a in (jq, jk, jv, jd, out_j))
    tlse = torch.from_numpy(np.array(lse_j))
    kw = _kw(case, qp, kp)
    got = _kernel_bf16_arithmetic(tq, tk, tv, tout, tlse, td, **kw)
    terms = ref.flash_bwd_rounding_plain(tq, tk, tv, tout, tlse, td, **kw)
    beyond_old_limit = False
    for name, g, w, term in zip(("dq", "dk", "dv"), got, want, terms):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert term.shape == w.shape and bool((term >= 0).all())
        err = (g.float() - w).abs()
        limit = 1e-4 + 2.0 ** -6 * w.abs() + term
        assert bool((err <= limit).all()), (
            f"{name}: worst excess {float((err - limit).max())}")
        beyond_old_limit |= bool((err > limit - term).any())
    assert beyond_old_limit


def test_rounding_term_is_the_bf16_unit_times_the_absolute_products():
    case = CASES[4]
    q, k, v, dout, qp, kp = _inputs(case, seed=7)
    kw = _kw(case, qp, kp)
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    out, lse = ref.attention_lse_plain(*t[:3], **kw)
    terms = ref.flash_bwd_rounding_plain(*t[:3], out, lse, t[3], **kw)
    # with |q|, |k|, |dout| and an out that makes delta 0, every term of the
    # sums is non-negative: the plain backward of those inputs gives the same
    # sums for dv (p >= 0); ds = p dp (1 - t²) scale >= 0 needs dp >= 0
    a = [x.abs() for x in t]
    out0 = torch.zeros_like(out)
    _, lse_a = ref.attention_lse_plain(*a[:3], **kw)
    gq, gk, gv = ref.flash_bwd_plain(*a[:3], out0, lse_a, a[3], **kw)
    eq, ek, ev = ref.flash_bwd_rounding_plain(*a[:3], out0, lse_a, a[3], **kw)
    for g, e in ((gq, eq), (gk, ek), (gv, ev)):
        torch.testing.assert_close(e, ref.BF16_ROUND * g, rtol=1e-6, atol=0)
    assert all(x.dtype == torch.float32 for x in terms)


@pytest.mark.parametrize("shape,dtype,splits", [
    ((4, 2048, 2048, 32, 8, 128), torch.bfloat16, 1),   # qwen3-4b training
    ((4, 2048, 2048, 32, 8, 128), torch.float32, 1),
    ((4, 1024, 1024, 32, 8, 128), torch.bfloat16, 1),   # 512 CTAs
    ((2, 1024, 1024, 32, 8, 128), torch.bfloat16, 2),   # 256: just short
    ((1, 2100, 2100, 16, 1, 256), torch.bfloat16, 8),   # MQA, hd 256
    ((1, 2100, 2100, 16, 1, 256), torch.float32, 4),
    ((1, 320, 320, 28, 4, 128), torch.bfloat16, 14),    # qwen2-7b, G 7
    ((2, 256, 256, 24, 8, 128), torch.bfloat16, 5),     # phi4-mini, G 3
    ((2, 256, 256, 24, 8, 128), torch.float32, 5),
    ((1, 64, 64, 4, 4, 32), torch.bfloat16, 2),         # one split a block
], ids=str)
def test_plan_splits_the_dkdv_grid_below_two_waves(shape, dtype, splits):
    B, Sq, Skv, Hq, Hkv, hd = shape
    got = fb.plan(B, Sq, Skv, Hq, Hkv, hd, dtype, sms=H100_SMS)
    keys = 32 if dtype == torch.float32 and hd > 128 else 64
    assert got.keys_per_cta == keys and got.rows_per_block == 32
    assert got.dkdv_ctas == -(-Skv // keys) * Hkv * B
    assert got.splits == splits
    blocks = -(-Sq * (Hq // Hkv) // 32)
    want_ctas = fb.MIN_WAVES * H100_SMS
    if got.dkdv_ctas >= want_ctas:
        assert got.splits == 1
    else:   # the fewest splits that reach two waves, or one per row block
        assert got.splits == blocks or (
            got.dkdv_ctas * got.splits >= want_ctas
            > got.dkdv_ctas * (got.splits - 1))


def test_wrapper_counts_a_reduce_pass_and_refuses_the_cpu():
    # each pass's launch is counted in the dispatch ledger, in launch order
    src = inspect.getsource(fb.flash_bwd)
    assert re.findall(r'check_launch\("flash_bwd\.(\w+)"', src) == [
        "delta", "dkdv", "reduce", "dq"]
    case = CASES[0]
    q, k, v, dout, qp, kp = _inputs(case)
    t = [torch.from_numpy(a) for a in (q, k, v, dout)]
    kw = _kw(case, qp, kp)
    out, lse = ref.attention_lse_plain(*t[:3], **kw)
    ledger = metrics.registry("dispatch")
    before = ledger.snapshot()
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_bwd(*t[:3], out, lse, t[3], **kw)
    assert ledger.snapshot() == before
