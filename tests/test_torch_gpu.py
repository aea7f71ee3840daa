"""The Hopper kernels (K1 attention, K1b its backward, K2 RG-LRU scan, K3
WKV scan) against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (decided in the
``cuda`` fixture, never at import). It imports torch and the port only, so
it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances of attention, as |got - want| <= atol + rtol * |want| (+ a third
term in bf16): fp32 atol = rtol = 5e-5 (the kernels and the plain version
sum in another order). bf16 atol 1e-4, rtol 2**-6: both round an fp32
result to bf16 once, so they differ by at most one bf16 ulp, 2**-7 of
|want|, and the limit allows two. The tensor-core bodies also round each
probability to bf16 before P V (the plain version and the fp32 Pallas
kernel do not): at most 2**-8 of it, which moves an output by at most 2**-8
of the probability-weighted mean of |v|, attention_plain(q, k, |v|); the
bf16 limit adds that term.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_bwd as fb
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops, ref, rglru, rwkv6
from repro_torch.models import Backbone, LayerGroup, get_config, reduced

pytestmark = pytest.mark.gpu

# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap): the shapes of
# tests/test_kernels.py's FLASH_CASES, plus head dims of every kernel width
SHAPES = [
    (1, 64, 64, 4, 4, 32, True, None, None),
    (2, 96, 96, 4, 2, 32, True, None, None),
    (2, 64, 64, 8, 1, 16, True, None, None),
    (1, 80, 80, 4, 2, 32, True, 16, None),
    (1, 64, 64, 4, 2, 32, True, None, 30.0),
    (1, 64, 64, 4, 2, 32, False, None, None),
    (1, 72, 72, 4, 2, 24, True, 32, 50.0),
    (2, 130, 130, 8, 2, 64, True, None, None),
    (1, 200, 200, 32, 8, 128, True, None, None),
    (1, 65, 65, 4, 1, 256, True, None, None),
    # recurrentgemma's local layers: Sq not a multiple of a CTA's 4 query
    # positions nor of the 32-key tile, the window cutting in
    (1, 2103, 2103, 16, 1, 256, True, 2048, None),
]
DTYPES = {"fp32": (torch.float32, (5e-5, 5e-5)),
          "bf16": (torch.bfloat16, (1e-4, 2.0 ** -6))}
P_ROUND = 2.0 ** -8     # bf16 rounding of P before P V (see above)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _assert_attention_close(got, q, k, v, kw, dtype):
    """got against attention_plain within the limits stated above."""
    dt, (atol, rtol) = DTYPES[dtype]
    want = ref.attention_plain(q, k, v, **kw).float()
    limit = atol + rtol * want.abs()
    if dt == torch.bfloat16:
        limit = limit + P_ROUND * ref.attention_plain(
            q.float(), k.float(), v.float().abs(), **kw)
    err = (got.float() - want).abs()
    assert got.dtype == dt and got.shape == q.shape
    assert bool((err <= limit).all()), (
        f"max abs err {float(err.max())}, worst excess "
        f"{float((err - limit).max())}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain(cuda, shape, dtype):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = shape
    dt = DTYPES[dtype][0]
    q = _randn((B, Sq, Hq, hd), dt, cuda, 0)
    k = _randn((B, Skv, Hkv, hd), dt, cuda, 1)
    v = _randn((B, Skv, Hkv, hd), dt, cuda, 2)
    qp = torch.arange(Sq, dtype=torch.int32, device=cuda)
    kp = torch.arange(Skv, dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_positions=qp,
              kv_positions=kp)
    got = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attention_close(got, q, k, v, kw, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_decode_against_a_wrapped_ring(cuda, dtype):
    dt = DTYPES[dtype][0]
    B, C, Hq, Hkv, hd = 3, 200, 32, 8, 128
    kpos = np.full((C,), -1, np.int32)
    for p in range(150, 331):           # wrapped at 200, 19 empty slots
        kpos[p % C] = p
    q = _randn((B, 1, Hq, hd), dt, cuda, 3)
    k = _randn((B, C, Hkv, hd), dt, cuda, 4)
    v = _randn((B, C, Hkv, hd), dt, cuda, 5)
    for window, cap in ((None, None), (64, 20.0)):
        kw = dict(causal=True, window=window, logit_cap=cap,
                  q_positions=torch.tensor([330], dtype=torch.int32,
                                           device=cuda),
                  kv_positions=torch.from_numpy(kpos).to(cuda))
        for kernel in (fa.flash_fwd, fd.flash_decode):
            _assert_attention_close(kernel(q, k, v, **kw), q, k, v, kw, dtype)


def _ring(C, first, last):
    """kv positions of a C-slot ring holding first..last at slots p % C."""
    kpos = np.full((C,), -1, np.int32)
    for p in range(first, last + 1):
        kpos[p % C] = p
    return kpos


# (B, C, Hq, Hkv, hd, first, last, window, cap): one query at position
# `last` against a C-slot ring holding positions first..last
DECODE_CASES = [
    (8, 2048, 16, 1, 256, 542, 2589, 2048, None),  # recurrentgemma, wrapped
    (8, 2048, 16, 1, 256, 0, 1023, 2048, None),    # half the ring empty
    (1, 1024, 32, 8, 128, 600, 1500, None, None),  # qwen3, B = 1, wrapped
    (8, 1024, 32, 8, 128, 600, 1500, None, None),  # qwen3, B = 8
    (8, 1024, 32, 8, 128, 0, 200, None, None),     # every split but one empty
    (3, 200, 32, 8, 128, 150, 330, 64, 20.0),      # window with softcap
    (2, 512, 16, 1, 64, 0, 100, None, None),       # G = 16, hd 64, mostly empty
    (2, 512, 8, 2, 64, 0, 700, 100, None),         # most chunks outside window
    (4, 300, 4, 1, 32, 0, 299, None, 30.0),        # ragged last tile
    (2, 256, 32, 1, 128, 0, 255, None, None),      # G = 32: two row blocks
    (1, 100, 4, 2, 24, 0, 99, 32, 50.0),           # hd 24, window, softcap
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_flash_decode_matches_plain(cuda, case, dtype):
    B, C, Hq, Hkv, hd, first, last, window, cap = case
    dt = DTYPES[dtype][0]
    q = _randn((B, 1, Hq, hd), dt, cuda, 30)
    k = _randn((B, C, Hkv, hd), dt, cuda, 31)
    v = _randn((B, C, Hkv, hd), dt, cuda, 32)
    kw = dict(causal=True, window=window, logit_cap=cap,
              q_positions=torch.tensor([last], dtype=torch.int32, device=cuda),
              kv_positions=torch.from_numpy(_ring(C, first, last)).to(cuda))
    got = fd.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attention_close(got, q, k, v, kw, dtype)


def test_fully_masked_rows_are_zero(cuda):
    """The Pallas kernel's choice, kept: a row with no valid key is 0."""
    q = _randn((1, 4, 2, 32), torch.float32, cuda, 6)
    k = _randn((1, 8, 1, 32), torch.float32, cuda, 7)
    out = fa.flash_fwd(q, k, k, causal=True,
                       q_positions=torch.tensor([0, 1, 2, 3], dtype=torch.int32,
                                                device=cuda),
                       kv_positions=torch.tensor([-1, -1, 2, 3, -1, 5, 6, 7],
                                                 dtype=torch.int32,
                                                 device=cuda))
    assert out[:, :2].abs().max().item() == 0.0
    assert out[:, 2:].abs().max().item() > 0.0
    # the split decode, whose combine sees every split empty
    kp = torch.tensor([-1, -1, 5, 6, -1, 9, 7, 8], dtype=torch.int32, device=cuda)
    for qpos, empty in ((4, True), (6, False)):
        out = fd.flash_decode(q[:, :1], k, k, causal=True, kv_positions=kp,
                              q_positions=torch.tensor([qpos], dtype=torch.int32,
                                                       device=cuda))
        assert (out.abs().max().item() == 0.0) == empty


def test_ops_attention_picks_the_kernel_by_query_length(cuda):
    q = _randn((2, 5, 4, 32), torch.bfloat16, cuda, 40)
    k = _randn((2, 9, 2, 32), torch.bfloat16, cuda, 41)
    kp = torch.arange(9, dtype=torch.int32, device=cuda)
    for sq, moved in ((1, (0, 1)), (5, (1, 0))):
        before = (fa.launches, fd.launches)
        ops.attention(q[:, :sq].contiguous(), k, k, kv_positions=kp,
                      q_positions=torch.arange(9 - sq, 9, dtype=torch.int32,
                                               device=cuda))
        assert (fa.launches - before[0], fd.launches - before[1]) == moved


def test_wrapper_counts_launches_and_rejects_what_it_cannot_take(cuda):
    q = _randn((1, 8, 4, 32), torch.bfloat16, cuda, 8)
    k = _randn((1, 8, 2, 32), torch.bfloat16, cuda, 9)
    before = fa.launches
    ops.flash_attention(q, k, k)
    ops.flash_attention(q, k, k)
    assert fa.launches == before + 2
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), k.half(), k.half())
    assert fa.launches == before + 2


def test_model_decode_matches_prefill_on_the_card(cuda):
    cfg = reduced(get_config("qwen3-4b"), groups=(LayerGroup(("attn",), 3),))
    bb = Backbone(cfg, compute_dtype=torch.float32, device=cuda)
    params = bb.init(0)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (2, 18), dtype=np.int32)).to(cuda)
    _, cache = bb.prefill(params, {"tokens": toks[:, :17]}, 40)
    got, _ = bb.decode_step(params, cache, toks[:, 17:])
    want, _ = bb.prefill(params, {"tokens": toks}, 40)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)


# --------------------------------------------------------------------------- #
# K2 (RG-LRU scan) and K3 (WKV scan) against their plain versions             #
# --------------------------------------------------------------------------- #
# Both scans return fp32 and both sides see the same input values, so the
# bf16-input cases keep the fp32 tolerance: atol = rtol = 1e-5 for the RG-LRU
# and 2e-4 for the WKV, the JAX tests' limits for the two kernels. The RG-LRU's
# sequential body does the plain version's operations in its order (only
# expf, log1pf and sqrtf round differently); its chunked body computes the
# same a_t and b_t but composes them into chunk maps joined by a carry, which
# regroups the products and sums of the chain: a few fp32 ulps of |h| <= a
# few units, far inside 1e-5. The WKV's sequential body sums y's 64 products
# in another order; its chunked body runs the products on the tensor cores in
# 3xTF32 (about fp32's precision) and its decays as exp of sums of log w.
# The plans (kernels/{rglru,rwkv6}.plan) give T above one chunk (32 steps
# for the RG-LRU, 64 for the WKV) the chunked body; the tests run both bodies
# at every shape, with ragged last chunks, and for the RG-LRU widths that
# are not a multiple of 8 (the scalar path).
RGLRU_SHAPES = [(1, 32, 64), (2, 50, 96), (2, 64, 128), (1, 33, 48),
                (1, 300, 4096), (8, 1, 4096), (2, 131, 100), (3, 65, 512),
                (1, 1000, 264)]
WKV_SHAPES = [(1, 32, 2, 16), (2, 50, 4, 32), (2, 64, 1, 8), (1, 33, 2, 16),
              (1, 100, 40, 64), (8, 1, 40, 64), (2, 131, 3, 24),
              (1, 129, 2, 8), (2, 200, 4, 32), (1, 512, 40, 64)]
SCAN_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _gates(shape, device, seed):
    return torch.sigmoid(_randn(shape, torch.float32, device, seed))


def _rglru_args(B, T, W, dt, dev):
    return (_randn((B, T, W), dt, dev, 11), _randn((W,), dt, dev, 12),
            _gates((B, T, W), dev, 13).to(dt), _gates((B, T, W), dev, 14).to(dt),
            _randn((B, W), torch.float32, dev, 15))


def _wkv_args(B, T, H, hd, dt, dev):
    # w in fp32, as the model passes it and as the kernel takes it
    return (_randn((B, T, H, hd), dt, dev, 21), _randn((B, T, H, hd), dt, dev, 22),
            _randn((B, T, H, hd), dt, dev, 23),
            _gates((B, T, H, hd), dev, 24), _randn((H, hd), dt, dev, 25),
            _randn((B, H, hd, hd), torch.float32, dev, 26))


BODIES = ["sequential", "chunked"]


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("dtype", list(SCAN_DTYPES))
@pytest.mark.parametrize("shape", RGLRU_SHAPES, ids=str)
def test_rglru_kernel_matches_plain(cuda, shape, dtype, body):
    args = _rglru_args(*shape, SCAN_DTYPES[dtype], cuda)
    y, h = rglru.rglru_scan(*args, body=body)
    torch.cuda.synchronize()
    y_want, h_want = ref.rglru_scan_plain(*args)
    assert y.dtype == h.dtype == torch.float32 and y.shape == args[0].shape
    torch.testing.assert_close(y, y_want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_want, atol=1e-5, rtol=1e-5)
    # the state can be written over h0 in place, as decode does; the
    # sequential body gives the same bits again, the chunked body's
    # look-back may group the chunk maps otherwise from run to run
    h0 = args[4].clone()
    y2, h2 = rglru.rglru_scan(*args[:4], h0, h_out=h0, body=body)
    assert h2 is h0
    again = 0 if body == "sequential" else 1e-5
    torch.testing.assert_close(y2, y, atol=again, rtol=again)
    torch.testing.assert_close(h0, h, atol=again, rtol=again)


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("dtype", list(SCAN_DTYPES))
@pytest.mark.parametrize("shape", WKV_SHAPES, ids=str)
def test_wkv_kernel_matches_plain(cuda, shape, dtype, body):
    args = _wkv_args(*shape, SCAN_DTYPES[dtype], cuda)
    y, s = rwkv6.wkv6_scan(*args, body=body)
    torch.cuda.synchronize()
    y_want, s_want = ref.rwkv6_scan_plain(*args)
    assert y.dtype == s.dtype == torch.float32 and y.shape == args[0].shape
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, s_want, atol=2e-4, rtol=2e-4)
    s0 = args[5].clone()
    y2, s2 = rwkv6.wkv6_scan(*args[:5], s0, state_out=s0, body=body)
    assert s2 is s0
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(s0, s, atol=0, rtol=0)


def test_wkv_state_chaining_on_the_card(cuda):
    """Two half-length calls that hand the state on equal one full call."""
    r, k, v, w, u, s0 = _wkv_args(1, 40, 2, 64, torch.float32, cuda)
    y_full, s_full = rwkv6.wkv6_scan(r, k, v, w, u, s0)
    y1, s1 = rwkv6.wkv6_scan(r[:, :20].contiguous(), k[:, :20].contiguous(),
                             v[:, :20].contiguous(), w[:, :20].contiguous(), u, s0)
    y2, s2 = rwkv6.wkv6_scan(r[:, 20:].contiguous(), k[:, 20:].contiguous(),
                             v[:, 20:].contiguous(), w[:, 20:].contiguous(), u, s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s2, s_full, atol=2e-4, rtol=2e-4)


def test_rglru_state_chaining_on_the_card(cuda):
    """Two calls that hand the state on equal one full call, through both
    bodies: 200 steps (chunked) as 180 (chunked) and 20 (sequential)."""
    x, a_log, gr, gi, h0 = _rglru_args(2, 200, 264, torch.bfloat16, cuda)
    y_full, h_full = rglru.rglru_scan(x, a_log, gr, gi, h0)
    part = lambda a, s: a[:, s].contiguous()
    first, second = slice(0, 180), slice(180, 200)
    y1, h1 = rglru.rglru_scan(part(x, first), a_log, part(gr, first),
                              part(gi, first), h0)
    y2, h2 = rglru.rglru_scan(part(x, second), a_log, part(gr, second),
                              part(gi, second), h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h2, h_full, atol=1e-5, rtol=1e-5)


def _edge_rglru(B, T, W, near, dev):
    """a_t near 0 (a_log large, r = 1: a = e^-8 softplus(20) ~ e^-160, 0 in
    fp32) or near 1 (a_log very negative: softplus ~ e^-20)."""
    x, _, _, gi, h0 = _rglru_args(B, T, W, torch.float32, dev)
    a_log = torch.full((W,), 20.0 if near == 0 else -20.0, device=dev)
    return x, a_log, torch.ones_like(x), gi, h0


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("near", [0, 1])
@pytest.mark.parametrize("T", [1, 33, 200])
def test_rglru_edge_decays_on_the_card(cuda, T, near, body):
    args = _edge_rglru(2, T, 96, near, cuda)
    y, h = rglru.rglru_scan(*args, body=body)
    y_want, h_want = ref.rglru_scan_plain(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, y_want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("body", BODIES)
@pytest.mark.parametrize("w_value", [0.0, 1.0, 1e-30])
@pytest.mark.parametrize("T", [1, 40, 150])
def test_wkv_edge_decays_on_the_card(cuda, T, w_value, body):
    r, k, v, _, u, s0 = _wkv_args(1, T, 3, 64, torch.float32, cuda)
    w = torch.full_like(r, w_value)
    y, s = rwkv6.wkv6_scan(r, k, v, w, u, s0, body=body)
    y_want, s_want = ref.rwkv6_scan_plain(r, k, v, w, u, s0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, s_want, atol=2e-4, rtol=2e-4)
    # decays of every size in one run: w = 0 for a step, then near 1
    w = torch.exp(-torch.exp(_randn(r.shape, torch.float32, cuda, 27) * 3))
    y, s = rwkv6.wkv6_scan(r, k, v, w, u, s0, body=body)
    y_want, s_want = ref.rwkv6_scan_plain(r, k, v, w, u, s0)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s, s_want, atol=2e-4, rtol=2e-4)


def test_each_body_counts_its_launches(cuda):
    """T = 1 runs the sequential body of each scan, T = 200 the chunked one;
    each wrapper counts the call once, under its body."""
    for T, body in ((1, "sequential"), (200, "chunked")):
        x, a_log, gr, gi, h0 = _rglru_args(2, T, 256, torch.bfloat16, cuda)
        r, k, v, w, u, s0 = _wkv_args(2, T, 4, 64, torch.bfloat16, cuda)
        before = (rglru.launches, dict(rglru.body_launches),
                  rwkv6.launches, dict(rwkv6.body_launches))
        assert rglru.plan(2, T, 256).body == rwkv6.plan(2, T, 4, 64).body == body
        ops.rglru_scan(x, a_log, gr, gi, h0)
        ops.rwkv6_scan(r, k, v, w, u, s0)
        assert rglru.launches == before[0] + 1
        assert rwkv6.launches == before[2] + 1
        for counts, old in ((rglru.body_launches, before[1]),
                            (rwkv6.body_launches, before[3])):
            assert counts[body] == old[body] + 1
            assert sum(counts.values()) == sum(old.values()) + 1


def test_scan_wrappers_count_launches_and_reject_what_they_cannot_take(cuda):
    x, a_log, gr, gi, h0 = _rglru_args(1, 8, 64, torch.bfloat16, cuda)
    r, k, v, w, u, s0 = _wkv_args(1, 8, 2, 64, torch.bfloat16, cuda)
    before = (rglru.launches, rwkv6.launches)
    ops.rglru_scan(x, a_log, gr, gi, h0)
    ops.rwkv6_scan(r, k, v, w, u, s0)
    ops.rwkv6_scan(r, k, v, w, u, s0)
    assert (rglru.launches, rwkv6.launches) == (before[0] + 1, before[1] + 2)
    with pytest.raises(ValueError):
        ops.rglru_scan(x.half(), a_log, gr.half(), gi.half(), h0)
    with pytest.raises(ValueError):
        ops.rglru_scan(x, a_log, gr, gi, h0.bfloat16())
    with pytest.raises(ValueError):
        ops.rwkv6_scan(r, k, v, w, u, s0.bfloat16())
    with pytest.raises(ValueError):
        ops.rwkv6_scan(r, k, v, w.bfloat16(), u, s0)
    big = _wkv_args(1, 4, 1, 72, torch.float32, cuda)
    with pytest.raises(ValueError):
        ops.rwkv6_scan(*big)
    with pytest.raises(ValueError):
        ops.rwkv6_scan(r, k, v, w, u, s0.cpu())
    assert (rglru.launches, rwkv6.launches) == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("arch,groups", [
    ("recurrentgemma-9b", None), ("rwkv6-3b", (("rwkv",), 3))])
def test_recurrent_decode_matches_prefill_on_the_card(cuda, arch, groups):
    kw = {} if groups is None else {"groups": (LayerGroup(*groups),)}
    cfg = reduced(get_config(arch), **kw)
    bb = Backbone(cfg, compute_dtype=torch.float32, device=cuda)
    params = bb.init(0)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (2, 41), dtype=np.int32)).to(cuda)
    launched = (fa.launches, rglru.launches, rwkv6.launches)
    _, cache = bb.prefill(params, {"tokens": toks[:, :40]}, 64)
    got, _ = bb.decode_step(params, cache, toks[:, 40:])
    want, _ = bb.prefill(params, {"tokens": toks}, 64)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    scans = (rglru.launches - launched[1], rwkv6.launches - launched[2])
    assert scans == ((3 * 3, 0) if arch == "recurrentgemma-9b" else (0, 3 * 3))


# --------------------------------------------------------------------------- #
# K1 with its LSE, K1b (flash backward), and the model's gradients            #
# --------------------------------------------------------------------------- #
# The LSE is fp32 on both sides from the same input values (the kernels sum
# the scores in another order, and the tensor-core body takes exp2 of
# log2-scaled scores): the fp32 limit, atol = rtol = 5e-5, in both dtypes,
# on rows with a valid key (a row with none gets -inf from the kernel and
# MASK_VALUE + log(Skv) from the plain version; the backward masks it).
# K1b and flash_bwd_plain take the same out, lse and dout and both sum in
# fp32 (K1b does not round P to bf16), so the forward's limits hold: fp32
# atol = rtol = 5e-5; bf16 atol 1e-4, rtol 2**-6 (two bf16 ulps of each
# gradient, which both sides round to bf16 once).
LSE_TOL = (5e-5, 5e-5)

# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, empty kv slots)
BWD_CASES = [
    (1, 64, 64, 4, 4, 32, True, None, None, False),
    (2, 96, 96, 4, 2, 32, True, None, None, False),
    (1, 80, 80, 4, 2, 32, True, 16, None, False),
    (1, 64, 64, 4, 2, 32, True, None, 30.0, False),
    (1, 64, 64, 4, 2, 32, False, None, None, False),
    (1, 72, 72, 4, 2, 24, True, 32, 50.0, True),
    (2, 130, 130, 8, 2, 64, True, None, None, True),
    (1, 200, 200, 32, 8, 128, True, None, 50.0, False),
    (2, 300, 300, 16, 1, 128, True, None, None, True),
    (1, 2100, 2100, 16, 1, 256, True, 2048, None, False),
    (2, 512, 512, 32, 8, 128, True, None, None, False),
]


def _bwd_inputs(case, dt, dev, seed=50):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, empty = case
    q = _randn((B, Sq, Hq, hd), dt, dev, seed)
    k = _randn((B, Skv, Hkv, hd), dt, dev, seed + 1)
    v = _randn((B, Skv, Hkv, hd), dt, dev, seed + 2)
    dout = _randn((B, Sq, Hq, hd), dt, dev, seed + 3)
    kp = np.arange(Skv, dtype=np.int32)
    if empty:  # every 7th slot empty, key 0 too: query 0 sees no key
        kp[::7] = -1
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_positions=torch.arange(Sq, dtype=torch.int32, device=dev),
              kv_positions=torch.from_numpy(kp).to(dev))
    return q, k, v, dout, kw


def _assert_close_elementwise(got, want, atol, rtol, what):
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool((err <= limit).all()), (
        f"{what}: max abs err {float(err.max())}, worst excess "
        f"{float((err - limit).max())}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", BWD_CASES[:9], ids=str)
def test_flash_fwd_lse_matches_plain(cuda, case, dtype):
    dt = DTYPES[dtype][0]
    q, k, v, _, kw = _bwd_inputs(case, dt, cuda)
    out, lse = fa.flash_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    # writing the LSE leaves out as it was (test_kernel_matches_plain
    # holds that against the plain version)
    assert torch.equal(out, fa.flash_fwd(q, k, v, **kw))
    _, want = ref.attention_lse_plain(q, k, v, **kw)
    seen = want > ref.MASK_VALUE / 2       # rows with a valid key
    assert lse.shape == want.shape and lse.dtype == torch.float32
    _assert_close_elementwise(lse[seen], want[seen], *LSE_TOL, "lse")
    assert bool(torch.isneginf(lse[~seen]).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_matches_plain(cuda, case, dtype):
    dt, (atol, rtol) = DTYPES[dtype]
    q, k, v, dout, kw = _bwd_inputs(case, dt, cuda)
    out, lse = ref.attention_lse_plain(q, k, v, **kw)
    want = ref.flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    before = dict(fb.kernel_launches)
    got = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close_elementwise(g, w, atol, rtol, name)
    assert {n: fb.kernel_launches[n] - before[n] for n in before} == {
        "delta": 1, "dkdv": 1, "dq": 1}
    # no atomics: a second run gives the same bits
    again = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_bwd_takes_the_kernels_lse_and_masks_empty_rows(cuda):
    """K1's LSE (-inf on a row with no valid key) through K1b: the same
    gradients as the plain pair, and none for the empty row."""
    case = (1, 72, 72, 4, 2, 24, True, 32, 50.0, True)
    q, k, v, dout, kw = _bwd_inputs(case, torch.float32, cuda, seed=60)
    out, lse = fa.flash_fwd(q, k, v, return_lse=True, **kw)
    got = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    p_out, p_lse = ref.attention_lse_plain(q, k, v, **kw)
    p_out[:, 0] = 0.0      # the kernel's choice for the row with no key
    want = ref.flash_bwd_plain(q, k, v, p_out, p_lse, dout, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _assert_close_elementwise(g, w, 5e-5, 5e-5, name)
    assert got[0][:, 0].abs().max().item() == 0.0


def test_flash_bwd_rejects_what_it_cannot_take(cuda):
    q, k, v, dout, kw = _bwd_inputs(BWD_CASES[1], torch.bfloat16, cuda)
    out, lse = ref.attention_lse_plain(q, k, v, **kw)
    before = fb.launches
    for bad in (dict(lse=lse[..., 1:].contiguous()), dict(out=out.float()),
                dict(dout=dout[:, 1:].contiguous()), dict(lse=lse.cpu())):
        args = dict(q=q, k=k, v=v, out=out, lse=lse, dout=dout)
        args.update(bad)
        with pytest.raises(ValueError):
            fb.flash_bwd(**args, **kw)
    assert fb.launches == before


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_model_grads_kernel_path_match_plain_path(cuda, dtype, remat):
    """loss_fn and every leaf's gradient of a 3-layer reduced qwen3-4b with
    fp32 params: the kernel path (K1 with LSE, K1b) against
    kernel_impl="plain". fp32 compute: the kernels and the plain versions
    sum in another order, 1e-4 of each leaf's largest gradient. bf16
    compute: the forward's tensor-core body rounds P to bf16, which moves
    activations by bf16 ulps through 3 layers and back: 2**-4 of each
    leaf's gradient norm, 2**-6 of the loss."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    cfg = reduced(get_config("qwen3-4b"), groups=(LayerGroup(("attn",), 3),))
    kern = Backbone(cfg, compute_dtype=dt, remat=remat, device=cuda)
    plain = Backbone(cfg, compute_dtype=dt, remat=remat, device=cuda,
                     kernel_impl="plain")
    params = kern.init(3)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (2, 65), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = (fa.launches, fd.launches, fb.launches)
    lk, gk = value_and_grad(kern, params, batch)
    torch.cuda.synchronize()
    assert (fa.launches - before[0], fd.launches - before[1],
            fb.launches - before[2]) == (3 * (2 if remat else 1), 0, 3)
    lp, gp = value_and_grad(plain, params, batch)
    if dt == torch.float32:
        torch.testing.assert_close(lk, lp, atol=1e-5, rtol=1e-5)
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    else:
        assert abs(float(lk) - float(lp)) <= 2.0 ** -6 * abs(float(lp))
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).norm()) <= 2.0 ** -4 * float(b.norm())
