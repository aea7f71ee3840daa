"""The Hopper kernels (K1 attention, K1b its backward, K2 RG-LRU scan, K2b
its backward, K3 WKV scan, K3b its backward, the MoE layer's grouped expert
kernel) against their plain versions, on the card.

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

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_bwd as fb
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref, rglru, rglru_bwd, rwkv6, rwkv6_bwd
from repro_torch.models import Backbone, LayerGroup, ffn, get_config, reduced
from repro_torch.obs import metrics

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
    # odd groups: qwen2-7b (28/4, G 7) and phi4-mini (24/8, G 3)
    (1, 200, 200, 28, 4, 128, True, None, None),
    (2, 130, 130, 24, 8, 128, True, None, None),
    # gemma2-2b's local layers: 8/4 at hd 256, window 4096, softcap 50,
    # past the window
    (1, 4200, 4200, 8, 4, 256, True, 4096, 50.0),
    # mixtral-8x22b's local layers: 48/8 (G 6) at hd 128, window 4096,
    # past the window; qwen3-moe-235b-a22b: 64/4 (G 16)
    (1, 4200, 4200, 48, 8, 128, True, 4096, None),
    (1, 512, 512, 64, 4, 128, True, None, None),
    # whisper-tiny, MHA 6/6 at hd 64 (G 1): the encoder's non-causal
    # self-attention over 1500 frames (1500 = 23 x 64 + 28: a ragged last
    # key tile), cross-attention from the text positions to the frames (Sq
    # != Skv, both ways), the decoder's causal self-attention at its 448
    # text positions
    (2, 1500, 1500, 6, 6, 64, False, None, None),
    (8, 32, 1500, 6, 6, 64, False, None, None),
    (1, 448, 1500, 6, 6, 64, False, None, None),
    (1, 1500, 448, 6, 6, 64, False, None, None),
    (2, 448, 448, 6, 6, 64, True, None, None),
    (3, 70, 131, 4, 2, 32, False, None, 30.0),
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


def _ledger():
    """The dispatch ledger's counts (``metrics.registry("dispatch")``): one
    a launch of a C entry point, ``<kernel>.<body or pass>`` or
    ``<kernel>``, and one a moe_mlp call, ``moe_mlp.<path>``."""
    return metrics.registry("dispatch").snapshot()["counters"]


def _moved(before):
    """The ledger's counts that moved since ``before`` (a :func:`_ledger`),
    by key."""
    return {k: n - before.get(k, 0) for k, n in _ledger().items()
            if n != before.get(k, 0)}


def _of(moved, kernel):
    """The counts of ``moved`` under one kernel's keys."""
    return {k: n for k, n in moved.items() if k.split(".")[0] == kernel}


def _total(moved, kernel):
    """A kernel's launches in ``moved``: the sum of its keys."""
    return sum(_of(moved, kernel).values())


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
    (8, 1024, 28, 4, 128, 600, 1500, None, None),  # qwen2-7b, G = 7
    (8, 1024, 24, 8, 128, 0, 700, None, None),     # phi4-mini, G = 3
    (8, 4096, 8, 4, 256, 600, 4695, 4096, 50.0),   # gemma2-2b, wrapped
    (8, 4096, 48, 8, 128, 135, 4230, 4096, None),  # mixtral-8x22b, wrapped
    (8, 1024, 64, 4, 128, 0, 542, None, None),     # qwen3-moe, G = 16
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


# (B, Skv, Hq, Hkv, hd): one query against every key, not causal: whisper's
# cross-attention in a decode step (8 slots over 1500 frames; 1500 keys
# split over CTAs with a ragged last tile), and smaller splits
CROSS_DECODE_CASES = [
    (8, 1500, 6, 6, 64),
    (1, 1500, 6, 6, 64),
    (3, 77, 4, 2, 32),
    (16, 1500, 6, 6, 64),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CROSS_DECODE_CASES, ids=str)
def test_flash_decode_across_matches_plain(cuda, case, dtype):
    B, Skv, Hq, Hkv, hd = case
    dt = DTYPES[dtype][0]
    q = _randn((B, 1, Hq, hd), dt, cuda, 33)
    k = _randn((B, Skv, Hkv, hd), dt, cuda, 34)
    v = _randn((B, Skv, Hkv, hd), dt, cuda, 35)
    # the decoder's position: with no causal mask it plays no part
    kw = dict(causal=False, window=None, logit_cap=None,
              q_positions=torch.tensor([40], dtype=torch.int32, device=cuda),
              kv_positions=torch.arange(Skv, dtype=torch.int32, device=cuda))
    got = fd.flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_attention_close(got, q, k, v, kw, dtype)
    # the same function as the prefill kernel's at one query position
    _assert_attention_close(fa.flash_fwd(q, k, v, **kw), q, k, v, kw, dtype)


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
    for sq, moved in ((1, {"flash_decode": 1}), (5, {"flash_fwd.mma": 1})):
        before = _ledger()
        ops.attention(q[:, :sq].contiguous(), k, k, kv_positions=kp,
                      q_positions=torch.arange(9 - sq, 9, dtype=torch.int32,
                                               device=cuda))
        assert _moved(before) == moved


def test_wrapper_counts_launches_and_rejects_what_it_cannot_take(cuda):
    q = _randn((1, 8, 4, 32), torch.bfloat16, cuda, 8)
    k = _randn((1, 8, 2, 32), torch.bfloat16, cuda, 9)
    before = _ledger()
    ops.flash_attention(q, k, k)
    ops.flash_attention(q, k, k)
    assert _total(_moved(before), "flash_fwd") == 2
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), k.half(), k.half())
    assert _total(_moved(before), "flash_fwd") == 2


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
        before = _ledger()
        assert rglru.plan(2, T, 256).body == rwkv6.plan(2, T, 4, 64).body == body
        ops.rglru_scan(x, a_log, gr, gi, h0)
        ops.rwkv6_scan(r, k, v, w, u, s0)
        assert _moved(before) == {f"rglru_scan.{body}": 1,
                                  f"wkv6_scan.{body}": 1}


def test_scan_wrappers_count_launches_and_reject_what_they_cannot_take(cuda):
    x, a_log, gr, gi, h0 = _rglru_args(1, 8, 64, torch.bfloat16, cuda)
    r, k, v, w, u, s0 = _wkv_args(1, 8, 2, 64, torch.bfloat16, cuda)
    before = _ledger()
    ops.rglru_scan(x, a_log, gr, gi, h0)
    ops.rwkv6_scan(r, k, v, w, u, s0)
    ops.rwkv6_scan(r, k, v, w, u, s0)
    counted = {"rglru_scan.sequential": 1, "wkv6_scan.sequential": 2}
    assert _moved(before) == counted
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
    assert _moved(before) == counted


@pytest.mark.parametrize("arch,groups", [
    ("recurrentgemma-9b", None), ("rwkv6-3b", (("rwkv",), 3))])
def test_recurrent_decode_matches_prefill_on_the_card(cuda, arch, groups):
    kw = {} if groups is None else {"groups": (LayerGroup(*groups),)}
    cfg = reduced(get_config(arch), **kw)
    bb = Backbone(cfg, compute_dtype=torch.float32, device=cuda)
    params = bb.init(0)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (2, 41), dtype=np.int32)).to(cuda)
    before = _ledger()
    _, cache = bb.prefill(params, {"tokens": toks[:, :40]}, 64)
    got, _ = bb.decode_step(params, cache, toks[:, 40:])
    want, _ = bb.prefill(params, {"tokens": toks}, 64)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
    moved = _moved(before)
    scans = (_total(moved, "rglru_scan"), _total(moved, "wkv6_scan"))
    assert scans == ((3 * 3, 0) if arch == "recurrentgemma-9b" else (0, 3 * 3))


# --------------------------------------------------------------------------- #
# K1 with its LSE, K1b (flash backward), and the model's gradients            #
# --------------------------------------------------------------------------- #
# The LSE is fp32 on both sides from the same input values (the kernels sum
# the scores in another order, and the tensor-core body takes exp2 of
# log2-scaled scores): the fp32 limit, atol = rtol = 5e-5, in both dtypes,
# on rows with a valid key (a row with none gets -inf from the kernel and
# MASK_VALUE + log(Skv) from the plain version; the backward masks it).
# K1b and flash_bwd_plain take the same out, lse and dout and sum in fp32:
# fp32 atol = rtol = 5e-5 (3xTF32 products, another order). In bf16 both
# round each gradient to bf16 once (atol 1e-4, rtol 2**-6: two bf16 ulps),
# and K1b's tensor-core body also rounds p and ds to bf16 before the
# products that take them, as the forward rounds P: each moves by at most
# 2**-8 of itself, so a gradient moves by at most 2**-8 of |p|ᵀ|dout| (dv),
# |ds|ᵀ|q| (dk) or |ds||k| (dq), which ref.flash_bwd_rounding_plain
# computes and the bf16 limit adds.
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
    # odd groups: a 16-row fragment straddles query positions
    (1, 320, 320, 28, 4, 128, True, None, None, False),   # qwen2-7b, G 7
    (2, 256, 256, 24, 8, 128, True, None, None, True),    # phi4-mini, G 3
    # 512 dk/dv CTAs, two waves: the plan does not split (no reduce pass)
    (4, 1024, 1024, 32, 8, 128, True, None, None, False),
]
# whisper-tiny (MHA 6/6, hd 64, G 1): the encoder [B, 1500] non-causal with
# a ragged last tile, cross-attention Sq != Skv both ways (the dk/dv grid
# over 1500 keys against rows over 448 queries), the decoder's causal
# self-attention at 448, and a split cross case with empty slots
WHISPER_BWD_CASES = [
    (2, 1500, 1500, 6, 6, 64, False, None, None, False),
    (2, 448, 1500, 6, 6, 64, False, None, None, False),
    (1, 1500, 448, 6, 6, 64, False, None, None, False),
    (2, 448, 448, 6, 6, 64, True, None, None, False),
    (1, 90, 200, 4, 2, 32, False, None, 30.0, True),
]
BWD_CASES += WHISPER_BWD_CASES


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


def _assert_close_elementwise(got, want, atol, rtol, what, extra=None):
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    if extra is not None:
        limit = limit + extra
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert bool((err <= limit).all()), (
        f"{what}: max abs err {float(err.max())}, worst excess "
        f"{float((err - limit).max())}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", BWD_CASES[:9] + WHISPER_BWD_CASES, ids=str)
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


def _assert_bwd_close(got, q, k, v, out, lse, dout, kw, dtype):
    """K1b's (dq, dk, dv) against flash_bwd_plain within the limits above."""
    dt, (atol, rtol) = DTYPES[dtype]
    want = ref.flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    extra = (ref.flash_bwd_rounding_plain(q, k, v, out, lse, dout, **kw)
             if dt == torch.bfloat16 else (None,) * 3)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, extra):
        _assert_close_elementwise(g, w, atol, rtol, name, e)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", BWD_CASES, ids=str)
def test_flash_bwd_matches_plain(cuda, case, dtype):
    dt = DTYPES[dtype][0]
    q, k, v, dout, kw = _bwd_inputs(case, dt, cuda)
    out, lse = ref.attention_lse_plain(q, k, v, **kw)
    before = _ledger()
    got = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    _assert_bwd_close(got, q, k, v, out, lse, dout, kw, dtype)
    B, Sq, Skv, Hq, Hkv, hd = case[:6]
    split = fb.plan(B, Sq, Skv, Hq, Hkv, hd, dt,
                    sms=fb.device_sms(q.device)).splits > 1
    passes = ("delta", "dkdv", "dq") + (("reduce",) if split else ())
    assert _moved(before) == {f"flash_bwd.{p}": 1 for p in passes}
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
    before = _ledger()
    for bad in (dict(lse=lse[..., 1:].contiguous()), dict(out=out.float()),
                dict(dout=dout[:, 1:].contiguous()), dict(lse=lse.cpu())):
        args = dict(q=q, k=k, v=v, out=out, lse=lse, dout=dout)
        args.update(bad)
        with pytest.raises(ValueError):
            fb.flash_bwd(**args, **kw)
    assert _moved(before) == {}


def test_flash_bwd_plan_tiles_as_the_library(cuda, monkeypatch):
    """flash_bwd.plan splits by the library's own dk/dv tiles, and a library
    that tiles otherwise is refused when the dk/dv pass is first bound."""
    fb._check_tiles()
    monkeypatch.setattr(fb, "dkdv_tiles", lambda hd, dtype: (128, 32))
    with pytest.raises(RuntimeError, match="tiles dk/dv"):
        fb._check_tiles()


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
    before = _ledger()
    lk, gk = value_and_grad(kern, params, batch)
    torch.cuda.synchronize()
    moved = _moved(before)
    assert (_total(moved, "flash_fwd"), _total(moved, "flash_decode"),
            moved.get("flash_bwd.dq", 0)) == (3 * (2 if remat else 1), 0, 3)
    lp, gp = value_and_grad(plain, params, batch)
    if dt == torch.float32:
        torch.testing.assert_close(lk, lp, atol=1e-5, rtol=1e-5)
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    else:
        assert abs(float(lk) - float(lp)) <= 2.0 ** -6 * abs(float(lp))
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).norm()) <= 2.0 ** -4 * float(b.norm())


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch,groups", [
    ("qwen3-4b", (("attn",), 3)), ("recurrentgemma-9b", None),
    ("rwkv6-3b", (("rwkv",), 2))])
def test_remat_dots_equals_full_on_the_card(cuda, arch, groups, dtype):
    """A reduced arch on the kernel path under remat "dots", "full" and
    off, from one init: the loss and every gradient bit for bit (the
    recompute gives the forward's values; "dots" hands it the forward's own
    products), and the kernels' launches under "dots" equal to "full"'s (K1
    and the scans' forwards run again in the recompute; K1b, K2b and K3b
    once)."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    over = {} if groups is None else {"groups": (LayerGroup(*groups),)}
    cfg = reduced(get_config(arch), **over)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (2, 129), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    for policy in ("off", "full", "dots"):
        kw = (dict(remat=False) if policy == "off"
              else dict(remat=True, remat_policy=policy))
        bb = Backbone(cfg, compute_dtype=dt, device=cuda, **kw)
        before = _ledger()
        loss, grads = value_and_grad(bb, bb.init(3), batch)
        torch.cuda.synchronize()
        runs[policy] = (loss, tree_leaves(grads), _moved(before))
    assert runs["dots"][2] == runs["full"][2] != runs["off"][2]
    for policy in ("full", "dots"):
        assert torch.equal(runs[policy][0], runs["off"][0]), policy
        assert all(torch.equal(a, b) for a, b in zip(
            runs[policy][1], runs["off"][1])), policy


# --------------------------------------------------------------------------- #
# K2b (RG-LRU backward) and K3b (WKV backward) against their plain versions    #
# --------------------------------------------------------------------------- #
# Both take the same inputs as their plain versions and compute in fp32,
# chunk-parallel: K2b joins chunk maps of the reverse recurrence through a
# carry (the plain version's operations regrouped; expf, log1pf, sqrtf and
# the sigmoid may round differently); K3b takes its chunk states and
# cotangents from 3xTF32 products and carries, sums dr, dk, dw over a row's
# 64 columns and dv as a matrix product, in another order. Each gradient is
# held within TOL of itself plus TOL of its tensor's largest entry (its
# entries are sums of terms up to that size), TOL 1e-5 for K2b and 2e-4 for
# K3b, the forward kernels' limits; a bf16 gradient is rounded to bf16 by
# both, which adds two bf16 ulps of itself (2**-6).
BWD_TOL = {"rglru_scan_bwd": 1e-5, "wkv6_scan_bwd": 2e-4}
BWD_BF16_RTOL = 2.0 ** -6
# (B, T, W): ragged T and W, T of one step and T not whole 32-step chunks
# at full width (the vector path), a sequence the forward's chunked body
# takes, recurrentgemma-9b's training shape
RGLRU_BWD_SHAPES = [(1, 1, 64), (2, 13, 100), (3, 65, 264), (1, 1, 4096),
                    (2, 100, 4096), (1, 300, 4096), (2, 2560, 4096)]
# (B, T, H, hd): ragged T (below, at and past one 64-step chunk, not whole
# sub-chunks), hd below 64 and not a multiple of 8, B x H above the 132
# SMs, rwkv6-3b's training shape
WKV_BWD_SHAPES = [(1, 1, 1, 8), (2, 17, 3, 24), (1, 50, 2, 64),
                  (1, 63, 2, 64), (2, 64, 3, 64), (1, 65, 2, 24),
                  (2, 131, 4, 32), (4, 100, 40, 32), (1, 300, 40, 64),
                  (4, 2048, 40, 64)]


def _assert_grads_close_on_card(got, want, kernel):
    tol = BWD_TOL[kernel]
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (kernel, n)
        w = w.float()
        limit = tol * (w.abs() + w.abs().max())
        if g.dtype == torch.bfloat16:
            limit = limit + BWD_BF16_RTOL * w.abs()
        err = (g.float() - w).abs()
        assert bool(torch.isfinite(g.float()).all()), (kernel, n)
        assert bool((err <= limit).all()), (
            f"{kernel} output {n}: max abs err {float(err.max())}, worst "
            f"excess {float((err - limit).max())}")


def _rglru_bwd_args(B, T, W, dt, dev, a_log=None):
    x, al, gr, gi, h0 = _rglru_args(B, T, W, dt, dev)
    if a_log is not None:
        al, gr = a_log.to(dt), torch.ones_like(gr)
    y, _ = ref.rglru_scan_plain(x, al, gr, gi, h0)
    return (x, al, gr, gi, h0, y, _randn((B, T, W), torch.float32, dev, 16),
            _randn((B, W), torch.float32, dev, 17))


@pytest.mark.parametrize("dtype", list(SCAN_DTYPES))
@pytest.mark.parametrize("shape", RGLRU_BWD_SHAPES, ids=str)
def test_rglru_bwd_matches_plain(cuda, shape, dtype):
    args = _rglru_bwd_args(*shape, SCAN_DTYPES[dtype], cuda)
    before = _ledger()
    got = rglru_bwd.rglru_scan_bwd(*args)
    torch.cuda.synchronize()
    assert _moved(before) == {"rglru_bwd": 1}
    _assert_grads_close_on_card(got, ref.rglru_scan_bwd_plain(*args),
                                "rglru_scan_bwd")
    # no atomics: a rerun gives the same bits
    again = rglru_bwd.rglru_scan_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("near", [0, 1])
@pytest.mark.parametrize("T", [1, 40, 300])
def test_rglru_bwd_edge_decays_on_the_card(cuda, T, near):
    """a_t = 0 (a_log 20, r = 1), and a_t within 2e-3 of 1 with
    1 - a_t² > 0 (a_log -9, r = 1), where a_t / b_t is large."""
    a_log = torch.full((96,), 20.0 if near == 0 else -9.0, device=cuda)
    args = _rglru_bwd_args(2, T, 96, torch.float32, cuda, a_log=a_log)
    got = rglru_bwd.rglru_scan_bwd(*args)
    _assert_grads_close_on_card(got, ref.rglru_scan_bwd_plain(*args),
                                "rglru_scan_bwd")


def test_rglru_bwd_takes_the_clamp_on_the_card(cuda):
    """r = 0 on every third step gives a_t = 1 exactly (the clamped branch,
    b_t = 0): finite gradients equal to the plain version's, no gradient to
    x or i at those steps."""
    args = list(_rglru_bwd_args(2, 100, 4096, torch.float32, cuda))
    args[2] = args[2].clone()
    args[2][:, ::3] = 0.0
    args[5], _ = ref.rglru_scan_plain(*args[:5])
    got = rglru_bwd.rglru_scan_bwd(*args)
    _assert_grads_close_on_card(got, ref.rglru_scan_bwd_plain(*args),
                                "rglru_scan_bwd")
    assert got[0][:, ::3].abs().max() == 0 and got[3][:, ::3].abs().max() == 0


def _wkv_bwd_args(B, T, H, hd, dt, dev, w=None):
    r, k, v, w_rand, u, s0 = _wkv_args(B, T, H, hd, dt, dev)
    return (r, k, v, w_rand if w is None else w, u, s0,
            _randn((B, T, H, hd), torch.float32, dev, 28),
            _randn((B, H, hd, hd), torch.float32, dev, 29))


@pytest.mark.parametrize("dtype", list(SCAN_DTYPES))
@pytest.mark.parametrize("shape", WKV_BWD_SHAPES, ids=str)
def test_wkv_bwd_matches_plain(cuda, shape, dtype):
    args = _wkv_bwd_args(*shape, SCAN_DTYPES[dtype], cuda)
    before = _ledger()
    got = rwkv6_bwd.wkv6_scan_bwd(*args)
    torch.cuda.synchronize()
    assert _moved(before) == {"wkv6_bwd": 1}
    _assert_grads_close_on_card(got, ref.rwkv6_scan_bwd_plain(*args),
                                "wkv6_scan_bwd")
    again = rwkv6_bwd.wkv6_scan_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("w_value", [0.0, 1.0, "mixed"])
def test_wkv_bwd_edge_decays_on_the_card(cuda, w_value):
    """w = 0 (no state survives a step: dividing by w would fail), w = 1,
    and decays of every size in one run."""
    shape = (1, 70, 3, 64)
    w = (torch.exp(-torch.exp(_randn(shape, torch.float32, cuda, 27) * 3))
         if w_value == "mixed"
         else torch.full(shape, w_value, device=cuda))
    args = _wkv_bwd_args(*shape, torch.float32, cuda, w=w)
    got = rwkv6_bwd.wkv6_scan_bwd(*args)
    _assert_grads_close_on_card(got, ref.rwkv6_scan_bwd_plain(*args),
                                "wkv6_scan_bwd")


@pytest.mark.parametrize("dtype", list(SCAN_DTYPES))
@pytest.mark.parametrize("shape", [(2, 200, 3, 64), (1, 129, 2, 24)], ids=str)
def test_wkv_bwd_scratch_holds_k3s_chunk_states(cuda, shape, dtype):
    """K3b's scratch is the state before every 64-step chunk,
    [B, H, ceil(T/64), 64, 64] (not checkpoints every 16 steps), and the
    same bits as K3's chunked body computes: the state K3 hands on after a
    prefix of c whole chunks is starts[:, :, c]. The cotangent after the
    last chunk is dS_T."""
    B, T, H, hd = shape
    args = _wkv_bwd_args(*shape, SCAN_DTYPES[dtype], cuda)
    sc = rwkv6_bwd.scratch(B, T, H, hd, cuda)
    rwkv6_bwd.wkv6_scan_bwd(*args, scratch_out=sc)
    torch.cuda.synchronize()
    n = -(-T // rwkv6_bwd.CHUNK)
    assert rwkv6_bwd.CHUNK == rwkv6.CHUNK == 64
    assert sc["starts"].shape == (B, H, n, 64, 64)
    starts = sc["starts"][..., :hd, :hd]
    r, k, v, w, u, s0 = args[:6]
    assert torch.equal(starts[:, :, 0], s0)
    pad = torch.ones(64, 64, dtype=torch.bool, device=cuda)
    pad[:hd, :hd] = False
    assert not bool(sc["starts"][..., pad].any())
    for c in range(1, n):
        t = c * rwkv6.CHUNK
        _, s_c = rwkv6.wkv6_scan(*(a[:, :t].contiguous() for a in (r, k, v, w)),
                                 u, s0, body="chunked")
        assert torch.equal(starts[:, :, c], s_c), c
    assert torch.equal(sc["ends"][:, :, n - 1, :hd, :hd], args[7])


def test_scan_bwd_wrappers_reject_what_they_cannot_take(cuda):
    x, al, gr, gi, h0, y, dy, dh = _rglru_bwd_args(1, 8, 64, torch.bfloat16,
                                                    cuda)
    r, k, v, w, u, s0, dyw, ds = _wkv_bwd_args(1, 8, 2, 64, torch.bfloat16,
                                               cuda)
    before = _ledger()
    for bad in (dict(y=y.bfloat16()), dict(dy=dy[:, 1:].contiguous()),
                dict(dh_T=dh.cpu()), dict(x=x.half(), gate_r=gr.half(),
                                          gate_i=gi.half())):
        a = dict(x=x, a_log=al, gate_r=gr, gate_i=gi, h0=h0, y=y, dy=dy,
                 dh_T=dh)
        a.update(bad)
        with pytest.raises(ValueError):
            ops.rglru_scan_bwd(**a)
    for bad in (dict(dy=dyw.bfloat16()), dict(ds_T=ds[:, :1].contiguous()),
                dict(w=w.bfloat16())):
        a = dict(r=r, k=k, v=v, w=w, u=u, state=s0, dy=dyw, ds_T=ds)
        a.update(bad)
        with pytest.raises(ValueError):
            ops.rwkv6_scan_bwd(**a)
    assert _moved(before) == {}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("arch,groups", [
    ("recurrentgemma-9b", None), ("rwkv6-3b", (("rwkv",), 3))])
def test_recurrent_model_grads_kernel_path_match_plain_path(cuda, arch, groups,
                                                            dtype, remat):
    """loss_fn and every leaf's gradient of reduced recurrentgemma-9b
    ((rec, rec, local) + (rec), window 32) and a 3-layer rwkv6-3b with fp32
    params, 65 tokens (the scans' chunked forward bodies, past the window):
    the kernel path (K2 + K2b, K3 + K3b, K1 + K1b) against
    kernel_impl="plain", with the limits of the qwen3 test above (the
    chunked forward bodies regroup fp32 sums, and in bf16 compute their y
    rounds to bf16 at other places)."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    kw = {} if groups is None else {"groups": (LayerGroup(*groups),)}
    cfg = reduced(get_config(arch), **kw)
    kern = Backbone(cfg, compute_dtype=dt, remat=remat, device=cuda)
    plain = Backbone(cfg, compute_dtype=dt, remat=remat, device=cuda,
                     kernel_impl="plain")
    params = kern.init(3)
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (2, 66),
                                              dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    before = _ledger()
    lk, gk = value_and_grad(kern, params, batch)
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds()
    fwd = 2 if remat else 1
    moved = _moved(before)
    assert (_total(moved, "rglru_scan"), moved.get("rglru_bwd", 0),
            _total(moved, "wkv6_scan"), moved.get("wkv6_bwd", 0)) == (
        fwd * kinds.count("rec"), kinds.count("rec"),
        fwd * kinds.count("rwkv"), kinds.count("rwkv"))
    lp, gp = value_and_grad(plain, params, batch)
    if dt == torch.float32:
        torch.testing.assert_close(lk, lp, atol=1e-5, rtol=1e-5)
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    else:
        assert abs(float(lk) - float(lp)) <= 2.0 ** -6 * abs(float(lp))
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).norm()) <= 2.0 ** -4 * float(b.norm())


# --------------------------------------------------------------------------- #
# The MoE layer on the card                                                   #
# --------------------------------------------------------------------------- #
def _moe_case(arch, seed):
    """A MoE layer of the arch's expert count and top-k at a narrow width
    (D 256, Fe 128) and the config's own capacity factor 1.25, and 2 x 160
    tokens: numpy weights at the init scale and inputs."""
    import dataclasses

    full = get_config(arch)
    cfg = dataclasses.replace(reduced(full), d_model=256, moe_d_ff=128,
                              n_experts=full.n_experts, top_k=full.top_k,
                              capacity_factor=full.capacity_factor)
    rng = np.random.default_rng(seed)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    p = {"router": dense(D, E), "w_gate": dense(E, D, Fe),
         "w_up": dense(E, D, Fe), "w_down": dense(E, Fe, D)}
    x = rng.standard_normal((2, 160, D)).astype(np.float32)
    return cfg, p, x


def _moe_run(cfg, p, x, device):
    tp = {k: torch.from_numpy(v).to(device).requires_grad_()
          for k, v in p.items()}
    tx = torch.from_numpy(x).to(device).requires_grad_()
    y, aux = ffn.moe_mlp(tp, tx, cfg)
    (y.square().sum() + aux).backward()
    _, _, idx = ffn.route(tx.detach().reshape(-1, cfg.d_model),
                          tp["router"].detach(), cfg.top_k)
    return [t.detach().cpu() for t in (idx, y, aux, tx.grad)] + [
        tp[k].grad.cpu() for k in p]


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_mlp_on_the_card_matches_the_cpu_port(cuda, arch):
    """fp32, the config's capacity factor (qwen3-moe's 128 experts drop
    here): the same routes, and y, aux and every gradient within 1e-4 of
    the CPU port (cuBLAS sums the products in another order)."""
    cfg, p, x = _moe_case(arch, 50)
    got = _moe_run(cfg, p, x, cuda)
    want = _moe_run(cfg, p, x, "cpu")
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_moe_router_is_full_fp32_whatever_tf32_is_set_to(cuda):
    """With TF32 switched on for fp32 products, the router still computes
    in full fp32: the same logits bit for bit, and the caller's setting is
    back afterwards."""
    cfg, p, x = _moe_case("qwen3-moe-235b-a22b", 51)
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model)).to(cuda)
    router = torch.from_numpy(p["router"]).to(cuda)
    want = ffn.route(xt, router, cfg.top_k)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        assert torch.backends.cuda.matmul.allow_tf32
        got = ffn.route(xt, router, cfg.top_k)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(before)
        torch.backends.cuda.matmul.allow_tf32 = False
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# The grouped expert kernel (csrc/moe_gemm.cu) and the MoE layer's grouped    #
# path                                                                        #
# --------------------------------------------------------------------------- #
# (E, D, Fe, kept rows of each expert, spare rows past them): an expert with
# no rows, one over several 128-row tiles, one of a single row; widths off
# the 64-deep stage and the 128 / 256-column tiles; qwen3-moe's 128 experts;
# one token of a decode, far smaller than a tile
MOE_GEMM_CASES = [
    (8, 256, 128, (0, 300, 1, 130, 128, 7, 0, 64), 1),
    (8, 200, 136, (5, 0, 257, 3, 0, 0, 90, 1), 17),
    (128, 256, 192, tuple(int(c) for c in np.random.default_rng(7).integers(
        0, 12, 128) * (np.arange(128) % 5 != 0)), 9),
    (4, 64, 64, (1, 0, 0, 0), 0),
]


def _moe_gemm_args(E, D, Fe, counts, spare, seed, device):
    R = sum(counts) + spare
    a = _randn((R, D), torch.bfloat16, device, seed)
    w = [_randn(shape, torch.float32, device, seed + i) / shape[1] ** 0.5
         for i, shape in enumerate(((E, D, Fe), (E, D, Fe), (E, Fe, D)), 1)]
    ends = torch.tensor(counts, dtype=torch.int64, device=device).cumsum(0)
    return (a, ends) + tuple(t.bfloat16() for t in w)


@pytest.mark.parametrize("case", MOE_GEMM_CASES,
                         ids=lambda c: f"E{c[0]}-D{c[1]}-Fe{c[2]}")
def test_moe_gemm_matches_plain(cuda, case):
    """Each entry of the grouped kernel against its plain version on the
    same input, on the kept rows, within the bf16 limit (both round an fp32
    result once); one launch each, counted."""
    a, ends, wg, wu, wd = _moe_gemm_args(*case, seed=60, device=cuda)
    n = sum(case[3])
    before = _ledger()
    h = mg.moe_gate_up(a, ends, wg, wu)
    out = mg.moe_down(h, ends, wd)
    torch.cuda.synchronize()
    assert _moved(before) == {"moe_gemm.gate_up": 1, "moe_gemm.down": 1}
    atol, rtol = DTYPES["bf16"][1]
    for got, want in ((h, ref.moe_gate_up_plain(a, ends, wg, wu)),
                      (out, ref.moe_down_plain(h, ends, wd))):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got[:n].float(), want[:n].float(),
                                   atol=atol, rtol=rtol)


def test_moe_gemm_rejects_what_it_cannot_take(cuda):
    a, ends, wg, wu, wd = _moe_gemm_args(4, 64, 64, (1, 2, 0, 3), 1, 61,
                                         cuda)
    with pytest.raises(TypeError):
        mg.moe_gate_up(a.float(), ends, wg, wu)
    with pytest.raises(ValueError):
        mg.moe_gate_up(a, ends.int(), wg, wu)
    with pytest.raises(ValueError):
        mg.moe_down(a[:, :60].contiguous(), ends, wd[:, :60].contiguous())
    with pytest.raises(ValueError):
        mg.moe_gate_up(a.cpu(), ends.cpu(), wg.cpu(), wu.cpu())


def _moe_bf16(cfg, p, x, device, grad=False):
    tp = {k: torch.from_numpy(v).to(device, torch.bfloat16).requires_grad_(
        grad) for k, v in p.items()}
    return tp, torch.from_numpy(x).to(device, torch.bfloat16)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_mlp_grouped_path_on_the_card_matches_the_cpu_port(cuda, arch):
    """bf16 under no_grad: the card's grouped path (the kernel) against the
    CPU port's (its plain version), at the config's capacity factor (qwen3-
    moe drops here): the same routes, y within 2**-6 of its largest entry
    (each side rounds h and y to bf16 once, from sums in another order);
    one call on the grouped path, two launches. With a gradient the card
    takes the capacity path and launches nothing."""
    cfg, p, x = _moe_case(arch, 52)
    tp, tx = _moe_bf16(cfg, p, x, cuda)
    cp, cx = _moe_bf16(cfg, p, x, "cpu")
    before = _ledger()
    with torch.no_grad():
        got, _ = ffn.moe_mlp(tp, tx, cfg)
        want, _ = ffn.moe_mlp(cp, cx, cfg)
    counted = {"moe_mlp.grouped": 2, "moe_gemm.gate_up": 1,
               "moe_gemm.down": 1}
    assert _moved(before) == counted
    _, _, ki = ffn.route(tx.reshape(-1, cfg.d_model), tp["router"],
                         cfg.top_k)
    _, _, ci = ffn.route(cx.reshape(-1, cfg.d_model), cp["router"], cfg.top_k)
    assert torch.equal(ki.cpu(), ci)
    want = want.float()
    err = float((got.float().cpu() - want).abs().max())
    assert err <= 2.0 ** -6 * float(want.abs().max()), err
    gp, gx = _moe_bf16(cfg, p, x, cuda, grad=True)
    ffn.moe_mlp(gp, gx, cfg)
    assert _moved(before) == dict(counted, **{"moe_mlp.capacity": 1})


def _device_launches(fn, calls=3):
    """Kernels, copies and fills on the card per call of ``fn``, from a
    torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    assert n % calls == 0, n
    return n // calls


def test_moe_mlp_grouped_path_makes_no_host_sync_and_fewer_launches(cuda):
    """mixtral's layer at a narrow width in bf16, 2 x 160 tokens, under
    no_grad: the grouped path with torch.cuda.set_sync_debug_mode("error")
    (any op that waits for the card raises), then its device launches a
    call against the capacity path's on the same input."""
    cfg, p, x = _moe_case("mixtral-8x22b", 53)
    tp, tx = _moe_bf16(cfg, p, x, cuda)
    with torch.no_grad():
        ffn.moe_mlp(tp, tx, cfg)           # the library's load, warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ffn.moe_mlp(tp, tx, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        grouped = _device_launches(lambda: ffn.moe_mlp(tp, tx, cfg))
    gp, gx = _moe_bf16(cfg, p, x, cuda, grad=True)
    capacity = _device_launches(lambda: ffn.moe_mlp(gp, gx, cfg))
    assert grouped <= capacity, (grouped, capacity)


@pytest.mark.parametrize("T", [945, 256])
def test_moe_mlp_share_makes_no_host_sync(cuda, T):
    """qwen3-moe's layer at full width in bf16 (D 4096, 128 experts of
    1536, top 8, capacity factor 16 = E / K: nothing dropped) under no_grad,
    over T tokens (a 945-token prefill, a 256-slot decode step): the call
    holding experts 64-127 makes no host sync
    (torch.cuda.set_sync_debug_mode("error")); its device launches a call
    beside the whole layer's grouped call on the same tokens (printed); the
    two halves' y sum to the whole
    layer's within 2**-6 of its largest |y| (each side rounds its experts'
    h and y to bf16 once, and sums a token's assignments in another
    order)."""
    import dataclasses

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b"),
                              capacity_factor=16.0)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    gen = torch.Generator(device=cuda).manual_seed(60 + T)

    def randn(*shape, scale):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(
            torch.bfloat16)
    whole = {"router": randn(D, E, scale=D ** -0.5),
             "w_gate": randn(E, D, Fe, scale=D ** -0.5),
             "w_up": randn(E, D, Fe, scale=D ** -0.5),
             "w_down": randn(E, Fe, D, scale=Fe ** -0.5)}
    halves = [dict(whole, **{k: whole[k][f:f + 64].contiguous()
                             for k in ("w_gate", "w_up", "w_down")})
              for f in (0, 64)]
    x = randn(1, T, D, scale=1.0)
    with torch.no_grad():
        ffn.moe_mlp(halves[1], x, cfg, held=(64, 64))   # the library, warm
        torch.cuda.synchronize()
        before = _ledger()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ffn.moe_mlp(halves[1], x, cfg, held=(64, 64))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert _of(_moved(before), "moe_mlp") == {"moe_mlp.grouped": 1}
        shared = _device_launches(
            lambda: ffn.moe_mlp(halves[1], x, cfg, held=(64, 64)))
        unshared = _device_launches(lambda: ffn.moe_mlp(whole, x, cfg))
        want, _ = ffn.moe_mlp(whole, x, cfg)
        got = sum(ffn.moe_mlp(h, x, cfg, held=(f, 64))[0].float()
                  for h, f in zip(halves, (0, 64)))
    print(f"[share launches] T {T}: unshared {unshared}, held 64/128 "
          f"{shared}")
    assert shared <= unshared + 8, (shared, unshared)
    want = want.float()
    err = float((got - want).abs().max())
    assert err <= 2.0 ** -6 * float(want.abs().max()), err


def test_prefill_graphs_replay_the_eager_prefill(cuda):
    """A small qwen3-moe holding experts 4-7 of 8, bf16 (the grouped path,
    M1 and K1 inside the graph): ``Backbone(prefill_graphs=True)`` captures
    each prompt length once, and every replay gives the eager prefill's
    logits and cache bit for bit (the same kernels on the same inputs), new
    tokens included; under the profiler it runs eagerly (the MoE layer is
    called), and a Server on it serves the eager Server's tokens."""
    from repro_torch.runtime.serve_loop import Request, Server

    cfg = reduced(get_config("qwen3-moe-235b-a22b"), n_experts=8)
    kw = dict(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
              remat=False, device=cuda, held_experts=(4, 4))
    eager, graphed = Backbone(cfg, **kw), Backbone(cfg, prefill_graphs=True,
                                                   **kw)
    params = eager.init(7)
    rng = np.random.default_rng(70)

    def leaves(tree, at=""):
        out = []
        for k in sorted(tree):
            v = tree[k]
            out += (leaves(v, f"{at}/{k}") if isinstance(v, dict)
                    else [(f"{at}/{k}", v)])
        return out

    for S in (17, 40, 17):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S),
                                             dtype=np.int32)).to(cuda)
        want, wcache = eager.prefill(params, {"tokens": toks}, 64)
        got, gcache = graphed.prefill(params, {"tokens": toks}, 64)
        assert torch.equal(got, want), S
        for (kg, g), (kw_, w) in zip(leaves(gcache), leaves(wcache)):
            assert kg == kw_
            assert (torch.equal(g, w) if isinstance(w, torch.Tensor)
                    else g == w), (S, kg)
    assert len(graphed._graphs) == 2
    before = _ledger()
    graphed.prefill(params, {"tokens": toks}, 64)
    assert _of(_moved(before), "moe_mlp") == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        graphed.prefill(params, {"tokens": toks}, 64)
    assert _of(_moved(before), "moe_mlp") == {"moe_mlp.grouped": cfg.n_layers}
    served = []
    for bb in (eager, graphed):
        srv = Server(bb, params, slots=3, ctx=64)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 21,
                                                   dtype=np.int32)
                        if bb is eager else served[0][1][i], max_new=6)
                for i in range(3)]
        for r in reqs:
            srv.submit(r)
        srv.run()
        served.append(([list(r.out) for r in reqs],
                       [r.prompt for r in reqs]))
    assert served[0][0] == served[1][0]
    graphed.drop_prefill_graphs()
    assert graphed._graphs == {}


# --------------------------------------------------------------------------- #
# K1's sm90 body (csrc/flash_fwd_sm90.cu): every bf16 call at hd 128          #
# --------------------------------------------------------------------------- #
def _mma_body(q, k, v, kw, return_lse=False):
    """flash_fwd.cu's mma.sync body on the same call, through the library's
    entry point: the wrapper sends bf16 at hd 128 to the sm90 body."""
    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hkv, Hq // Hkv, Sq), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    rc = build.entry("flash_fwd", fa.FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kw["q_positions"].data_ptr(),
        kw["kv_positions"].data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, 1,
        int(kw["causal"]), kw["window"] or 0, 0.0, float(hd ** -0.5),
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return (out, lse) if return_lse else out


def _sm90_call(q, k, v, kw, return_lse=False):
    """fa.flash_fwd, held to one launch of the sm90 body."""
    before = _ledger()
    got = fa.flash_fwd(q, k, v, return_lse=return_lse, **kw)
    torch.cuda.synchronize()
    assert _moved(before) == {"flash_fwd.sm90": 1}
    return got


def _assert_sm90_close(q, k, v, kw, return_lse=False):
    """The sm90 body against attention_plain (rows with a valid key) within
    the bf16 limit, 0 on a row with no valid key; its LSE against
    attention_lse_plain within LSE_TOL, -inf on such a row."""
    got = _sm90_call(q, k, v, kw, return_lse)
    out, lse = got if return_lse else (got, None)
    B, Sq, Hq, _ = q.shape
    G = Hq // k.shape[2]
    _, want_lse = ref.attention_lse_plain(q, k, v, **kw)
    seen = want_lse > ref.MASK_VALUE / 2                  # [B, Hkv, G, Sq]
    rows = seen.permute(0, 3, 1, 2).reshape(B, Sq, Hq)    # [B, Sq, Hq]
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    if bool((~rows).any()):  # a row with no valid key gives 0
        assert out[~rows].abs().max().item() == 0.0
    want = ref.attention_plain(q, k, v, **kw).float()
    limit = (1e-4 + 2.0 ** -6 * want.abs() + P_ROUND * ref.attention_plain(
        q.float(), k.float(), v.float().abs(), **kw))
    err = (out.float() - want).abs()
    ok = (err <= limit) | ~rows[..., None]
    assert bool(ok.all()), (f"max abs err {float(err[rows].max())}, worst "
                            f"excess {float((err - limit)[rows].max())}")
    if return_lse:
        assert lse.shape == want_lse.shape and lse.dtype == torch.float32
        _assert_close_elementwise(lse[seen], want_lse[seen], *LSE_TOL, "lse")
        assert bool(torch.isneginf(lse[~seen]).all())
    return got


# (B, Sq, Skv, Hq, Hkv, window, LSE): the cells' calls at hd 128, causal:
# qwen3-moe's prefill strata (64/4), mixtral's (48/8) and its registered
# window of 4096 past the window, qwen3-4b's training forward with its LSE
SM90_CELL_SHAPES = [
    (1, 945, 945, 64, 4, None, False),
    (1, 1500, 1500, 64, 4, None, False),
    (1, 2381, 2381, 64, 4, None, False),
    (1, 1500, 1500, 48, 8, None, False),
    (1, 4200, 4200, 48, 8, 4096, False),
    (4, 2048, 2048, 32, 8, None, True),
]


@pytest.mark.parametrize("case", SM90_CELL_SHAPES, ids=str)
def test_sm90_body_at_the_cells_shapes(cuda, case):
    B, Sq, Skv, Hq, Hkv, window, lse = case
    q = _randn((B, Sq, Hq, 128), torch.bfloat16, cuda, 80)
    k = _randn((B, Skv, Hkv, 128), torch.bfloat16, cuda, 81)
    v = _randn((B, Skv, Hkv, 128), torch.bfloat16, cuda, 82)
    kw = dict(causal=True, window=window, logit_cap=None,
              q_positions=torch.arange(Sq, dtype=torch.int32, device=cuda),
              kv_positions=torch.arange(Skv, dtype=torch.int32, device=cuda))
    _assert_sm90_close(q, k, v, kw, return_lse=lse)


def _sm90_edge_cases():
    """name -> (B, Sq, Hq, Hkv, causal, window, q positions, kv positions)."""
    ring = _ring(512, 700, 1180)             # wrapped, 31 empty slots
    holes = np.arange(333, dtype=np.int32)
    holes[::5] = -1                          # key 0 too: query 0 sees none
    return {
        # Sq and Skv off the 128-row and 128-key tiles, the queries the
        # last 200 of 333 positions, B > 1
        "ragged_tail_b2": (2, 200, 32, 8, True, None, np.arange(133, 333),
                           np.arange(333)),
        "odd_group_g7": (1, 333, 28, 4, True, None, np.arange(333),
                         np.arange(333)),
        "not_causal": (3, 70, 4, 2, False, None, np.arange(70),
                       np.arange(131)),
        "empty_slots_and_a_row_without_keys": (2, 333, 16, 1, True, None,
                                               np.arange(333), holes),
        "prefill_against_a_ring": (2, 100, 32, 8, True, None,
                                   np.arange(1081, 1181), ring),
        "window_inside_a_ring": (1, 100, 32, 8, True, 64,
                                 np.arange(1081, 1181), ring),
        "one_query_position": (3, 1, 32, 8, True, None, np.array([1180]),
                               ring),
        "no_valid_key_at_all": (1, 5, 8, 2, True, None, np.arange(5),
                                np.full(300, -1)),
    }


@pytest.mark.parametrize("lse", [False, True])
@pytest.mark.parametrize("name", list(_sm90_edge_cases()))
def test_sm90_body_at_the_edges(cuda, name, lse):
    B, Sq, Hq, Hkv, causal, window, qpos, kpos = _sm90_edge_cases()[name]
    Skv = len(kpos)
    q = _randn((B, Sq, Hq, 128), torch.bfloat16, cuda, 83)
    k = _randn((B, Skv, Hkv, 128), torch.bfloat16, cuda, 84)
    v = _randn((B, Skv, Hkv, 128), torch.bfloat16, cuda, 85)
    kw = dict(causal=causal, window=window, logit_cap=None,
              q_positions=torch.as_tensor(qpos, dtype=torch.int32).to(cuda),
              kv_positions=torch.as_tensor(kpos, dtype=torch.int32).to(cuda))
    _assert_sm90_close(q, k, v, kw, return_lse=lse)


def test_flash_bwd_on_the_sm90_bodys_output(cuda):
    """K1b on the sm90 body's O and LSE matches K1b on the mma body's, within
    K1b's bf16 limit (atol 1e-4, rtol 2^-6 and the rounding of p and ds),
    at qwen3-4b's heads with empty slots."""
    case = (2, 512, 512, 32, 8, 128, True, None, None, True)
    q, k, v, dout, kw = _bwd_inputs(case, torch.bfloat16, cuda, seed=86)
    out, lse = _sm90_call(q, k, v, kw, return_lse=True)
    mma_out, mma_lse = _mma_body(q, k, v, kw, return_lse=True)
    got = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    want = fb.flash_bwd(q, k, v, mma_out, mma_lse, dout, **kw)
    extra = ref.flash_bwd_rounding_plain(q, k, v, mma_out, mma_lse, dout, **kw)
    atol, rtol = DTYPES["bf16"][1]
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, extra):
        _assert_close_elementwise(g, w, atol, rtol, name, e)


def test_sm90_body_syncs_nothing(cuda):
    """The sm90 body's launch neither synchronises nor reads the card from
    the host, with and without its LSE."""
    q = _randn((1, 300, 16, 128), torch.bfloat16, cuda, 87)
    k = _randn((1, 300, 4, 128), torch.bfloat16, cuda, 88)
    kw = dict(causal=True, window=None, logit_cap=None,
              q_positions=torch.arange(300, dtype=torch.int32, device=cuda),
              kv_positions=torch.arange(300, dtype=torch.int32, device=cuda))
    want = fa.flash_fwd(q, k, k, **kw)   # the library loaded, the body sized
    before = _ledger()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fa.flash_fwd(q, k, k, **kw)
        out2, _ = fa.flash_fwd(q, k, k, return_lse=True, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _moved(before) == {"flash_fwd.sm90": 2}
    assert torch.equal(out, want) and torch.equal(out2, want)


def test_sm90_body_inside_the_prefill_graphs(cuda):
    """A small qwen3-moe with the cell's attention (hd 128, G 16; experts
    4-7 of 8 held, bf16): the sm90 body takes every prefill's attention,
    and each CUDA-graph replay of the prefill gives the eager prefill's
    logits and cache bit for bit, at prompts past one key tile."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"), n_experts=8,
                  head_dim=128, n_heads=16, n_kv_heads=1)
    kw = dict(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
              remat=False, device=cuda, held_experts=(4, 4))
    eager, graphed = Backbone(cfg, **kw), Backbone(cfg, prefill_graphs=True,
                                                   **kw)
    params = eager.init(9)
    rng = np.random.default_rng(90)
    n_attn = sum(kind == "attn" for kind in cfg.layer_kinds())
    assert n_attn >= 1

    def leaves(tree, at=""):
        out = []
        for key in sorted(tree):
            v = tree[key]
            out += (leaves(v, f"{at}/{key}") if isinstance(v, dict)
                    else [(f"{at}/{key}", v)])
        return out

    for S in (200, 333, 200):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, S),
                                             dtype=np.int32)).to(cuda)
        before = _ledger()
        want, wcache = eager.prefill(params, {"tokens": toks}, 512)
        assert _of(_moved(before), "flash_fwd") == {"flash_fwd.sm90": n_attn}
        got, gcache = graphed.prefill(params, {"tokens": toks}, 512)
        assert torch.equal(got, want), S
        for (kg, g), (kw_, w) in zip(leaves(gcache), leaves(wcache)):
            assert kg == kw_
            assert (torch.equal(g, w) if isinstance(w, torch.Tensor)
                    else g == w), (S, kg)
    assert len(graphed._graphs) == 2
    graphed.drop_prefill_graphs()


# --------------------------------------------------------------------------- #
# whisper-tiny at full width and full depth (4 enc + 4 dec layers)            #
# --------------------------------------------------------------------------- #
def _whisper_frames(cfg, B, seed, device):
    return _randn((B, cfg.enc_seq, cfg.d_model), torch.float32, device, seed)


def test_whisper_prefill_and_decode_on_the_card(cuda):
    """fp32: decode after a prefill of 32 tokens matches the prefill of 33
    over the same 1500 frames (2e-3, as tests/test_models.py), with
    flash_fwd launched 12 times a prefill (4 encoder, 4 self, 4 cross) and
    flash_decode 8 times a decode step (4 self, 4 cross). bf16: the kernel
    path against kernel_impl="plain" with the same weights, logits within
    0.125 (a few bf16 ulps of a logit, chip_smoke.py's MODEL_BF16_TOL)."""
    cfg = get_config("whisper-tiny")
    frames = _whisper_frames(cfg, 2, 13, cuda)
    toks = torch.from_numpy(np.random.default_rng(13).integers(
        0, cfg.vocab, (2, 37), dtype=np.int32)).to(cuda)
    bb = Backbone(cfg, compute_dtype=torch.float32, device=cuda)
    params = bb.init(0)
    before = _ledger()
    _, cache = bb.prefill(params, {"tokens": toks[:, :32],
                                   "enc_frames": frames}, 448)
    moved = _moved(before)
    assert (_total(moved, "flash_fwd"), _total(moved, "flash_decode")) == (
        12, 0)
    assert set(cache) == {"pos", "g1"}
    assert cache["g1"]["s0"]["ck"].shape == (4, 2, 1500, 6, 64)
    got, _ = bb.decode_step(params, cache, toks[:, 32:33])
    moved = _moved(before)
    assert (_total(moved, "flash_fwd"), _total(moved, "flash_decode")) == (
        12, 8)
    want, _ = bb.prefill(params, {"tokens": toks[:, :33],
                                  "enc_frames": frames}, 448)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)

    kern = Backbone(cfg, compute_dtype=torch.bfloat16,
                    param_dtype=torch.bfloat16, device=cuda)
    plain = Backbone(cfg, compute_dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, device=cuda,
                     kernel_impl="plain")
    params = kern.init(1)
    batch = {"tokens": toks[:, :32], "enc_frames": frames}
    lk, ck = kern.prefill(params, batch, 448)
    lp, cp = plain.prefill(params, batch, 448)
    errs = [float((lk.float() - lp.float()).abs().max())]
    for i in range(4):
        t = toks[:, 32 + i:33 + i]
        lk, ck = kern.decode_step(params, ck, t)
        lp, cp = plain.decode_step(params, cp, t)
        errs.append(float((lk.float() - lp.float()).abs().max()))
    assert max(errs) <= 0.125, errs


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_whisper_grads_kernel_path_match_plain_path(cuda, dtype):
    """loss_fn and every leaf's gradient of the full whisper-tiny with fp32
    params, [2, 64] tokens over 1500 frames, remat on: the kernel path (K1
    with LSE and K1b at the encoder's, the decoder's and the cross shapes)
    against kernel_impl="plain", with the limits of the qwen3 test above.
    K1 runs twice a layer (remat) and K1b once: 12 attention calls a pass."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    cfg = get_config("whisper-tiny")
    kern = Backbone(cfg, compute_dtype=dt, remat=True, device=cuda)
    plain = Backbone(cfg, compute_dtype=dt, remat=True, device=cuda,
                     kernel_impl="plain")
    params = kern.init(3)
    toks = np.random.default_rng(14).integers(0, cfg.vocab, (2, 65),
                                              dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "enc_frames": _whisper_frames(cfg, 2, 14, cuda)}
    before = _ledger()
    lk, gk = value_and_grad(kern, params, batch)
    torch.cuda.synchronize()
    moved = _moved(before)
    assert (_total(moved, "flash_fwd"), _total(moved, "flash_decode"),
            moved.get("flash_bwd.dq", 0)) == (24, 0, 12)
    lp, gp = value_and_grad(plain, params, batch)
    if dt == torch.float32:
        torch.testing.assert_close(lk, lp, atol=1e-5, rtol=1e-5)
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    else:
        assert abs(float(lk) - float(lp)) <= 2.0 ** -6 * abs(float(lp))
        for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
            assert float((a - b).norm()) <= 2.0 ** -4 * float(b.norm())


def test_state_cell_carries_cuda_bf16_leaves_as_host_bytes(cuda):
    """A StateCell of CUDA bf16 leaves pickles them as host bytes (the
    wire's protocol 5, out of band): the copy's leaves lie on the CPU, move
    back to the card with an explicit .to(), and equal the originals bit for
    bit; get raises no torn-snapshot error on the copy."""
    import pickle

    from repro_torch.txstore.store import StateCell
    g = torch.Generator(device=cuda).manual_seed(21)
    tree = {"w": torch.randn((256, 384), generator=g, device=cuda).to(
                torch.bfloat16),
            "layers": [torch.empty(4, 8, device=cuda, dtype=torch.bfloat16
                                   ).normal_(generator=g),
                       torch.tensor(1.5, device=cuda, dtype=torch.bfloat16)]}
    bufs = []
    data = pickle.dumps(StateCell(tree, 2), protocol=5,
                        buffer_callback=bufs.append)
    copy = pickle.loads(data, buffers=[bytes(b.raw()) for b in bufs])
    got = copy.get()
    flat = [got["w"], *got["layers"]]
    want = [tree["w"], *tree["layers"]]
    assert all(t.device.type == "cpu" for t in flat)
    for a, b in zip(flat, want):
        back = a.to(cuda)
        assert back.dtype == torch.bfloat16 and back.shape == b.shape
        assert torch.equal(back.view(torch.int16), b.view(torch.int16))
    assert copy.get_version() == 2


def test_donating_step_matches_the_functional_step_on_the_card(cuda):
    """make_train_step(donate=True) against the functional step on the card
    (2 layers of qwen3-4b's kind at d_model 1024, vocab 4096, 35.7 M fp32
    parameters, bf16 compute on the kernel path, [2, 128] tokens): 2 steps
    from clones of one init, every leaf, the loss and grad_norm bit for
    bit, each donated leaf on its own storage. The first step's peak above
    what was allocated before it (max_memory_allocated) is lower for the
    donating step by at least 12 bytes a parameter (the functional step's
    second params, m and v) less a slack of 4 x the largest leaf's fp32
    bytes: the backward's transients beside the grads (the tied embedding's
    two gradient halves) and the update's slices, which the functional
    step's peak need not hold."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                           make_train_step)
    cfg = reduced(get_config("qwen3-4b"), d_model=1024, n_heads=8,
                  n_kv_heads=4, head_dim=128, d_ff=4096, vocab=4096,
                  groups=(LayerGroup(("attn",), 2),))
    bb = Backbone(cfg, compute_dtype=torch.bfloat16,
                  param_dtype=torch.float32, remat=False, device=cuda)
    settings = StepSettings(remat=False)
    opt = adamw.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    data = DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2)
    batches = [make_batch(data, i) for i in range(2)]

    def first_step_peak(step, state):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = step(state, batches[0])
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - before

    init = init_train_state(bb, 0, settings)
    d_state = adamw.tree_map(torch.clone, init)
    ptrs = [t.data_ptr() for t in adamw.tree_leaves(d_state)]
    (state, m0), f_peak = first_step_peak(make_train_step(bb, opt, settings),
                                          init)
    del init
    donating = make_train_step(bb, opt, settings, donate=True)
    (out, d0), d_peak = first_step_peak(donating, d_state)
    assert out is d_state
    state, m1 = make_train_step(bb, opt, settings)(state, batches[1])
    out, d1 = donating(out, batches[1])
    for a, b in ((m0, d0), (m1, d1)):
        assert all(torch.equal(a[k], b[k]) for k in ("loss", "grad_norm"))
    for a, b in zip(adamw.tree_leaves(state), adamw.tree_leaves(out)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in adamw.tree_leaves(out)] == ptrs
    leaves = adamw.tree_leaves(out["params"])
    n = sum(int(t.numel()) for t in leaves)
    slack = 4 * 4 * max(int(t.numel()) for t in leaves)
    assert f_peak - d_peak >= 12 * n - slack, (f_peak, d_peak, n, slack)


def _indexed_views(bb, gp, repeat):
    """Layer r's views as ``leaf[r]``, one select a layer: the yardstick of
    ``Backbone._layer_views``, whose backward pads each layer's gradient to
    the leaf's size with zeros and adds the padded tensors."""
    return [{s: {name: leaf[r] for name, leaf in sub.items()}
             for s, sub in gp.items()} for r in range(repeat)]


def test_layer_views_match_indexing_on_the_card(cuda, monkeypatch):
    """4 layers of qwen3-4b's kind in one group at d_model 1024 (the
    donating test's widths), fp32 parameters, bf16 compute on the kernel
    path, [2, 128] tokens, from one init: the group's unbind views against
    the per-layer ``leaf[r]`` views. The gradients of value_and_grad and
    the state after one donating step are equal bit for bit (each removed
    add added zeros), and the step's peak above what was allocated before
    it is no higher. The ledger counts one ``layer_views.unbind`` a
    forward."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                           make_train_step, value_and_grad)
    cfg = reduced(get_config("qwen3-4b"), d_model=1024, n_heads=8,
                  n_kv_heads=4, head_dim=128, d_ff=4096, vocab=4096,
                  groups=(LayerGroup(("attn",), 4),))
    bb = Backbone(cfg, compute_dtype=torch.bfloat16,
                  param_dtype=torch.float32, remat=False, device=cuda)
    settings = StepSettings(remat=False)
    opt = adamw.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=128,
                                  global_batch=2), 0)
    init = init_train_state(bb, 0, settings)

    def run():
        state = adamw.tree_map(torch.clone, init)
        before = _ledger()
        _, grads = value_and_grad(bb, state["params"], batch)
        step = make_train_step(bb, opt, settings, donate=True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        return (adamw.tree_leaves(grads), adamw.tree_leaves(state), m, peak,
                _moved(before).get("layer_views.unbind", 0))

    grads, state, m, peak, unbinds = run()
    monkeypatch.setattr(Backbone, "_layer_views", _indexed_views)
    w_grads, w_state, w_m, w_peak, _ = run()
    assert unbinds == 2
    assert all(torch.equal(a, b) for a, b in zip(grads, w_grads))
    assert all(torch.equal(a, b) for a, b in zip(state, w_state))
    assert all(torch.equal(m[k], w_m[k]) for k in ("loss", "grad_norm"))
    assert peak <= w_peak, (peak, w_peak)
