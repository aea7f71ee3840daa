"""The chunked bodies of the scans (K2 RG-LRU, K3 WKV), through their plain
mirrors, against the sequential plain versions and the JAX package on the
CPU; and the plans that choose a body from the shapes.

``ref.rglru_scan_chunked_plain`` and ``ref.rwkv6_scan_chunked_plain`` repeat
the arithmetic of the chunked CUDA bodies (chunk maps, carry and rescan for
K2; sub-chunk runs of log w, summaries, carry, factored blocks and the
u-term for K3) in plain PyTorch. Inputs are made with numpy from a seed and
handed to both packages. The CUDA bodies themselves are held against the
plain versions on the card in tests/test_torch_gpu.py and chip_smoke.py.

Tolerances (atol = rtol) are the JAX tests' own: 1e-5 for the RG-LRU (the
chunked form regroups the chain's products and sums) and 2e-4 for the WKV
(it sums y's terms in another order and takes decays as exp of sums of
log w); the bf16 cases too, since both sides see the same bf16 values and
compute in fp32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as krglru
from repro_torch.kernels import rwkv6 as krwkv6
from test_torch_recurrent import _close, _rglru_inputs, _wkv_inputs

L = krglru.CHUNK     # the RG-LRU's chunk
LW = krwkv6.CHUNK    # the WKV's chunk
T_CASES = [1, L - 1, L, 2 * L + 3]
TW_CASES = [1, LW - 1, LW, 2 * LW + 3]


def _chunked_rglru(*args, **kw):
    return ref.rglru_scan_chunked_plain(*args, chunk=krglru.CHUNK, **kw)


def _chunked_wkv(*args, **kw):
    return ref.rwkv6_scan_chunked_plain(*args, chunk=krwkv6.CHUNK,
                                        sub=krwkv6.SUB, **kw)


# --------------------------------------------------------------------------- #
# The mirrors against the sequential plain versions and JAX                    #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=str)
@pytest.mark.parametrize("T", T_CASES)
def test_rglru_chunked_matches_sequential_and_jax(T, dtype):
    B, W = 2, 40
    jargs, targs = _rglru_inputs(B, T, W, dtype, seed=T)
    y, h = _chunked_rglru(*targs)
    assert y.dtype == h.dtype == torch.float32 and y.shape == (B, T, W)
    y_seq, h_seq = ref.rglru_scan_plain(*targs)
    y_ref, h_ref = jref.rglru_scan_ref(*jargs)
    y_pal, h_pal = jops.rglru_scan(*jargs, impl="pallas", block_t=16,
                                   block_w=W)
    for want_y, want_h in ((y_seq, h_seq), (y_ref, h_ref), (y_pal, h_pal)):
        _close(y, want_y, 1e-5)
        _close(h, want_h, 1e-5)
    # h_T is the last rescanned h, as in the sequential version
    assert torch.equal(y[:, -1], h)


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("T", TW_CASES)
def test_rwkv6_chunked_matches_sequential_and_jax(T, hd):
    B, H = 1, 2
    jargs, targs = _wkv_inputs(B, T, H, hd, jnp.float32, seed=hd + T)
    y, s = _chunked_wkv(*targs)
    assert y.dtype == s.dtype == torch.float32 and y.shape == (B, T, H, hd)
    y_seq, s_seq = ref.rwkv6_scan_plain(*targs)
    y_ref, s_ref = jref.rwkv6_scan_ref(*jargs)
    y_pal, s_pal = jops.rwkv6_scan(*jargs, impl="pallas", block_t=64)
    for want_y, want_s in ((y_seq, s_seq), (y_ref, s_ref), (y_pal, s_pal)):
        _close(y, want_y, 2e-4)
        _close(s, want_s, 2e-4)


@pytest.mark.parametrize("T", [LW - 1, 2 * LW + 3])
def test_rwkv6_chunked_matches_jax_in_bf16(T):
    jargs, targs = _wkv_inputs(2, T, 2, 16, jnp.bfloat16, seed=7)
    y, s = _chunked_wkv(*targs)
    y_ref, s_ref = jref.rwkv6_scan_ref(*jargs)
    _close(y, y_ref, 2e-4)
    _close(s, s_ref, 2e-4)


@pytest.mark.parametrize("chunk,sub", [(16, 4), (32, 8), (128, 16)])
def test_rwkv6_chunked_holds_at_other_chunkings(chunk, sub):
    _, targs = _wkv_inputs(1, 150, 2, 32, jnp.float32, seed=5)
    y, s = ref.rwkv6_scan_chunked_plain(*targs, chunk=chunk, sub=sub)
    y_seq, s_seq = ref.rwkv6_scan_plain(*targs)
    _close(y, y_seq, 2e-4)
    _close(s, s_seq, 2e-4)


@pytest.mark.parametrize("chunk", [4, 16, 128])
def test_rglru_chunked_holds_at_other_chunkings(chunk):
    _, targs = _rglru_inputs(1, 150, 24, jnp.float32, seed=5)
    y, h = ref.rglru_scan_chunked_plain(*targs, chunk=chunk)
    y_seq, h_seq = ref.rglru_scan_plain(*targs)
    _close(y, y_seq, 1e-5)
    _close(h, h_seq, 1e-5)


# --------------------------------------------------------------------------- #
# Edge decays                                                                  #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("near", [0, 1])
@pytest.mark.parametrize("T", [L - 1, 2 * L + 3])
def test_rglru_chunked_edge_decays(T, near):
    """a_t near 0 (a_log 20, r = 1: exp(-8 softplus(20)) is 0 in fp32) and
    near 1 (a_log -20: softplus about 2e-9)."""
    _, (x, _, _, gi, h0) = _rglru_inputs(2, T, 24, jnp.float32, seed=3)
    a_log = torch.full((24,), 20.0 if near == 0 else -20.0)
    args = (x, a_log, torch.ones_like(x), gi, h0)
    y, h = _chunked_rglru(*args)
    y_seq, h_seq = ref.rglru_scan_plain(*args)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    _close(y, y_seq, 1e-5)
    _close(h, h_seq, 1e-5)


def _edge_w(kind, shape):
    if kind == "mixed":  # w = 0 exactly, tiny, near 1 and 1, in one run
        a = np.random.default_rng(11).standard_normal(shape) * 3
        return torch.exp(-torch.exp(torch.from_numpy(a.astype(np.float32))))
    return torch.full(shape, {"zero": 0.0, "one": 1.0, "tiny": 1e-30}[kind])


@pytest.mark.parametrize("kind", ["zero", "one", "tiny", "mixed"])
@pytest.mark.parametrize("T", [LW, 2 * LW + 3])
def test_rwkv6_chunked_edge_decays(T, kind):
    _, (r, k, v, w, u, s0) = _wkv_inputs(1, T, 2, 64, jnp.float32, seed=4)
    w = _edge_w(kind, w.shape)
    if kind == "mixed":
        assert bool((w == 0).any()) and bool((w > 0.99).any())
    y, s = _chunked_wkv(r, k, v, w, u, s0)
    y_seq, s_seq = ref.rwkv6_scan_plain(r, k, v, w, u, s0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    _close(y, y_seq, 2e-4)
    _close(s, s_seq, 2e-4)


def test_rwkv6_chunked_keeps_a_short_run_behind_a_long_one():
    """A step of w = 0 and then w near 1: Λ sums to about -88 before the
    small decays. A difference of prefix sums would lose them to fp32's
    rounding at 88 (7.6e-6 an ulp); the sub-chunk runs keep them."""
    _, (r, k, v, w, u, s0) = _wkv_inputs(1, 2 * LW, 2, 64, jnp.float32, seed=6)
    w = torch.full_like(w, 0.999)
    w[:, ::16] = 0.0
    y, s = _chunked_wkv(r, k, v, w, u, s0)
    y64, s64 = ref.rwkv6_scan_plain(*(a.double() for a in (r, k, v, w, u, s0)))
    scale = float(y64.abs().max())
    assert float((y.double() - y64).abs().max()) < 2e-6 * scale
    assert float((s.double() - s64).abs().max()) < 2e-6 * float(s64.abs().max())


# --------------------------------------------------------------------------- #
# The state: in place and handed on                                            #
# --------------------------------------------------------------------------- #
def test_chunked_mirrors_write_the_state_in_place():
    _, (x, al, gr, gi, h0) = _rglru_inputs(2, 2 * L + 3, 32, jnp.float32, 2)
    y, h = _chunked_rglru(x, al, gr, gi, h0)
    buf = h0.clone()
    y2, h2 = _chunked_rglru(x, al, gr, gi, buf, h_out=buf)
    assert h2 is buf
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(buf, h, atol=0, rtol=0)
    _, (r, k, v, w, u, s0) = _wkv_inputs(2, 2 * LW + 3, 2, 8, jnp.float32, 3)
    y, s = _chunked_wkv(r, k, v, w, u, s0)
    buf = s0.clone()
    y2, s2 = _chunked_wkv(r, k, v, w, u, buf, state_out=buf)
    assert s2 is buf
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(buf, s, atol=0, rtol=0)


def test_chunked_mirrors_hand_the_state_on():
    """Two calls (the first ending inside a chunk) equal one, and JAX."""
    cut = L + 20
    jargs, (x, al, gr, gi, h0) = _rglru_inputs(1, 3 * L, 32, jnp.float32, 8)
    y1, h1 = _chunked_rglru(x[:, :cut], al, gr[:, :cut], gi[:, :cut], h0)
    y2, h2 = _chunked_rglru(x[:, cut:], al, gr[:, cut:], gi[:, cut:], h1)
    y_ref, h_ref = jref.rglru_scan_ref(*jargs)
    _close(torch.cat([y1, y2], 1), y_ref, 1e-5)
    _close(h2, h_ref, 1e-5)
    cut = LW + 20
    jargs, (r, k, v, w, u, s0) = _wkv_inputs(1, 3 * LW, 2, 16, jnp.float32, 9)
    y1, s1 = _chunked_wkv(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut], u, s0)
    y2, s2 = _chunked_wkv(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:], u, s1)
    y_ref, s_ref = jref.rwkv6_scan_ref(*jargs)
    _close(torch.cat([y1, y2], 1), y_ref, 2e-4)
    _close(s2, s_ref, 2e-4)


# --------------------------------------------------------------------------- #
# The plans                                                                    #
# --------------------------------------------------------------------------- #
SMS = 132  # streaming multiprocessors of an H100 SXM


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("B,T", [(1, 2560), (1, 2103), (8, 1)])
def test_rglru_plan_at_the_serving_shapes(B, T, dtype):
    """recurrentgemma-9b (W 4096): prefills of 2560 (chip_smoke's serve) and
    2103 tokens take the chunked body on at least one CTA per SM, a decode
    step (8 slots, T = 1) the sequential one."""
    p = krglru.plan(B, T, 4096, dtype)
    if T == 1:
        assert p == krglru.Plan("sequential", 1, (4096 // 64, 8, 1))
        return
    per_cta = 256 if dtype == torch.bfloat16 else 128
    n = -(-T // L)
    assert p == krglru.Plan("chunked", L, (n * B * 4096 // per_cta, 1, 1))
    assert p.grid[0] >= SMS


@pytest.mark.parametrize("T,body", [(1, "sequential"), (L, "sequential"),
                                    (L + 1, "chunked"), (2560, "chunked")])
def test_rglru_plan_takes_the_chunked_body_past_one_chunk(T, body):
    assert krglru.plan(1, T, 100).body == body
    assert krglru.plan(1, T, 100, body="chunked").body == "chunked"
    assert krglru.plan(1, T, 100, body="sequential").body == "sequential"
    with pytest.raises(ValueError):
        krglru.plan(1, T, 100, body="parallel")


def test_rwkv6_plan_at_the_serving_shapes():
    """rwkv6-3b (H 40, hd 64): the 512-token prefill takes the chunked body
    on 8 chunks x 40 heads of CTAs, a decode step (8 slots) the sequential
    one."""
    p = krwkv6.plan(1, 512, 40, 64)
    assert p == krwkv6.Plan("chunked", LW, (512 // LW, 40, 1))
    assert p.grid[0] * p.grid[1] * p.grid[2] >= SMS
    assert krwkv6.plan(8, 1, 40, 64) == krwkv6.Plan("sequential", 1, (40, 8, 1))
    assert krwkv6.plan(1, LW, 40, 64).body == "sequential"
    assert krwkv6.plan(1, LW + 1, 40, 64).grid == (2, 40, 1)
    with pytest.raises(ValueError):
        krwkv6.plan(1, 512, 40, 64, body="parallel")
