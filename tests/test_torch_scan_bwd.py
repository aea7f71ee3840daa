"""The backwards of the port's scans against the JAX package on the CPU:
``ref.rglru_scan_bwd_plain`` (K2b's plain version) and
``ref.rwkv6_scan_bwd_plain`` (K3b's) against ``jax.vjp`` of the oracles
``rglru_scan_ref`` and ``rwkv6_scan_ref``; the autograd Functions
``RGLRUScan`` and ``WKVScan`` against ``jax.grad``; the chunk-parallel
schemes of K2b (``ref.rglru_scan_bwd_chunked_plain``) and K3b
(``ref.rwkv6_scan_bwd_chunked_plain``) against the sequential plain
backwards and ``jax.vjp``. The CUDA kernels themselves are held against the
plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).

Inputs are made with numpy from a seed; initial states and the final
state's cotangent are nonzero. Tolerances: the gradients are sums of many
fp32 terms taken in another order (reverse loops against JAX's transposed
scan), so each is held within ``TOL`` of itself plus ``TOL`` of its
tensor's largest entry, with TOL 1e-5 for the RG-LRU and 2e-4 for the WKV
(the forward tests' limits); a bf16 input's gradient is rounded to bf16 by
both, which adds two bf16 ulps of itself (2**-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.models.rglru import RGLRUScan
from repro_torch.models.rwkv6 import WKVScan

RGLRU_TOL, WKV_TOL, BF16_RTOL = 1e-5, 2e-4, 2.0 ** -6


def _sigmoid(a):
    return (1.0 / (1.0 + np.exp(-a))).astype(np.float32)


def _to_jax(arrays, dtypes):
    return [jnp.asarray(a).astype(d) for a, d in zip(arrays, dtypes)]


def _to_torch(jarrays):
    """Torch tensors holding exactly the JAX arrays' values and dtypes."""
    out = []
    for a in jarrays:
        t = torch.from_numpy(np.array(a, np.float32))
        out.append(t.bfloat16() if a.dtype == jnp.bfloat16 else t)
    return out


def _assert_grads_close(got, want, tol, what=""):
    assert len(got) == len(want)
    for n, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        bf16 = w.dtype == jnp.bfloat16
        assert g.dtype == (torch.bfloat16 if bf16 else torch.float32), (what, n)
        w = w.astype(np.float32)
        g = g.float().numpy()
        assert g.shape == w.shape, (what, n)
        limit = tol * (np.abs(w).max() + np.abs(w))
        if bf16:
            limit = limit + BF16_RTOL * np.abs(w)
        err = np.abs(g - w)
        assert np.all(err <= limit), (
            f"{what} input {n}: max abs err {err.max()}, worst excess "
            f"{(err - limit).max()}")


# --------------------------------------------------------------------------- #
# The RG-LRU                                                                  #
# --------------------------------------------------------------------------- #
# (B, T, W, input dtype, a_log: random or an edge decay)
RGLRU_BWD_CASES = [
    (1, 1, 8, jnp.float32, "random"),
    (2, 13, 16, jnp.float32, "random"),
    (3, 40, 24, jnp.float32, "random"),
    (2, 33, 16, jnp.bfloat16, "random"),
    # a_t = e^-160 = 0 in fp32: b_t = 1
    (2, 9, 16, jnp.float32, "near_0"),
    # a_t = exp(-8 softplus(-9) r) within 2e-3 of 1: 1 - a² > 0 but small,
    # so a_t / b_t is large (at the clamp, 1 - a² <= 0, JAX's gradient is
    # not finite and the port's takes the clamped branch's 0: not compared)
    (2, 9, 16, jnp.float32, "near_1"),
]


def _rglru_arrays(B, T, W, dtype, decay, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, r, i = n(B, T, W), _sigmoid(n(B, T, W)), _sigmoid(n(B, T, W))
    a_log = n(W)
    if decay != "random":
        a_log = np.full((W,), 20.0 if decay == "near_0" else -9.0, np.float32)
        r = np.ones_like(r)
    arrays = _to_jax([x, a_log, r, i, n(B, W)],
                     [dtype, jnp.float32, dtype, dtype, jnp.float32])
    cot = _to_jax([n(B, T, W), n(B, W)], [jnp.float32] * 2)
    return arrays, cot


@pytest.mark.parametrize("case", RGLRU_BWD_CASES, ids=str)
def test_rglru_bwd_plain_matches_jax_vjp(case):
    B, T, W, dtype, decay = case
    (jx, jal, jr, ji, jh0), (jdy, jdh) = _rglru_arrays(B, T, W, dtype, decay)
    (jy, jh), vjp = jax.vjp(jref.rglru_scan_ref, jx, jal, jr, ji, jh0)
    want = vjp((jdy, jdh))
    x, al, r, i, h0 = _to_torch([jx, jal, jr, ji, jh0])
    y, _ = ref.rglru_scan_plain(x, al, r, i, h0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    got = ref.rglru_scan_bwd_plain(x, al, r, i, h0, y,
                                   *_to_torch([jdy, jdh]))
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _assert_grads_close(got, want, RGLRU_TOL, "rglru")
    # ops sends CPU tensors to the plain version
    again = ops.rglru_scan_bwd(x, al, r, i, h0, y, *_to_torch([jdy, jdh]))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_rglru_bwd_plain_takes_the_clamped_branch_at_a_equal_1():
    """r = 0 gives a_t = 1 exactly: 1 - a² = 0 and b_t = 0. JAX's gradient
    through sqrt there is not finite; the port's plain backward gives the
    clamped branch's, which leaves da_t = g_t h_{t-1}: finite."""
    (jx, jal, jr, ji, jh0), (jdy, jdh) = _rglru_arrays(1, 5, 8, jnp.float32,
                                                       "random")
    jr = jnp.zeros_like(jr)
    _, vjp = jax.vjp(jref.rglru_scan_ref, jx, jal, jr, ji, jh0)
    want = vjp((jdy, jdh))
    assert not all(bool(jnp.isfinite(g).all()) for g in want)
    x, al, r, i, h0 = _to_torch([jx, jal, jr, ji, jh0])
    y, _ = ref.rglru_scan_plain(x, al, r, i, h0)
    dx, dal, dr, di, dh0 = ref.rglru_scan_bwd_plain(x, al, r, i, h0, y,
                                                    *_to_torch([jdy, jdh]))
    for g in (dx, dal, dr, di, dh0):
        assert bool(torch.isfinite(g).all())
    # b = 0: no gradient reaches x or i; h passes through unscaled
    assert dx.abs().max() == 0 and di.abs().max() == 0
    np.testing.assert_allclose(dh0.numpy(), np.asarray(want[4]), rtol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=str)
def test_rglru_function_matches_jax_grad(dtype):
    """RGLRUScan's gradients (plain and device-dispatched halves alike on
    the CPU) against jax.grad of a loss that reads y and h_T."""
    (jx, jal, jr, ji, jh0), (jdy, jdh) = _rglru_arrays(2, 21, 16, dtype,
                                                       "random", seed=3)

    def jloss(x, al, r, i, h0):
        y, h = jref.rglru_scan_ref(x, al, r, i, h0)
        return jnp.sum(y * jdy) + jnp.sum(h * jdh)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(jx, jal, jr, ji, jh0)
    dy, dh = _to_torch([jdy, jdh])
    for plain in (True, False):
        leaves = [t.requires_grad_() for t in _to_torch([jx, jal, jr, ji, jh0])]
        y, h = RGLRUScan.apply(*leaves, plain)
        loss = (y * dy).sum() + (h * dh).sum()
        got = torch.autograd.grad(loss, leaves)
        _assert_grads_close(got, want, RGLRU_TOL, f"RGLRUScan plain={plain}")


# (B, T, W, input dtype, a_log): T of one step, below, at and past K2b's
# 32-step chunk, and several chunks with a ragged last one
RGLRU_CHUNKED_CASES = [
    (2, 1, 16, jnp.float32, "random"),
    (2, 31, 16, jnp.float32, "random"),
    (1, 32, 24, jnp.float32, "random"),
    (2, 33, 16, jnp.float32, "random"),
    (3, 100, 16, jnp.float32, "random"),
    (2, 70, 16, jnp.bfloat16, "random"),
    (2, 70, 16, jnp.float32, "near_0"),
    (2, 70, 16, jnp.float32, "near_1"),
]


@pytest.mark.parametrize("case", RGLRU_CHUNKED_CASES, ids=str)
def test_rglru_bwd_chunked_scheme_matches_plain_and_jax(case):
    """K2b's scheme (chunk maps, reverse carry, rescan, ordered da_log sum)
    against the sequential plain backward and jax.vjp of the oracle, both
    within RGLRU_TOL: the carries regroup the products and sums."""
    B, T, W, dtype, decay = case
    (jx, jal, jr, ji, jh0), (jdy, jdh) = _rglru_arrays(B, T, W, dtype, decay,
                                                       seed=T)
    _, vjp = jax.vjp(jref.rglru_scan_ref, jx, jal, jr, ji, jh0)
    want = vjp((jdy, jdh))
    x, al, r, i, h0 = _to_torch([jx, jal, jr, ji, jh0])
    y, _ = ref.rglru_scan_plain(x, al, r, i, h0)
    args = (x, al, r, i, h0, y, *_to_torch([jdy, jdh]))
    got = ref.rglru_scan_bwd_chunked_plain(*args)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _assert_grads_close(got, want, RGLRU_TOL, "rglru chunked vs jax")
    plain = ref.rglru_scan_bwd_plain(*args)
    _assert_grads_close(got, [np.asarray(p.float()).astype(w.dtype)
                              for p, w in zip(plain, want)],
                        RGLRU_TOL, "rglru chunked vs plain")


@pytest.mark.parametrize("chunk,quarters", [(32, 4), (8, 4), (4, 1)])
def test_rglru_bwd_chunked_scheme_takes_the_clamp(chunk, quarters):
    """r = 0 on every third step gives a_t = 1 there (b_t = 0, the clamped
    branch): the scheme gives the plain backward's finite gradients, with
    no gradient to x or i at those steps."""
    (jx, jal, jr, ji, jh0), (jdy, jdh) = _rglru_arrays(2, 45, 8, jnp.float32,
                                                       "random", seed=9)
    x, al, r, i, h0 = _to_torch([jx, jal, jr, ji, jh0])
    r[:, ::3] = 0.0
    y, _ = ref.rglru_scan_plain(x, al, r, i, h0)
    args = (x, al, r, i, h0, y, *_to_torch([jdy, jdh]))
    got = ref.rglru_scan_bwd_chunked_plain(*args, chunk=chunk,
                                           quarters=quarters)
    want = ref.rglru_scan_bwd_plain(*args)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert got[0][:, ::3].abs().max() == 0 and got[3][:, ::3].abs().max() == 0
    _assert_grads_close(got, [w.numpy() for w in want], RGLRU_TOL,
                        "rglru chunked clamp")


# --------------------------------------------------------------------------- #
# The WKV                                                                     #
# --------------------------------------------------------------------------- #
# (B, T, H, hd, input dtype of r, k, v and u, decays)
WKV_BWD_CASES = [
    (1, 1, 1, 8, jnp.float32, "random"),
    (2, 9, 2, 16, jnp.float32, "random"),
    (1, 37, 3, 8, jnp.float32, "random"),
    (2, 20, 2, 16, jnp.bfloat16, "random"),
    (1, 12, 2, 8, jnp.float32, "zero"),
    (1, 12, 2, 8, jnp.float32, "one"),
    # exp(-exp(3 z)): 0 for some steps, within fp32 of 1 for others
    (1, 21, 2, 8, jnp.float32, "mixed"),
]


def _wkv_arrays(B, T, H, hd, dtype, decay, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    shape = (B, T, H, hd)
    w = {"random": _sigmoid(n(*shape)), "zero": np.zeros(shape, np.float32),
         "one": np.ones(shape, np.float32),
         "mixed": np.exp(-np.exp(3 * n(*shape))).astype(np.float32),
         "rows": _sigmoid(n(*shape))}[decay]
    if decay == "rows":   # state row 0 never survives a step, row 1 never decays
        w[..., 0], w[..., 1] = 0.0, 1.0
    arrays = _to_jax([n(*shape), n(*shape), n(*shape), w, n(H, hd) * 0.5,
                      n(B, H, hd, hd)],
                     [dtype, dtype, dtype, jnp.float32, dtype, jnp.float32])
    cot = _to_jax([n(*shape), n(B, H, hd, hd)], [jnp.float32] * 2)
    return arrays, cot


@pytest.mark.parametrize("case", WKV_BWD_CASES, ids=str)
def test_rwkv6_bwd_plain_matches_jax_vjp(case):
    B, T, H, hd, dtype, decay = case
    arrays, (jdy, jds) = _wkv_arrays(B, T, H, hd, dtype, decay)
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *arrays)
    want = vjp((jdy, jds))
    inputs = _to_torch(arrays)
    cot = _to_torch([jdy, jds])
    got = ref.rwkv6_scan_bwd_plain(*inputs, *cot)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _assert_grads_close(got, want, WKV_TOL, "rwkv6")
    again = ops.rwkv6_scan_bwd(*inputs, *cot)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=str)
def test_wkv_function_matches_jax_grad(dtype):
    arrays, (jdy, jds) = _wkv_arrays(2, 19, 2, 16, dtype, "random", seed=4)

    def jloss(*a):
        y, s = jref.rwkv6_scan_ref(*a)
        return jnp.sum(y * jdy) + jnp.sum(s * jds)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*arrays)
    dy, ds = _to_torch([jdy, jds])
    for plain in (True, False):
        leaves = [t.requires_grad_() for t in _to_torch(arrays)]
        y, s = WKVScan.apply(*leaves, plain)
        loss = (y * dy).sum() + (s * ds).sum()
        got = torch.autograd.grad(loss, leaves)
        _assert_grads_close(got, want, WKV_TOL, f"WKVScan plain={plain}")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=str)
@pytest.mark.parametrize("T", [1, 63, 64, 65, 131, 200])
def test_rwkv6_bwd_chunked_scheme_matches_plain_and_jax(T, dtype):
    """K3b's chunk-parallel scheme at its own chunk (64) and sub-chunk (16):
    T of one step, below, at and past one chunk, and several chunks with a
    ragged last one; state row 0 has w = 0 (dividing by w would fail) and
    row 1 w = 1. Held against the sequential plain backward and jax.vjp of
    the oracle, within WKV_TOL."""
    arrays, cot = _wkv_arrays(2, T, 2, 8, dtype, "rows", seed=T)
    _, vjp = jax.vjp(jref.rwkv6_scan_ref, *arrays)
    want = vjp(tuple(cot))
    inputs, tcot = _to_torch(arrays), _to_torch(cot)
    got = ref.rwkv6_scan_bwd_chunked_plain(*inputs, *tcot)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)
    _assert_grads_close(got, want, WKV_TOL, "rwkv6 chunked vs jax")
    plain = ref.rwkv6_scan_bwd_plain(*inputs, *tcot)
    _assert_grads_close(got, [np.asarray(p.float()).astype(w.dtype)
                              for p, w in zip(plain, want)],
                        WKV_TOL, "rwkv6 chunked vs plain")


@pytest.mark.parametrize("chunk,sub", [(64, 16), (16, 4), (12, 3), (4, 1)])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 50])
def test_rwkv6_bwd_checkpoint_scheme_matches_sequential(T, chunk, sub):
    """K3b's scheme (chunk states and end cotangents from the carries, each
    chunk walked on its own) at other chunk and sub-chunk lengths, ragged T
    too, bf16 inputs and decays of every size: within
    WKV_TOL of the sequential plain backward (the chunk states and
    cotangents regroup its sums, so the bits differ); with a single chunk
    (T <= chunk) the states are the plain version's, and dr, dk, dv, dw
    its bits."""
    arrays, cot = _wkv_arrays(2, T, 3, 8, jnp.bfloat16, "mixed", seed=T)
    inputs, cot = _to_torch(arrays), _to_torch(cot)
    want = ref.rwkv6_scan_bwd_plain(*inputs, *cot)
    got = ref.rwkv6_scan_bwd_chunked_plain(*inputs, *cot, chunk=chunk, sub=sub)
    _assert_grads_close(got, [np.asarray(w.float()).astype(
        jnp.bfloat16 if w.dtype == torch.bfloat16 else np.float32)
        for w in want], WKV_TOL, f"chunk {chunk} sub {sub}")
    if T <= chunk:
        for n in range(4):
            assert torch.equal(got[n], want[n])


def test_scan_backwards_leave_their_inputs_alone():
    (jx, jal, jr, ji, jh0), (jdy, jdh) = _rglru_arrays(1, 6, 8, jnp.float32,
                                                       "random")
    x, al, r, i, h0 = _to_torch([jx, jal, jr, ji, jh0])
    y, _ = ref.rglru_scan_plain(x, al, r, i, h0)
    args = (x, al, r, i, h0, y, *_to_torch([jdy, jdh]))
    copies = [a.clone() for a in args]
    ref.rglru_scan_bwd_plain(*args)
    ref.rglru_scan_bwd_chunked_plain(*args)
    assert all(torch.equal(a, c) for a, c in zip(args, copies))
    arrays, cot = _wkv_arrays(1, 6, 2, 8, jnp.float32, "random")
    args = (*_to_torch(arrays), *_to_torch(cot))
    copies = [a.clone() for a in args]
    ref.rwkv6_scan_bwd_plain(*args)
    ref.rwkv6_scan_bwd_chunked_plain(*args)
    assert all(torch.equal(a, c) for a, c in zip(args, copies))


@pytest.mark.parametrize("source,module,names", [
    ("wkv6_bwd.cu", "rwkv6_bwd", ("L", "SUB")),
    ("wkv6_chunk.cu", "rwkv6", ("L", "SUB")),
    ("rglru_bwd.cu", "rglru_bwd", ("L", "SUB")),
])
def test_wrapper_steps_match_the_kernel_source(source, module, names):
    """The wrappers size their scratch buffers by CHUNK and SUB, which must
    be the kernel's constants (the library is checked again when it loads,
    through its steps query)."""
    import importlib
    import re

    from repro_torch.kernels import build
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    text = (build.CSRC / source).read_text()
    got = tuple(int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
                for n in names)
    assert got == (mod.CHUNK, mod.SUB)


@pytest.mark.parametrize("library,ok", [((64, 16), True), ((16, 16), False),
                                        ((64, 4), False)])
def test_check_steps_raises_when_library_and_wrapper_differ(library, ok,
                                                            monkeypatch):
    from repro_torch.kernels import build

    def query(steps, sub):
        steps._obj.value, sub._obj.value = library
        return 0
    monkeypatch.setattr(build, "entry", lambda name, argtypes: query)
    if ok:
        build.check_steps("wkv6_scan_bwd_steps", (64, 16))
    else:
        with pytest.raises(RuntimeError, match="wkv6_scan_bwd"):
            build.check_steps("wkv6_scan_bwd_steps", (64, 16))
