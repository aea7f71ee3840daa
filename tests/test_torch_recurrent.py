"""The port's recurrent layer kinds against the JAX package's on the CPU, in
fp32: ``rec`` (recurrentgemma's RG-LRU, K2) and ``rwkv`` (RWKV-6's WKV, K3).

Inputs are made with numpy from a seed and handed to both packages; the
backbones get the JAX init grafted through repro_torch.bridge, with its zero
leaves perturbed so that u, w0, the LoRAs and the norm scales are exercised.
The CUDA kernels themselves are held against the plain versions on the card
in tests/test_torch_gpu.py and chip_smoke.py.

Tolerances (atol = rtol): the scans at the JAX tests' own limits, 1e-5 for
the RG-LRU and 2e-4 for the WKV (one sequential fp32 recurrence against
another; the bf16 cases too, since both sides see the same bf16 values and
compute in fp32); the blocks 1e-5, time mixing 1e-4 (its scan sums in
another order); logits, caches and decode steps of the reduced stacks 1e-4
(as tests/test_torch_models.py); decode against a longer prefill 2e-3 (as
tests/test_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Backbone as JBackbone
from repro.models import LayerGroup as JLayerGroup
from repro.models import get_config as jget_config
from repro.models import reduced as jreduced
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv6
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import Server as JServer
from repro_torch import bridge
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru as krglru
from repro_torch.kernels import rwkv6 as krwkv6
from repro_torch.models import Backbone, LayerGroup, get_config, reduced
from repro_torch.models import rglru, rwkv6
from repro_torch.obs import metrics
from repro_torch.runtime.serve_loop import Request, Server, _merge_slot
from test_kernels import RGLRU_CASES, RWKV_CASES


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _pair(arrays, dtype):
    """The same values for both packages: (jax arrays in ``dtype``, torch
    tensors holding exactly those values)."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jx, [torch.from_numpy(np.array(a, np.float32)).to(tdt) for a in jx]


def _sigmoid(a):
    return (1.0 / (1.0 + np.exp(-a))).astype(np.float32)


# --------------------------------------------------------------------------- #
# The scans: plain versions against the JAX oracles and Pallas interpret mode  #
# --------------------------------------------------------------------------- #
def _rglru_inputs(B, T, W, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    (jx, jgr, jgi), (tx, tgr, tgi) = _pair(
        [n(B, T, W), _sigmoid(n(B, T, W)), _sigmoid(n(B, T, W))], dtype)
    (jal, jh0), (tal, th0) = _pair([n(W), n(B, W)], jnp.float32)
    return (jx, jal, jgr, jgi, jh0), (tx, tal, tgr, tgi, th0)


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_rglru_plain_matches_jax(case):
    B, T, W, bt, bw, dtype = case
    jargs, targs = _rglru_inputs(B, T, W, dtype)
    y_ref, h_ref = jref.rglru_scan_ref(*jargs)
    y_pal, h_pal = jops.rglru_scan(*jargs, impl="pallas", block_t=bt,
                                   block_w=bw)
    y, h = ops.rglru_scan(*targs)
    assert y.dtype == h.dtype == torch.float32 and y.shape == (B, T, W)
    for want_y, want_h in ((y_ref, h_ref), (y_pal, h_pal)):
        _close(y, want_y, 1e-5)
        _close(h, want_h, 1e-5)


def _wkv_inputs(B, T, H, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    (jr, jk, jv, jw), (tr, tk, tv, tw) = _pair(
        [n(B, T, H, hd), n(B, T, H, hd), n(B, T, H, hd),
         _sigmoid(n(B, T, H, hd))], dtype)
    (ju, js), (tu, ts) = _pair([n(H, hd), n(B, H, hd, hd)], jnp.float32)
    return (jr, jk, jv, jw, ju, js), (tr, tk, tv, tw, tu, ts)


@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_plain_matches_jax(case):
    B, T, H, hd, block_t, dtype = case
    jargs, targs = _wkv_inputs(B, T, H, hd, dtype)
    y_ref, s_ref = jref.rwkv6_scan_ref(*jargs)
    y_pal, s_pal = jops.rwkv6_scan(*jargs, impl="pallas", block_t=block_t)
    y, s = ops.rwkv6_scan(*targs)
    assert y.dtype == s.dtype == torch.float32 and y.shape == (B, T, H, hd)
    for want_y, want_s in ((y_ref, s_ref), (y_pal, s_pal)):
        _close(y, want_y, 2e-4)
        _close(s, want_s, 2e-4)


def test_rwkv6_state_chaining():
    """Two half-sequences that hand the state on equal one full run, and
    JAX's full run."""
    jargs, (r, k, v, w, u, s0) = _wkv_inputs(1, 40, 2, 16, jnp.float32, 1)
    y_jax, s_jax = jref.rwkv6_scan_ref(*jargs)
    y1, s1 = ops.rwkv6_scan(r[:, :20], k[:, :20], v[:, :20], w[:, :20], u, s0)
    y2, s2 = ops.rwkv6_scan(r[:, 20:], k[:, 20:], v[:, 20:], w[:, 20:], u, s1)
    _close(torch.cat([y1, y2], dim=1), y_jax, 2e-4)
    _close(s2, s_jax, 2e-4)


def test_scans_write_the_state_in_place():
    """Decode hands the cache's state as both input and output."""
    _, (x, al, gr, gi, h0) = _rglru_inputs(2, 9, 32, jnp.float32, 2)
    y, h = ops.rglru_scan(x, al, gr, gi, h0)
    buf = h0.clone()
    y2, h2 = ops.rglru_scan(x, al, gr, gi, buf, h_out=buf)
    assert h2 is buf
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(buf, h, atol=0, rtol=0)
    _, (r, k, v, w, u, s0) = _wkv_inputs(2, 7, 2, 8, jnp.float32, 3)
    y, s = ops.rwkv6_scan(r, k, v, w, u, s0)
    buf = s0.clone()
    y2, s2 = ops.rwkv6_scan(r, k, v, w, u, buf, state_out=buf)
    assert s2 is buf
    torch.testing.assert_close(y2, y, atol=0, rtol=0)
    torch.testing.assert_close(buf, s, atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_versions():
    _, targs = _rglru_inputs(1, 4, 16, jnp.float32)
    _, wargs = _wkv_inputs(1, 4, 2, 8, jnp.float32)
    ledger = metrics.registry("dispatch")
    before = ledger.snapshot()
    torch.testing.assert_close(ops.rglru_scan(*targs)[0],
                               ref.rglru_scan_plain(*targs)[0], atol=0, rtol=0)
    torch.testing.assert_close(ops.rwkv6_scan(*wargs)[0],
                               ref.rwkv6_scan_plain(*wargs)[0], atol=0, rtol=0)
    assert ledger.snapshot() == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        krglru.rglru_scan(*targs)
    with pytest.raises(ValueError, match="CUDA tensors"):
        krwkv6.wkv6_scan(*wargs)
    with pytest.raises(ValueError, match="one device"):
        ops.rglru_scan(*targs[:4], torch.zeros(1, 16, device="meta"))


def _bad_rglru():
    x, a, g, h0 = (torch.zeros(2, 5, 32), torch.zeros(32), torch.zeros(2, 5, 32),
                   torch.zeros(2, 32))
    ok = dict(x=x, a_log=a, gate_r=g, gate_i=g, h0=h0, h_out=None)
    return {
        "fp16": dict(ok, x=x.half(), gate_r=g.half(), gate_i=g.half()),
        "mixed x and gates": dict(ok, gate_r=g.bfloat16()),
        "bf16 h0": dict(ok, h0=h0.bfloat16()),
        "fp16 a_log": dict(ok, a_log=a.half()),
        "gates of another shape": dict(ok, gate_i=torch.zeros(2, 4, 32)),
        "a_log of another width": dict(ok, a_log=torch.zeros(31)),
        "h0 of another batch": dict(ok, h0=torch.zeros(1, 32)),
        "empty time": dict(ok, x=x[:, :0], gate_r=g[:, :0], gate_i=g[:, :0]),
        "non-contiguous x": dict(ok, x=torch.zeros(2, 32, 5).transpose(1, 2)),
        "h_out of another shape": dict(ok, h_out=torch.zeros(2, 31)),
    }


def _bad_wkv():
    r, u, s = torch.zeros(1, 4, 2, 16), torch.zeros(2, 16), torch.zeros(1, 2, 16, 16)
    ok = dict(r=r, k=r, v=r, w=r, u=u, state=s, state_out=None)
    big = torch.zeros(1, 4, 2, 72)
    return {
        "fp16": dict(ok, r=r.half(), k=r.half(), v=r.half()),
        "mixed r, k, v": dict(ok, v=r.bfloat16()),
        "bf16 state": dict(ok, state=s.bfloat16()),
        "fp16 w": dict(ok, w=r.half()),
        "bf16 w": dict(ok, w=r.bfloat16()),
        "hd above 64": dict(ok, r=big, k=big, v=big, w=big,
                            u=torch.zeros(2, 72), state=torch.zeros(1, 2, 72, 72)),
        "u of another head count": dict(ok, u=torch.zeros(3, 16)),
        "state of another batch": dict(ok, state=torch.zeros(2, 2, 16, 16)),
        "non-contiguous k": dict(ok, k=torch.zeros(1, 2, 4, 16).transpose(1, 2)),
        "state_out of another dtype": dict(ok, state_out=s.double()),
    }


@pytest.mark.parametrize("name", list(_bad_rglru()))
def test_rglru_wrapper_rejects(name):
    with pytest.raises(ValueError):
        krglru.check_inputs(**_bad_rglru()[name])


@pytest.mark.parametrize("name", list(_bad_wkv()))
def test_wkv_wrapper_rejects(name):
    with pytest.raises(ValueError):
        krwkv6.check_inputs(**_bad_wkv()[name])


# --------------------------------------------------------------------------- #
# The blocks                                                                   #
# --------------------------------------------------------------------------- #
def _np_params(shapes, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in shapes.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_causal_conv1d_matches_jax():
    jp, tp = _both(_np_params({"conv_w": (4, 24), "conv_b": (24,)}, 0))
    rng = np.random.default_rng(1)
    for T in (1, 2, 9):
        x = rng.standard_normal((2, T, 24)).astype(np.float32)
        st = rng.standard_normal((2, 3, 24)).astype(np.float32)
        jy, js = jrglru.causal_conv1d(jp, jnp.asarray(x), jnp.asarray(st))
        ty, ts = rglru.causal_conv1d(tp, torch.from_numpy(x), torch.from_numpy(st))
        _close(ty, jy, 1e-5)
        _close(ts, js, 1e-5)


def _tmix_shapes(D, H, hd):
    Dr = H * hd
    shapes = {"dd_a": (D, 32), "w_r": (D, Dr), "w_k": (D, Dr), "w_v": (D, Dr),
              "w_g": (D, Dr), "w0": (Dr,), "wd_a": (D, 64), "wd_b": (64, Dr),
              "u": (Dr,), "ln_x": (Dr,), "w_o": (Dr, D)}
    for n in "rkvgw":
        shapes[f"mu_{n}"] = (D,)
        shapes[f"dd_b_{n}"] = (32, D)
    return shapes


@pytest.mark.parametrize("T", [1, 11])
def test_time_mix_matches_jax(T):
    B, D, H, hd = 2, 32, 2, 16
    jp, tp = _both(_np_params(_tmix_shapes(D, H, hd), 2, 0.2))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    sh = rng.standard_normal((B, D)).astype(np.float32)
    wkv = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    jy, js, jw = jrwkv6.time_mix(jp, jnp.asarray(x), jnp.asarray(sh),
                                 jnp.asarray(wkv), H, hd)
    ty, ts, tw = rwkv6.time_mix(tp, torch.from_numpy(x), torch.from_numpy(sh),
                                torch.from_numpy(wkv), H, hd)
    _close(ty, jy, 1e-4)
    _close(ts, js, 1e-5)
    _close(tw, jw, 1e-4)


def test_time_mix_promotes_like_jax_in_bf16():
    """The scan's fp32 y meets the bf16 gate: JAX computes y * g and @ w_o
    in fp32, and so does the port (torch would raise on fp32 @ bf16)."""
    B, T, D, H, hd = 1, 5, 32, 2, 16
    p = _np_params(_tmix_shapes(D, H, hd), 4, 0.2)
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).bfloat16()
          for k, v in jp.items()}
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, T, D))).astype(jnp.bfloat16)
    sh = jnp.zeros((B, D), jnp.bfloat16)
    wkv = jnp.zeros((B, H, hd, hd), jnp.float32)
    jy, _, _ = jrwkv6.time_mix(jp, x, sh, wkv, H, hd)
    ty, _, _ = rwkv6.time_mix(tp, torch.from_numpy(np.array(x, np.float32)).bfloat16(),
                              torch.zeros(B, D, dtype=torch.bfloat16),
                              torch.zeros(B, H, hd, hd), H, hd)
    assert jy.dtype == jnp.float32 and ty.dtype == torch.float32
    # both round the same fp32 chain at other places in bf16: a few ulps
    _close(ty, jy, 5e-2)


def test_channel_mix_matches_jax():
    D, F = 32, 48
    jp, tp = _both(_np_params({"mu_k": (D,), "mu_r": (D,), "w_in": (D, F),
                               "w_out": (F, D), "w_rgate": (D, D)}, 6))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, D)).astype(np.float32)
    sh = rng.standard_normal((2, D)).astype(np.float32)
    jy, js = jrwkv6.channel_mix(jp, jnp.asarray(x), jnp.asarray(sh))
    ty, ts = rwkv6.channel_mix(tp, torch.from_numpy(x), torch.from_numpy(sh))
    _close(ty, jy, 1e-5)
    _close(ts, js, 1e-5)


# --------------------------------------------------------------------------- #
# Reduced recurrentgemma ((rec, rec, local) + (rec), window 32) and a         #
# 3-layer stacked rwkv6                                                        #
# --------------------------------------------------------------------------- #
ARCHS = {"recurrentgemma-9b": None, "rwkv6-3b": (("rwkv",), 3)}
CTX = 64


def _configs(arch):
    g = ARCHS[arch]
    jkw = {} if g is None else {"groups": (JLayerGroup(*g),)}
    tkw = {} if g is None else {"groups": (LayerGroup(*g),)}
    return jreduced(jget_config(arch), **jkw), reduced(get_config(arch), **tkw)


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    """(jax backbone, jax params, port backbone, port params), grafted."""
    jcfg, tcfg = _configs(request.param)
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=False)
    jparams = jbb.init(jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    rng = np.random.default_rng(4)
    leaves = [l + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
              if not np.any(np.asarray(l)) else l for l in leaves]
    jparams = jax.tree_util.tree_unflatten(treedef, leaves)
    tbb = Backbone(tcfg, compute_dtype=torch.float32, device="cpu")
    tparams = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    return jbb, jparams, tbb, tparams


def test_recurrent_configs_match_the_reference():
    for arch in ARCHS:
        jcfg, tcfg = _configs(arch)
        assert tcfg.layer_kinds() == jcfg.layer_kinds()
        assert tcfg.param_count() == jcfg.param_count()
    assert "local" in _configs("recurrentgemma-9b")[1].layer_kinds()
    assert _configs("recurrentgemma-9b")[1].attn_window == 32


def test_init_layout_matches_reference(pair):
    jbb, jparams, tbb, _ = pair
    mine = bridge.params_to_numpy(tbb.init(0))
    ref_tree = _np_tree(jparams)
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(ref_tree))
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_lru_init_puts_the_decay_where_the_reference_does():
    tbb = Backbone(_configs("recurrentgemma-9b")[1], device="cpu")
    a_log = tbb.init(3)["g0"]["s0"]["a_log"]
    decay = torch.nn.functional.softplus(a_log)
    assert 0.05 <= float(decay.min()) and float(decay.max()) <= 0.6


def _assert_caches_close(mine, ref_tree, tol):
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(ref_tree))
    flat_m = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_r = jax.tree_util.tree_leaves(ref_tree)
    for (path, a), b in zip(flat_m, flat_r):
        if jax.tree_util.keystr(path).endswith("['kpos']"):
            np.testing.assert_array_equal(a, b)
        else:
            _close(a, b, tol)


def test_prefill_caches_and_decode_match_jax(pair):
    """Prefill beyond the window (the local ring wraps), every cache leaf,
    then 4 decode steps."""
    jbb, jparams, tbb, tparams = pair
    rng = np.random.default_rng(5)
    B, S, N = 2, 40, 4
    toks = rng.integers(0, tbb.cfg.vocab, (B, S + N), dtype=np.int32)
    jlog, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                               CTX)
    tlog, tcache = tbb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])},
                               CTX)
    _close(tlog, jlog, 1e-4)
    mine = bridge.cache_to_numpy(tcache)
    assert int(mine["pos"]) == int(jcache["pos"]) == S
    _assert_caches_close(mine, _np_tree(jcache), 1e-4)
    jdec = jax.jit(jbb.decode_step)
    for i in range(N):
        tok = toks[:, S + i:S + i + 1]
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tbb.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, 1e-4)
    assert tcache["pos"] == S + N
    _assert_caches_close(bridge.cache_to_numpy(tcache), _np_tree(jcache), 1e-4)


def test_decode_from_a_grafted_jax_cache(pair):
    jbb, jparams, tbb, tparams = pair
    toks = np.random.default_rng(9).integers(0, tbb.cfg.vocab, (2, 36),
                                             dtype=np.int32)
    _, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :35])}, CTX)
    tcache = bridge.cache_from_numpy(_np_tree(jcache), device="cpu")
    jlog, _ = jbb.decode_step(jparams, jcache, jnp.asarray(toks[:, 35:]))
    tlog, _ = tbb.decode_step(tparams, tcache, torch.from_numpy(toks[:, 35:]))
    _close(tlog, jlog, 1e-4)


def test_decode_matches_longer_prefill(pair):
    _, _, tbb, tparams = pair
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tbb.cfg.vocab, (2, 42), dtype=np.int32))
    _, cache = tbb.prefill(tparams, {"tokens": toks[:, :41]}, CTX)
    got, cache = tbb.decode_step(tparams, cache, toks[:, 41:])
    want, _ = tbb.prefill(tparams, {"tokens": toks}, CTX)
    _close(got, want, 2e-3)
    assert cache["pos"] == 42


def test_plain_switch_gives_the_same_logits_on_the_cpu(pair):
    """kernel_impl='plain' calls the plain versions directly; on the CPU the
    dispatch picks them too, so the two paths agree exactly."""
    _, _, tbb, tparams = pair
    plain = Backbone(tbb.cfg, compute_dtype=torch.float32, device="cpu",
                     kernel_impl="plain")
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tbb.cfg.vocab, (1, 12), dtype=np.int32))
    a, _ = tbb.prefill(tparams, {"tokens": toks}, CTX)
    b, _ = plain.prefill(tparams, {"tokens": toks}, CTX)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="kernel_impl"):
        Backbone(tbb.cfg, device="cpu", kernel_impl="triton")


def test_merge_slot_merges_the_recurrent_state(pair):
    """Every rec and rwkv cache leaf is batch-major: a batch-1 prefill cache
    lands in slot i whole, the other slots are untouched."""
    _, _, tbb, tparams = pair
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, tbb.cfg.vocab, (1, 9), dtype=np.int32))
    _, one = tbb.prefill(tparams, {"tokens": toks}, CTX)
    cache = tbb.init_cache(3, CTX)
    _merge_slot(cache, one, 1)
    kinds = set()
    for gi, group in enumerate(tbb.cfg.groups):
        for si, kind in enumerate(group.pattern):
            kinds.add(kind)
            if kind not in ("rec", "rwkv"):
                continue
            for key, leaf in cache[f"g{gi}"][f"s{si}"].items():
                src = one[f"g{gi}"][f"s{si}"][key]
                assert leaf.shape[1] == 3 and src.shape[1] == 1
                torch.testing.assert_close(leaf[:, 1], src[:, 0], atol=0, rtol=0)
                assert leaf[:, 0].eq(0).all() and leaf[:, 2].eq(0).all()
                assert src[:, 0].ne(0).any()
    assert kinds & {"rec", "rwkv"}


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    """The JAX Server and the port's, on the same grafted parameters, with
    prompts longer than recurrentgemma's reduced window."""
    jcfg, tcfg = _configs(request.param)
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=False)
    jparams = jbb.init(jax.random.PRNGKey(1))
    tbb = Backbone(tcfg, compute_dtype=torch.float32, device="cpu")
    tparams = bridge.params_from_numpy(_np_tree(jparams), device="cpu")

    def requests(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, prompt=rng.integers(0, 512, 36, dtype=np.int32),
                    max_new=5) for i in range(5)]

    out = {}
    for name, srv, cls in (("jax", JServer(jbb, jparams, slots=2, ctx=CTX),
                            JRequest),
                           ("torch", Server(tbb, tparams, slots=2, ctx=CTX),
                            Request)):
        reqs = requests(cls)
        for r in reqs:
            srv.submit(r)
        srv.run(max_steps=200)
        out[name] = (srv, reqs)
    return out, tbb, tparams


def test_server_token_lists_match_jax(served):
    out, _, _ = served
    (jsrv, jreqs), (tsrv, treqs) = out["jax"], out["torch"]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tsrv.stats == jsrv.stats
    assert all(r.done.is_set() and len(r.out) == 5 for r in treqs)


def test_server_first_token_is_direct_prefill(served):
    out, tbb, tparams = served
    _, treqs = out["torch"]
    for r in treqs[:2]:
        logits, _ = tbb.prefill(tparams, {"tokens": torch.from_numpy(
            r.prompt[None, :])}, CTX)
        assert r.out[0] == int(torch.argmax(logits[0, -1, :tbb.cfg.vocab]))
