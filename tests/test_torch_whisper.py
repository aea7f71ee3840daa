"""Whisper-tiny (the ``enc`` and ``dec`` layer kinds) in the port against the
JAX package, on the CPU in fp32.

The reduced whisper-tiny has two encoder and two decoder layers here, so
the stacked [R, ...] leaves and the per-layer cross caches are exercised;
JAX's init is grafted through repro_torch.bridge with its zero leaves
perturbed (the norm scales and biases), as in
tests/test_torch_models.py::test_dense_arch_prefill_and_decode_match_jax.
Frames and tokens come from a seeded numpy generator.

Tolerances, as tests/test_torch_models.py states them: 1e-4 for the
encoder's output, logits and caches (the port's attention is the unchunked
softmax, JAX's the chunked online one), 2e-3 for decode against a longer
prefill; the loss within 1e-5 and each gradient leaf within 1e-4 of its
largest entry (tests/test_torch_train.py). K1's and K1b's plain versions at
cross-attention shapes (Sq != Skv, not causal): 1e-5 against the Pallas
kernel in interpret mode and against ``jax.vjp(flash_attention_jnp)``
(tests/test_torch_kernels.py, tests/test_torch_flash_bwd.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import Backbone as JBackbone
from repro.models import LayerGroup as JLayerGroup
from repro.models import get_config as jget_config
from repro.models import reduced as jreduced
from repro.models.attention import flash_attention_jnp
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import Server as JServer
from repro_torch import bridge
from repro_torch.kernels import ref
from repro_torch.models import Backbone, LayerGroup, get_config, reduced
from repro_torch.runtime.serve_loop import Request, Server
from repro_torch.runtime.steps import value_and_grad

CTX = 40
B, S, N = 2, 11, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _frames(cfg, batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, batch, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (batch, n),
                                                dtype=np.int32)


def _pair(remat=False):
    """(jax backbone, jax params, port backbone, port params), grafted."""
    jcfg = jreduced(jget_config("whisper-tiny"),
                    groups=(JLayerGroup(("enc",), 2), JLayerGroup(("dec",), 2)))
    tcfg = reduced(get_config("whisper-tiny"),
                   groups=(LayerGroup(("enc",), 2), LayerGroup(("dec",), 2)))
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=remat)
    leaves, treedef = jax.tree_util.tree_flatten(
        jbb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    leaves = [l + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
              if not np.any(np.asarray(l)) else l for l in leaves]
    jparams = jax.tree_util.tree_unflatten(treedef, leaves)
    tbb = Backbone(tcfg, compute_dtype=torch.float32, remat=remat,
                   device="cpu")
    tparams = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    return jbb, jparams, tbb, tparams


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both packages' prefill of S tokens over the same frames."""
    jbb, jparams, tbb, tparams = pair
    toks = _tokens(tbb.cfg, B, S + N, 5)
    frames = _frames(tbb.cfg, B, 6)
    jlog, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S]),
                                         "enc_frames": jnp.asarray(frames)},
                               CTX)
    tlog, tcache = tbb.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :S]), "enc_frames": torch.from_numpy(frames)}, CTX)
    return toks, frames, (jlog, jcache), (tlog, tcache)


def test_init_layout_matches_reference(pair):
    _, jparams, tbb, _ = pair
    mine = bridge.params_to_numpy(tbb.init(0))
    want = _np_tree(jparams)
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    cfg = tbb.cfg
    assert mine["embed"]["enc_pos"].shape == (cfg.enc_seq, cfg.d_model)
    assert "ln_cross" in mine["g1"]["s0"] and "c_wq" in mine["g1"]["s0"]
    assert "ln_cross" not in mine["g0"]["s0"]
    assert mine["g1"]["s0"]["c_wk"].shape[0] == 2


def test_encoder_output_matches_jax(pair):
    jbb, jparams, tbb, tparams = pair
    frames = _frames(tbb.cfg, B, 7)
    want = jbb._encode(jparams, jnp.asarray(frames))
    got = tbb._encode(tparams, torch.from_numpy(frames), remat=False)
    assert got.shape == (B, tbb.cfg.enc_seq, tbb.cfg.d_model)
    _close(got, want, 1e-4)


def test_prefill_logits_and_every_cache_leaf_match_jax(prefilled):
    _, _, (jlog, jcache), (tlog, tcache) = prefilled
    _close(tlog, jlog, 1e-4)
    mine, want = bridge.cache_to_numpy(tcache), _np_tree(jcache)
    # the encoder's group holds no cache, in both packages
    assert "g0" not in mine and "g0" not in want
    assert set(mine["g1"]["s0"]) == {"k", "v", "kpos", "ck", "cv"}
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(want))
    assert int(mine["pos"]) == int(want["pos"]) == S
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(mine)[0],
                            jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        if jax.tree_util.keystr(path).endswith("['kpos']"):
            np.testing.assert_array_equal(a, b)
        else:
            _close(a, b, 1e-4)


def test_decode_steps_match_jax(pair, prefilled):
    jbb, jparams, tbb, tparams = pair
    toks, _, (_, jcache), (_, tcache) = prefilled
    tcache = bridge.cache_from_numpy(bridge.cache_to_numpy(tcache),
                                     device="cpu")  # the fixture's stays
    jdec = jax.jit(jbb.decode_step)
    for i in range(N):
        tok = toks[:, S + i:S + i + 1]
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tbb.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, 1e-4)
    mine, want = bridge.cache_to_numpy(tcache), _np_tree(jcache)
    for key in ("k", "v", "ck", "cv"):
        _close(mine["g1"]["s0"][key], want["g1"]["s0"][key], 1e-4)
    np.testing.assert_array_equal(mine["g1"]["s0"]["kpos"],
                                  want["g1"]["s0"]["kpos"])
    assert tcache["pos"] == S + N


def test_decode_from_a_grafted_jax_cache(pair, prefilled):
    jbb, jparams, tbb, tparams = pair
    toks, _, (_, jcache), _ = prefilled
    tcache = bridge.cache_from_numpy(_np_tree(jcache), device="cpu")
    assert tcache["pos"] == S
    tok = toks[:, S:S + 1]
    jlog, _ = jbb.decode_step(jparams, jcache, jnp.asarray(tok))
    tlog, _ = tbb.decode_step(tparams, tcache, torch.from_numpy(tok))
    _close(tlog, jlog, 1e-4)


def test_decode_matches_longer_prefill(pair):
    """decode(t_{S+1} | prefill(S)) == prefill(S+1) over the same frames."""
    _, _, tbb, tparams = pair
    toks = torch.from_numpy(_tokens(tbb.cfg, B, S + 1, 8))
    frames = torch.from_numpy(_frames(tbb.cfg, B, 9))
    _, cache = tbb.prefill(tparams, {"tokens": toks[:, :S],
                                     "enc_frames": frames}, CTX)
    got, cache = tbb.decode_step(tparams, cache, toks[:, S:])
    want, _ = tbb.prefill(tparams, {"tokens": toks, "enc_frames": frames},
                          CTX)
    _close(got, want, 2e-3)
    assert cache["pos"] == S + 1


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(remat):
    jbb, jparams, tbb, tparams = _pair(remat)
    toks = _tokens(tbb.cfg, B, S + 1, 10)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:],
             "enc_frames": _frames(tbb.cfg, B, 11)}
    jloss, jgrads = jax.value_and_grad(jbb.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = value_and_grad(tbb, tparams, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    mine, want = bridge.params_to_numpy(tgrads), _np_tree(jgrads)
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(want))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(mine)[0],
                            jax.tree_util.tree_leaves(want)):
        scale = max(float(np.abs(b).max()), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    # the cross leaves and the encoder's positions take gradient
    assert np.abs(mine["embed"]["enc_pos"]).max() > 0
    assert np.abs(mine["g1"]["s0"]["c_wk"]).max() > 0


# --------------------------------------------------------------------------- #
# K1 and K1b's plain versions at whisper's attention shapes                    #
# --------------------------------------------------------------------------- #
# (B, Sq, Skv, Hq, Hkv, hd): cross (Sq != Skv both ways) and the encoder's
# self-attention, non-causal; ragged against the 8- and 16-wide blocks
CROSS = [(2, 24, 40, 6, 6, 16), (1, 9, 37, 4, 2, 8), (2, 40, 24, 6, 6, 16),
         (1, 1, 45, 6, 6, 16), (2, 29, 29, 6, 6, 16)]


def _attn_inputs(shape, seed):
    Bq, Sq, Skv, Hq, Hkv, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bq, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Skv, Hkv, hd)).astype(np.float32)
    dout = rng.standard_normal((Bq, Sq, Hq, hd)).astype(np.float32)
    return q, k, v, dout


def _positions(shape):
    return dict(q_positions=torch.arange(shape[1], dtype=torch.int32),
                kv_positions=torch.arange(shape[2], dtype=torch.int32))


@pytest.mark.parametrize("shape", CROSS)
def test_plain_attention_matches_pallas_interpret_across(shape):
    q, k, v, _ = _attn_inputs(shape, 20)
    want = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=False, block_q=8,
                                  block_k=16, interpret=True)
    got = ref.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False,
                              **_positions(shape))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("shape", CROSS)
def test_plain_backward_matches_jax_vjp_across(shape):
    q, k, v, dout = _attn_inputs(shape, 21)
    jout, vjp = jax.vjp(
        lambda a, b, c: flash_attention_jnp(a, b, c, causal=False, q_chunk=8,
                                            kv_chunk=16),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=False, **_positions(shape))
    out, lse = ref.attention_lse_plain(tq, tk, tv, **kw)
    _close(out, jout, 1e-5)
    got = ref.flash_bwd_plain(tq, tk, tv, out, lse, torch.from_numpy(dout),
                              **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, 1e-5)


# --------------------------------------------------------------------------- #
# The reference's Server takes no frames                                       #
# --------------------------------------------------------------------------- #
def test_server_cannot_serve_the_encoder_decoder_in_either_package(pair):
    """Both Servers prefill with {"tokens": ...} only, and the enc-dec
    prefill reads batch["enc_frames"]: KeyError in both (ROADMAP.md,
    section 3). Whisper is served by prefill + decode_step."""
    jbb, jparams, tbb, tparams = pair
    prompt = _tokens(tbb.cfg, 1, 6, 12)[0]
    for srv, cls in ((JServer(jbb, jparams, slots=2, ctx=CTX), JRequest),
                     (Server(tbb, tparams, slots=2, ctx=CTX), Request)):
        srv.submit(cls(rid=0, prompt=prompt, max_new=2))
        with pytest.raises(KeyError, match="enc_frames"):
            srv.run(max_steps=4)
