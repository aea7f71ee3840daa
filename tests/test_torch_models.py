"""The port's model against the JAX package's on the CPU, in fp32.

The building blocks get numpy inputs made from a seed; the backbone gets the
JAX init grafted through repro_torch.bridge (jax.random and torch.Generator
never agree). The reduced qwen3-4b here has three stacked layers, so the
[R, ...] layout and the per-layer cache slices are exercised.

Tolerances: 1e-5 for the blocks (one fp32 op order against another), 1e-4
for logits and caches after three layers (the port's attention is the
unchunked softmax, JAX's the chunked online one), 2e-3 for decode against a
longer prefill (as tests/test_models.py: other reduction shapes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ARCH_NAMES as JARCH_NAMES
from repro.models import Backbone as JBackbone
from repro.models import LayerGroup as JLayerGroup
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import get_config as jget_config
from repro.models import reduced as jreduced
from repro_torch import bridge
from repro_torch.models import (ARCH_NAMES, Backbone, LayerGroup, get_config,
                                reduced)
from repro_torch.models import common, ffn


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_config_copy_matches_reference(arch):
    mine, ref = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert (dataclasses.asdict(reduced(mine))
            == dataclasses.asdict(jreduced(ref)))


def test_the_port_runs_every_reference_arch():
    assert sorted(ARCH_NAMES) == sorted(JARCH_NAMES)
    with pytest.raises(KeyError, match="unknown architecture"):
        get_config("no-such-arch")


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    s = rng.standard_normal((48,)).astype(np.float32) * 0.1
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("cap", [None, 30.0, 5.0])
def test_softcap_matches_jax(cap):
    x = np.random.default_rng(8).standard_normal((4, 9)).astype(np.float32) * 20
    _close(common.softcap(torch.from_numpy(x), cap),
           jcommon.softcap(jnp.asarray(x), cap), 1e-5)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5, 0.3])
def test_apply_rope_matches_jax(rotary_pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 20)).astype(np.float32)
    pos = np.array([0, 1, 5, 9, 100, 1023, 4095], np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              rotary_pct)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            rotary_pct)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_gated_mlp_matches_jax(kind):
    rng = np.random.default_rng(2)
    D, F = 16, 40
    p = {"w_gate": rng.standard_normal((D, F)), "w_up": rng.standard_normal((D, F)),
         "w_down": rng.standard_normal((F, D))}
    if kind == "gelu":
        p = {"w_gate": p["w_gate"], "b_gate": rng.standard_normal((F,)),
             "w_down": p["w_down"], "b_down": rng.standard_normal((D,))}
    p = {k: (v * 0.3).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((3, D)).astype(np.float32)
    want = jffn.gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), kind)
    got = ffn.gated_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), kind)
    _close(got, want, 1e-5)


def test_bridge_round_trip_keeps_keys_shapes_and_bits():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((2, 3)).astype(np.float32),
            "g0": {"s0": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                          "i": np.arange(6, dtype=np.int32)}}}
    back = bridge.params_to_numpy(bridge.params_from_numpy(tree, device="cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = np.asarray(jnp.asarray(tree["a"]).astype(jnp.bfloat16))
    t = bridge.params_from_numpy({"a": bf}, device="cpu")["a"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), bf.astype(np.float32))


# --------------------------------------------------------------------------- #
# The backbone, three stacked layers of reduced qwen3-4b                       #
# --------------------------------------------------------------------------- #
CTX = 40


@pytest.fixture(scope="module")
def pair():
    """(jax backbone, jax params, port backbone, port params), grafted."""
    jcfg = jreduced(jget_config("qwen3-4b"),
                    groups=(JLayerGroup(("attn",), 3),))
    tcfg = reduced(get_config("qwen3-4b"), groups=(LayerGroup(("attn",), 3),))
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=False)
    jparams = jbb.init(jax.random.PRNGKey(0))
    # non-zero norm scales, so (1 + scale) is exercised too
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    rng = np.random.default_rng(4)
    leaves = [l + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
              if not np.any(np.asarray(l)) else l for l in leaves]
    jparams = jax.tree_util.tree_unflatten(treedef, leaves)
    tbb = Backbone(tcfg, compute_dtype=torch.float32, device="cpu")
    tparams = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    return jbb, jparams, tbb, tparams


def test_init_layout_matches_reference(pair):
    jbb, jparams, tbb, _ = pair
    mine = bridge.params_to_numpy(tbb.init(0))
    ref = _np_tree(jparams)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(ref)
    for a, b in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(ref)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert mine["g0"]["s0"]["wq"].shape[0] == 3


def test_prefill_and_decode_match_jax(pair):
    jbb, jparams, tbb, tparams = pair
    rng = np.random.default_rng(5)
    B, S, N = 2, 13, 4
    toks = rng.integers(0, tbb.cfg.vocab, (B, S + N), dtype=np.int32)
    jlog, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                               CTX)
    tlog, tcache = tbb.prefill(tparams, {"tokens": torch.from_numpy(toks[:, :S])},
                               CTX)
    _close(tlog, jlog, 1e-4)
    mine, ref = bridge.cache_to_numpy(tcache), _np_tree(jcache)
    assert jax.tree_util.tree_structure(mine) == jax.tree_util.tree_structure(ref)
    np.testing.assert_array_equal(mine["g0"]["s0"]["kpos"],
                                  ref["g0"]["s0"]["kpos"])
    assert int(mine["pos"]) == int(ref["pos"]) == S
    for key in ("k", "v"):
        _close(mine["g0"]["s0"][key], ref["g0"]["s0"][key], 1e-4)
    jdec = jax.jit(jbb.decode_step)
    for i in range(N):
        tok = toks[:, S + i:S + i + 1]
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tbb.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, 1e-4)
    mine, ref = bridge.cache_to_numpy(tcache), _np_tree(jcache)
    np.testing.assert_array_equal(mine["g0"]["s0"]["kpos"],
                                  ref["g0"]["s0"]["kpos"])
    _close(mine["g0"]["s0"]["k"], ref["g0"]["s0"]["k"], 1e-4)
    assert int(mine["pos"]) == S + N


def test_decode_from_a_grafted_jax_cache(pair):
    """The cache layouts agree in the other direction too: the port decodes
    from JAX's prefill cache as JAX does."""
    jbb, jparams, tbb, tparams = pair
    toks = np.random.default_rng(9).integers(0, tbb.cfg.vocab, (2, 12),
                                             dtype=np.int32)
    _, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :11])}, CTX)
    tcache = bridge.cache_from_numpy(_np_tree(jcache), device="cpu")
    assert tcache["pos"] == 11
    jlog, _ = jbb.decode_step(jparams, jcache, jnp.asarray(toks[:, 11:]))
    tlog, _ = tbb.decode_step(tparams, tcache, torch.from_numpy(toks[:, 11:]))
    _close(tlog, jlog, 1e-4)


def test_prefill_wraps_the_ring_like_jax(pair):
    """A context longer than the ring keeps the last C positions at
    position % C, in both packages."""
    jbb, jparams, tbb, tparams = pair
    toks = np.random.default_rng(6).integers(0, tbb.cfg.vocab, (1, 29),
                                             dtype=np.int32)
    C = 16
    jlog, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks)}, C)
    tlog, tcache = tbb.prefill(tparams, {"tokens": torch.from_numpy(toks)}, C)
    _close(tlog, jlog, 1e-4)
    mine, ref = bridge.cache_to_numpy(tcache), _np_tree(jcache)
    np.testing.assert_array_equal(mine["g0"]["s0"]["kpos"],
                                  ref["g0"]["s0"]["kpos"])
    _close(mine["g0"]["s0"]["v"], ref["g0"]["s0"]["v"], 1e-4)


def test_decode_matches_longer_prefill(pair):
    """Cache correctness in the port alone: decode(t_{S+1} | prefill(S)) ==
    prefill(S+1)."""
    _, _, tbb, tparams = pair
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tbb.cfg.vocab, (2, 18), dtype=np.int32))
    _, cache = tbb.prefill(tparams, {"tokens": toks[:, :17]}, CTX)
    got, cache = tbb.decode_step(tparams, cache, toks[:, 17:])
    want, _ = tbb.prefill(tparams, {"tokens": toks}, CTX)
    _close(got, want, 2e-3)
    assert cache["pos"] == 18


# --------------------------------------------------------------------------- #
# Every ported arch: tests/test_models.py's smoke and cache tests, and the     #
# dense archs against JAX                                                      #
# --------------------------------------------------------------------------- #
def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_smoke_train_step(arch):
    """tests/test_models.py::test_arch_smoke_train_step on the port: one
    forward + backward + optimizer step of the reduced config; finite loss,
    gradients flow; a second step stays finite."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                           make_train_step)

    cfg = reduced(get_config(arch))
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    settings = StepSettings(zero3=False, gather_weights=False, remat=False)
    step = make_train_step(bb, adamw.AdamWConfig(lr=1e-3), settings)
    data = DataConfig(vocab=cfg.vocab, seq_len=24, global_batch=2,
                      enc_seq=cfg.enc_seq, enc_dim=cfg.d_model)
    state, metrics = step(init_train_state(bb, 0, settings),
                          make_batch(data, 0))
    assert np.isfinite(float(metrics["loss"])), arch
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    _, metrics2 = step(state, make_batch(data, 1))
    assert np.isfinite(float(metrics2["loss"]))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_decode_matches_prefill(arch):
    """tests/test_models.py::test_arch_decode_matches_prefill on the port:
    decode(t_{S+1} | prefill(S)) == prefill(S+1)."""
    cfg = reduced(get_config(arch))
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    params = bb.init(0)
    B, S = 2, 17
    toks = torch.from_numpy(_tokens(cfg.vocab, B, S + 1, 42))
    batch = {"tokens": toks[:, :S]}
    if cfg.is_enc_dec:
        batch["enc_frames"] = torch.from_numpy(np.random.default_rng(42)
                                               .standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    logits_pre, cache = bb.prefill(params, batch, 40)
    assert logits_pre.shape[:2] == (B, 1)
    logits_dec, cache2 = bb.decode_step(params, cache, toks[:, S:])
    logits_pre2, _ = bb.prefill(params, dict(batch, tokens=toks), 40)
    _close(logits_dec, logits_pre2, 2e-3)
    assert cache2["pos"] == S + 1


DENSE_ARCHS = ["gemma2-2b", "qwen2-7b", "phi4-mini-3.8b", "chameleon-34b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_arch_prefill_and_decode_match_jax(arch):
    """The reduced dense archs with JAX's init grafted (zero leaves
    perturbed): prefill logits past the reduced window (gemma2-2b's local
    layers' ring wraps), every cache leaf, then 4 decode steps."""
    jbb = JBackbone(jreduced(jget_config(arch)), compute_dtype=jnp.float32,
                    remat=False)
    leaves, treedef = jax.tree_util.tree_flatten(
        jbb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    leaves = [l + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
              if not np.any(np.asarray(l)) else l for l in leaves]
    jparams = jax.tree_util.tree_unflatten(treedef, leaves)
    tbb = Backbone(reduced(get_config(arch)), compute_dtype=torch.float32,
                   device="cpu")
    tparams = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    B, S, N = 2, 45, 4
    toks = _tokens(tbb.cfg.vocab, B, S + N, 5)
    jlog, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                               64)
    tlog, tcache = tbb.prefill(tparams, {"tokens": torch.from_numpy(
        toks[:, :S])}, 64)
    _close(tlog, jlog, 1e-4)
    mine, want = bridge.cache_to_numpy(tcache), _np_tree(jcache)
    assert (jax.tree_util.tree_structure(mine)
            == jax.tree_util.tree_structure(want))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(mine)[0],
                            jax.tree_util.tree_leaves(want)):
        if jax.tree_util.keystr(path).endswith("['kpos']"):
            np.testing.assert_array_equal(a, b)
        else:
            _close(a, b, 1e-4)
    jdec = jax.jit(jbb.decode_step)
    for i in range(N):
        tok = toks[:, S + i:S + i + 1]
        jlog, jcache = jdec(jparams, jcache, jnp.asarray(tok))
        tlog, tcache = tbb.decode_step(tparams, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, 1e-4)
    assert tcache["pos"] == S + N
