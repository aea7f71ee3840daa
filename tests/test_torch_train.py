"""The port's training path against the JAX package on the CPU, in fp32:
the loss, ``Backbone.loss_fn`` and its gradients, AdamW, and the train step.

The JAX init is grafted into the port through ``repro_torch.bridge``; data
and noise are made with numpy from a seed and handed to both. Tolerances:
the cross-entropy 1e-6 (one fp32 logsumexp against another); the loss after
three or four layers 1e-5 and each leaf's gradient 1e-4 of the leaf's
largest entry (the port's attention is the unchunked softmax and its
backward the chunked one at other chunk sizes, the scans' backwards reverse
loops against JAX's transposed scans: fp32 round-off, compounded through
the layers and back); AdamW's update 1e-6 (elementwise fp32, the same
operations); two train steps 1e-5 on the loss and grad_norm, and each
parameter leaf's RMS difference 1e-3 x lr (Adam's step is lr times
m / (sqrt(v) + eps), normalised per entry: where an entry's gradient is
near 0, the gradients' round-off above is large against it and can move
that entry by a sizable share of lr, so the limit is on the leaf's RMS).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import Backbone as JBackbone
from repro.models import LayerGroup as JLayerGroup
from repro.models import common as jcommon
from repro.models import get_config as jget_config
from repro.models import reduced as jreduced
from repro.optim import adamw as jadamw
from repro.runtime.steps import StepSettings as JStepSettings
from repro.runtime.steps import init_train_state as jinit_train_state
from repro.runtime.steps import make_train_step as jmake_train_step
from repro_torch import bridge
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import Backbone, LayerGroup, get_config, reduced
from repro_torch.models import common
from repro_torch.optim import adamw
from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                       make_train_step, value_and_grad)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _leaves_close(got_tree, want_tree, rel):
    got = adamw.tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=rel)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cap", [None, 30.0])
def test_stable_cross_entropy_matches_jax(cap):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 20).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    want = jcommon.stable_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), cap)
    got = common.stable_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(labels), cap)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, 1e-6)
    # bf16 logits are taken in fp32, as the reference does
    got16 = common.stable_cross_entropy(torch.from_numpy(logits).bfloat16(),
                                        torch.from_numpy(labels), cap)
    want16 = jcommon.stable_cross_entropy(jnp.asarray(logits, jnp.bfloat16),
                                          jnp.asarray(labels), cap)
    _close(got16, want16, 1e-6)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------
# variant -> (arch, layer groups or None for reduced()'s own, overrides):
# reduced qwen3-4b with 3 attn layers, or an (attn, local) group with a
# window and both softcaps; reduced recurrentgemma-9b ((rec, rec, local) +
# (rec)) and a 3-layer rwkv6-3b, whose scans' gradients are K2b's and K3b's
# plain versions here; the four dense archs' reduced configs
VARIANTS = {
    "attn": ("qwen3-4b", (("attn",), 3), {}),
    "local": ("qwen3-4b", (("attn", "local"), 1),
              dict(attn_window=8, attn_logit_softcap=30.0,
                   final_logit_softcap=20.0)),
    "rec": ("recurrentgemma-9b", None, {}),
    "rwkv": ("rwkv6-3b", (("rwkv",), 3), {}),
    "gemma2-2b": ("gemma2-2b", None, {}),
    "qwen2-7b": ("qwen2-7b", None, {}),
    "phi4-mini-3.8b": ("phi4-mini-3.8b", None, {}),
    "chameleon-34b": ("chameleon-34b", None, {}),
}


def _pair(variant, remat):
    """(JAX backbone, port backbone) of a variant's reduced config."""
    arch, groups, over = VARIANTS[variant]
    jover, over = dict(over), dict(over)
    if groups is not None:
        jover["groups"] = (JLayerGroup(*groups),)
        over["groups"] = (LayerGroup(*groups),)
    jcfg = jreduced(jget_config(arch), **jover)
    cfg = reduced(get_config(arch), **over)
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=remat)
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=remat, device="cpu")
    return jbb, bb


def _batch(vocab, B=2, S=24, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1),
                                               dtype=np.int32)
    return {"tokens": toks[:, :S], "labels": toks[:, 1:]}


def _perturbed_init(jbb):
    """JAX's init with its zero leaves (norm scales, biases, u, w0, the
    LoRAs' second factors) perturbed, so that every leaf's gradient path is
    exercised."""
    leaves, treedef = jax.tree_util.tree_flatten(jbb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    leaves = [l + 0.1 * rng.standard_normal(l.shape).astype(np.float32)
              if not np.any(np.asarray(l)) else l for l in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_fn_and_grads_match_jax(variant, remat):
    jbb, bb = _pair(variant, remat)
    jparams = _perturbed_init(jbb)
    params = bridge.params_from_numpy(_np_tree(jparams), device="cpu")
    # past the reduced window (32) where there is one
    batch = _batch(jbb.cfg.vocab, S=40 if jbb.cfg.attn_window else 24)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.value_and_grad(jbb.loss_fn)(jparams, jbatch)
    loss, grads = value_and_grad(bb, params, batch)
    _close(loss, want_loss, 1e-5)
    _leaves_close(grads, want_grads, 1e-4)
    # the parameters were not touched
    for a, b in zip(adamw.tree_leaves(params),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_meta_init_has_the_shapes_of_init():
    bb = Backbone(reduced(get_config("qwen3-4b")), device="cpu")
    real, meta = bb.init(0), bb.init(0, device="meta")
    assert [(t.shape, t.dtype) for t in adamw.tree_leaves(real)] == [
        (t.shape, t.dtype) for t in adamw.tree_leaves(meta)]
    assert all(t.device.type == "meta" for t in adamw.tree_leaves(meta))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _tree(rng, scale=1.0):
    return {"b": {"w": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
                  "a": (rng.standard_normal((4,)) * scale).astype(np.float32)},
            "a": (rng.standard_normal((2, 2, 3)) * scale).astype(np.float32)}


@pytest.mark.parametrize("step", [0, 7, 150])
@pytest.mark.parametrize("clip", [1.0, None])
def test_apply_updates_matches_jax(step, clip):
    rng = np.random.default_rng(step)
    params, grads = _tree(rng), _tree(rng, 3.0)
    m, v = _tree(rng, 0.1), {k: np.abs(x) if not isinstance(x, dict) else
                             {kk: np.abs(xx) for kk, xx in x.items()}
                             for k, x in _tree(rng, 0.1).items()}
    cfg = dict(lr=1e-2, warmup_steps=10, total_steps=200, clip_norm=clip)
    jstate = {"step": jnp.asarray(step, jnp.int32),
              "m": jax.tree_util.tree_map(jnp.asarray, m),
              "v": jax.tree_util.tree_map(jnp.asarray, v)}
    jp, js, jm = jadamw.apply_updates(
        jadamw.AdamWConfig(**cfg), jax.tree_util.tree_map(jnp.asarray, params),
        jstate, jax.tree_util.tree_map(jnp.asarray, grads))
    t = lambda tree: bridge.params_from_numpy(tree, device="cpu")
    state = {"step": torch.tensor(step, dtype=torch.int32), "m": t(m),
             "v": t(v)}
    before = [x.clone() for x in adamw.tree_leaves(t(params))]
    p_in = t(params)
    p, s, metrics = adamw.apply_updates(adamw.AdamWConfig(**cfg), p_in, state,
                                        t(grads))
    assert s["step"].dtype == torch.int32 and int(s["step"]) == step + 1
    _leaves_close(p, jp, 1e-6)
    _leaves_close(s["m"], js["m"], 1e-6)
    _leaves_close(s["v"], js["v"], 1e-6)
    _close(metrics["grad_norm"], jm["grad_norm"], 1e-6)
    _close(metrics["lr"], jm["lr"], 1e-6)
    # functional: the inputs are unchanged
    assert all(torch.equal(a, b) for a, b in zip(before,
                                                 adamw.tree_leaves(p_in)))


def test_cosine_lr_and_global_norm_match_jax():
    cfg = dict(lr=3e-4, warmup_steps=7, total_steps=50, min_lr_frac=0.1)
    for step in (0, 1, 6, 7, 8, 30, 50, 60):
        _close(adamw.cosine_lr(adamw.AdamWConfig(**cfg),
                               torch.tensor(step, dtype=torch.int32)),
               jadamw.cosine_lr(jadamw.AdamWConfig(**cfg),
                                jnp.asarray(step, jnp.int32)), 1e-7)
    tree = _tree(np.random.default_rng(3), 5.0)
    _close(adamw.global_norm(bridge.params_from_numpy(tree, device="cpu")),
           jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray, tree)), 1e-7)
    # leaves in jax.tree_util order: sorted keys
    names = [tuple(t.shape) for t in adamw.tree_leaves(
        bridge.params_from_numpy(tree, device="cpu"))]
    assert names == [a.shape for a in jax.tree_util.tree_leaves(tree)]


def test_compress_with_feedback_matches_jax():
    rng = np.random.default_rng(5)
    grads, err = _tree(rng, 2.0), _tree(rng, 0.01)
    jd, je = jadamw.compress_with_feedback(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, err))
    d, e = adamw.compress_with_feedback(
        bridge.params_from_numpy(grads, device="cpu"),
        bridge.params_from_numpy(err, device="cpu"))
    # the int8 codes agree exactly (both round half to even); the
    # dequantised values and residuals to fp32 round-off
    _leaves_close(d, jd, 1e-6)
    _leaves_close(e, je, 1e-5)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)


def _small(groups=(("attn",), 2)):
    from repro.models import ModelConfig as JModelConfig
    from repro_torch.models import ModelConfig
    jcfg = JModelConfig(name="rt-test", family="dense",
                        groups=(JLayerGroup(*groups),), **SMALL)
    cfg = ModelConfig(name="rt-test", family="dense",
                      groups=(LayerGroup(*groups),), **SMALL)
    return jcfg, cfg


@pytest.mark.parametrize("compress", [False, True])
def test_two_train_steps_match_jax(compress):
    jcfg, cfg = _small()
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=False)
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    jset = JStepSettings(zero3=False, gather_weights=False, remat=False,
                         compress_grads=compress)
    settings = StepSettings(zero3=False, gather_weights=False, remat=False,
                            compress_grads=compress)
    opt = dict(lr=5e-3, warmup_steps=1, total_steps=10)
    jstate = jinit_train_state(jbb, jax.random.PRNGKey(0), jset)
    state = bridge.train_state_from_numpy(_np_tree(jstate), device="cpu")
    jstep = jax.jit(jmake_train_step(jbb, jadamw.AdamWConfig(**opt), jset))
    step = make_train_step(bb, adamw.AdamWConfig(**opt), settings)
    data = JDataConfig(vocab=jcfg.vocab, seq_len=16, global_batch=4)
    for i in range(2):
        batch = jmake_batch(data, i)
        jstate, jm = jstep(jstate, batch)
        state, m = step(state, batch)
        _close(m["loss"], jm["loss"], 1e-5)
        _close(m["grad_norm"], jm["grad_norm"], 1e-5)
        _close(m["lr"], jm["lr"], 1e-7)
    for g, w in zip(adamw.tree_leaves(state["params"]),
                    jax.tree_util.tree_leaves(jstate["params"])):
        rms = float(np.sqrt(np.mean((g.numpy() - np.asarray(w)) ** 2)))
        assert rms <= 1e-3 * opt["lr"], rms
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 2
    if compress:
        # the residuals g + e - deq carry the gradient's round-off (1e-4 of
        # the leaf's largest gradient, which is 127 quantisation steps, each
        # at least twice the largest residual); an entry whose round-off
        # crosses a rounding boundary of its int8 code moves by a whole
        # step, which is rare (at most 0.1 % of the entries)
        for g, w in zip(adamw.tree_leaves(state["error"]),
                        jax.tree_util.tree_leaves(jstate["error"])):
            w = np.asarray(w)
            off = np.abs(g.numpy() - w) > 1e-4 * 254 * np.abs(w).max()
            assert off.mean() <= 1e-3, off.mean()
    back = bridge.train_state_to_numpy(state)
    assert back["opt"]["step"].dtype == np.int32


def test_microbatching_matches_full_batch():
    """tests/test_runtime.py::test_microbatching_matches_full_batch, on the
    port: 4-way accumulation gives the full batch's update."""
    _, cfg = _small()
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    s1 = StepSettings(zero3=False, gather_weights=False, remat=False,
                      microbatches=1)
    s4 = dataclasses.replace(s1, microbatches=4)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=8), 0)
    out1, m1 = make_train_step(bb, adamw.AdamWConfig(lr=1e-3), s1)(
        init_train_state(bb, 0, s1), batch)
    out4, m4 = make_train_step(bb, adamw.AdamWConfig(lr=1e-3), s4)(
        init_train_state(bb, 0, s4), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    for a, b in zip(adamw.tree_leaves(out1["params"]),
                    adamw.tree_leaves(out4["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4)


def test_step_returns_fresh_tensors():
    """The store publishes states by reference, so a step never writes into
    the state it was given."""
    _, cfg = _small()
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    state = init_train_state(bb, 0, StepSettings(remat=False))
    before = [(t, t._version, t.clone()) for t in adamw.tree_leaves(state)]
    new, _ = make_train_step(bb, adamw.AdamWConfig(lr=1e-2),
                             StepSettings(remat=False))(
        state, make_batch(DataConfig(vocab=cfg.vocab, seq_len=8,
                                     global_batch=2), 0))
    for t, version, copy in before:
        assert t._version == version and torch.equal(t, copy)
    olds = {id(t) for t, _, _ in before}
    assert not any(id(t) in olds for t in adamw.tree_leaves(new))


def test_train_step_wrappers_of_serving():
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    bb = Backbone(reduced(get_config("qwen3-4b")), compute_dtype=torch.float32,
                  device="cpu")
    params = bb.init(0)
    toks = torch.from_numpy(_batch(bb.cfg.vocab, B=1, S=6)["tokens"])
    logits, cache = make_prefill_step(bb, 16)(params, {"tokens": toks})
    want, _ = bb.prefill(params, {"tokens": toks}, 16)
    assert torch.equal(logits, want)
    nxt, _ = make_decode_step(bb)(params, cache, toks[:, -1:])
    assert nxt.shape == (1, 1, bb.Vp)
