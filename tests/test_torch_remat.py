"""The reference's ``remat_policy="dots"`` in the port
(``repro_torch.models.remat``), on the CPU in fp32 at reduced widths (the
layer views' cases also in bf16 compute).

What the port saves under "dots" (the outputs SAC caches in the forward,
the products its policy marks MUST_SAVE) against what the reference saves:
``saved_residuals`` of JAX's ``loss_fn`` under "dots", less those under
"full". Both are keyed by (trailing dim, elements per token, dtype), since
the reference's residuals are stacked over the scan's repeat axis and the
port's are the ``mm`` outputs [tokens, N]; the two multisets must be equal,
with nothing cached that the recompute does not read back. The gradients
under "dots", "full" and no remat are bit for bit equal in the port (the
same operations on the same values), and match ``jax.grad`` of the
reference under "dots" within the tolerances of the existing parity tests
(the loss 1e-5, each leaf 1e-4 of its largest entry). The dry run's count
under "dots": the FLOPs of "full" less the saved products' forward FLOPs,
exactly; at least remat-off's; its peak above "full"'s by at most the
saved bytes.
The layers' views of a group's stacked leaves (one ``unbind`` a leaf)
against per-layer indexing, under every policy: the gradients bit for bit,
and no full-size zero-fill or add of a stacked leaf's gradient.
"""
import collections
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import (CheckpointPolicy, _VersionWrapper,
                                    create_selective_checkpoint_contexts)
from torch.utils._pytree import tree_flatten

from repro.models import Backbone as JBackbone
from repro.models import get_config as jget_config
from repro.models import reduced as jreduced
from repro_torch import bridge
from repro_torch.models import (Backbone, LayerGroup, ShapeConfig, get_config,
                                reduced, remat)
from repro_torch.optim import adamw
from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                       make_train_step, value_and_grad)

ARCHS = ("qwen3-4b", "gemma2-2b", "recurrentgemma-9b", "rwkv6-3b",
         "mixtral-8x22b", "qwen3-moe-235b-a22b", "whisper-tiny")
B, S = 2, 16      # whisper-tiny's reduced encoder takes 16 frames too
POLICIES = {"off": dict(remat=False), "full": dict(remat=True),
            "dots": dict(remat=True, remat_policy="dots")}


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:]}
    if cfg.is_enc_dec:
        batch["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _product(op, args):
    """(M, K, N, dtype) of an ``mm`` or ``addmm`` call: shapes only, since
    a reference to an operand would hold its memory."""
    a, b = (args[1], args[2]) if op == torch.ops.aten.addmm.default \
        else args[:2]
    return a.shape[0], a.shape[1], b.shape[1], a.dtype


class _Saves:
    """Records the products the "dots" policy saves in the forward, and
    every SAC cache it makes."""

    def __init__(self, monkeypatch):
        self.products, self.stores = [], []
        policy = remat._dots

        def recording(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
                self.products.append(_product(op, args))
            return decision

        def context():
            modes = create_selective_checkpoint_contexts(recording)
            self.stores.append(modes[0].storage)
            return modes
        monkeypatch.setattr(remat, "context", context)

    def keys(self):
        """(trailing dim, elements per token, dtype) of each saved output."""
        return collections.Counter(
            (n, Fraction(m * n, B * S), str(dt).removeprefix("torch."))
            for m, _, n, dt in self.products)

    def left_in_cache(self):
        """Cached outputs that no recompute took back."""
        entries = [v for store in self.stores for per_op in store.values()
                   for v in (per_op.values() if isinstance(per_op, dict)
                             else per_op)]
        return sum(isinstance(x, _VersionWrapper)
                   for x in tree_flatten(entries)[0])


def _reference_saved(arch):
    """The reference's scan residuals under "dots" less those under
    "full", keyed as ``_Saves.keys``."""
    cfg = jreduced(jget_config(arch))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    out = {}
    for policy in ("full", "dots"):
        jbb = JBackbone(cfg, compute_dtype=jnp.float32, remat=True,
                        remat_policy=policy)
        res = saved_residuals(jbb.loss_fn, jbb.init(jax.random.PRNGKey(0)),
                              batch)
        out[policy] = collections.Counter(
            ((a.shape or (1,))[-1], Fraction(int(np.prod(a.shape)), B * S),
             str(a.dtype)) for a, _ in res)
    assert not out["full"] - out["dots"]
    return out["dots"] - out["full"]


def _grads(arch, policy, params=None):
    cfg = reduced(get_config(arch))
    bb = Backbone(cfg, compute_dtype=torch.float32, device="cpu",
                  **POLICIES[policy])
    return value_and_grad(bb, bb.init(0) if params is None else params,
                          _batch(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_saves_the_reference_residuals(arch, monkeypatch):
    """The products the port saves under "dots" are the reference's saved
    residuals: q, k, v and o (and a dec layer's cross products), the gated
    FFN's gate and up, the router's fp32 logits, the rec block's and
    rwkv6's products; not the experts', the RG-LRU gates' or attention's
    (batch dims), and not the last sublayer's down projection, which only
    the residual add reads. Every cached output is read by the recompute."""
    saves = _Saves(monkeypatch)
    _grads(arch, "dots")
    assert saves.keys() == _reference_saved(arch)
    assert saves.stores and saves.left_in_cache() == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_bit_for_bit_under_dots_full_and_off(arch):
    """SAC hands the recompute the forward's own outputs, and recomputes
    the rest from the same values: the loss and every leaf's gradient are
    equal bit for bit with and without remat."""
    want_loss, want = _grads(arch, "off")
    for policy in ("full", "dots"):
        loss, grads = _grads(arch, policy)
        assert torch.equal(loss, want_loss), policy
        assert all(torch.equal(a, b) for a, b in zip(
            adamw.tree_leaves(grads), adamw.tree_leaves(want))), policy


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_gradients_match_jax_under_dots(arch):
    """The port's loss and gradients under "dots" against
    ``jax.value_and_grad`` of the reference under "dots", from JAX's init
    with its zero leaves perturbed."""
    jcfg = jreduced(jget_config(arch))
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=True,
                    remat_policy="dots")
    leaves, treedef = jax.tree_util.tree_flatten(
        jbb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    leaves = [np.asarray(l) + 0.1 * rng.standard_normal(l.shape).astype(
        np.float32) if not np.any(np.asarray(l)) else np.asarray(l)
        for l in leaves]
    jparams = jax.tree_util.tree_unflatten(treedef, leaves)
    batch = _batch(jcfg)
    want_loss, want = jax.value_and_grad(jbb.loss_fn)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _grads(arch, "dots",
                         bridge.params_from_numpy(jparams, device="cpu"))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5,
                               atol=1e-5)
    got, want = adamw.tree_leaves(grads), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * scale,
                                   rtol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b", "whisper-tiny"])
def test_dryrun_counts_dots_as_full_less_the_saved_products(arch,
                                                            monkeypatch):
    """The dry run's train cell (launch/dryrun.py: ZeRO-3, the per-layer
    gather, bf16 compute) of a reduced arch with four layers a group and
    2 x 64 tokens, on a (1, 1) mesh over the fake group, under the cost
    counter: a product SAC serves from its cache in the recompute never
    reaches the counter, so "dots" counts the FLOPs of "full" less the
    saved products' forward FLOPs (2 M K N each), exactly, and no fewer
    than remat-off's. Its peak lies above "full"'s by at most the saved
    bytes: by all of them where the peak falls where every layer's cache
    is held, less where "full"'s peak falls later in the step. The tokens
    are enough that the caches, not the reduced models' gradients, set the
    peak: at 2 x 32, rwkv6-3b's and whisper-tiny's peaks fall where no
    cache is held, equal under both policies, once each stacked leaf's
    gradient grows one layer's slot at a time."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun, mesh

    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, groups=tuple(
        LayerGroup(g.pattern, 4) for g in cfg.groups))
    shape = ShapeConfig("train", 64, 2, "train")
    saves = _Saves(monkeypatch)
    mesh.init_fake_world(1)
    try:
        m = mesh.make_host_mesh()
        counted = {}
        for name, kw in POLICIES.items():
            saves.products.clear()
            res = dryrun.count_cell(cfg, shape, m, settings=StepSettings(**kw))
            counted[name] = (res["hlocost"]["flops"],
                             res["memory"]["peak_bytes"])
    finally:
        dist.destroy_process_group()
    flops = sum(2 * m * k * n for m, k, n, _ in saves.products)
    nbytes = sum(m * n * dt.itemsize for m, _, n, dt in saves.products)
    assert flops > 0
    assert counted["dots"][0] == counted["full"][0] - flops
    assert counted["dots"][0] >= counted["off"][0]
    assert counted["full"][1] < counted["dots"][1] <= (counted["full"][1]
                                                       + nbytes)


# ---------------------------------------------------------------------------
# A group's layer views: one unbind a stacked leaf, not leaf[r] a layer
# ---------------------------------------------------------------------------
VIEW_REPEATS = {"qwen3-4b": 4, "mixtral-8x22b": 3, "recurrentgemma-9b": 2,
                "rwkv6-3b": 3, "whisper-tiny": 3}
VIEW_CASES = ([(arch, policy, 1, "bf16") for arch in VIEW_REPEATS
               for policy in POLICIES]
              + [("qwen3-4b", "full", 2, "bf16"), ("qwen3-4b", "off", 1,
                                                   "fp32")])
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _repeated(arch, repeat=None):
    """A reduced arch with every group repeated (``VIEW_REPEATS``)."""
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, groups=tuple(
        LayerGroup(g.pattern, repeat or VIEW_REPEATS[arch])
        for g in cfg.groups))


def _indexed_views(bb, gp, repeat):
    """The yardstick: layer r's views as ``leaf[r]``, one select a layer,
    whose backward pads the layer's gradient to the leaf's size with
    zeros; autograd adds the ``repeat`` padded tensors."""
    return [{s: {name: leaf[r] for name, leaf in sub.items()}
             for s, sub in gp.items()} for r in range(repeat)]


def _step_or_grads(bb, microbatches, policy):
    """(loss, gradients) of ``value_and_grad``, or with microbatches the
    leaves of the state after one functional train step and its metrics."""
    cfg = bb.cfg
    if microbatches == 1:
        loss, grads = value_and_grad(bb, bb.init(0), _batch(cfg))
        return [loss], adamw.tree_leaves(grads)
    settings = StepSettings(microbatches=microbatches, **POLICIES[policy])
    step = make_train_step(bb, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=4), settings)
    state, out = step(init_train_state(bb, 0, settings), _batch(cfg))
    return ([out["loss"], out["grad_norm"]],
            adamw.tree_leaves(state["params"])
            + adamw.tree_leaves(state["opt"]))


@pytest.mark.parametrize("arch,policy,microbatches,dtype", VIEW_CASES,
                         ids=str)
def test_layer_views_give_the_indexed_gradients_bit_for_bit(
        arch, policy, microbatches, dtype, monkeypatch):
    """The loss and every gradient (with microbatches: the state after a
    step) from a group's unbind views equal those of the per-layer
    ``leaf[r]`` views bit for bit: each add the indexing makes adds zeros
    (``torch.equal`` takes -0 for 0). fp32 leaves, in the training cell's
    bf16 compute (the cast's backward feeds the unbind) and in fp32."""
    bb = Backbone(_repeated(arch), compute_dtype=DTYPES[dtype],
                  device="cpu", **POLICIES[policy])
    got = _step_or_grads(bb, microbatches, policy)
    monkeypatch.setattr(Backbone, "_layer_views", _indexed_views)
    want = _step_or_grads(bb, microbatches, policy)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert all(torch.equal(a, b) for a, b in zip(g, w))


def _at_leaf_shape(event):
    """The shape an autograd op of the backward writes, where the profiler
    records it: ``add_``'s own input, ``zeros``' fill (its ``zero_`` or
    ``fill_`` child), ``stack``'s final view (the size it is given)."""
    if event.name == "aten::add_":
        return tuple(event.input_shapes[0])
    for child in event.cpu_children:
        if event.name == "aten::zeros" and child.name == "aten::zero_":
            return tuple(child.input_shapes[0])
        if event.name == "aten::stack" and child.name == "aten::view":
            return tuple(child.concrete_inputs[1])
    return None


def _full_size_ops(bb, params, batch):
    """(op, a stacked leaf's shape) -> count in ``value_and_grad``, for the
    zero-fills, the in-place adds and the stacks at a stacked leaf's whole
    shape."""
    from torch.profiler import ProfilerActivity, profile

    shapes = {tuple(leaf.shape) for gi in range(len(bb.cfg.groups))
              for leaf in adamw.tree_leaves(params[f"g{gi}"])}
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        value_and_grad(bb, params, batch)
    return collections.Counter(
        (e.name.removeprefix("aten::"), _at_leaf_shape(e))
        for e in prof.events()
        if e.name in ("aten::zeros", "aten::add_", "aten::stack")
        and _at_leaf_shape(e) in shapes)


def test_layer_views_leave_no_full_size_fill_or_add(monkeypatch):
    """A 4-layer reduced qwen3's backward under the profiler: the indexed
    views zero-fill each stacked leaf's gradient at its whole size 4 times
    and add 3 times; the unbind views do neither and stack it once. The
    dispatch ledger counts ``layer_views.unbind`` once a group a training
    forward (remat's recompute makes none), and none in a Server's prefills
    and decode steps."""
    from repro_torch.obs import metrics
    from repro_torch.runtime.serve_loop import Request, Server

    cfg = _repeated("qwen3-4b")
    R = cfg.groups[0].repeat
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, device="cpu",
                  remat=False)
    params = bb.init(0)
    leaves = collections.Counter(tuple(leaf.shape) for leaf
                                 in adamw.tree_leaves(params["g0"]))
    got = _full_size_ops(bb, params, _batch(cfg))
    assert got == collections.Counter(
        {("stack", shape): n for shape, n in leaves.items()})
    with monkeypatch.context() as m:
        m.setattr(Backbone, "_layer_views", _indexed_views)
        indexed = _full_size_ops(bb, params, _batch(cfg))
    assert indexed == collections.Counter(
        {**{("zeros", shape): R * n for shape, n in leaves.items()},
         **{("add_", shape): (R - 1) * n for shape, n in leaves.items()}})

    ledger = metrics.registry("dispatch")

    def unbinds(run):
        before = ledger.snapshot()["counters"].get("layer_views.unbind", 0)
        run()
        return (ledger.snapshot()["counters"].get("layer_views.unbind", 0)
                - before)

    two = dataclasses.replace(cfg, groups=(LayerGroup(("attn",), 2),) * 2)
    for remat_kw in ({"remat": False}, {"remat": True},
                     {"remat": True, "remat_policy": "dots"}):
        bb2 = Backbone(two, compute_dtype=torch.float32, device="cpu",
                       **remat_kw)
        assert unbinds(lambda: value_and_grad(bb2, bb2.init(0),
                                              _batch(two))) == 2, remat_kw
    srv = Server(bb2, bb2.init(0), slots=2, ctx=64)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, two.vocab, 8,
                                               dtype=np.int32), max_new=4)
            for i in range(3)]

    def serve():
        for r in reqs:
            srv.submit(r)
        srv.run(max_steps=100)
    assert unbinds(serve) == 0
    assert all(len(r.out) == 4 for r in reqs)


def test_an_unknown_policy_raises():
    cfg = reduced(get_config("qwen3-4b"))
    with pytest.raises(ValueError, match="remat_policy 'offload'"):
        Backbone(cfg, remat_policy="offload", device="cpu")
    # read only with remat, as the reference's
    bb = Backbone(cfg, remat=False, remat_policy="dots", device="cpu")
    assert bb.remat_policy == "dots"
