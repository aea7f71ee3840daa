"""The donated train state on the CPU: ``adamw.apply_updates_`` (and
``compress_with_feedback_``), ``make_train_step(..., donate=True)``, the
donating ``Trainer``, checkpoints and snapshot readers under donation, and
the dry run's train cells, which donate as the reference jits them.

Tolerances: the in-place update and the donating step against the
functional ones bit for bit (the same operations in the same order on the
same inputs); checkpoints bit for bit; a reader's snapshot bit for bit
equal to one committed step, or TornSnapshotError. The donating Trainer
against the JAX package's step, jitted with ``donate_argnums=(0,)`` as its
Trainer builds it, at tests/test_torch_train.py::test_two_train_steps_match_jax's
limits: loss and grad_norm within 1e-5, each parameter leaf's RMS difference
at most 1e-3 x lr (fp32; the two backbones' attention and reductions round
differently, and Adam's normalised step can move an entry whose gradient is
near 0 by a sizable share of lr).
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import Backbone as JBackbone
from repro.models import get_config as jget_config
from repro.models import reduced as jreduced
from repro.optim import adamw as jadamw
from repro.runtime.steps import StepSettings as JStepSettings
from repro.runtime.steps import init_train_state as jinit_train_state
from repro.runtime.train_loop import Trainer as JTrainer
from repro.runtime.train_loop import TrainerConfig as JTrainerConfig
from repro_torch import bridge
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import Backbone, get_config, reduced
from repro_torch.optim import adamw
from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                       make_train_step)
from repro_torch.runtime.train_loop import Trainer, TrainerConfig, to_host
from repro_torch.txstore.store import TornSnapshotError, VersionedStateStore

SETTINGS = StepSettings(zero3=False, gather_weights=False, remat=False)


def _clone(tree):
    return adamw.tree_map(lambda t: t.detach().clone(), tree)


def _equal(a, b):
    la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
    assert len(la) == len(lb)
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))


def _torn(err):
    return isinstance(err, TornSnapshotError) or isinstance(
        err.__cause__, TornSnapshotError)


# ---------------------------------------------------------------------------
# The update in place
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("chunk", [None, 100])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("clip", [1.0, None])
def test_apply_updates_in_place_equals_the_functional_update(
        monkeypatch, clip, dtype, compress, chunk):
    """3 steps with weight decay, clip on and off, fp32 and bf16 params
    (cast back from fp32), with and without the int8 error feedback, each
    leaf whole or in slices of 100 elements (the largest leaf in 22, the
    last one ragged): every leaf and metric bit for bit, and every donated
    tensor keeps its identity. Gradients large enough that the clip
    binds."""
    if chunk is not None:
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                            clip_norm=clip)
    rng = np.random.default_rng(0)

    def draw(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dtype)
    params = {"w": draw(64, 33), "b": {"c": draw(7), "d": draw(3, 5)}}
    opt = adamw.init_state(params)
    error = adamw.tree_map(torch.zeros_like, params)
    d_params, d_opt, d_error = _clone(params), _clone(opt), _clone(error)
    donated = adamw.tree_leaves({"p": d_params, "o": d_opt, "e": d_error})
    for _ in range(3):
        grads = adamw.tree_map(lambda p: draw(*p.shape, scale=3.0), params)
        g = grads
        if compress:
            g, error = adamw.compress_with_feedback(grads, error)
        params, opt, metrics = adamw.apply_updates(cfg, params, opt, g)
        g = grads
        if compress:
            g = adamw.compress_with_feedback_(grads, d_error)
        d_metrics = adamw.apply_updates_(cfg, d_params, d_opt, g)
        assert _equal(d_metrics, metrics)
    assert _equal({"p": d_params, "o": d_opt, "e": d_error},
                  {"p": params, "o": opt, "e": error})
    assert int(d_opt["step"]) == 3
    now = adamw.tree_leaves({"p": d_params, "o": d_opt, "e": d_error})
    assert all(a is b for a, b in zip(now, donated))
    if clip is not None:
        assert float(metrics["grad_norm"]) > clip


@pytest.mark.parametrize("fn", ["apply_updates_", "compress_with_feedback_"])
def test_in_place_update_marks_its_leaves_before_its_first_write(fn):
    """Every tensor an in-place update writes has its version counter
    bumped before the update issues its first write (the op's own bump
    comes after its kernel is issued), so a reader that checks the counters
    after its copy (StateCell.get_host) sees every write that reached it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    params = {"w": torch.ones(4, 3), "b": torch.ones(5)}
    opt = adamw.init_state(params)
    error = adamw.tree_map(torch.zeros_like, params)
    grads = adamw.tree_map(lambda p: torch.full_like(p, 0.5), params)
    written = adamw.tree_leaves({"p": params, "o": opt} if
                                fn == "apply_updates_" else error)
    seen = [t._version for t in written]
    stale = []

    class FirstWrite(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func._schema.is_mutable and not stale:
                stale.append([t for t, v in zip(written, seen)
                              if t._version == v])
            return func(*args, **(kwargs or {}))

    with FirstWrite():
        if fn == "apply_updates_":
            adamw.apply_updates_(adamw.AdamWConfig(), params, opt, grads)
        else:
            adamw.compress_with_feedback_(grads, error)
    assert stale == [[]]


# ---------------------------------------------------------------------------
# The donating step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-4b", "mixtral-8x22b"])
def test_donating_step_equals_the_functional_step(arch, microbatches):
    """make_train_step(donate=True) at the reduced arch (mixtral: the MoE
    layer), 3 steps: the same dicts and tensors come back, holding the
    functional step's state and metrics bit for bit; the functional step
    leaves its input as it was."""
    cfg = reduced(get_config(arch))
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    settings = StepSettings(remat=False, microbatches=microbatches)
    opt = adamw.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    functional = make_train_step(bb, opt, settings)
    donating = make_train_step(bb, opt, settings, donate=True)
    state = init_train_state(bb, 0, settings)
    d_state = _clone(state)
    leaves = adamw.tree_leaves(d_state)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    for i in range(3):
        batch = make_batch(data, i)
        prev, before = state, _clone(state)
        state, metrics = functional(state, batch)
        assert _equal(prev, before)
        out, d_metrics = donating(d_state, batch)
        assert out is d_state and _equal(d_metrics, metrics)
        assert all(a is b for a, b in zip(adamw.tree_leaves(out), leaves))
    assert _equal(d_state, state)


@pytest.mark.parametrize("compress", [False, True])
def test_donating_trainer_matches_the_jax_donated_step(tmp_path, compress):
    """The JAX init of reduced mixtral-8x22b (fp32, drop-free routing),
    carried into the port by bridge.py: 3 steps of the port's Trainer (which
    donates) against 3 of the JAX Trainer's own jitted step
    (``donate_argnums=(0,)``) on the same batches; with int8 compression
    the error state is donated too."""
    arch = "mixtral-8x22b"
    jbb = JBackbone(jreduced(jget_config(arch)), compute_dtype=jax.numpy.float32,
                    remat=False)
    bb = Backbone(reduced(get_config(arch)), compute_dtype=torch.float32,
                  remat=False, device="cpu")
    jset = JStepSettings(zero3=False, gather_weights=False, remat=False,
                         compress_grads=compress)
    settings = StepSettings(zero3=False, gather_weights=False, remat=False,
                            compress_grads=compress)
    opt = dict(lr=5e-3, warmup_steps=1, total_steps=10)
    steps = 3
    jdata = JDataConfig(vocab=bb.cfg.vocab, seq_len=16, global_batch=4)
    data = DataConfig(vocab=bb.cfg.vocab, seq_len=16, global_batch=4)
    jstate = jinit_train_state(jbb, jax.random.PRNGKey(0), jset)
    state = bridge.train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    if compress:
        state["error"] = adamw.tree_map(torch.zeros_like, state["params"])
    jtr = JTrainer(jbb, jadamw.AdamWConfig(**opt), jdata,
                   JTrainerConfig(total_steps=steps, ckpt_dir=str(
                       tmp_path / "j")), jset)
    want = []
    try:
        for i in range(steps):
            jstate, jm = jtr._step(jstate, jmake_batch(jdata, i))
            want.append((float(jm["loss"]), float(jm["grad_norm"])))
    finally:
        jtr.shutdown()
    tr = Trainer(bb, adamw.AdamWConfig(**opt), data,
                 TrainerConfig(total_steps=steps, ckpt_every=steps + 1,
                               ckpt_dir=str(tmp_path / "t"), log_every=100),
                 settings)
    try:
        tr.init_or_restore()
        leaves = adamw.tree_leaves(state)
        out = tr.run(state)
        got = [(m["loss"], m["grad_norm"]) for m in tr.metrics_log]
    finally:
        tr.shutdown()
    assert all(a is b for a, b in zip(adamw.tree_leaves(out), leaves))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for g, w in zip(adamw.tree_leaves(out["params"]),
                    jax.tree_util.tree_leaves(jstate["params"])):
        rms = float(np.sqrt(np.mean((g.numpy() - np.asarray(w)) ** 2)))
        assert rms <= 1e-3 * opt["lr"], rms
    assert int(out["opt"]["step"]) == int(jstate["opt"]["step"]) == steps


# ---------------------------------------------------------------------------
# The store and checkpoints under donation
# ---------------------------------------------------------------------------
def _qwen_trainer(tmp_path, total, ckpt_every):
    cfg = reduced(get_config("qwen3-4b"))
    bb = Backbone(cfg, compute_dtype=torch.float32, remat=False, device="cpu")
    return Trainer(bb, adamw.AdamWConfig(lr=2e-3, warmup_steps=2,
                                         total_steps=total),
                   DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
                   TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                                 ckpt_dir=str(tmp_path), log_every=1000),
                   SETTINGS)


def _recording(store):
    """Wrap ``store.commit_step`` to keep a host copy of every committed
    state, taken in the trainer's thread before its next step."""
    committed = {}
    commit = store.commit_step

    def commit_step(params, opt, step):
        if params is not None:
            committed[step] = to_host({"params": params, "opt": opt})
        commit(params, opt, step)
    store.commit_step = commit_step
    return committed


def test_checkpoint_is_exact_under_donation(tmp_path):
    """Checkpoints at steps 2 and 4 of 5 each restore bit for bit to the
    state committed after that step, although the next step wrote into
    those tensors; the run donated (the state's tensors are the initial
    ones)."""
    tr = _qwen_trainer(tmp_path, total=5, ckpt_every=2)
    try:
        committed = _recording(tr.store)
        state = tr.init_or_restore()
        leaves = adamw.tree_leaves(state)
        out = tr.run(state)
        assert all(a is b for a, b in zip(adamw.tree_leaves(out), leaves))
        assert _equal(to_host({"params": out["params"], "opt": out["opt"]}),
                      committed[5])
        assert not _equal(committed[2], committed[4])
        template = init_train_state(tr.bb, 0, tr.settings, device="meta")
        for step in (2, 4):
            restored, at = tr.ckpt.restore(template, step)
            assert at == step
            assert _equal({"params": restored["params"],
                           "opt": restored["opt"]}, committed[step])
    finally:
        tr.shutdown()


class _UpdateWriter:
    """A trainer thread without a model: each step donates the state to
    ``apply_updates_`` with large leaves (so its writes take long enough to
    overlap a reader's copies), commits, and leaves the committed state
    standing for 2 ms, as a step's forward and backward would."""

    def __init__(self, store, steps):
        self.store, self.steps = store, steps
        rng = np.random.default_rng(1)
        self.params = {f"w{i}": torch.from_numpy(rng.standard_normal(
            1 << 18).astype(np.float32)) for i in range(4)}
        self.opt = adamw.init_state(self.params)
        self.grads = [adamw.tree_map(lambda p: torch.from_numpy(
            rng.standard_normal(p.shape).astype(np.float32)), self.params)
            for _ in range(2)]
        self.cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)

    def run(self):
        for step in range(1, self.steps + 1):
            adamw.apply_updates_(self.cfg, self.params, self.opt,
                                 self.grads[step % 2])
            self.store.commit_step(self.params, self.opt, step)
            time.sleep(2e-3)        # the next step's forward and backward


@pytest.mark.parametrize("writer", ["trainer", "update"])
def test_reader_gets_a_committed_state_or_a_torn_error(tmp_path, writer):
    """A reader thread snapshots params, opt and the cursor to the host
    while the trainer thread donates its state step after step (the
    Trainer itself, or a bare loop of apply_updates_ over 4 MiB of leaves):
    every snapshot is one committed step's state bit for bit (its versions
    all equal) or TornSnapshotError, never a torn value; at least one
    snapshot of a committed state comes through."""
    if writer == "trainer":
        tr = _qwen_trainer(tmp_path, total=30, ckpt_every=1000)
        store = tr.store
        committed = _recording(store)
        state = tr.init_or_restore()

        def train():
            tr.run(state)
    else:
        store = VersionedStateStore()
        w = _UpdateWriter(store, steps=200)
        committed = _recording(store)
        train = w.run
    seen, torn, bad = [], [], []
    done = threading.Event()

    def reader():
        deadline = time.monotonic() + 120
        while not done.is_set() and time.monotonic() < deadline:
            try:
                snap = store.snapshot(("params", "opt", "data_cursor"),
                                      host=True)
            except RuntimeError as err:
                if not _torn(err):
                    raise
                torn.append(err)
            else:
                if snap["params"] is not None:
                    seen.append(snap)
            time.sleep(1e-3)        # leaves the trainer the GIL

    t = threading.Thread(target=reader)
    t.start()
    try:
        train()
    finally:
        done.set()
        t.join(timeout=120)
        (tr.shutdown if writer == "trainer" else store.shutdown)()
    assert not t.is_alive()
    for snap in seen:
        step = snap["data_cursor"]
        assert snap["params_version"] == snap["opt_version"] == step
        if not _equal({"params": snap["params"], "opt": snap["opt"]},
                      committed[step]):
            bad.append(step)
    assert bad == [] and len(seen) > 0, (bad, len(seen), len(torn))


# ---------------------------------------------------------------------------
# The dry run
# ---------------------------------------------------------------------------
def test_dryrun_train_cell_counts_one_state(monkeypatch):
    """qwen3-4b at full width and 2 layers, [2, 256], on a (1, 1) mesh over
    the fake group, the reference's settings (ZeRO-3, the per-layer gather,
    remat). The donating cell's temp_bytes equal those of the same cell
    with the update left out: the update, sliced, adds nothing above the
    backward's peak (the grads and the backward's transients), so the cell
    counts one state. The cell built with the functional step counts a
    second state: its temp_bytes hold the grads and a whole new params, m
    and v at once (16 bytes a parameter). Both count the same arguments,
    params, m and v (12 bytes a parameter). The difference of the two
    cells' temp_bytes is not the whole 12 bytes a parameter: the functional
    update's peak falls at one leaf and the backward's at another."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import LayerGroup, ShapeConfig
    from repro_torch.runtime import steps

    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              groups=(LayerGroup(("attn",), 2),))
    shape = ShapeConfig("train", 256, 2, "train")
    mesh.init_fake_world(1)
    try:
        m = mesh.make_host_mesh()

        def count():
            return dryrun.count_cell(cfg, shape, m,
                                     settings=StepSettings())["memory"]
        donated = count()
        with monkeypatch.context() as mp:
            mp.setattr(adamw, "apply_updates_", lambda *a: {})
            no_update = count()
        monkeypatch.setattr(dryrun, "make_train_step",
                            lambda *a, donate=False: steps.make_train_step(*a))
        functional = count()
    finally:
        dist.destroy_process_group()
    n = sum(int(t.numel()) for t in adamw.tree_leaves(
        Backbone(cfg, device="meta").init(device="meta")))
    assert donated["argument_bytes"] == functional["argument_bytes"] \
        == no_update["argument_bytes"] >= 12 * n
    assert donated["temp_bytes"] == no_update["temp_bytes"] > 4 * n
    assert functional["temp_bytes"] >= 16 * n > donated["temp_bytes"]
    assert donated["peak_bytes"] == (donated["argument_bytes"]
                                     + donated["temp_bytes"])
