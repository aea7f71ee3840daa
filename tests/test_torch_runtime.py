"""The port's training runtime on the CPU against the JAX package: the data
pipeline, the copied OptSVA-CF core, the transactional state store, the
checkpoint store and the ``Trainer``.

Tolerances: batches and checkpoint files bit for bit; the crash-restart
losses 1e-5 relative (tests/test_runtime.py's limit: the same CPU ops in
the same order); the port's Trainer against the JAX Trainer from one
checkpoint 1e-4 relative over 5 steps (fp32; the two backbones' attention
and reductions round differently, and the optimizer feeds the difference
forward).
"""
import gc
import pathlib
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JCheckpointStore
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import Backbone as JBackbone
from repro.models import LayerGroup as JLayerGroup
from repro.models import ModelConfig as JModelConfig
from repro.optim import adamw as jadamw
from repro.runtime.steps import StepSettings as JStepSettings
from repro.runtime.steps import init_train_state as jinit_train_state
from repro.runtime.train_loop import Trainer as JTrainer
from repro.runtime.train_loop import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.store import AsyncCheckpointer, CheckpointStore
from repro_torch.data.pipeline import DataConfig, Pipeline, make_batch
from repro_torch.models import Backbone, LayerGroup, ModelConfig
from repro_torch.optim import adamw
from repro_torch.runtime.steps import StepSettings
from repro_torch.runtime.train_loop import (StragglerStats, Trainer,
                                            TrainerConfig, rescale_state)
from repro_torch.txstore.store import TornSnapshotError, VersionedStateStore

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
SETTINGS = StepSettings(zero3=False, gather_weights=False, remat=False)


def _cfg():
    return ModelConfig(name="rt-test", family="dense",
                       groups=(LayerGroup(("attn",), 2),), **SMALL)


def _trainer(tmpdir, total=24, ckpt_every=8, **kw):
    bb = Backbone(_cfg(), compute_dtype=torch.float32, remat=False,
                  device="cpu")
    return Trainer(bb, adamw.AdamWConfig(lr=2e-3, warmup_steps=4,
                                         total_steps=total),
                   DataConfig(vocab=SMALL["vocab"], seq_len=16,
                              global_batch=4),
                   TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                                 ckpt_dir=str(tmpdir), log_every=1000),
                   SETTINGS, **kw)


# ---------------------------------------------------------------------------
# The data pipeline: a copy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", [
    dict(vocab=256, seq_len=16, global_batch=4),
    dict(vocab=151_936, seq_len=33, global_batch=3, seed=7),
    dict(vocab=128, seq_len=8, global_batch=2, enc_seq=5, enc_dim=6),
], ids=str)
def test_make_batch_bit_for_bit(cfg):
    for step in (0, 1, 17):
        got, want = make_batch(DataConfig(**cfg), step), jmake_batch(
            JDataConfig(**cfg), step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_pipeline_deterministic_and_restorable():
    cfg = DataConfig(vocab=256, seq_len=16, global_batch=4)
    a = [next(Pipeline(cfg, i)) for i in range(3)]
    p = Pipeline(cfg, 0)
    next(p), next(p)
    p.restore(1)
    np.testing.assert_array_equal(next(p)["tokens"], a[1]["tokens"])


# ---------------------------------------------------------------------------
# The copied OptSVA-CF core and obs modules
# ---------------------------------------------------------------------------
COPIES = ["core/api.py", "core/buffers.py", "core/executor.py",
          "core/versioning.py", "core/registry.py", "core/transaction.py",
          "core/faults.py", "obs/txtrace.py", "obs/metrics.py",
          "data/pipeline.py"]
NET_STUB = ("        from repro.net.remote import RemoteNode  # lazy: net "
            "imports core",
            '        raise NotImplementedError("no net layer in the port: '
            'ROADMAP.md slice 8")')
# the one docstring line the copy words otherwise: the source names the
# benchmark by the change that added it
BENCH_NOTE = "attribute read per site (the <1% overhead budget of the "


def _is_import(line):
    s = line.strip()
    return s.startswith(("import ", "from "))


@pytest.mark.parametrize("module", COPIES)
def test_copied_module_equals_its_source_line_for_line(module):
    """Apart from import lines (``repro.`` -> ``repro_torch.``; the
    pipeline's unused jax imports dropped), the stub of
    ``Registry.connect``'s net import and one docstring line of txtrace."""
    src = (ROOT / "src" / "repro" / module).read_text().splitlines()
    port = (ROOT / "src" / "repro_torch" / module).read_text().splitlines()
    if module == "data/pipeline.py":
        src = [l for l in src if l not in ("import jax", "import jax.numpy as jnp")]
    assert len(src) == len(port)
    for a, b in zip(src, port):
        if a == b:
            continue
        if (a, b) == NET_STUB or (a.startswith(BENCH_NOTE) and
                                  b == BENCH_NOTE + "transport bench)."):
            continue
        assert _is_import(a) and b == a.replace("repro.", "repro_torch.", 1), (a, b)


def test_copied_core_runs_a_transaction():
    from repro_torch.core import (Mode, Registry, Transaction,
                                  TransactionMonitor, access)

    class Account:
        def __init__(self, v):
            self.v = v

        @access(Mode.READ)
        def get(self):
            return self.v

        @access(Mode.UPDATE)
        def add(self, d):
            self.v += d

    reg = Registry()
    node = reg.add_node("n")
    a, b = reg.bind("a", Account(10), node=node), reg.bind("b", Account(0),
                                                           node=node)
    mon = TransactionMonitor(reg, timeout=5.0)
    mon.start()
    try:
        t = Transaction(reg)
        pa, pb = t.updates(a, 1), t.updates(b, 1)
        t.start(lambda _t: (pa.add(-3), pb.add(3)))
        t = Transaction(reg)
        ra, rb = t.reads(a, 1), t.reads(b, 1)
        out = {}
        t.start(lambda _t: out.update(a=ra.get(), b=rb.get()))
        assert out == {"a": 7, "b": 3}
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            reg.connect("localhost:1")
    finally:
        mon.stop()
        reg.shutdown()


# ---------------------------------------------------------------------------
# The transactional state store
# ---------------------------------------------------------------------------
def test_txstore_snapshot_is_consistent_cut_with_fresh_tensors():
    """tests/test_runtime.py::test_txstore_snapshot_is_consistent_cut with
    tensors: the trainer thread builds each step's state from the last one
    (fresh tensors, as the train step does) while snapshots are taken and
    copied to the host; every copy is a consistent cut."""
    store = VersionedStateStore()
    bad, seen = [], []
    stop = threading.Event()

    def trainer():
        w, m, step = torch.zeros(64), torch.zeros(64), 0
        while not stop.is_set():
            step += 1
            w, m = w + 1, m + 1
            store.commit_step({"w": w}, {"m": m}, step)

    def checker():
        deadline = time.monotonic() + 30
        while len(seen) < 30 and time.monotonic() < deadline:
            snap = store.snapshot(("params", "opt", "data_cursor"))
            if snap["params"] is None:
                continue
            w, m = snap["params"]["w"].clone(), snap["opt"]["m"].clone()
            seen.append(snap["data_cursor"])
            if not (bool((w == snap["data_cursor"]).all())
                    and bool((m == snap["data_cursor"]).all())):
                bad.append(snap["data_cursor"])

    t = threading.Thread(target=trainer)
    c = threading.Thread(target=checker)
    t.start(); c.start(); c.join(timeout=60); stop.set(); t.join(timeout=60)
    store.shutdown()
    assert not t.is_alive() and not c.is_alive()
    assert bad == [] and len(seen) == 30


def test_txstore_refuses_a_snapshot_of_a_tensor_changed_in_place():
    """A published tensor updated in place (what a step that wrote into its
    state would do) would make a torn snapshot: the cell refuses it."""
    store = VersionedStateStore()
    try:
        w = torch.zeros(8)
        store.commit_step({"w": w}, {"m": torch.zeros(8)}, 1)
        assert store.snapshot(("params",))["params"]["w"] is w
        w.add_(1.0)                                  # step 2, in place
        with pytest.raises(RuntimeError) as err:
            store.snapshot(("params", "opt", "data_cursor"))
        assert isinstance(err.value, TornSnapshotError) or isinstance(
            err.value.__cause__, TornSnapshotError)
        store.commit_step({"w": w.clone()}, {"m": torch.zeros(8)}, 2)
        assert store.snapshot(("data_cursor",))["data_cursor"] == 2
    finally:
        store.shutdown()


def test_txstore_keeps_no_earlier_state_alive():
    """A finished transaction's buffers are dropped: the state before a
    commit is freed at once, not when the cyclic collector runs."""
    store = VersionedStateStore()
    gc.disable()
    try:
        w = torch.zeros(1000)
        ref = weakref.ref(w)
        store.commit_step({"w": w}, {"m": torch.zeros(3)}, 1)
        store.snapshot(("params", "opt", "data_cursor"))
        del w
        store.commit_step({"w": torch.ones(1000)}, {"m": torch.zeros(3)}, 2)
        store.snapshot(("params", "opt", "data_cursor"))
        assert ref() is None
    finally:
        gc.enable()
        store.shutdown()


def test_txstore_checkpoint_metadata_and_rescale():
    store = VersionedStateStore()
    try:
        store.record_checkpoint(5, "ckpt/step_5")
        meta = store.latest_checkpoint()
        assert meta["step"] == 5 and meta["path"].endswith("step_5")
        store.commit_step({"w": torch.arange(4.0)}, {"v": torch.zeros(2)}, 1)
        store.rescale(lambda tree: rescale_state(tree, "meta"))
        snap = store.snapshot(("params", "opt"))
        assert snap["params"]["w"].device.type == "meta"
        assert snap["opt"]["v"].device.type == "meta"
    finally:
        store.shutdown()


# ---------------------------------------------------------------------------
# The checkpoint store
# ---------------------------------------------------------------------------
def _state_tree():
    return {"params": {"b": torch.arange(6.0).reshape(2, 3),
                       "a": {"c": torch.ones(4, dtype=torch.bfloat16) / 3}},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip_gc_and_latest(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = _state_tree()
    for s in (1, 2, 3, 4, 5):
        store.save(tree, s)
    store.gc(keep=2)
    assert store.latest_step() == 5
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_4",
                                                               "step_5"]
    template = adamw.tree_map(lambda t: torch.empty_like(t, device="meta"),
                              tree)
    got, step = store.restore(template)
    assert step == 5
    for a, b in zip(adamw.tree_leaves(got), adamw.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.device.type == "cpu"
        assert torch.equal(a, b)


def test_async_checkpointer_writes_and_reports(tmp_path):
    store = CheckpointStore(str(tmp_path))
    done = []
    ac = AsyncCheckpointer(store, on_done=lambda s, p: done.append(s))
    ac.submit({"a": torch.ones(3)}, 10)
    ac.stop()
    assert ac.saved == [10] and done == [10] and ac.errors == []
    assert store.latest_step() == 10


def _jax_tree():
    return {"params": {"b": jnp.arange(6.0).reshape(2, 3),
                       "a": {"c": jnp.ones((4,), jnp.bfloat16) / 3}},
            "opt": {"step": jnp.asarray(7, jnp.int32)}}


def _files(d, step):
    root = pathlib.Path(d) / f"step_{step}"
    return {p.name: p.read_bytes() for p in root.iterdir()}


def test_checkpoint_files_equal_the_reference_writers(tmp_path):
    """The same tree written by both stores gives the same files: manifest
    and every .npy, the bf16 leaf included."""
    JCheckpointStore(str(tmp_path / "j")).save(_jax_tree(), 3)
    CheckpointStore(str(tmp_path / "t")).save(_state_tree(), 3)
    assert _files(tmp_path / "j", 3) == _files(tmp_path / "t", 3)
    assert (tmp_path / "j" / "LATEST").read_text() == (
        tmp_path / "t" / "LATEST").read_text()


def test_checkpoint_cross_restore_both_directions(tmp_path):
    # JAX writes (a bf16 leaf among them), the port restores the bits
    JCheckpointStore(str(tmp_path / "j")).save(_jax_tree(), 3)
    template = adamw.tree_map(lambda t: torch.empty_like(t, device="meta"),
                              _state_tree())
    got, step = CheckpointStore(str(tmp_path / "j")).restore(template)
    want = _state_tree()
    assert step == 3
    for a, b in zip(adamw.tree_leaves(got), adamw.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the port writes, JAX restores. The reference's restore cannot load a
    # bfloat16 leaf, its own included (np.load gives 2-byte voids, which
    # jnp.asarray refuses: ROADMAP.md section 3), so it restores the other
    # leaves, and the bf16 file is read back as the reference's ml_dtypes
    # bfloat16 bits
    store = CheckpointStore(str(tmp_path / "t"))
    store.save(_state_tree(), 4)
    jtemplate = {"params": {"b": np.zeros((2, 3), np.float32)},
                 "opt": {"step": np.zeros((), np.int32)}}
    jgot, jstep = JCheckpointStore(str(tmp_path / "t")).restore(jtemplate)
    assert jstep == 4 and int(jgot["opt"]["step"]) == 7
    np.testing.assert_array_equal(np.asarray(jgot["params"]["b"]),
                                  np.arange(6.0, dtype=np.float32).reshape(2, 3))
    import json
    manifest = json.loads((tmp_path / "t" / "step_4" / "manifest.json")
                          .read_text())
    meta = manifest["leaves"]["params/a/c"]
    raw = np.load(tmp_path / "t" / "step_4" / meta["file"])
    np.testing.assert_array_equal(
        raw.view(ml_dtypes.bfloat16),
        np.asarray(jnp.ones((4,), jnp.bfloat16) / 3))
    with pytest.raises(TypeError):   # the reference's own limit, both files
        JCheckpointStore(str(tmp_path / "j")).restore(
            {"params": {"a": {"c": np.zeros(4, ml_dtypes.bfloat16)}}})


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------
def test_trainer_loss_decreases(tmp_path):
    tr = _trainer(tmp_path)
    try:
        tr.run(tr.init_or_restore())
        losses = [m["loss"] for m in tr.metrics_log]
        assert losses[-1] < losses[0]
        assert all(np.isfinite(m["grad_norm"]) for m in tr.metrics_log)
        assert tr.async_ckpt.errors == [] and tr.ckpt.latest_step() == 24
        assert tr.store.snapshot(("data_cursor",))["data_cursor"] == 24
    finally:
        tr.shutdown()


def test_trainer_crash_restart_matches_uninterrupted(tmp_path):
    tr = _trainer(tmp_path / "a")
    try:
        tr.run(tr.init_or_restore())
        ref_losses = {m["step"]: m["loss"] for m in tr.metrics_log}
    finally:
        tr.shutdown()
    tr1 = _trainer(tmp_path / "b")
    try:
        with pytest.raises(RuntimeError, match="injected crash"):
            tr1.run(tr1.init_or_restore(), crash_at=13)
    finally:
        tr1.shutdown()
    tr2 = _trainer(tmp_path / "b")
    try:
        state = tr2.init_or_restore()
        assert tr2.start_step == 8          # resumed from the checkpoint
        tr2.run(state)
        res_losses = {m["step"]: m["loss"] for m in tr2.metrics_log}
    finally:
        tr2.shutdown()
    for step in range(8, 24):
        np.testing.assert_allclose(res_losses[step], ref_losses[step],
                                   rtol=1e-5)


def test_trainer_resumes_from_a_jax_checkpoint_like_the_jax_trainer(tmp_path):
    """A JAX init saved at step 0 by the JAX CheckpointStore, into two
    directories: the JAX Trainer resumes from one, the port's from the
    other, and their first 5 losses agree (the analog of
    tests/test_system.py::test_train_end_to_end_loss_decreases through the
    cross-restore path)."""
    jcfg = JModelConfig(name="rt-test", family="dense",
                        groups=(JLayerGroup(("attn",), 2),), **SMALL)
    jbb = JBackbone(jcfg, compute_dtype=jnp.float32, remat=False)
    jset = JStepSettings(zero3=False, gather_weights=False, remat=False)
    state = jinit_train_state(jbb, jax.random.PRNGKey(0), jset)
    for d in ("j", "t"):
        JCheckpointStore(str(tmp_path / d)).save(state, 0)
    opt = dict(lr=2e-3, warmup_steps=4, total_steps=5)
    jtr = JTrainer(jbb, jadamw.AdamWConfig(**opt),
                   JDataConfig(vocab=SMALL["vocab"], seq_len=16,
                               global_batch=4),
                   JTrainerConfig(total_steps=5, ckpt_every=100,
                                  ckpt_dir=str(tmp_path / "j"),
                                  log_every=1000), jset)
    try:
        jtr.run(jtr.init_or_restore())
        want = [m["loss"] for m in jtr.metrics_log]
    finally:
        jtr.shutdown()
    tr = _trainer(tmp_path / "t", total=5, ckpt_every=100)  # the same opt
    try:
        tr.run(tr.init_or_restore())
        assert tr.start_step == 0
        got = [m["loss"] for m in tr.metrics_log]
    finally:
        tr.shutdown()
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_straggler_detection_and_hook(tmp_path):
    st = StragglerStats()
    hits = [step for step in range(40)
            if st.observe(0.1 if step != 30 else 2.0, step, z_thresh=4.0,
                          warmup=10)]
    assert hits == [30]
    events = []
    tr = _trainer(tmp_path, total=5, ckpt_every=100,
                  straggler_hook=events.append)
    try:
        tr.straggler.n, tr.straggler.ewma, tr.straggler.ewvar = 20, 1e-6, 1e-14
        tr.run(tr.init_or_restore())
        assert len(events) >= 1
    finally:
        tr.shutdown()


@pytest.mark.parametrize("arch", ["qwen3-4b", "recurrentgemma-9b",
                                  "rwkv6-3b"])
def test_train_launcher_runs_on_the_cpu(tmp_path, monkeypatch, capsys, arch):
    from repro_torch.launch import train
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", arch, "--reduced", "--device", "cpu",
        "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-every", "3",
        "--ckpt-dir", str(tmp_path)])
    train.main()
    out = capsys.readouterr().out
    assert "on cpu" in out and "checkpoints [3, 6]" in out
