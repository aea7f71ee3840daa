"""The port's distribution and cost-analysis layer against the JAX package:
the shape table, the suprema, every sharding rule (parameters, batches,
caches) on the production meshes, MODEL_FLOPS, the long_500k skips and the
roofline terms with the H100's rates; the cost counter's per-device FLOPs
and collective bytes on known sharded matmuls; the kernels' meta shape
functions; one sharded train step on four gloo ranks against the plain
step; the sharded Trainer with a checkpoint, a restore and an elastic
rescale at world size 1; moe_mlp_ep over two gloo ranks.

The reference's rule functions read only a mesh's axis names and sizes, so
they get a ``jax.sharding.AbstractMesh`` (no devices); the port's get a
stub with ``mesh_dim_names`` and ``shape``. Collectives run over the fake
process group (one process) or gloo over a FileStore (several), never a
network address.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.launch import roofline as jrl
from repro.launch import shardings as jsh
from repro.launch.dryrun import cell_skip_reason as j_skip
from repro.models import Backbone as JBackbone
from repro.models import PartitionPlan as JPlan
from repro.models import SHAPES as J_SHAPES
from repro.models import get_config as j_get_config
from repro.models.config import all_configs as j_all_configs
from repro.sched import release_points as j_release_points
from repro.sched import step_suprema as j_step_suprema
from repro_torch.kernels import ops
from repro_torch.launch import roofline as rl
from repro_torch.launch import shardings as sh
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.dryrun import cell_skip_reason
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import (ARCH_NAMES, SHAPES, Backbone, PartitionPlan,
                                all_configs, get_config)
from repro_torch.sched import release_points, step_suprema

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass
class StubMesh:
    """The port's rules read a mesh's axis names and sizes only."""

    shape: tuple
    mesh_dim_names: tuple


def meshes(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names), StubMesh(shape, names)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _jax_leaves(tree):
    import jax
    return {tuple(p.key if hasattr(p, "key") else str(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# --------------------------------------------------------------------------- #
# Shapes, configs, suprema                                                     #
# --------------------------------------------------------------------------- #
def test_shapes_and_configs_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    port, ref = all_configs(), j_all_configs()
    assert sorted(port) == sorted(ref) == sorted(ARCH_NAMES)
    for name in ARCH_NAMES:
        assert dataclasses.asdict(port[name]) == dataclasses.asdict(ref[name])


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_derived_config_properties_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for prop in ("n_layers", "hd", "is_enc_dec", "sub_quadratic"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.layer_kinds() == jcfg.layer_kinds()
    assert cfg.sub_quadratic == (arch in ("recurrentgemma-9b", "rwkv6-3b",
                                          "mixtral-8x22b"))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_step_suprema_and_release_points_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for remat in (True, False):
        got, want = step_suprema(cfg, remat=remat), j_step_suprema(
            jcfg, remat=remat)
        assert list(got) == list(want)
        for k in got:
            assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k])
            g, w = got[k].as_suprema(), want[k].as_suprema()
            assert (g.reads, g.writes, g.updates, g.total) == (
                w.reads, w.writes, w.updates, w.total)
    assert release_points(cfg) == j_release_points(jcfg)


def test_gemma2_g0_suprema_pinned():
    plan = step_suprema(get_config("gemma2-2b"), remat=True)
    assert plan["g0"].weight_reads == 3       # fwd + remat + bwd
    assert plan["g0"].grad_writes == 1
    assert plan["g0"].optimizer_updates == 1
    assert plan["g0"].as_suprema().total == 5


# --------------------------------------------------------------------------- #
# Sharding rules                                                               #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch):
    """Every leaf's spec, both production meshes, ZeRO-3 on and off, and
    full-DP where full_dp_active says so (at train_4k's batch)."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    B = SHAPES["train_4k"].global_batch
    for kind in MESHES:
        jmesh, mesh = meshes(kind)
        fdp_options = {False, sh.full_dp_active(cfg, mesh, B)}
        assert sh.full_dp_active(cfg, mesh, B) == jsh.full_dp_active(
            jcfg, jmesh, B)
        for fdp in fdp_options:
            tp = 1 if fdp else 16
            bb = Backbone(cfg, PartitionPlan(tp=tp), device="meta")
            jbb = JBackbone(jcfg, JPlan(tp=tp))
            jleaves = _jax_leaves(jbb.param_specs())
            for zero3 in (True, False):
                got = dict(_walk(sh.param_shardings(bb, mesh, zero3=zero3,
                                                    full_dp=fdp)))
                assert sorted(got) == sorted(jleaves)
                for path, leaf in jleaves.items():
                    want = jsh.param_spec(path, leaf.shape, jcfg, jmesh,
                                          zero3=zero3, full_dp=fdp)
                    assert tuple(got[path].spec) == tuple(want), (
                        kind, fdp, zero3, path)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for kind in MESHES:
        jmesh, mesh = meshes(kind)
        for shape in SHAPES.values():
            for batch_sharded in (True, False):
                got = sh.batch_shardings(cfg, shape, mesh,
                                         batch_sharded=batch_sharded)
                want = jsh.batch_shardings(jcfg, J_SHAPES[shape.name], jmesh,
                                           batch_sharded=batch_sharded)
                assert {k: tuple(v.spec) for k, v in got.items()} == {
                    k: tuple(v.spec) for k, v in want.items()}
        bb = Backbone(cfg, PartitionPlan(tp=16), device="meta")
        jbb = JBackbone(jcfg, JPlan(tp=16))
        for B in (1, 8, 128):
            got = {p: tuple(s.spec) for p, s in _walk(
                sh.cache_shardings(bb, mesh, B))}
            want = {p: tuple(s.spec) for p, s in _jax_leaves(
                jsh.cache_shardings(jbb, jmesh, B)).items()}
            assert got == want, (kind, B)
    assert tuple(sh.batch_spec(meshes("multi")[1])) == tuple(
        jsh.batch_spec(meshes("multi")[0]))


def test_a_tuple_of_axes_shards_one_dim_pod_major():
    init_fake_world(512)
    try:
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        got = sh.placements(sh.PSpec(("pod", "data"), None, "model"), mesh)
        assert got == (sh.Shard(0), sh.Shard(0), sh.Shard(2))
        assert sh.placements(sh.PSpec(None, None), mesh) == (
            sh.Replicate(),) * 3
        t = sh.distribute(torch.empty(64, 8, 32, device="meta"),
                          sh.NamedSharding(mesh, sh.PSpec(("pod", "data"),
                                                          None, "model")))
        assert tuple(t.to_local().shape) == (2, 8, 2)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Roofline, MODEL_FLOPS, skips                                                 #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_active_params_equal_the_reference(arch):
    bb = Backbone(get_config(arch), PartitionPlan(tp=16), device="meta")
    jbb = JBackbone(j_get_config(arch), JPlan(tp=16))
    assert rl.active_param_count(bb) == jrl.active_param_count(jbb)
    for shape in SHAPES.values():
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        assert rl.model_flops(bb, shape.kind, tokens) == jrl.model_flops(
            jbb, shape.kind, tokens)


def test_cell_skip_reason_matches_the_reference():
    for arch in ARCH_NAMES:
        for name, shape in SHAPES.items():
            assert cell_skip_reason(arch, shape) == j_skip(
                arch, J_SHAPES[name]), (arch, name)


def test_roofline_terms_dominant_and_fraction_at_h100_rates():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 450e9)
    t = rl.RooflineTerms(compute_s=0.5, memory_s=0.2, collective_s=0.8,
                         model_flops=rl.PEAK_FLOPS * 0.4 * 256, hlo_flops=1e14,
                         useful_ratio=0.5, n_chips=256)
    assert t.dominant == "collective"
    assert t.roofline_fraction == pytest.approx(0.4 / 0.8)
    terms = rl.derive_terms({"flops": 989e12, "bytes accessed": 6.7e12},
                            900e9, 2 * 989e12, 2)
    assert (terms.compute_s, terms.memory_s, terms.collective_s) == (
        pytest.approx(1.0), pytest.approx(2.0), pytest.approx(2.0))
    assert terms.useful_ratio == pytest.approx(1.0)


# --------------------------------------------------------------------------- #
# The cost counter                                                             #
# --------------------------------------------------------------------------- #
def _local(mesh, shape, placements, requires_grad=False):
    local = list(shape)
    for i, p in enumerate(placements):
        if isinstance(p, sh.Shard):
            local[p.dim] //= mesh.shape[i]
    return sh.DTensor.from_local(
        torch.empty(local, device="meta", requires_grad=requires_grad),
        mesh, placements, run_check=False)


def test_cost_counter_counts_one_rank_of_a_sharded_matmul():
    """[4096, 2560] x [2560, 9728] on the fake (16, 16) mesh: one rank's
    FLOPs exactly (FlopCounterMode would add the global product's), with
    and without the contraction dim sharded; the Partial result's
    all-reduce counted by its output bytes."""
    S, R = sh.Shard, sh.Replicate
    init_fake_world(256)
    try:
        mesh = make_production_mesh(device_type="cuda")
        x = _local(mesh, (4096, 2560), (S(0), R()))
        w = _local(mesh, (2560, 9728), (R(), S(1)))
        with CostCounter() as c:
            y = x @ w
        assert tuple(y.to_local().shape) == (256, 608)
        assert c.totals.flops == 2 * 256 * 2560 * 608
        assert c.totals.collective_bytes == 0 == c.totals.collective_count
        x = _local(mesh, (4096, 2560), (R(), S(1)))
        w = _local(mesh, (2560, 9728), (R(), S(0)))
        with CostCounter() as c:
            y = (x @ w).redistribute(mesh, (R(), R()))
        assert c.totals.flops == 2 * 4096 * 160 * 9728
        assert c.totals.coll_by_op == {"all-reduce": 4096 * 9728 * 4}
        assert c.totals.collective_count == 1
        assert c.totals.in_loop_count == 0
        with CostCounter() as c:
            with c.in_layer():
                (x @ w).redistribute(mesh, (R(), R()))
        assert c.totals.in_loop_bytes == 4096 * 9728 * 4
    finally:
        dist.destroy_process_group()


def test_meta_shape_functions_charge_the_kernels_and_dtensors_raise():
    charged = []
    ops.SINKS.append(lambda name, flops, nbytes: charged.append(
        (name, flops, nbytes)))
    try:
        q = torch.empty(2, 8, 4, 16, device="meta", dtype=torch.bfloat16)
        kv = torch.empty(2, 8, 2, 16, device="meta", dtype=torch.bfloat16)
        pos = torch.empty(8, device="meta", dtype=torch.int32)
        kw = dict(q_positions=pos, kv_positions=pos)
        out, lse = ops.attention_fwd(q, kv, kv, **kw)
        assert out.shape == q.shape and lse.shape == (2, 2, 2, 8)
        assert lse.dtype == torch.float32
        grads = ops.attention_bwd(q, kv, kv, out, lse, out, **kw)
        assert [g.shape for g in grads] == [q.shape, kv.shape, kv.shape]
        ops.attention(q, kv, kv, window=3, **kw)
        x = torch.empty(2, 8, 32, device="meta")
        h = torch.empty(2, 32, device="meta")
        y, hT = ops.rglru_scan(x, h[0], x, x, h)
        assert y.shape == x.shape and hT.shape == h.shape
        assert len(ops.rglru_scan_bwd(x, h[0], x, x, h, y, y, h)) == 5
        r = torch.empty(2, 8, 4, 16, device="meta")
        s = torch.empty(2, 4, 16, 16, device="meta")
        y, sT = ops.rwkv6_scan(r, r, r, r, r[0, 0], s)
        assert y.shape == r.shape and sT.shape == s.shape
        assert len(ops.rwkv6_scan_bwd(r, r, r, r, r[0, 0], s, y, s)) == 6
    finally:
        ops.SINKS.pop()
    pairs = 8 * 9 // 2            # causal, Sq == Skv == 8
    window_pairs = 1 + 2 + 3 * 6  # window 3
    n = 2 * 8 * 4 * 16
    assert [(c[0], c[1]) for c in charged] == [
        ("flash_fwd", 4 * 16 * 4 * 2 * pairs),
        ("flash_bwd", 10 * 16 * 4 * 2 * pairs),
        ("flash_fwd", 4 * 16 * 4 * 2 * window_pairs),
        ("rglru_scan", 9 * 2 * 8 * 32), ("rglru_bwd", 20 * 2 * 8 * 32),
        ("wkv6_scan", (5 * 16 + 5) * n), ("wkv6_bwd", 14 * 16 * n)]
    # bytes: q, k, v read, out and the fp32 LSE written
    assert charged[0][2] == 2 * (1024 + 512 + 512 + 1024) + 4 * 64
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = torch.distributed.device_mesh.init_device_mesh(
            "cpu", (1,), mesh_dim_names=("model",))
        dq = sh.DTensor.from_local(torch.zeros(2, 8, 4, 16), mesh,
                                   (sh.Replicate(),), run_check=False)
        with pytest.raises(TypeError, match="local_map"):
            ops.attention(dq, kv, kv, **kw)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Real ranks: four gloo processes                                             #
# --------------------------------------------------------------------------- #
WORKER = textwrap.dedent('''
    import json, sys
    import torch, torch.distributed as dist
    rank, world, store, arch, out = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh, tp_size
    from repro_torch.models import (Backbone, PartitionPlan, ShapeConfig,
                                    get_config, reduced)
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                           make_train_step, value_and_grad)
    cfg = reduced(get_config(arch))
    # the MoE layer on (1, 4): its aux loss, a mean over the data ranks'
    # own, equals the plain path's only with one data rank
    moe = cfg.ffn_kind == "moe"
    mesh = make_host_mesh(dp=1 if moe else 2, tp=4 if moe else 2,
                          device_type="cpu")
    B, S = 8, 16
    fdp = sh.full_dp_active(cfg, mesh, B)
    plan = PartitionPlan(tp=1 if fdp else tp_size(mesh))
    kw = dict(compute_dtype=torch.float32, remat=True, device="cpu")
    plain = Backbone(cfg, plan, **kw)
    bb = Backbone(cfg, plan, sharder=sh.make_sharder(cfg, mesh, global_batch=B),
                  param_gather=sh.make_param_gatherer(cfg, mesh, full_dp=fdp),
                  mesh=mesh, dp_axes=sh.effective_dp(cfg, mesh, B),
                  moe_impl="ep" if moe else "gspmd", **kw)
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    state = init_train_state(plain, 0)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=S,
                                  global_batch=B), 0)
    st_sh = sh.state_shardings(sh.param_shardings(bb, mesh, full_dp=fdp),
                               mesh)
    bsh = sh.batch_shardings(cfg, ShapeConfig("t", S, B, "train"), mesh)
    dbatch = {k: sh.distribute(torch.as_tensor(v), bsh[k])
              for k, v in batch.items()}
    dstate = sh.tree_distribute(state, st_sh)
    want_loss, want_g = value_and_grad(plain, state["params"], batch)
    loss, grads = value_and_grad(bb, dstate["params"], dbatch)
    _, step_metrics = make_train_step(bb, opt)(dstate, dbatch)
    # the update of the same gradients, sharded and plain
    got_p = adamw.apply_updates(opt, dstate["params"], dstate["opt"],
                                sh.tree_distribute(want_g, st_sh["params"]))[0]
    want_p = adamw.apply_updates(opt, state["params"], state["opt"], want_g)[0]

    def rel(a, b):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
    res = {"loss": float(loss.full_tensor()), "want": float(want_loss),
           "step_loss": float(step_metrics["loss"].full_tensor()),
           "grad": max(rel(a, b) for a, b in zip(adamw.tree_leaves(grads),
                                                adamw.tree_leaves(want_g))),
           "update": max(rel(a, b) for a, b in zip(adamw.tree_leaves(got_p),
                                                  adamw.tree_leaves(want_p))),
           "full_dp": fdp}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()
''')


def _spawn(tmp_path, script, args, world, timeout=300):
    path = tmp_path / "worker.py"
    path.write_text(script)
    procs = [subprocess.Popen([sys.executable, str(path), str(r), str(world),
                               str(tmp_path / "store"), *args],
                              env={**os.environ, "PYTHONPATH": SRC},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), outs[0][-3000:]


@pytest.mark.parametrize("arch", ["qwen3-4b", "rwkv6-3b", "mixtral-8x22b"])
def test_sharded_train_step_equals_the_plain_step_on_four_gloo_ranks(
        arch, tmp_path):
    """A reduced qwen3-4b on a (data 2, model 2) mesh, a reduced rwkv6-3b
    full-DP (its batch over data x model) and a reduced mixtral-8x22b on
    (data 1, model 4) with the expert-parallel layer (one of its 4 experts
    a model rank) against the plain scatter path, ZeRO-3 with the per-layer gather, remat on,
    fp32: the loss, every gradient and the update of the same gradients
    equal the unsharded step's within 1e-5 relative (a leaf's max
    difference over its max)."""
    out = tmp_path / "out.json"
    _spawn(tmp_path, WORKER, [arch, str(out)], 4)
    res = json.loads(out.read_text())
    assert res["full_dp"] == (arch == "rwkv6-3b")
    assert res["loss"] == pytest.approx(res["want"], rel=1e-5)
    assert res["step_loss"] == res["loss"]
    assert res["grad"] < 1e-5 and res["update"] < 1e-5, res


MOE_WORKER = textwrap.dedent('''
    import json, sys, warnings
    import torch, torch.distributed as dist
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.models import ffn, get_config, moe_ep, reduced
    cfg = reduced(get_config("mixtral-8x22b"))
    g = torch.Generator().manual_seed(5)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    leaves = {"router": torch.randn(D, E, generator=g),
              "w_gate": torch.randn(E, D, Fe, generator=g) * 0.2,
              "w_up": torch.randn(E, D, Fe, generator=g) * 0.2,
              "w_down": torch.randn(E, Fe, D, generator=g) * 0.2}
    x = torch.randn(2, 16, D, generator=g)
    ct = torch.randn(2, 16, D, generator=g)

    def run(fn, scale):
        p = {k: v.clone().requires_grad_() for k, v in leaves.items()}
        xx = x.clone().requires_grad_()
        y, aux = fn(p, xx)
        # each rank holds 1/scale of the objective: the backward of the
        # all-reduce sums the ranks' cotangents, as the reference's psum
        # transposes
        ((torch.sum(y * ct) + aux) / scale).backward()
        return y.detach(), aux.detach(), xx.grad, {k: p[k].grad for k in p}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        y, aux, dx, dp = run(lambda p, xx: moe_ep.moe_mlp_ep(
            p, xx, cfg, dist.group.WORLD), world)
    ry, raux, rdx, rdp = run(lambda p, xx: ffn.moe_mlp(p, xx, cfg), 1)
    # a rank's gradients come from its own experts' part of y (and 1/world
    # of aux): x's, the router's and the expert leaves' sum over the ranks
    for t in [dx] + list(dp.values()):
        dist.all_reduce(t)
    err = lambda a, b: float((a - b).abs().max())
    res = {"y": err(y, ry), "aux": err(aux, raux), "dx": err(dx, rdx),
           "router": err(dp["router"], rdp["router"]),
           "experts": max(err(dp[k], rdp[k])
                          for k in ("w_gate", "w_up", "w_down")),
           "deprecations": [str(w.message) for w in caught
                            if issubclass(w.category, (DeprecationWarning,
                                                       FutureWarning))]}
    if rank == 0:
        json.dump(res, open(out, "w"))
    dist.destroy_process_group()
''')


def test_moe_mlp_ep_on_two_gloo_ranks_equals_moe_mlp(tmp_path):
    """moe_mlp_ep at tp 2 (each rank runs 2 of the reduced mixtral's 4
    experts) against moe_mlp: y, aux and every gradient within 1e-5, and no
    deprecation warning from its all-reduce."""
    out = tmp_path / "out.json"
    _spawn(tmp_path, MOE_WORKER, [str(out)], 2)
    res = json.loads(out.read_text())
    assert res.pop("deprecations") == []
    assert all(v < 1e-5 for v in res.values()), res


def test_moe_ep_uses_no_deprecated_collective():
    src = open(os.path.join(SRC, "repro_torch", "models", "moe_ep.py")).read()
    assert "torch.distributed.nn" not in src


# --------------------------------------------------------------------------- #
# World size 1: the sharded Trainer, restore, rescale                         #
# --------------------------------------------------------------------------- #
def test_sharded_trainer_checkpoint_restore_and_rescale_equal_the_plain_path(
        tmp_path):
    """The Trainer on a (1, 1) mesh over a one-rank gloo group, state under
    ZeRO-3 shardings: its losses equal the plain Trainer's; its checkpoint
    restores through ``shardings=`` onto the same placements with the same
    values; rescale_state re-places every leaf under new shardings (ZeRO-3
    off) and back to one device, values unchanged."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import reduced
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import StepSettings, init_train_state
    from repro_torch.runtime.train_loop import (Trainer, TrainerConfig,
                                                rescale_state)
    cfg = reduced(get_config("qwen3-4b"))
    settings = StepSettings(remat=False)
    opt = adamw.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=6)
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    kw = dict(compute_dtype=torch.float32, remat=False, device="cpu")

    def trainer(d, bb, **mesh_kw):
        return Trainer(bb, opt, data, TrainerConfig(
            total_steps=6, ckpt_every=3, ckpt_dir=str(d), log_every=100),
            settings, **mesh_kw)

    plain = trainer(tmp_path / "plain", Backbone(cfg, **kw))
    try:
        plain.run(plain.init_or_restore())
        want = [m["loss"] for m in plain.metrics_log]
    finally:
        plain.shutdown()
    mesh = make_host_mesh(device_type="cpu")
    try:
        bb = Backbone(cfg, sharder=sh.make_sharder(cfg, mesh, global_batch=4),
                      param_gather=sh.make_param_gatherer(cfg, mesh),
                      mesh=mesh, dp_axes=("data",), **kw)
        st_sh = sh.state_shardings(sh.param_shardings(bb, mesh), mesh)
        tr = trainer(tmp_path / "dist", bb, mesh=mesh, state_shardings=st_sh)
        try:
            state = tr.run(tr.init_or_restore())
            got = [m["loss"] for m in tr.metrics_log]
        finally:
            tr.shutdown()
        assert got == want
        template = init_train_state(bb, 0, settings, device="meta")
        restored, step = CheckpointStore(str(tmp_path / "dist")).restore(
            template, shardings=st_sh)
        assert step == 6
        for (path, a), (_, b) in zip(_walk(restored), _walk(state)):
            assert a.placements == b.placements, path
            assert torch.equal(a.full_tensor(), b.full_tensor()), path
        flat = sh.state_shardings(sh.param_shardings(bb, mesh, zero3=False),
                                  mesh)
        moved = rescale_state(state, flat)
        for (path, a), (_, b), (_, s) in zip(_walk(moved), _walk(state),
                                             _walk(flat)):
            assert a.placements == s.placements, path
            assert torch.equal(a.full_tensor(), b.full_tensor()), path
        local = rescale_state(moved, "cpu")
        assert all(type(t) is torch.Tensor and torch.equal(
            t, b.full_tensor()) for (_, t), (_, b) in zip(_walk(local),
                                                         _walk(state)))
    finally:
        dist.destroy_process_group()
