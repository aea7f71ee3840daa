"""The port's MoE layer (``models/ffn.py``), its expert-parallel form
(``models/moe_ep.py``) and the MoE archs' ``Backbone`` against the JAX
package on the CPU, in fp32.

Inputs and weights are made with numpy from a seed and handed to both; the
backbone gets the JAX init grafted through repro_torch.bridge. Tolerances:
the layer's y, aux and every gradient 1e-5 (atol = rtol; one fp32 order of
the same products against another, the routes equal); the backbone's logits
and caches 1e-4, its loss 1e-5 and each leaf's gradient 1e-4 of the leaf's
largest entry, as tests/test_torch_train.py and test_torch_models.py hold
the dense archs (the port's attention is the unchunked softmax, JAX's the
chunked online one). The routing itself (which experts, in which order,
which assignments are dropped) is held exactly. The expert-parallel form at
world size 1 equals ``moe_mlp`` bit for bit; summed over 8 emulated ranks
with column-split experts it equals it within 1e-5 (the split sums each
expert's products in two halves). Under ``torch.no_grad()`` the layer takes
its grouped path (the experts over the routed rows alone): against JAX, y and
aux within the same 1e-5; against the capacity path on the same input, the
same kept assignments, y within 1e-6 in fp32 (atol = rtol: the products of
one row in another order) and within 2**-6 of the largest |y| in bf16 (the
capacity path rounds the gate and up products, the SiLU and their product to
bf16, the grouped path only their product: a few bf16 ulps, 2**-8 each).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models import Backbone as JBackbone
from repro.models import ffn as jffn
from repro.models import get_config as jget_config
from repro.models import moe_ep as jmoe_ep
from repro.models import reduced as jreduced
from repro_torch import bridge
from repro_torch.models import Backbone, get_config, reduced
from repro_torch.models import ffn, moe_ep
from repro_torch.obs import metrics
from repro_torch.optim import adamw
from repro_torch.runtime.steps import value_and_grad

MOE_ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
TOL = 1e-5


def _paths():
    """moe_mlp's calls by path in the dispatch ledger."""
    counts = metrics.registry("dispatch").snapshot()["counters"]
    return {k[len("moe_mlp."):]: n for k, n in counts.items()
            if k.startswith("moe_mlp.")}


def _moved(before):
    """moe_mlp's calls by path since ``before`` (a :func:`_paths`), the
    paths that moved."""
    return {k: n - before.get(k, 0) for k, n in _paths().items()
            if n != before.get(k, 0)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer(cfg, seed, router_scale=1.0):
    """numpy weights of one MoE layer: router [D, E] (scaled by
    ``router_scale``; 0 makes every probability tie), experts [E, D, Fe] and
    [E, Fe, D], each at the backbone's init scale."""
    rng = np.random.default_rng(seed)
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

    def dense(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    return {"router": dense(D, E) * np.float32(router_scale),
            "w_gate": dense(E, D, Fe), "w_up": dense(E, D, Fe),
            "w_down": dense(E, Fe, D)}


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _jax_layer(p, x, cfg, ct, c_aux):
    """JAX's (y, aux) and the gradients of sum(y * ct) + c_aux * aux with
    respect to every leaf and x."""
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def f(jp, x):
        y, aux = jffn.moe_mlp(jp, x, cfg)
        return jnp.sum(y * ct) + c_aux * aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                                 has_aux=True)(
        jp, jnp.asarray(x))
    return y, aux, gp, gx


def _torch_layer(p, x, cfg, ct, c_aux, fn=ffn.moe_mlp):
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = fn(tp, tx, cfg)
    (torch.sum(y * torch.from_numpy(ct)) + c_aux * aux).backward()
    return y.detach(), aux.detach(), {k: t.grad for k, t in tp.items()}, \
        tx.grad


def _jax_keep(p, x, cfg):
    """The reference's routes and kept assignments, from its own router and
    ``jax.lax.top_k`` and its formula (ffn.py:48-63), in numpy."""
    xt = jnp.asarray(x.reshape(-1, cfg.d_model))
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    idx = np.asarray(idx)
    flat = idx.reshape(-1)
    onehot = np.eye(cfg.n_experts, dtype=np.int64)[flat]
    pos = (np.cumsum(onehot, 0) - 1)[np.arange(len(flat)), flat]
    C = jffn.moe_capacity(xt.shape[0], cfg.n_experts, cfg.top_k,
                          cfg.capacity_factor)
    return idx, pos < C


def _port_keep(p, x, cfg):
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model))
    _, _, idx = ffn.route(xt, torch.from_numpy(p["router"]), cfg.top_k)
    pos = ffn.slot_positions(idx.reshape(-1), cfg.n_experts)
    C = ffn.moe_capacity(xt.shape[0], cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
    return idx.numpy(), (pos < C).numpy()


def _check_layer(cfg, jcfg, p, x, seed, no_grad=False):
    """y, aux and every gradient against JAX's; with ``no_grad``, y and aux
    of a call under torch.no_grad(), which takes the grouped path."""
    ct = np.random.default_rng(seed).standard_normal(x.shape).astype(
        np.float32)
    jy, jaux, jgp, jgx = _jax_layer(p, x, jcfg, ct, 0.5)
    if no_grad:
        calls = _paths()
        with torch.no_grad():
            ty, taux = ffn.moe_mlp({k: torch.from_numpy(v) for k, v in
                                    p.items()}, torch.from_numpy(x), cfg)
        assert _moved(calls) == {"grouped": 1}
        _close(ty, jy, TOL)
        _close(taux, jaux, TOL)
        return
    ty, taux, tgp, tgx = _torch_layer(p, x, cfg, ct, 0.5)
    assert ty.shape == x.shape and taux.dtype == torch.float32
    _close(ty, jy, TOL)
    _close(taux, jaux, TOL)
    _close(tgx, jgx, TOL)
    for k in p:
        _close(tgp[k], jgp[k], TOL)


# each arch with gradients (the capacity path), and under torch.no_grad()
# (the grouped path), which the ids mark
GRAD_MODES = ([pytest.param(a, False, id=a) for a in MOE_ARCHS]
              + [pytest.param(a, True, id=f"{a}-no_grad") for a in MOE_ARCHS])


@pytest.mark.parametrize("arch,no_grad", GRAD_MODES)
def test_moe_mlp_matches_jax(arch, no_grad):
    """y, aux and the gradients of every leaf and of x, drop-free
    (reduced()'s capacity factor 8); under no_grad y and aux."""
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    p, x = _layer(cfg, 0), _x(cfg, 2, 16, 1)
    idx, keep = _port_keep(p, x, cfg)
    assert keep.all()
    np.testing.assert_array_equal(idx, _jax_keep(p, x, jcfg)[0])
    _check_layer(cfg, jcfg, p, x, 2, no_grad)


@pytest.mark.parametrize("arch,no_grad", GRAD_MODES)
def test_moe_mlp_drops_like_jax(arch, no_grad):
    """capacity_factor 1.0 at T = 64: C = 32 slots for 128 assignments over
    4 experts, so an unbalanced router drops for certain. The kept set, y,
    aux and the gradients (under no_grad: y and aux) match JAX's."""
    cfg = reduced(get_config(arch), capacity_factor=1.0)
    jcfg = jreduced(jget_config(arch), capacity_factor=1.0)
    p, x = _layer(cfg, 3, router_scale=3.0), _x(cfg, 2, 32, 4)
    idx, keep = _port_keep(p, x, cfg)
    jidx, jkeep = _jax_keep(p, x, jcfg)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(keep, jkeep)
    assert 0 < (~keep).sum() < keep.size
    _check_layer(cfg, jcfg, p, x, 5, no_grad)


def _skewed_layer(cfg, seed):
    """A layer and tokens whose feature 0 is 4 everywhere, with router row 0
    pushing every token to expert 0 (logit +12) and away from the last
    expert (-12): the last expert gets no rows, and expert 0 overflows
    wherever its capacity is below T."""
    p, x = _layer(cfg, seed), _x(cfg, 1, 256, seed + 1)
    p["router"][0] = 0.0
    p["router"][0, 0], p["router"][0, -1] = 3.0, -3.0
    x[..., 0] = 4.0
    return p, x


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 7, 256])
@pytest.mark.parametrize("cf", [0.5, 1.25, 4.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grouped_path_matches_capacity_path(arch, cf, T, dtype):
    """Under no_grad against the capacity path (with a gradient) on the same
    input: the same kept assignments, an expert with none, expert 0 over
    its capacity wherever C < T; y within the limits above, aux equal."""
    cfg = reduced(get_config(arch), capacity_factor=cf)
    p, x = _skewed_layer(cfg, 20)
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    tp = {k: torch.from_numpy(v).to(dt) for k, v in p.items()}
    tx = torch.from_numpy(x[:, :T]).to(dt)
    E, K = cfg.n_experts, cfg.top_k
    C = ffn.moe_capacity(T, E, K, cf)
    _, _, idx = ffn.route(tx.reshape(T, -1), tp["router"], K)
    flat = idx.reshape(-1)
    keep, rows, ends = ffn.grouped_rows(flat, E, C)
    assert torch.equal(keep, ffn.slot_positions(flat, E) < C)
    kept = torch.diff(ends, prepend=ends.new_zeros(1))
    assert int(kept[-1]) == 0
    assert bool((~keep).any()) == (C < T)
    assert sorted(rows[keep].tolist()) == list(range(int(ends[-1])))
    calls = _paths()
    with torch.no_grad():
        got, got_aux = ffn.moe_mlp(tp, tx, cfg)
    want, want_aux = ffn.moe_mlp({k: v.requires_grad_() for k, v in
                                  tp.items()}, tx, cfg)
    assert _moved(calls) == {"grouped": 1, "capacity": 1}
    assert torch.equal(got_aux, want_aux.detach())
    want = want.detach().float()
    if dt == torch.float32:
        _close(got, want, 1e-6)
    else:
        assert got.dtype == dt
        err = float((got.float() - want).abs().max())
        assert err <= 2.0 ** -6 * float(want.abs().max()), err


def test_grouped_path_is_taken_only_without_a_gradient():
    """No gradient mode, or nothing that requires grad: grouped. x or an
    expert leaf requiring grad with grad mode on: capacity. The router alone
    does not decide (the grouped path's gate values stay differentiable)."""
    cfg = reduced(get_config("mixtral-8x22b"))
    p = {k: torch.from_numpy(v) for k, v in _layer(cfg, 21).items()}
    x = torch.from_numpy(_x(cfg, 1, 5, 22))
    assert ffn.grouped_path(p, x)
    assert not ffn.grouped_path(p, x.clone().requires_grad_())
    with torch.no_grad():
        assert ffn.grouped_path(p, x.clone().requires_grad_())
    for k in ("w_gate", "w_up", "w_down"):
        q = dict(p, **{k: p[k].clone().requires_grad_()})
        assert not ffn.grouped_path(q, x), k
    assert ffn.grouped_path(dict(p, router=p["router"].clone()
                                 .requires_grad_()), x)
    assert ffn.grouped_path({k: v.to("meta") for k, v in p.items()},
                            x.to("meta"))


def test_grouped_path_on_meta_tensors_charges_the_kernels():
    """The meta route of ops.moe_experts: the output's shape and dtype, and
    each launch's operations charged for every row of the compact buffer
    (4 D Fe a row for gate-up, 2 Fe D for down)."""
    from repro_torch.kernels import ops

    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    p = {k: torch.from_numpy(v).to("meta") for k, v in _layer(cfg, 23).items()}
    x = torch.empty((2, 5, cfg.d_model), device="meta")
    charged = []
    ops.SINKS.append(lambda name, flops, nbytes: charged.append((name, flops)))
    try:
        y, aux = ffn.moe_mlp(p, x, cfg)
    finally:
        ops.SINKS.pop()
    R, D, Fe = 10 * cfg.top_k + 1, cfg.d_model, cfg.moe_d_ff
    assert y.shape == x.shape and y.device.type == "meta"
    assert charged == [("moe_gate_up", 4.0 * R * D * Fe),
                       ("moe_down", 2.0 * R * Fe * D)]


# --------------------------------------------------------------------------- #
# A share of the experts (held = (first, n))                                  #
# --------------------------------------------------------------------------- #
# ways to cut the reduced archs' 4 experts into shares
SHARES = {"halves": [(0, 2), (2, 2)], "1+3": [(0, 1), (1, 3)],
          "quarters": [(0, 1), (1, 1), (2, 1), (3, 1)]}
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _held(p, first, n):
    """The layer's leaves as the share [first, first + n) holds them."""
    return dict(p, **{k: p[k][first:first + n] for k in EXPERT_LEAVES})


@pytest.mark.parametrize("shares", list(SHARES))
@pytest.mark.parametrize("no_grad", [False, True],
                         ids=["capacity", "grouped"])
@pytest.mark.parametrize("drops", [False, True], ids=["drop_free", "drops"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_held_shares_sum_to_the_whole_layer(arch, drops, no_grad, shares):
    """The shares' y sum to the whole layer's y (each held expert numbers
    its assignments as the whole layer does, so they drop alike) and each
    share's aux is the whole layer's. On the capacity path the gradients
    too: x's and the router's summed over the shares, each expert leaf's
    the whole layer's slice. Drop-free at capacity factor E / K, and with
    drops at 1.0."""
    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, capacity_factor=1.0 if drops else
                              cfg.n_experts / cfg.top_k)
    p, x = _layer(cfg, 30, router_scale=3.0), _x(cfg, 2, 32, 31)
    assert _port_keep(p, x, cfg)[1].all() != drops
    ct = torch.from_numpy(np.random.default_rng(32).standard_normal(
        x.shape).astype(np.float32))

    def run(leaves, held=None):
        tp = {k: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(
            not no_grad) for k, v in leaves.items()}
        tx = torch.from_numpy(x).requires_grad_(not no_grad)
        calls = _paths()
        y, aux = ffn.moe_mlp(tp, tx, cfg, held=held)
        assert _moved(calls) == {"grouped" if no_grad else "capacity": 1}
        if no_grad:
            return y, aux, None
        (torch.sum(y * ct) + 0.5 * aux).backward()
        return y.detach(), aux.detach(), dict(
            {k: t.grad for k, t in tp.items()}, x=tx.grad)

    whole_y, whole_aux, whole_g = run(p)
    parts = [run(_held(p, f, n), (f, n)) for f, n in SHARES[shares]]
    _close(sum(y for y, _, _ in parts), whole_y, TOL)
    for _, aux, _ in parts:
        assert torch.equal(aux, whole_aux)
    if no_grad:
        return
    # aux's gradient reaches x and the router in every share alike: the
    # whole layer's counts it once
    aux_g = _torch_layer({k: v.copy() for k, v in p.items()}, x, cfg,
                         np.zeros_like(x), 0.5)[2:]
    extra = len(parts) - 1
    _close(sum(g["x"] for _, _, g in parts) - extra * aux_g[1],
           whole_g["x"], TOL)
    _close(sum(g["router"] for _, _, g in parts) - extra * aux_g[0]["router"],
           whole_g["router"], TOL)
    for (f, n), (_, _, g) in zip(SHARES[shares], parts):
        for k in EXPERT_LEAVES:
            _close(g[k], whole_g[k][f:f + n], TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 7, 256])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_held_grouped_path_matches_capacity_path(arch, T, dtype):
    """A share (experts 2 and 3 of 4, the last of them with no rows) at
    capacity factor E / K, under no_grad against the capacity path with a
    gradient: the held assignments kept, all of them and no other, in rows
    [0, ends[-1]); y within the limits of the unshared comparison, aux
    equal."""
    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    p, x = _skewed_layer(cfg, 33)
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype]
    held = (2, 2)
    tp = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dt)
          for k, v in _held(p, *held).items()}
    tx = torch.from_numpy(x[:, :T]).to(dt)
    E, K = cfg.n_experts, cfg.top_k
    C = ffn.moe_capacity(T, E, K, cfg.capacity_factor)
    _, _, idx = ffn.route(tx.reshape(T, -1), tp["router"], K)
    flat = idx.reshape(-1)
    keep, rows, ends = ffn.grouped_rows(flat, E, C, held)
    assert ends.shape == (2,) and int(torch.diff(ends)[0]) == 0
    assert torch.equal(keep, flat >= 2)
    assert sorted(rows[keep].tolist()) == list(range(int(ends[-1])))
    assert bool((rows[~keep] == flat.shape[0]).all())
    with torch.no_grad():
        got, got_aux = ffn.moe_mlp(tp, tx, cfg, held=held)
    want, want_aux = ffn.moe_mlp({k: v.requires_grad_() for k, v in
                                  tp.items()}, tx, cfg, held=held)
    assert torch.equal(got_aux, want_aux.detach())
    want = want.detach().float()
    if dt == torch.float32:
        _close(got, want, 1e-6)
    else:
        err = float((got.float() - want).abs().max())
        assert err <= 2.0 ** -6 * float(want.abs().max()), err


def test_without_a_share_the_held_code_is_not_entered(monkeypatch):
    """held None, or a range of all E experts: neither path enters
    held_slots, and y and aux are those of the layer called as before, bit
    for bit. A range outside the router's experts, or leaves of another
    count, is refused."""
    cfg = reduced(get_config("mixtral-8x22b"), capacity_factor=1.0)
    p, x = _layer(cfg, 34, router_scale=3.0), _x(cfg, 2, 32, 35)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x)

    def both(**kw):
        with torch.no_grad():
            grouped = ffn.moe_mlp(tp, tx, cfg, **kw)
        capacity = ffn.moe_mlp(tp, tx.clone().requires_grad_(), cfg, **kw)
        return grouped + tuple(t.detach() for t in capacity)

    want = both()

    def entered(*args):
        raise AssertionError("held_slots entered without a share")
    monkeypatch.setattr(ffn, "held_slots", entered)
    E = cfg.n_experts
    for held in (None, (0, E)):
        for a, b in zip(both(held=held), want):
            assert torch.equal(a, b)
    assert ffn.held_range((0, E), E) is None
    assert ffn.held_range((1, 3), E) == (1, 3)
    for bad in ((3, 2), (0, 0), (-1, 2)):
        with pytest.raises(ValueError, match="do not lie"):
            ffn.held_range(bad, E)
    with pytest.raises(ValueError, match="expert leaves hold 4"):
        ffn.moe_mlp(tp, tx, cfg, held=(0, 2))


def test_expert_rows_counts_each_grouped_call_while_on():
    """Off: nothing kept. On: each grouped call's (rows its experts
    computed, experts with a row), the whole layer's and a share's, read
    once by take(); a capacity call adds nothing."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    p, x = _skewed_layer(cfg, 36)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tx = torch.from_numpy(x[:, :40])
    counter = ffn.expert_rows
    assert not counter.on and counter.take() == []
    with torch.no_grad():
        ffn.moe_mlp(tp, tx, cfg)
    assert counter.take() == []
    _, _, idx = ffn.route(tx.reshape(40, -1), tp["router"], cfg.top_k)
    flat = idx.reshape(-1).tolist()
    counter.on = True
    try:
        with torch.no_grad():
            ffn.moe_mlp(tp, tx, cfg)
            ffn.moe_mlp(_held(tp, 1, 3), tx, cfg, held=(1, 3))
        ffn.moe_mlp(tp, tx.clone().requires_grad_(), cfg)
    finally:
        counter.on = False
    mine = [e for e in flat if e >= 1]
    assert counter.take() == [(len(flat), len(set(flat))),
                              (len(mine), len(set(mine)))]
    assert counter.take() == []


def test_expert_rows_add_launches_nothing():
    """Counting a call runs no operation (it keeps the call's ends as they
    are); take() reads rows and experts with rows, empty experts and
    calls of another length too."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func)
            return func(*args, **(kwargs or {}))

    counter = ffn.ExpertRows()
    calls = [torch.tensor([0, 3, 3, 7]), torch.tensor([2, 2]),
             torch.tensor([0, 0, 0])]
    with Ops() as mode:
        for ends in calls:
            counter.add(ends)
    assert mode.ops == []
    assert counter.take() == [(7, 2), (2, 1), (0, 0)]
    assert counter.take() == []


def test_backbone_holds_its_share_of_the_experts():
    """Backbone(held_experts=(2, 2)): expert leaves of 2 experts, the
    router over all 4; its prefill and decode agree (drop-free), and its
    MoE layers pass their share on. The ep path, a dense model or a range
    outside the router are refused."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    bb = Backbone(cfg, compute_dtype=torch.float32, device="cpu",
                  held_experts=(2, 2))
    meta = bb.init(device="meta")["g0"]["s0"]
    R, D, Fe = cfg.groups[0].repeat, cfg.d_model, cfg.moe_d_ff
    assert meta["router"].shape == (R, D, 4)
    assert meta["w_gate"].shape == meta["w_up"].shape == (R, 2, D, Fe)
    assert meta["w_down"].shape == (R, 2, Fe, D)
    params = bb.init(0)
    toks = torch.from_numpy(_tokens(cfg.vocab, 2, 13, 37))
    _, cache = bb.prefill(params, {"tokens": toks[:, :12]}, 32)
    got, _ = bb.decode_step(params, cache, toks[:, 12:13])
    want, _ = bb.prefill(params, {"tokens": toks}, 32)
    _close(got[:, -1], want[:, -1], 1e-4)
    seen = []

    def spy(*args, **kw):
        seen.append(kw.get("held"))
        return ffn.moe_mlp(*args, **kw)
    from repro_torch.models import backbone
    old = backbone.moe_mlp
    backbone.moe_mlp = spy
    try:
        bb.prefill(params, {"tokens": toks[:, :4]}, 32)
    finally:
        backbone.moe_mlp = old
    assert seen == [(2, 2)] * cfg.n_layers
    with pytest.raises(ValueError, match="held_experts"):
        Backbone(cfg, device="cpu", moe_impl="ep", held_experts=(0, 2))
    with pytest.raises(ValueError):
        Backbone(reduced(get_config("qwen3-4b")), device="cpu",
                 held_experts=(0, 1))
    with pytest.raises(ValueError, match="do not lie"):
        Backbone(cfg, device="cpu", held_experts=(3, 2))


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_local_moe_runs_whole_experts_through_moe_mlp_with_its_share(
        monkeypatch, tp):
    """_local_moe hands a rank's whole experts (split 1) to moe_mlp with
    the rank's share; column-split experts (tp 8 over 4) stay on its own
    capacity steps."""
    cfg = reduced(get_config("mixtral-8x22b"))
    V, split = moe_ep.virtualization(cfg, tp)
    p = {k: torch.from_numpy(v) for k, v in _virtualize(
        _layer(cfg, 38), split).items()}
    seen = []

    def spy(*args, **kw):
        seen.append(kw["held"])
        return ffn.moe_mlp(*args, **kw)
    monkeypatch.setattr(moe_ep, "moe_mlp", spy)
    xt = torch.from_numpy(_x(cfg, 1, 9, 39)[0])
    V_loc = V // tp
    for r in range(tp):
        own = slice(r * V_loc, (r + 1) * V_loc)
        moe_ep._local_moe(xt, p["router"], p["w_gate"][own], p["w_up"][own],
                          p["w_down"][own], cfg=cfg, V=V, split=split, tp=tp,
                          rank=r)
    assert seen == ([(r * V_loc, V_loc) for r in range(tp)] if split == 1
                    else [])


def test_ep_form_passes_plain_to_moe_mlp(monkeypatch):
    """moe_mlp_ep(plain=) reaches moe_mlp through _local_moe, and
    Backbone(kernel_impl="plain", moe_impl="ep") sets it, so the plain
    Backbone sends whole experts' routed rows to their plain version on
    the ep path as on the gspmd one."""
    cfg = reduced(get_config("mixtral-8x22b"))
    seen = []

    def spy(*args, **kw):
        seen.append(kw["plain"])
        return ffn.moe_mlp(*args, **kw)
    monkeypatch.setattr(moe_ep, "moe_mlp", spy)
    p = {k: torch.from_numpy(v) for k, v in _layer(cfg, 40).items()}
    x = torch.from_numpy(_x(cfg, 1, 9, 41))
    for plain in (False, True):
        moe_ep.moe_mlp_ep(p, x, cfg, plain=plain)
    assert seen == [False, True]
    seen.clear()
    for impl in ("kernel", "plain"):
        bb = Backbone(cfg, compute_dtype=torch.float32, device="cpu",
                      moe_impl="ep", kernel_impl=impl)
        params = bb.init(0)
        with torch.no_grad():
            bb.prefill(params,
                       {"tokens": torch.zeros(1, 8, dtype=torch.int32)}, 16)
    layers = cfg.n_layers
    assert seen == [False] * layers + [True] * layers


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serving_counts_only_grouped_calls_and_training_only_capacity(arch):
    """moe_mlp's calls by path in the dispatch ledger over a no_grad serve
    of the reduced arch through Server (each layer once a prefill and once a
    decode step) and over a train step's loss and gradients (each layer
    once, remat off), each read after a reset of the ledger."""
    from repro_torch.runtime.serve_loop import Request, Server

    _, _, bb, params = _moe_pair(arch, "drops")
    layers = bb.cfg.n_layers
    metrics.registry("dispatch").reset()
    srv = Server(bb, params, slots=2, ctx=64)
    prompts = _tokens(bb.cfg.vocab, 3, 9, 24)
    reqs = [Request(rid=i, prompt=prompts[i], max_new=4) for i in range(3)]
    for r in reqs:
        srv.submit(r)
    with torch.no_grad():
        srv.run()
    calls = layers * (len(reqs) + srv.stats["steps"])
    assert _paths() == {"grouped": calls}
    metrics.registry("dispatch").reset()
    toks = _tokens(bb.cfg.vocab, 2, 17, 25)
    value_and_grad(bb, params, {"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]})
    assert _paths() == {"capacity": layers}


@pytest.mark.parametrize("reset", ["dispatch", "every registry"])
def test_the_dispatch_ledger_counts_paths_after_a_reset(reset):
    """After ``metrics.registry("dispatch").reset()`` or ``metrics.reset()``
    (each drops the registry's counters) the ledger counts on: a no-grad
    moe_mlp on the CPU is one ``moe_mlp.grouped``, one under autograd one
    ``moe_mlp.capacity``, and ``metrics.dump()`` shows the dispatch site."""
    import io
    import json

    cfg = reduced(get_config("mixtral-8x22b"))
    p, x = _layer(cfg, 40), _x(cfg, 1, 8, 41)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    for _ in range(2):
        ffn.moe_mlp(tp, torch.from_numpy(x), cfg)
        if reset == "dispatch":
            metrics.registry("dispatch").reset()
        else:
            metrics.reset()
        assert _paths() == {}
        with torch.no_grad():
            ffn.moe_mlp(tp, torch.from_numpy(x), cfg)
        assert _paths() == {"grouped": 1}
        ffn.moe_mlp({k: v.clone().requires_grad_() for k, v in tp.items()},
                    torch.from_numpy(x), cfg)
        assert _paths() == {"grouped": 1, "capacity": 1}
    out = io.StringIO()
    metrics.dump(out)
    sites = {r["site"]: r for r in json.loads(out.getvalue())}
    assert sites["dispatch"]["counters"]["moe_mlp.capacity"] == 1


@pytest.mark.parametrize("E,K", [(4, 2), (8, 2), (128, 8)])
def test_tied_probabilities_pick_the_lower_index_first(E, K):
    """Every probability equal: ``ffn.top_k`` picks experts 0..K-1 in that
    order, as ``jax.lax.top_k`` does (``torch.topk`` promises no order)."""
    probs = np.full((5, E), 1.0 / E, np.float32)
    probs[1, E // 2:] = 2.0 / E      # ties among the larger half too
    vals, idx = ffn.top_k(torch.from_numpy(probs), K)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx[0].numpy(), np.arange(K))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_zero_router_routes_like_jax(arch, cf):
    """A zero router ties every probability: every token goes to experts
    0..K-1 in that order, in both packages, and at capacity factor 1 the
    same assignments are dropped."""
    cfg = reduced(get_config(arch), capacity_factor=cf)
    jcfg = jreduced(jget_config(arch), capacity_factor=cf)
    p, x = _layer(cfg, 6, router_scale=0.0), _x(cfg, 2, 16, 7)
    idx, keep = _port_keep(p, x, cfg)
    jidx, jkeep = _jax_keep(p, x, jcfg)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(idx, np.tile(np.arange(cfg.top_k), (32, 1)))
    np.testing.assert_array_equal(keep, jkeep)
    assert (~keep).any() == (cf == 1.0)
    _check_layer(cfg, jcfg, p, x, 8)


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 8.0])
def test_moe_capacity_matches_jax(cf):
    for T in (1, 7, 8, 64, 512, 4200, 4097):
        for E, K in ((4, 2), (8, 2), (128, 8), (3, 1)):
            assert ffn.moe_capacity(T, E, K, cf) == jffn.moe_capacity(
                T, E, K, cf), (T, E, K, cf)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_aux_loss_is_at_least_one(arch):
    """tests/test_models.py::test_moe_router_load_balance_loss_positive on
    the port: >= 1 by Cauchy-Schwarz, 1 iff balanced."""
    cfg = reduced(get_config(arch))
    p = {k: torch.from_numpy(v) for k, v in _layer(cfg, 9).items()}
    y, aux = ffn.moe_mlp(p, torch.from_numpy(_x(cfg, 2, 16, 10)), cfg)
    assert y.shape == (2, 16, cfg.d_model)
    assert float(aux) >= 1.0 - 1e-3


# --------------------------------------------------------------------------- #
# Expert parallelism                                                          #
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16, 32, 64, 128])
def test_virtualization_matches_jax(tp):
    for arch in MOE_ARCHS:
        assert moe_ep.virtualization(get_config(arch), tp) == \
            jmoe_ep.virtualization(jget_config(arch), tp)
    assert moe_ep.virtualization(get_config("mixtral-8x22b"), 16) == (16, 2)
    assert moe_ep.virtualization(get_config("qwen3-moe-235b-a22b"),
                                 16) == (128, 1)


def test_column_split_is_exact():
    """tests/test_models.py::test_moe_virtualization_split_is_exact on the
    port: silu(x Wg) * (x Wu) Wd is the sum over column halves."""
    rng = np.random.default_rng(11)
    x, wg, wu, wd = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((5, 8), (8, 12), (8, 12), (12, 8)))
    full = ffn.expert_ffn(x[None], wg[None], wu[None], wd[None])[0]
    parts = sum(ffn.expert_ffn(x[None], wg[None, :, i * 6:(i + 1) * 6],
                               wu[None, :, i * 6:(i + 1) * 6],
                               wd[None, i * 6:(i + 1) * 6])[0]
                for i in range(2))
    _close(parts, full, TOL)


def _virtualize(p, split):
    """[E, D, Fe] experts -> [E * split, D, Fe / split] (virtual e * split
    + h takes columns h of expert e), as Backbone stores them for ep."""
    E, D, Fe = p["w_gate"].shape
    Fv = Fe // split
    out = {"router": p["router"]}
    for k in ("w_gate", "w_up"):
        out[k] = p[k].reshape(E, D, split, Fv).transpose(0, 2, 1, 3).reshape(
            E * split, D, Fv)
    out["w_down"] = p["w_down"].reshape(E * split, Fv, D)
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_local_moe_summed_over_ranks_equals_moe_mlp(arch, tp):
    """Emulated tensor parallelism: _local_moe of ranks 0..tp-1 on their
    virtual experts (4 experts: split 2 at tp 8) sums to moe_mlp, at a
    capacity that drops (the positions are global, so every rank drops the
    same assignments)."""
    cfg = reduced(get_config(arch), capacity_factor=1.0)
    p, x = _layer(cfg, 12, router_scale=3.0), _x(cfg, 2, 32, 13)
    V, split = moe_ep.virtualization(cfg, tp)
    vp = {k: torch.from_numpy(v) for k, v in _virtualize(p, split).items()}
    xt = torch.from_numpy(x.reshape(-1, cfg.d_model))
    V_loc = V // tp
    parts = [moe_ep._local_moe(
        xt, vp["router"], vp["w_gate"][r * V_loc:(r + 1) * V_loc],
        vp["w_up"][r * V_loc:(r + 1) * V_loc],
        vp["w_down"][r * V_loc:(r + 1) * V_loc], cfg=cfg, V=V, split=split,
        tp=tp, rank=r) for r in range(tp)]
    want_y, want_aux = ffn.moe_mlp({k: torch.from_numpy(v)
                                    for k, v in p.items()},
                                   torch.from_numpy(x), cfg)
    _close(sum(y for y, _ in parts).reshape(x.shape), want_y, TOL)
    for _, aux in parts:
        assert torch.equal(aux, want_aux)
    assert not _port_keep(p, x, cfg)[1].all()


@pytest.fixture(scope="module")
def one_rank():
    """A one-process gloo group over an in-memory store (no network)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_mlp_ep_at_world_size_1_equals_moe_mlp(one_rank, arch):
    """tests/test_models.py::test_moe_ep_matches_gspmd_baseline on the port,
    through the collective of a one-rank group: y, aux and the gradients
    bit for bit, also where assignments drop; with the data group too."""
    cfg = reduced(get_config(arch), capacity_factor=1.0)
    p, x = _layer(cfg, 14, router_scale=3.0), _x(cfg, 2, 32, 15)
    ct = np.random.default_rng(16).standard_normal(x.shape).astype(np.float32)
    want = _torch_layer(p, x, cfg, ct, 0.5)
    for group, data_group in ((one_rank, None), (one_rank, one_rank)):
        got = _torch_layer(p, x, cfg, ct, 0.5, fn=lambda tp, tx, c:
                           moe_ep.moe_mlp_ep(tp, tx, c, group, data_group))
        for a, b in zip(got[:2] + (got[3],), want[:2] + (want[3],)):
            assert torch.equal(a, b)
        for k in p:
            assert torch.equal(got[2][k], want[2][k]), k


def test_moe_mlp_ep_rejects_leaves_of_another_split(one_rank):
    cfg = reduced(get_config("mixtral-8x22b"))
    p = {k: torch.from_numpy(v) for k, v in _layer(cfg, 17).items()}
    p["w_gate"] = p["w_gate"][:2]
    with pytest.raises(ValueError, match="virtual experts"):
        moe_ep.moe_mlp_ep(p, torch.zeros(1, 2, cfg.d_model), cfg, one_rank)


# --------------------------------------------------------------------------- #
# The backbone                                                                #
# --------------------------------------------------------------------------- #
# variant -> (reduced() overrides, router scale): drop-free, capacity
# factor 1 (prefill drops), a zero router (every probability ties; at
# capacity factor 1 the ties drop)
VARIANTS = {"drop_free": ({}, 1.0),
            "drops": (dict(capacity_factor=1.0), 1.0),
            "ties": (dict(capacity_factor=1.0), 0.0)}


def _moe_pair(arch, variant, remat=False, **kw):
    over, router_scale = VARIANTS[variant]
    jbb = JBackbone(jreduced(jget_config(arch), **over),
                    compute_dtype=jnp.float32, remat=remat)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jbb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(4)
    out = []
    for path, leaf in leaves:
        leaf = np.asarray(leaf)
        if not np.any(leaf):   # norm scales: perturbed, as the dense tests
            leaf = leaf + 0.1 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        if jax.tree_util.keystr(path).endswith("['router']"):
            leaf = leaf * np.float32(router_scale)
        out.append(leaf)
    jparams = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jbb.init(jax.random.PRNGKey(0))), out)
    bb = Backbone(reduced(get_config(arch), **over),
                  compute_dtype=torch.float32, remat=remat, device="cpu",
                  **kw)
    return jbb, jparams, bb, bridge.params_from_numpy(jparams, device="cpu")


def _tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_backbone_prefill_and_decode_match_jax(arch, variant):
    """Prefill past the reduced window (mixtral's local ring wraps), every
    cache leaf, then 4 decode steps of 2 slots."""
    jbb, jparams, bb, params = _moe_pair(arch, variant)
    assert params["g0"]["s0"]["router"].shape == (1, 64, 4)
    assert params["g0"]["s0"]["w_gate"].shape == (1, 4, 64, 32)
    B, S, N, ctx = 2, 45, 4, 64
    toks = _tokens(bb.cfg.vocab, B, S + N, 5)
    jlog, jcache = jbb.prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                               ctx)
    tlog, tcache = bb.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, ctx)
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
        tlog, tcache = bb.decode_step(params, tcache, torch.from_numpy(tok))
        _close(tlog, jlog, 1e-4)
    assert tcache["pos"] == S + N


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


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_backbone_loss_and_grads_match_jax(arch, variant, remat):
    """loss_fn (cross-entropy + AUX_COEF * the summed aux) and every leaf's
    gradient against jax.value_and_grad, past mixtral's reduced window; with
    remat the routing is recomputed in the backward and must pick the same
    experts."""
    jbb, jparams, bb, params = _moe_pair(arch, variant, remat=remat)
    toks = _tokens(bb.cfg.vocab, 2, 41, 1)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.value_and_grad(jbb.loss_fn)(jparams, jbatch)
    loss, grads = value_and_grad(bb, params, batch)
    _close(loss, want_loss, 1e-5)
    _leaves_close(grads, want_grads, 1e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_backbone_loss_adds_the_aux_loss(arch):
    """loss_fn - AUX_COEF * (the layers' aux) is the plain cross-entropy."""
    from repro_torch.models import backbone, common

    _, _, bb, params = _moe_pair(arch, "drops")
    toks = _tokens(bb.cfg.vocab, 2, 25, 2)
    loss = bb.loss_fn(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    x = bb._embed_tokens(params, torch.from_numpy(toks[:, :-1]))
    pos = torch.arange(24, dtype=torch.int32)
    lp, = bb._layer_views(params["g0"], 1)
    x, aux = bb._train_layer(lp, bb.cfg.groups[0].pattern, x, pos,
                             bb._rope(pos))
    ce = common.stable_cross_entropy(bb._logits(params, x),
                                     torch.from_numpy(toks[:, 1:]))
    assert float(aux) >= 1.0 - 1e-3
    _close(loss, ce + backbone.AUX_COEF * aux, 1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_backbone_ep_at_world_size_1_equals_gspmd(one_rank, arch):
    """Backbone(moe_impl="ep") over a one-rank group: the same leaves, and
    the same loss and gradients bit for bit, as the scatter path."""
    _, _, bb, params = _moe_pair(arch, "drops")
    ep = Backbone(bb.cfg, compute_dtype=torch.float32, remat=False,
                  device="cpu", moe_impl="ep", model_group=one_rank)
    assert (ep.moe_V, ep.moe_split) == (bb.cfg.n_experts, 1)
    toks = _tokens(bb.cfg.vocab, 2, 25, 3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    l1, g1 = value_and_grad(bb, params, batch)
    l2, g2 = value_and_grad(ep, params, batch)
    assert torch.equal(l1, l2)
    for a, b in zip(adamw.tree_leaves(g1), adamw.tree_leaves(g2)):
        assert torch.equal(a, b)


def test_backbone_ep_rejects_a_group_that_does_not_fit_its_leaves():
    """The leaves follow the plan's tp (8 virtual experts of half the
    columns at tp 8); driven with no group (tp 1) the layer raises."""
    from repro_torch.models import PartitionPlan

    cfg = reduced(get_config("mixtral-8x22b"))
    bb = Backbone(cfg, PartitionPlan(tp=8, vocab_align=1), device="cpu",
                  moe_impl="ep", compute_dtype=torch.float32)
    params = bb.init(0)
    assert params["g0"]["s0"]["w_gate"].shape == (1, 8, 64, 16)
    toks = _tokens(cfg.vocab, 1, 9, 4)
    with pytest.raises(ValueError, match="virtual experts"):
        bb.loss_fn(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    with pytest.raises(ValueError, match="moe_impl"):
        Backbone(cfg, device="cpu", moe_impl="shard_map")


@pytest.mark.parametrize("moe_impl", ["gspmd", "ep"])
@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_size_leaves_match_the_reference(arch, tp, moe_impl):
    """The full-size parameter tree (meta tensors, no memory) against the
    reference's param_specs: at tp 16 with ep mixtral's 8 experts are
    stored as 16 virtual experts of half the columns."""
    from repro.models.partition import PartitionPlan as JPartitionPlan
    from repro_torch.models import PartitionPlan

    jbb = JBackbone(jget_config(arch), JPartitionPlan(tp=tp),
                    moe_impl=moe_impl)
    bb = Backbone(get_config(arch), PartitionPlan(tp=tp), device="cpu",
                  moe_impl=moe_impl)
    mine = bb.init(device="meta")
    want = jbb.param_specs()
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), mine)
    assert got == jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
    if arch == "mixtral-8x22b" and tp == 16 and moe_impl == "ep":
        assert got["g0"]["s0"]["w_gate"] == (56, 16, 6144, 8192)
