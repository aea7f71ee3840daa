"""Sharding rules: parameter specs, batch/cache specs, activation sharder.

The port of ``repro.launch.shardings``, on DTensor. The rules over leaf
names and shapes are the reference's, line for line (DESIGN.md §5):

* TP ("model" axis): attention head dims, FFN hidden dim, expert dim (EP)
  when divisible, vocab dim of embeddings.
* ZeRO ("data" axis): the non-TP matrix dim of every large 2-D kernel.
  With ``zero3=True`` parameters themselves are sharded over "data" and
  each layer's leaves are gathered to their TP-only placements right before
  use (``make_param_gatherer``: a ``redistribute``, the FSDP2 way); the
  backward of that redistribute reduce-scatters the layer's gradient inside
  the layer (the OptSVA-CF "early release on last write" schedule). With
  ``zero3=False`` parameters are replicated over "data" and the gradient is
  reduced once, after the backward ("release at commit").
* "pod" axis: pure DP — parameters replicated, batch sharded.

A spec (:class:`PSpec`) names, per tensor dimension, the mesh axis (or a
tuple of axes) that shards it, or None; :func:`placements` turns it into
DTensor placements, one per mesh dimension. A tensor dimension named by a
tuple such as ``("pod", "data")`` takes ``Shard(d)`` on both mesh
dimensions, pod major, as JAX orders it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.models.backbone import Backbone
from repro_torch.models.config import ModelConfig, ShapeConfig

from .mesh import axis_sizes, dp_axes, tp_size

Params = Any


class PSpec(tuple):
    """A ``PartitionSpec``: per tensor dimension an axis name, a tuple of
    axis names, or None; a tuple of one name is that name, as JAX
    normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"PSpec{tuple(self)!r}"


def placements(spec: PSpec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec``, one per mesh dimension."""
    out: List[Placement] = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: DeviceMesh
    spec: PSpec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.spec, self.mesh)


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """A full tensor (the same on every rank) as a DTensor under
    ``sharding``; a DTensor on the same mesh is redistributed, one on
    another mesh is gathered whole first."""
    if isinstance(t, DTensor):
        if t.device_mesh == sharding.mesh:
            return t.redistribute(sharding.mesh, sharding.placements)
        t = t.full_tensor()
    return distribute_tensor(t, sharding.mesh, sharding.placements)


def _divisible(n: int, m: int) -> bool:
    return m > 0 and n % m == 0


def full_dp_arch(cfg: ModelConfig) -> bool:
    """Attention-free (SSM) archs get nothing from tensor parallelism but
    per-layer activation all-reduces. For them the "model" axis is
    repurposed as additional data parallelism: batch sharded over
    data×model, weights ZeRO-sharded over data and gathered per layer."""
    return cfg.family == "ssm"


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
               cfg: ModelConfig, mesh: DeviceMesh, *, zero3: bool = True,
               full_dp: bool = False) -> PSpec:
    """PSpec for one parameter leaf, by name pattern + shape."""
    spec = _param_spec_raw(path, shape, cfg, mesh, zero3=zero3)
    if full_dp:
        spec = PSpec(*(None if s == "model" else s for s in spec))
    return spec


def _param_spec_raw(path: Tuple[str, ...], shape: Tuple[int, ...],
                    cfg: ModelConfig, mesh: DeviceMesh, *,
                    zero3: bool = True) -> PSpec:
    P = PSpec
    name = path[-1]
    tp = tp_size(mesh)
    n_data = axis_sizes(mesh).get("data", 1)
    zaxis = "data" if zero3 else None

    def zshard(dim: int) -> Optional[str]:
        return zaxis if _divisible(shape[dim], n_data) else None

    # ---- embeddings / head ---------------------------------------------------
    if name == "tok":                       # [Vp, D]
        if not cfg.tie_embeddings:
            return P(zshard(0), "model")
        return P("model", zshard(1))
    if name == "enc_pos":                   # [enc_seq, D]
        return P(None, None)
    if name == "lm_head":                   # [D, Vp]
        return P(zshard(0), "model")
    if name == "final_norm":
        return P(None)

    # ---- stacked layer leaves: shape[0] is the repeat axis -------------------
    if len(shape) == 4 and name in ("w_gate", "w_up", "w_down") \
            and cfg.ffn_kind == "moe":
        if _divisible(shape[1], tp):
            return P(None, "model", zshard(2), None)
        if name == "w_down":
            return P(None, None, "model", zshard(3))
        return P(None, None, zshard(2), "model")
    if name == "router":                    # [R, D, E]
        return P(None, zshard(1), None)
    if name in ("wq", "wk", "wv", "c_wq", "c_wk", "c_wv",
                "w_r", "w_k", "w_v", "w_g"):
        return P(None, zshard(1), "model")  # [R, D, out]
    if name in ("wo", "c_wo", "w_o"):
        return P(None, "model", zshard(2))  # [R, out, D]
    if name in ("w_gate", "w_up", "w_in", "w_gate_branch"):
        return P(None, zshard(1), "model")  # [R, D, F/W]
    if name in ("w_down", "w_out"):
        return P(None, "model", zshard(2))  # [R, F/W, D]
    if name == "w_rgate":                   # [R, D, D]
        return P(None, zshard(1), "model")
    if name in ("bq", "bk", "bv", "c_bq", "c_bk", "c_bv",
                "u", "w0", "ln_x", "conv_b", "gb_a", "gb_x", "a_log"):
        return P(None, "model") if _divisible(shape[1], tp) else P(None, None)
    if name == "conv_w":                    # [R, K, W]
        return P(None, None, "model")
    if name in ("gw_a", "gw_x"):            # [R, NB, wb, wb]
        return P(None, "model", None, None) if _divisible(shape[1], tp) \
            else P(None, None, None, None)
    if name in ("wd_a", "dd_a"):            # [R, D, r]
        return P(None, zshard(1), None)
    if name == "wd_b":                      # [R, r, Dr]
        return P(None, None, "model")
    if name.startswith("dd_b"):             # [R, 32, D]
        return P(None, None, zshard(2))
    # norms, mu_*, small vectors -> replicated
    return P(*([None] * len(shape)))


def _map_with_path(fn: Callable, tree: Params, path: Tuple[str, ...] = ()
                   ) -> Params:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(bb: Backbone, mesh: DeviceMesh, *, zero3: bool = True,
                    full_dp: bool = False) -> Params:
    """The parameter tree's shardings, from its shapes
    (``bb.init(device="meta")``)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec(
            path, tuple(leaf.shape), bb.cfg, mesh, zero3=zero3,
            full_dp=full_dp)),
        bb.init(device="meta"))


def state_shardings(param_sh: Params, mesh: DeviceMesh, *,
                    compress_grads: bool = False) -> Params:
    """The train state's shardings: the moments (and the error feedback)
    as the parameters, the step replicated."""
    out = {"params": param_sh,
           "opt": {"step": NamedSharding(mesh, PSpec()), "m": param_sh,
                   "v": param_sh}}
    if compress_grads:
        out["error"] = param_sh
    return out


def tree_distribute(tree: Params, shardings: Params) -> Params:
    """Every leaf of ``tree`` placed under its sharding in ``shardings``
    (the same dict structure)."""
    if isinstance(tree, dict):
        return {k: tree_distribute(v, shardings[k]) for k, v in tree.items()}
    return distribute(tree, shardings)


# --------------------------------------------------------------------------- #
# Batches and caches                                                           #
# --------------------------------------------------------------------------- #
def batch_spec(mesh: DeviceMesh) -> PSpec:
    return PSpec(dp_axes(mesh) or None)


def full_dp_active(cfg: ModelConfig, mesh: DeviceMesh,
                   global_batch: int) -> bool:
    """full-DP applies only when the batch divides the whole device grid."""
    if not full_dp_arch(cfg):
        return False
    sizes = axis_sizes(mesh)
    total = 1
    for a in dp_axes(mesh) + ("model",):
        total *= sizes[a]
    return _divisible(global_batch, total)


def effective_dp(cfg: ModelConfig, mesh: DeviceMesh, global_batch: int
                 ) -> Tuple[str, ...]:
    """Batch-sharding axes: data(+pod); plus 'model' for full-DP archs
    when the batch divides the larger grid."""
    dp = dp_axes(mesh)
    if full_dp_active(cfg, mesh, global_batch):
        return dp + ("model",)
    return dp


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh,
                    *, batch_sharded: bool = True
                    ) -> Dict[str, NamedSharding]:
    dp = effective_dp(cfg, mesh, shape.global_batch) if batch_sharded else ()
    tok = NamedSharding(mesh, PSpec(dp or None, None))
    out = {"tokens": tok}
    if shape.kind == "train":
        out["labels"] = tok
    if cfg.is_enc_dec:
        out["enc_frames"] = NamedSharding(mesh, PSpec(dp or None, None, None))
    return out


def cache_shardings(bb: Backbone, mesh: DeviceMesh, B: int) -> Params:
    """Cache specs: batch over dp (when divisible), heads/width over model."""
    cache = bb.init_cache(B, 8, device="meta")
    dp = dp_axes(mesh)
    sizes = axis_sizes(mesh)
    dp_total = 1
    for a in dp:
        dp_total *= sizes[a]
    bshard = dp if _divisible(B, dp_total) else None
    tp = tp_size(mesh)

    def spec_for(path, leaf):
        P = PSpec
        name = path[-1]
        if name == "pos":
            return NamedSharding(mesh, P())
        shp = tuple(leaf.shape)
        if name == "kpos":
            return NamedSharding(mesh, P(None, None))
        if name in ("k", "v", "ck", "cv"):    # [R, B, C, KV, hd]
            kv = "model" if _divisible(shp[3], tp) else None
            return NamedSharding(mesh, P(None, bshard, None, kv, None))
        if name == "wkv":                     # [R, B, H, hd, hd]
            h = "model" if _divisible(shp[2], tp) else None
            return NamedSharding(mesh, P(None, bshard, h, None, None))
        if name in ("shift1", "shift2"):      # [R, B, D]
            return NamedSharding(mesh, P(None, bshard, None))
        if name == "conv":                    # [R, B, K-1, W]
            w = "model" if _divisible(shp[3], tp) else None
            return NamedSharding(mesh, P(None, bshard, None, w))
        if name == "h":                       # [R, B, W]
            w = "model" if _divisible(shp[2], tp) else None
            return NamedSharding(mesh, P(None, bshard, w))
        return NamedSharding(mesh, P(*([None] * len(shp))))

    return _map_with_path(spec_for, cache)


def make_param_gatherer(cfg: ModelConfig, mesh: DeviceMesh, *,
                        full_dp: bool = False) -> Callable:
    """Per-layer weight gather for the layer loop.

    Under ZeRO-3 ("data"-sharded weights), redistributing the *sliced*
    layer parameters to their TP-only placements all-gathers each layer's
    weights right before use (the paper's asynchronous read-only buffering),
    and the backward of that redistribute reduce-scatters each layer's
    gradient right after its backward (early release on last write),
    instead of reducing activations at every matmul whose contraction dim
    is "data"-sharded. With ``stacked=False`` it takes whole leaves (the
    embedding table and the LM head, gathered where they are used: DTensor
    looks up and projects only over a table whose model dim is whole).
    """

    def gather(layer_params: Params, stacked: bool = True) -> Params:
        def one(path, leaf):
            if not isinstance(leaf, DTensor):
                return leaf
            if not stacked:
                return leaf.redistribute(mesh, placements(param_spec(
                    path, tuple(leaf.shape), cfg, mesh, zero3=False,
                    full_dp=full_dp), mesh))
            # rules index shapes with the stacked dim first; re-add it
            spec = param_spec(path, (1,) + tuple(leaf.shape), cfg, mesh,
                              zero3=False, full_dp=full_dp)
            sliced = PSpec(*spec[1:]) if len(spec) > 1 else PSpec()
            if len(sliced) != leaf.ndim:
                return leaf
            return leaf.redistribute(mesh, placements(sliced, mesh))

        return _map_with_path(one, layer_params)

    return gather


# --------------------------------------------------------------------------- #
# Activation sharder                                                           #
# --------------------------------------------------------------------------- #
def make_sharder(cfg: ModelConfig, mesh: DeviceMesh,
                 *, batch_sharded: bool = True,
                 global_batch: int = 0) -> Callable:
    dp = (effective_dp(cfg, mesh, global_batch or 1 << 30)
          if batch_sharded else ())
    dps = dp or None
    tp = tp_size(mesh)
    ep = cfg.ffn_kind == "moe" and _divisible(cfg.n_experts, tp)
    fdp = batch_sharded and full_dp_active(cfg, mesh, global_batch or 1 << 30)
    P = PSpec
    rules: Dict[str, PSpec] = {
        "act_hidden": P(dps, None, None),
        "act_heads": P(dps, None, None if fdp else "model"),
        "logits": P(dps, None, None if fdp else "model"),
        "moe_buf": P("model", None, None) if ep else P(None, None, "model"),
    }
    by_name = {name: placements(spec, mesh) for name, spec in rules.items()}

    def shard(x: torch.Tensor, name: str) -> torch.Tensor:
        spec = rules.get(name)
        if not isinstance(x, DTensor) or spec is None or len(spec) != x.ndim:
            # a plain tensor, an unknown tag or a rank mismatch: no-op
            return x
        return x.redistribute(mesh, by_name[name])

    return shard
