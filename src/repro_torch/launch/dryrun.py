"""Multi-pod dry run: one step of every (arch × shape × mesh) cell on the
production meshes, without a card or memory.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny \\
        --shape train_4k --mesh both

The port of ``repro.launch.dryrun``, with its cells, flags and skips. Where
the reference lowers and compiles each cell for 512 placeholder devices,
the port runs it: in one process, over the fake process group
(``launch.mesh.init_fake_world``: 256 or 512 ranks, every collective a
no-op), every tensor on the ``meta`` device, parameters, optimizer state,
batch and cache as DTensors under the production shardings. For each cell
this:

  1. builds the arch's Backbone with ``PartitionPlan(tp=tp_size(mesh))``
     (tp 1 for a full-DP arch), its sharder, per-layer gather and mesh,
     and the settings' ``remat`` and ``remat_policy``,
  2. places the step's arguments on the mesh (nothing is allocated: their
     local shards are meta tensors),
  3. runs one train step, prefill or decode step under
     ``launch.cost.CostCounter``, which counts one rank's FLOPs, bytes,
     collectives (and those inside a layer) and live memory; the kernels
     take their shape functions (``kernels.ops``); a train step donates its
     state, as the reference's jit of it does (its update writes into the
     arguments, so the peak counts one state),
  4. records the rank's argument bytes (its local shards), its peak (the
     arguments plus the peak of what the step allocates), the cost totals
     and the roofline terms at the H100's rates into
     ``results/dryrun_torch/<arch>--<shape>--<mesh>.json`` (incremental;
     --force to redo).

``long_500k`` is skipped for pure-full-attention archs (see DESIGN.md §4)
and recorded as {"skipped": reason}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch import roofline as rl
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import (init_fake_world, make_production_mesh,
                                     production_shape, tp_size)
from repro_torch.launch.shardings import (NamedSharding, batch_shardings,
                                          distribute, effective_dp,
                                          full_dp_active, make_param_gatherer,
                                          make_sharder, param_shardings,
                                          tree_distribute)
from repro_torch.models import SHAPES, Backbone, PartitionPlan, get_config
from repro_torch.models.config import ARCH_NAMES, ModelConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime.steps import (StepSettings, make_decode_step,
                                       make_prefill_step, make_train_step)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# long_500k policy (DESIGN.md §4): run only where the KV footprint is bounded
LONG_OK = {"rwkv6-3b", "mixtral-8x22b", "recurrentgemma-9b"}


def cell_skip_reason(arch: str, shape: ShapeConfig) -> Optional[str]:
    if shape.name == "long_500k" and arch not in LONG_OK:
        return ("full-attention KV cache at 524288 would be unbounded; "
                "sub-quadratic archs only (DESIGN.md §4)")
    return None


def _meta(shape, dtype, sharding: NamedSharding) -> DTensor:
    return distribute(torch.empty(shape, dtype=dtype, device="meta"),
                      sharding)


def local_bytes(tree: Any) -> int:
    """The bytes one rank holds of a tree's tensors: a DTensor's local
    shard, a plain tensor whole."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        tree = tree.to_local()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def build_cell(arch: str, shape: ShapeConfig, mesh, *,
               settings: StepSettings,
               layer_scope: Callable[[], Any] = contextlib.nullcontext,
               cfg: Optional[ModelConfig] = None):
    """Returns (step_fn, its arguments on the mesh); ``cfg`` overrides the
    arch's config (a cut depth)."""
    cfg = cfg or get_config(arch)
    fdp = full_dp_active(cfg, mesh, shape.global_batch)
    plan = PartitionPlan(tp=1 if fdp else tp_size(mesh))
    dp = effective_dp(cfg, mesh, shape.global_batch)
    serve = shape.kind != "train"
    gatherer = (make_param_gatherer(cfg, mesh, full_dp=fdp)
                if (settings.gather_weights and settings.zero3
                    and not serve) else None)
    B, S = shape.global_batch, shape.seq_len
    bb = Backbone(cfg, plan,
                  compute_dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16 if serve else torch.float32,
                  remat=settings.remat and not serve,
                  remat_policy=settings.remat_policy,
                  device="meta",
                  sharder=make_sharder(cfg, mesh, batch_sharded=B > 1,
                                       global_batch=B),
                  param_gather=gatherer,
                  moe_impl="ep" if settings.moe_ep else "gspmd",
                  mesh=mesh, dp_axes=dp if B > 1 else (),
                  layer_scope=layer_scope)
    p_sh = param_shardings(bb, mesh, zero3=settings.zero3, full_dp=fdp)
    params = tree_distribute(bb.init(device="meta"), p_sh)
    bsh = batch_shardings(cfg, shape, mesh, batch_sharded=B > 1)

    def frames(batch):
        if cfg.is_enc_dec:
            batch["enc_frames"] = _meta((B, cfg.enc_seq, cfg.d_model),
                                        torch.bfloat16, bsh["enc_frames"])
        return batch

    if shape.kind == "train":
        state = {"params": params, "opt": adamw.init_state(params)}
        if settings.compress_grads:
            state["error"] = adamw.tree_map(torch.zeros_like, params)
        batch = frames({name: _meta((B, S), torch.int32, bsh[name])
                        for name in ("tokens", "labels")})
        # donated, as the reference jits it (donate_argnums=(0,)): the
        # update writes into the arguments, so the peak holds one state
        return make_train_step(bb, adamw.AdamWConfig(), settings,
                               donate=True), (state, batch)
    if shape.kind == "prefill":
        batch = frames({"tokens": _meta((B, S), torch.int32, bsh["tokens"])})
        return make_prefill_step(bb, ctx=S), (params, batch)
    # decode: the cache is made on the mesh by the backbone
    cache = bb.init_cache(B, S)
    tokens = _meta((B, 1), torch.int32, bsh["tokens"])
    return make_decode_step(bb), (params, cache, tokens)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               settings: StepSettings) -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` on ``mesh`` (a fake one) under the
    cost counter: times, one rank's memory, the cost totals and the
    roofline terms."""
    n_chips = mesh.size()
    counter = CostCounter()
    t0 = time.time()
    fn, args = build_cell(cfg.name, shape, mesh, settings=settings,
                          layer_scope=counter.in_layer, cfg=cfg)
    t_build = time.time() - t0
    arg_bytes = local_bytes(args)
    with counter:
        out = fn(*args)
    t_run = time.time() - t0 - t_build
    totals = counter.totals
    bb = Backbone(cfg, PartitionPlan(tp=tp_size(mesh)), device="meta")
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mflops = rl.model_flops(bb, shape.kind, tokens)
    terms = rl.derive_terms_from_totals(totals, mflops, n_chips)
    return {
        "build_s": round(t_build, 2),
        "run_s": round(t_run, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": local_bytes(out),
            "temp_bytes": counter.peak_bytes,
            "peak_bytes": arg_bytes + counter.peak_bytes,
        },
        "hlocost": totals.to_json(),
        "roofline": terms.to_json(),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             settings: StepSettings, verbose: bool = True) -> Dict[str, Any]:
    shape = SHAPES[shape_name]
    multi = mesh_kind == "multi"
    dims, _ = production_shape(multi)
    n = 1
    for d in dims:
        n *= d
    init_fake_world(n)
    # typed "cuda" (its tensors are meta): DTensor takes a "cpu" mesh for
    # gloo and sends its all-to-alls through all-gathers
    mesh = make_production_mesh(multi_pod=multi, device_type="cuda")
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "chips": mesh.size(), "settings": settings.__dict__,
    }
    reason = cell_skip_reason(arch, shape)
    if reason:
        result["skipped"] = reason
        return result
    result.update(count_cell(get_config(arch), shape, mesh,
                             settings=settings))
    totals, terms = result["hlocost"], result["roofline"]
    if verbose:
        m = result["memory"]
        print(f"[{arch} × {shape_name} × {mesh_kind}] "
              f"run={result['run_s']:.1f}s "
              f"args/dev={m['argument_bytes'] / 2**30:.2f}GiB "
              f"peak/dev={m['peak_bytes'] / 2**30:.2f}GiB "
              f"flops/dev={terms['hlo_flops']:.3e} "
              f"coll/dev={totals['collective_bytes'] / 2**20:.1f}MiB "
              f"(in-layer {totals['in_loop_bytes'] / 2**20:.1f}MiB, "
              f"{totals['in_loop_count']:.0f} ops) "
              f"dominant={terms['dominant']} "
              f"frac={terms['roofline_fraction']:.3f}",
              flush=True)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help=f"one of {list(SHAPES)} or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--zero3", type=int, default=1)
    ap.add_argument("--gather-weights", type=int, default=1)
    ap.add_argument("--remat", type=int, default=1)
    ap.add_argument("--compress-grads", type=int, default=0)
    ap.add_argument("--moe-ep", type=int, default=1)
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"],
                    help="with --remat 1, what the backward recomputes: the "
                    "whole layer (full) or all but the products without "
                    "batch dims (dots); the Backbone's remat_policy")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="", help="suffix for result files")
    args = ap.parse_args()

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    settings = StepSettings(zero3=bool(args.zero3),
                            gather_weights=bool(args.gather_weights),
                            remat=bool(args.remat),
                            compress_grads=bool(args.compress_grads),
                            remat_policy=args.remat_policy,
                            moe_ep=bool(args.moe_ep),
                            microbatches=args.microbatches)
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                tag = f"-{args.tag}" if args.tag else ""
                out = RESULTS_DIR / f"{arch}--{shape}--{mesh_kind}{tag}.json"
                if out.exists() and not args.force:
                    print(f"skip (exists): {out.name}", flush=True)
                    continue
                try:
                    res = run_cell(arch, shape, mesh_kind, settings=settings)
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape, mesh_kind, repr(e)))
                    res = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "error": repr(e)}
                out.write_text(json.dumps(res, indent=2))
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nDRY-RUN COMPLETE: every requested cell ran on the fake mesh.")


if __name__ == "__main__":
    main()
