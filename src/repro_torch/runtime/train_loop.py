"""The training runtime: loop, fault tolerance, stragglers, elasticity.

The port of ``repro.runtime.train_loop``. The control plane runs on the
transactional store (``repro_torch.txstore``):

* every step commits (params, opt, cursor) as one write transaction —
  readers can never observe a torn step;
* checkpoints are taken by an irrevocable read-only transaction (snapshot
  happens asynchronously per paper §2.7) and written by a background
  thread (``AsyncCheckpointer``) — the trainer never blocks on disk;
* crash/restart resumes from the newest atomic checkpoint + the stateless
  data pipeline cursor, onto the trainer's device;
* stragglers are detected by a step-time EWMA z-test; mitigation is a
  pluggable policy (on a real cluster: re-slice the batch / evict the
  slow host — here: recorded + surfaced);
* elastic rescale re-places the state under a new mesh's shardings
  (``rescale_state``), or moves it to one device.

On a mesh (``Trainer(mesh=, state_shardings=)``) the state's leaves are
DTensors placed by ``state_shardings`` (``launch.shardings``: the
parameters' and the moments' specs, the step replicated); a checkpoint is
written from their full values, by rank 0, and restored onto the same
placements.

The step donates its state, as the reference's ``jax.jit(step_fn,
donate_argnums=(0,))`` does: it writes the new params, m and v into the
tensors of the old ones (``make_train_step(..., donate=True)``), so the
card holds one training state. The store publishes those tensors by
reference, and the next step overwrites them; so a checkpoint's snapshot is
copied to the host before the next step (the order carries correctness:
the copy is the only committed state left once the step runs), and a
reader in another thread copies through ``snapshot(..., host=True)``, which
refuses a state the next step has begun to overwrite. Each entry of
``metrics_log`` also holds the step's ``grad_norm`` (the reference logs
step, loss and dt).
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.store import AsyncCheckpointer, CheckpointStore
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch.shardings import (batch_shardings, distribute,
                                          tree_distribute)
from repro_torch.models.backbone import Backbone
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import adamw
from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                       make_train_step)
from repro_torch.txstore.store import VersionedStateStore


@dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    straggler_zscore: float = 4.0
    straggler_warmup: int = 10
    keep_ckpts: int = 3


@dataclass
class StragglerStats:
    ewma: float = 0.0
    ewvar: float = 0.0
    n: int = 0
    events: List[Dict[str, float]] = field(default_factory=list)

    def observe(self, dt: float, step: int, z_thresh: float,
                warmup: int) -> bool:
        self.n += 1
        if self.n == 1:
            self.ewma = dt
            return False
        # z against the PRE-update statistics (the outlier must not be
        # allowed to widen the band it is tested against); sd floored at
        # 5% of the mean so warm, uniform phases don't fire on jitter.
        sd = max(np.sqrt(self.ewvar), 0.05 * self.ewma, 1e-9)
        z = (dt - self.ewma) / sd
        hit = self.n > warmup and z > z_thresh
        if hit:
            self.events.append({"step": step, "dt": dt, "z": float(z)})
        else:
            # stragglers are excluded from the running statistics
            alpha = 0.1
            delta = dt - self.ewma
            self.ewma += alpha * delta
            self.ewvar = (1 - alpha) * (self.ewvar + alpha * delta * delta)
        return hit


def to_host(tree: Any) -> Any:
    """A copy of nested dicts of tensors in host memory; a DTensor's full
    value (a collective: every rank calls it)."""
    return adamw.tree_map(lambda t: _full(t).detach().to("cpu", copy=True),
                          tree)


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _is_writer() -> bool:
    """Rank 0 writes the checkpoints (every rank when there is no group)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class Trainer:
    def __init__(self, bb: Backbone, opt_cfg: adamw.AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 settings: StepSettings = StepSettings(),
                 *, mesh=None, state_shardings=None,
                 straggler_hook: Optional[Callable[[Dict], None]] = None):
        self.bb = bb
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.settings = settings
        self.mesh = mesh
        self.state_shardings = state_shardings
        self.straggler_hook = straggler_hook

        self.store = VersionedStateStore()
        self.ckpt = CheckpointStore(tcfg.ckpt_dir)
        self.async_ckpt = AsyncCheckpointer(
            self.ckpt, on_done=self._on_ckpt_done)
        self.straggler = StragglerStats()
        self.metrics_log: List[Dict[str, float]] = []
        self._step = make_train_step(bb, opt_cfg, settings, donate=True)

    # ------------------------------------------------------------------ #
    def _on_ckpt_done(self, step: int, path: str) -> None:
        self.store.record_checkpoint(step, path)
        self.ckpt.gc(self.tcfg.keep_ckpts)

    def init_or_restore(self, seed: int = 0) -> Dict[str, Any]:
        """Fresh init, or resume from the newest checkpoint (crash restart)
        onto the backbone's device, placed by ``state_shardings`` where the
        trainer has them."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            template = init_train_state(self.bb, seed, self.settings,
                                        device="meta")
            state, step = self.ckpt.restore(template, latest,
                                            device=self.bb.device,
                                            shardings=self.state_shardings)
            self.start_step = step
            print(f"[trainer] resumed from checkpoint step {step}")
        else:
            state = init_train_state(self.bb, seed, self.settings)
            if self.state_shardings is not None:
                state = tree_distribute(state, self.state_shardings)
            self.start_step = 0
        self.store.commit_step(None, None, self.start_step)  # cursor only
        return state

    # ------------------------------------------------------------------ #
    def run(self, state: Dict[str, Any], *, crash_at: Optional[int] = None
            ) -> Dict[str, Any]:
        """Train from ``state`` to ``total_steps``; returns the last state.
        ``state`` is consumed, as a donated jax array is deleted: each step
        writes the new state into its tensors, so a reference the caller
        keeps to them reads the last step's values, never the ones it
        passed in. A copy of the initial state must be taken before the
        call (``to_host``)."""
        pipe = Pipeline(self.data_cfg, start_step=self.start_step)
        for step in range(self.start_step, self.tcfg.total_steps):
            batch = self._place(next(pipe))
            t0 = time.monotonic()
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"injected crash at step {step}")
            state, metrics = self._step(state, batch)
            loss = float(_full(metrics["loss"]))
            dt = time.monotonic() - t0
            if self.straggler.observe(step=step, dt=dt,
                                      z_thresh=self.tcfg.straggler_zscore,
                                      warmup=self.tcfg.straggler_warmup):
                ev = self.straggler.events[-1]
                print(f"[straggler] step {step}: {dt*1e3:.1f}ms "
                      f"(z={ev['z']:.1f}) — mitigation hook invoked")
                if self.straggler_hook:
                    self.straggler_hook(ev)
            self.metrics_log.append({"step": step, "loss": loss, "dt": dt,
                                     "grad_norm": float(_full(
                                         metrics["grad_norm"]))})
            # control-plane commit: one write txn over (params, opt, cursor)
            self.store.commit_step(state["params"], state["opt"], step + 1)
            if (step + 1) % self.tcfg.ckpt_every == 0:
                # irrevocable read-only txn -> consistent async snapshot;
                # copied to the host NOW (the copy-buffer copy): the next
                # step writes into the published tensors
                snap = self.store.snapshot(("params", "opt", "data_cursor"))
                host = to_host({"params": snap["params"], "opt": snap["opt"]})
                if _is_writer():
                    self.async_ckpt.submit(host, snap["data_cursor"])
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"[train] step {step+1}: loss={loss:.4f} "
                      f"({dt*1e3:.0f}ms/step)")
        self.async_ckpt.drain()
        return state

    def _place(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """On a mesh, the batch as DTensors: its rows over the data axes."""
        if self.mesh is None:
            return batch
        d = self.data_cfg
        shape = ShapeConfig("train", d.seq_len, d.global_batch, "train")
        sh = batch_shardings(self.bb.cfg, shape, self.mesh,
                             batch_sharded=d.global_batch > 1)
        return {k: distribute(torch.as_tensor(v, device=self.bb.device),
                              sh[k]) for k, v in batch.items()}

    def shutdown(self) -> None:
        self.async_ckpt.stop()
        self.store.shutdown()


# --------------------------------------------------------------------------- #
# Elastic rescale                                                              #
# --------------------------------------------------------------------------- #
def rescale_state(state: Any, new_shardings: Any) -> Any:
    """Re-place every leaf under the new mesh's shardings (elastic event):
    ``new_shardings`` is a tree of ``launch.shardings.NamedSharding`` like
    ``state``, or one device, to which every leaf moves whole.

    On a real cluster this runs after re-forming the mesh with the surviving
    hosts; the transactional store serializes it against readers so nobody
    observes a half-resharded tree.
    """
    if isinstance(new_shardings, dict):
        return tree_distribute(state, new_shardings)
    return adamw.tree_map(lambda t: _full(t).to(new_shardings), state)
