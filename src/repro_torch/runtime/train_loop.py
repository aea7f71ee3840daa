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
* elastic rescale moves the state to another device (one card: there is no
  mesh to re-shard over until slice 8, ROADMAP.md).

A step returns fresh tensors and the store publishes them by reference; a
checkpoint's snapshot is copied to the host before the next step, so the
card does not hold a second state while the file is written. Each entry of
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

from repro_torch.checkpoint.store import AsyncCheckpointer, CheckpointStore
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.backbone import Backbone
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
    """A copy of nested dicts of tensors in host memory."""
    return adamw.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


class Trainer:
    def __init__(self, bb: Backbone, opt_cfg: adamw.AdamWConfig,
                 data_cfg: DataConfig, tcfg: TrainerConfig,
                 settings: StepSettings = StepSettings(),
                 *, straggler_hook: Optional[Callable[[Dict], None]] = None):
        self.bb = bb
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.settings = settings
        self.straggler_hook = straggler_hook

        self.store = VersionedStateStore()
        self.ckpt = CheckpointStore(tcfg.ckpt_dir)
        self.async_ckpt = AsyncCheckpointer(
            self.ckpt, on_done=self._on_ckpt_done)
        self.straggler = StragglerStats()
        self.metrics_log: List[Dict[str, float]] = []
        self._step = make_train_step(bb, opt_cfg, settings)

    # ------------------------------------------------------------------ #
    def _on_ckpt_done(self, step: int, path: str) -> None:
        self.store.record_checkpoint(step, path)
        self.ckpt.gc(self.tcfg.keep_ckpts)

    def init_or_restore(self, seed: int = 0) -> Dict[str, Any]:
        """Fresh init, or resume from the newest checkpoint (crash restart)
        onto the backbone's device."""
        latest = self.ckpt.latest_step()
        if latest is not None:
            template = init_train_state(self.bb, seed, self.settings,
                                        device="meta")
            state, step = self.ckpt.restore(template, latest,
                                            device=self.bb.device)
            self.start_step = step
            print(f"[trainer] resumed from checkpoint step {step}")
        else:
            state = init_train_state(self.bb, seed, self.settings)
            self.start_step = 0
        self.store.commit_step(None, None, self.start_step)  # cursor only
        return state

    # ------------------------------------------------------------------ #
    def run(self, state: Dict[str, Any], *, crash_at: Optional[int] = None
            ) -> Dict[str, Any]:
        """Train from ``state`` to ``total_steps``; returns the last state.
        Each step replaces the state with fresh tensors, so a caller that
        keeps a reference to the state it passed keeps that state on the
        card for the whole run (the reference donates it): pass
        ``init_or_restore()``'s result straight in."""
        pipe = Pipeline(self.data_cfg, start_step=self.start_step)
        for step in range(self.start_step, self.tcfg.total_steps):
            batch = next(pipe)
            t0 = time.monotonic()
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"injected crash at step {step}")
            state, metrics = self._step(state, batch)
            loss = float(metrics["loss"])
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
                                     "grad_norm": float(metrics["grad_norm"])})
            # control-plane commit: one write txn over (params, opt, cursor)
            self.store.commit_step(state["params"], state["opt"], step + 1)
            if (step + 1) % self.tcfg.ckpt_every == 0:
                # irrevocable read-only txn -> consistent async snapshot;
                # copied to the host NOW (the copy-buffer copy), so the
                # card holds one state while the file is written
                snap = self.store.snapshot(("params", "opt", "data_cursor"))
                host = to_host({"params": snap["params"], "opt": snap["opt"]})
                self.async_ckpt.submit(host, snap["data_cursor"])
            if (step + 1) % self.tcfg.log_every == 0:
                print(f"[train] step {step+1}: loss={loss:.4f} "
                      f"({dt*1e3:.0f}ms/step)")
        self.async_ckpt.drain()
        return state

    def shutdown(self) -> None:
        self.async_ckpt.stop()
        self.store.shutdown()


# --------------------------------------------------------------------------- #
# Elastic rescale                                                              #
# --------------------------------------------------------------------------- #
def rescale_state(state: Any, device: Any) -> Any:
    """Move every leaf to ``device`` (the elastic event on one host: the
    reference re-places leaves under a new mesh's shardings, which waits for
    slice 8). The transactional store serializes it against readers so
    nobody observes a half-moved tree."""
    return adamw.tree_map(lambda t: t.to(device), state)
