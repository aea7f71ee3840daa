"""Transactional versioned training-state store (DESIGN.md §2.1).

The control plane of the training runtime, synchronized by **OptSVA-CF**
(``repro.core``). Cluster state — parameters, optimizer state, the data
cursor, checkpoint metadata — lives in shared objects homed on registry
nodes; every actor runs transactions against them:

* the **trainer** commits each step(-group) as an *update* transaction with
  suprema 1 per object (one ``set`` per step);
* the **checkpointer** is an *irrevocable read-only* transaction: per paper
  §2.7 the snapshot is taken by the executor thread the moment the access
  condition passes and the objects are released immediately — the trainer
  blocks only for the buffer copy, never for the checkpoint I/O; and per
  §2.4 irrevocability means the file write can never be re-executed by a
  cascade;
* **evaluators** are read-only transactions (same asynchronous buffering);
* **elastic rescale** events are update transactions that swap shardings.

The paper's guarantees carry over directly: no torn reads (a checkpoint
snapshot is a consistent version cut across params/opt/cursor), no
writer starvation, deadlock freedom, and crashed actors roll back via the
transaction monitor (§3.4).

The port of ``repro.txstore.store`` on the port's copy of the OptSVA-CF core
(``repro_torch.core``). One decision differs, because torch tensors are
mutable and jax arrays are not. The reference snapshots a cell by reference;
a torch step that updated the published parameters in place would change a
snapshot already taken, a torn checkpoint the reference cannot produce. Two
ways out were weighed:

* snapshots copy tensor leaves to the host. Every commit's write access
  takes two snapshots of each cell (the abort checkpoint and the read
  buffer, ``ObjectAccess._lw_apply_body``), so at qwen3-4b's depth 8 each
  step would copy 19 GB (fp32 params, m and v) to the host twice;
* the step returns fresh tensors (``repro_torch.optim.adamw.apply_updates``
  is functional), and a published tensor is never written again. That costs
  a second set of params, m and v on the card while the step runs: 14.4 GB
  at depth 8, which the 80 GB card holds.

The port takes the second, and snapshots stay reference copies. The cell
enforces it: ``set`` records each tensor leaf's version counter, and ``get``
raises :class:`TornSnapshotError` when a tensor of the value it would hand
out was since modified in place, so a torn snapshot is never handed out.

A finished ``Transaction`` and its per-object records reference each other,
and the records' abort checkpoints and read buffers hold the cells' values:
until the cyclic garbage collector ran, each step's commit would keep the
state before it alive (the reference's donated jax buffers hold no memory
there; torch tensors would keep whole training states on the card). So
every transaction of the store drops those buffers once it has finished
(:func:`_run`).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import (Mode, Registry, SharedObject, Transaction,
                              TransactionMonitor, access)


def _run(t: Transaction, body: Callable[[Transaction], Any]) -> Any:
    """``t.start(body)``, then drop the buffers of ``t``'s finished
    per-object records (see the module docstring)."""
    try:
        return t.start(body)
    finally:
        for acc in t._order:
            acc.st = acc.buf = None


class TornSnapshotError(RuntimeError):
    """A published tensor was modified in place after it was committed."""


def _tensor_versions(value: Any) -> List[tuple]:
    """(tensor, version counter) of every tensor in nested dicts/lists; of a
    DTensor, its local shard's (an in-place write reaches the shard)."""
    if isinstance(value, DTensor):
        with torch.no_grad():
            value = value.to_local()
    if isinstance(value, torch.Tensor):
        return [(value, value._version)]
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return [tv for item in value for tv in _tensor_versions(item)]
    return []


class StateCell:
    """A shared object holding one piece of cluster state.

    ``set`` is a pure WRITE (never reads), so trainer commits go through the
    log buffer without synchronizing with concurrent snapshot readers until
    apply time (§2.6). Published tensors are never written again (see the
    module docstring), so snapshot copies are reference copies — cheap —
    checked against the version counters recorded at ``set``.
    """

    def __init__(self, value: Any = None, version: int = 0,
                 _versions: Optional[List[tuple]] = None):
        self.value = value
        self.version = version
        self._versions = (_tensor_versions(value) if _versions is None
                          else _versions)

    @access(Mode.READ)
    def get(self):
        self._check_unmodified()
        return self.value

    @access(Mode.READ)
    def get_version(self) -> int:
        return self.version

    @access(Mode.WRITE)
    def set(self, value, version: int) -> None:
        self.value = value
        self.version = version
        self._versions = _tensor_versions(value)

    @access(Mode.UPDATE)
    def bump(self, fn: Callable[[Any], Any]) -> Any:
        self.value = fn(self.value)
        self.version += 1
        self._versions = _tensor_versions(self.value)
        return self.value

    def _check_unmodified(self) -> None:
        for t, seen in self._versions:
            if t._version != seen:
                raise TornSnapshotError(
                    f"a tensor {tuple(t.shape)} published at version "
                    f"{self.version} was modified in place since: a snapshot "
                    "of it would be torn (steps must return fresh tensors)")

    def __deepcopy__(self, memo):
        # published tensors are never written again (get checks): snapshot =
        # reference copy of the tree
        return StateCell(self.value, self.version, self._versions)

    def __tx_snapshot__(self) -> "StateCell":
        # Snapshot protocol (buffers.py): same reference-copy rationale, but
        # O(1) with no deepcopy dispatch on the checkpoint/read-buffer path.
        return StateCell(self.value, self.version, self._versions)


class VersionedStateStore:
    """Named state cells + transaction factories for the runtime actors."""

    CELLS = ("params", "opt", "data_cursor", "ckpt_meta")

    def __init__(self, *, monitor_timeout: float = 30.0):
        self.registry = Registry()
        self.node = self.registry.add_node("trainer-host")
        self.cells: Dict[str, SharedObject] = {}
        for name in self.CELLS:
            self.cells[name] = self.registry.bind(
                name, StateCell(), node=self.node)
        self.monitor = TransactionMonitor(self.registry,
                                          timeout=monitor_timeout)
        self.monitor.start()

    def shutdown(self) -> None:
        self.monitor.stop()
        self.registry.shutdown()

    # ------------------------------------------------------------------ #
    # Actor transactions                                                  #
    # ------------------------------------------------------------------ #
    def commit_step(self, params, opt, step: int) -> None:
        """Trainer: publish the post-step state (one write per cell)."""
        t = Transaction(self.registry)
        p = t.writes(self.cells["params"], 1)
        o = t.writes(self.cells["opt"], 1)
        c = t.writes(self.cells["data_cursor"], 1)

        def body(t):
            p.set(params, step)
            o.set(opt, step)
            c.set(step, step)

        _run(t, body)

    def snapshot(self, cells: Iterable[str] = ("params", "opt", "data_cursor"),
                 *, irrevocable: bool = True) -> Dict[str, Any]:
        """Checkpointer/evaluator: consistent read-only snapshot.

        Uses the §2.7 asynchronous buffering path: each cell is snapshotted
        and released by the executor as soon as its access condition passes.
        """
        t = Transaction(self.registry, irrevocable=irrevocable)
        proxies = {name: t.reads(self.cells[name], 2) for name in cells}
        out: Dict[str, Any] = {}

        def body(t):
            for name, proxy in proxies.items():
                out[name] = proxy.get()
                out[f"{name}_version"] = proxy.get_version()

        _run(t, body)
        return out

    def record_checkpoint(self, step: int, path: str) -> None:
        t = Transaction(self.registry)
        m = t.writes(self.cells["ckpt_meta"], 1)
        _run(t, lambda _t: m.set({"step": step, "path": path,
                                  "time": time.time()}, step))

    def latest_checkpoint(self) -> Optional[Dict[str, Any]]:
        snap = self.snapshot(("ckpt_meta",))
        return snap["ckpt_meta"]

    def rescale(self, remap: Callable[[Any], Any]) -> None:
        """Elastic event: atomically re-shard params+opt under one txn."""
        t = Transaction(self.registry)
        p = t.updates(self.cells["params"], 1)
        o = t.updates(self.cells["opt"], 1)

        def body(t):
            p.bump(remap)
            o.bump(remap)

        _run(t, body)
