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
(``repro_torch.core``). One thing differs, because torch tensors are mutable
and jax arrays are not. The reference snapshots a cell by reference, and
its trainer donates the state to the next step: XLA writes the new state
into the old buffers and deletes the old arrays, so a reader of a snapshot
taken before that step either read it in time or meets a deleted array.
The port's trainer donates too (``make_train_step(..., donate=True)``: the
step writes into the published tensors, and the card holds one state), and
snapshots stay reference copies: copying every tensor leaf at each commit
would move the whole state (19 GB at qwen3-4b's depth 8) to the host twice
a step, since a write access takes two snapshots of its cell (the abort
checkpoint and the read buffer, ``ObjectAccess._lw_apply_body``).

So a published tensor may be overwritten by a later step, and
:class:`TornSnapshotError` is the counterpart of reading a donated (deleted)
jax array. The cell guarantees every reader one of two outcomes: a value
equal bit for bit to one committed step, or that error. ``set`` records
each tensor leaf's version counter; an in-place update bumps the counter of
every tensor it will write before it issues its first write
(``repro_torch.optim.adamw.mark_donated``), and each op bumps it again.

* ``get`` hands out references after checking that no counter moved since
  ``set``. That is enough for a reader that finishes with the tensors
  before the writer's next step, such as the trainer's own checkpoint path,
  which copies its snapshot to the host before the next step runs.
* ``get_host`` (``snapshot(..., host=True)``), for a reader in another
  thread, such as an evaluator: it checks the counters, copies every tensor
  leaf to the host and waits for the copy (``.cpu()`` synchronizes with
  the card), then checks the counters again. A write that reached the copy
  was issued before the copy ended, so its bump came before the second
  check, which then raises. The card runs a stream in order, and a copy
  may run on another stream than the writer's: the check does not rely on
  either.

A finished ``Transaction`` and its per-object records reference each other,
and the records' abort checkpoints and read buffers hold the cells' values:
until the cyclic garbage collector ran, each step's commit would keep the
state before it alive (the reference's donated jax buffers hold no memory
there; torch tensors would keep whole training states on the card). So
every transaction of the store drops those buffers once it has finished
(:func:`_run`).

A cell bound on a node server (``repro_torch.net``) crosses the wire as a
pickle, and torch's own tensor pickling would keep a tensor's device: a
node server that unpickled a CUDA tensor would open a CUDA context or fail.
So a cell pickles itself (:meth:`StateCell.__reduce__`): every tensor leaf
goes over as its dtype, its shape and its contiguous host bytes (a
``uint8`` numpy view, which keeps bf16 exact and leaves the pickle stream
under protocol 5), and is rebuilt on the CPU. The recorded version counters
are rebuilt from the rebuilt leaves, so ``get`` on the far side raises
nothing spurious. A DTensor leaf raises ``TypeError``: sharded state is not
homed remotely. A client that reads a remote cell back gets CPU tensors and
moves them with an explicit ``.to(device)``; method arguments and results
(``set``'s value, ``get``'s) are pickled by torch's own reducer, so a client
passes host tensors to a remote cell's ``set`` the same way.
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
    """A published tensor was written in place after it was committed: a
    later step has begun to overwrite that state (the counterpart of
    reading a donated, deleted jax array)."""


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


def _map_tensors(value: Any, path: str, fn: Callable[[torch.Tensor], Any],
                 why: str) -> Any:
    """``value`` with ``fn`` of every tensor leaf (nested dicts/lists/tuples,
    as :func:`_tensor_versions` walks them); a DTensor leaf raises
    ``TypeError`` for the reason ``why``."""
    if isinstance(value, DTensor):
        raise TypeError(f"StateCell leaf {path} is a DTensor: {why}")
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, dict):
        return {k: _map_tensors(v, f"{path}[{k!r}]", fn, why)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        items = [_map_tensors(v, f"{path}[{i}]", fn, why)
                 for i, v in enumerate(value)]
        return items if isinstance(value, list) else type(value)(items)
    return value


class _HostTensor:
    """A tensor leaf on its way over the wire: it pickles as its dtype, its
    shape and its contiguous host bytes, and unpickles as a CPU tensor."""

    __slots__ = ("tensor",)

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor

    def __reduce__(self):
        t = self.tensor.detach()
        data = t.cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
        return (_host_tensor, (str(t.dtype).removeprefix("torch."),
                               tuple(t.shape), data))


def _host_tensor(dtype: str, shape: tuple, data) -> torch.Tensor:
    """The CPU tensor of a :class:`_HostTensor`'s pickled form."""
    dt = getattr(torch, dtype)
    if data.size == 0:                  # numpy gives it stride 0: no view
        return torch.empty(shape, dtype=dt)
    if not data.flags.writeable:        # an out-of-band frame's bytes
        data = data.copy()
    return torch.from_numpy(data).view(dt).reshape(shape)


class StateCell:
    """A shared object holding one piece of cluster state.

    ``set`` is a pure WRITE (never reads), so trainer commits go through the
    log buffer without synchronizing with concurrent snapshot readers until
    apply time (§2.6). Snapshot copies are reference copies — cheap —
    checked against the version counters recorded at ``set``; a published
    tensor may be overwritten by a later step (see the module docstring).
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
    def get_host(self):
        """The value with every tensor leaf copied to the host, equal bit
        for bit to the committed one, or :class:`TornSnapshotError` (see the
        module docstring). A DTensor leaf raises ``TypeError``: its host copy
        is a collective (``runtime.train_loop.to_host``)."""
        self._check_unmodified()
        host = _map_tensors(self.value, "value",
                            lambda t: t.detach().to("cpu", copy=True),
                            "its host copy is a collective")
        self._check_unmodified()
        return host

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
                    f"{self.version} was written in place since: a later "
                    "step has begun to overwrite it (donated), so a "
                    "snapshot of it would be torn")

    def __reduce__(self):
        # Host bytes, rebuilt on the CPU; __init__ records the rebuilt
        # leaves' version counters (see the module docstring).
        return (StateCell, (_map_tensors(self.value, "value", _HostTensor,
                                         "sharded state is not homed "
                                         "remotely"), self.version))

    def __deepcopy__(self, memo):
        # snapshot = reference copy of the tree, with the version counters
        # recorded at set (get and get_host check them)
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
                 *, irrevocable: bool = True, host: bool = False
                 ) -> Dict[str, Any]:
        """Checkpointer/evaluator: consistent read-only snapshot.

        Uses the §2.7 asynchronous buffering path: each cell is snapshotted
        and released by the executor as soon as its access condition passes.
        ``host=False`` hands out references to the published tensors, valid
        until the trainer's next step writes into them; ``host=True`` gives
        host copies, each bit for bit a committed value, or raises
        :class:`TornSnapshotError` (``StateCell.get_host``).
        """
        t = Transaction(self.registry, irrevocable=irrevocable)
        proxies = {name: t.reads(self.cells[name], 2) for name in cells}
        out: Dict[str, Any] = {}

        def body(t):
            for name, proxy in proxies.items():
                out[name] = proxy.get_host() if host else proxy.get()
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
