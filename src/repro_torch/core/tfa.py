"""TFA-style optimistic baseline (HyFlow2 stand-in, paper §4.1/§5).

An in-process realization of the Transaction Forwarding Algorithm family
(TFA [18] / DTL2): a global version clock, per-object version stamps,
transaction-local read/write buffering, *transaction forwarding* (advancing
the transaction's start stamp after revalidating the read set when a newer
object version is encountered), commit-time lock-validate-writeback, and
abort/retry with backoff. Opaque, but irrevocable operations inside the
atomic block may re-execute on retry — exactly the deficiency the paper's
pessimistic approach avoids (§2.4, Fig. 13).
"""
from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from .api import Mode, OpStats, TransactionError
from .buffers import snapshot_state
from .registry import Node, Registry, SharedObject

_txn_ids = itertools.count(1)


class _GlobalClock:
    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def read(self) -> int:
        return self._v

    def advance(self) -> int:
        with self._lock:
            self._v += 1
            return self._v


CLOCK = _GlobalClock()


class _TfaMeta:
    """Per-object optimistic metadata: version stamp + commit lock."""

    __slots__ = ("version", "lock", "owner")

    def __init__(self):
        self.version = 0
        self.lock = threading.Lock()
        self.owner: Optional[int] = None


class _MetaTable:
    def __init__(self):
        self._lock = threading.Lock()
        self._meta: Dict[SharedObject, _TfaMeta] = {}

    def get(self, shared: SharedObject) -> _TfaMeta:
        with self._lock:
            return self._meta.setdefault(shared, _TfaMeta())


META = _MetaTable()


class TfaAbort(TransactionError):
    """Internal conflict signal: triggers a retry loop iteration."""


class _TfaProxy:
    __slots__ = ("_txn", "_shared")

    def __init__(self, txn: "TfaTransaction", shared: SharedObject):
        object.__setattr__(self, "_txn", txn)
        object.__setattr__(self, "_shared", shared)

    def __getattr__(self, method: str) -> Callable[..., Any]:
        txn = object.__getattribute__(self, "_txn")
        shared = object.__getattribute__(self, "_shared")

        def call(*args: Any, **kwargs: Any) -> Any:
            return txn._invoke(shared, method, args, kwargs)

        return call


class TfaTransaction:
    """Optimistic transaction: buffered execution + commit-time validation."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 client_node: Optional[Node] = None,
                 max_retries: int = 10_000):
        self.id = next(_txn_ids)
        self.registry = registry
        self.client_node = client_node
        self.max_retries = max_retries
        self.stats = OpStats()
        self._declared: List[SharedObject] = []
        self._reset()

    def _reset(self) -> None:
        self.rv = CLOCK.read()
        # shared -> (local deep copy to run operations on, version at copy time)
        self._workspace: Dict[SharedObject, Tuple[Any, int]] = {}
        self._read_set: Dict[SharedObject, int] = {}
        self._write_set: Dict[SharedObject, Any] = {}

    # -- preamble (declarations are advisory for optimistic execution) --------
    def _declare(self, obj: Union[SharedObject, str]) -> _TfaProxy:
        shared = self.registry.locate(obj) if isinstance(obj, str) else obj
        self._declared.append(shared)
        return _TfaProxy(self, shared)

    def reads(self, obj, *_sup) -> _TfaProxy:
        return self._declare(obj)

    writes = reads
    updates = reads
    accesses = reads

    def begin(self) -> None:
        self._reset()

    # -- operation execution ----------------------------------------------------
    def _open(self, shared: SharedObject) -> Any:
        """Open an object into the transaction workspace (DF model: the state
        is fetched to the client; operations run on the local copy)."""
        if shared in self._workspace:
            return self._workspace[shared][0]
        meta = META.get(shared)
        if meta.lock.locked() and meta.owner != self.id:
            raise TfaAbort(f"{shared.name} locked by a committing transaction")
        version = meta.version
        if version > self.rv:
            # Transaction forwarding: revalidate the read set, advance rv.
            self._validate_read_set()
            self.rv = CLOCK.read()
        shared.check_reachable()
        # DF model: the state is fetched to the client. Uses the snapshot
        # protocol (buffers.snapshot_state) so the optimistic baseline pays
        # the same per-object copy cost as the pessimistic frameworks.
        local = snapshot_state(shared.holder.obj)
        self._workspace[shared] = (local, version)
        self._read_set[shared] = version
        return local

    def _validate_read_set(self) -> None:
        for shared, seen in self._read_set.items():
            meta = META.get(shared)
            if meta.version != seen or (meta.lock.locked() and meta.owner != self.id):
                raise TfaAbort(f"read-set validation failed on {shared.name}")

    def _invoke(self, shared: SharedObject, method: str, args: tuple,
                kwargs: dict) -> Any:
        mode = shared.mode_of(method)
        local = self._open(shared)
        if shared.node is not None:
            shared.node.simulate_network(self.client_node)
        v = getattr(local, method)(*args, **kwargs)
        if mode is Mode.READ:
            self.stats.reads += 1
        else:
            self._write_set[shared] = local
            if mode is Mode.WRITE:
                self.stats.writes += 1
            else:
                self.stats.updates += 1
        return v

    # -- commit -----------------------------------------------------------------
    def commit(self) -> None:
        locked: List[_TfaMeta] = []
        try:
            for shared in sorted(self._write_set, key=lambda s: s.header.uid):
                meta = META.get(shared)
                if not meta.lock.acquire(blocking=False):
                    self.stats.waits += 1        # actually contended
                    if not meta.lock.acquire(timeout=1.0):
                        raise TfaAbort(f"commit lock timeout on {shared.name}")
                meta.owner = self.id
                locked.append(meta)
            self._validate_read_set()
            wv = CLOCK.advance()
            for shared, local in self._write_set.items():
                shared.holder.obj = local
                META.get(shared).version = wv
        finally:
            for meta in locked:
                meta.owner = None
                meta.lock.release()

    def start(self, body: Callable[["TfaTransaction"], Any]) -> Any:
        """Optimistic retry loop: execute, validate, commit; abort → re-execute.

        Every retry re-runs the entire atomic block — including any
        irrevocable operations in it.
        """
        attempt = 0
        while True:
            attempt += 1
            self.begin()
            try:
                result = body(self)
                self.commit()
                return result
            except TfaAbort:
                self.stats.aborts += 1
                self.stats.retries += 1
                if attempt >= self.max_retries:
                    raise
                # randomized backoff, grows with contention
                time.sleep(random.uniform(0, 0.0005) * min(attempt, 32))
