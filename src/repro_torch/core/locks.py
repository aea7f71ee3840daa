"""Lock-based distributed concurrency-control baselines (paper §4.1).

* ``Mutex``  — one mutual-exclusion lock per shared object.
* ``R/W``    — one reader-writer lock per shared object (writer-preferring,
  so writers are not starved under read-heavy Eigenbench mixes).
* ``S2PL``   — conservative strong strict two-phase locking: every lock in
  the access set is acquired (in global order, to avoid deadlock) at start
  and held to commit. Satisfies opacity.
* ``2PL``    — non-strict two-phase locking: same acquisition, but the
  programmer releases each lock after the *last* access to its object
  (``LockTransaction.done(obj)``), which satisfies last-use opacity under
  correct last-access marking.
* ``GLock``  — a single global mutual-exclusion lock held for the entire
  transaction; the fully sequential baseline.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .api import Mode, OpStats
from .registry import Node, Registry, SharedObject


class RWLock:
    """Writer-preferring reader-writer lock.

    ``acquire_*`` return True iff the caller actually blocked, so callers
    can report real waits (not mere acquisition counts) in their stats.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._readers_ok = threading.Condition(self._lock)
        self._writers_ok = threading.Condition(self._lock)
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self) -> bool:
        with self._lock:
            waited = False
            while self._writer or self._writers_waiting:
                waited = True
                self._readers_ok.wait()
            self._readers += 1
            return waited

    def release_read(self) -> None:
        with self._lock:
            self._readers -= 1
            if self._readers == 0:
                self._writers_ok.notify()

    def acquire_write(self) -> bool:
        with self._lock:
            self._writers_waiting += 1
            waited = False
            while self._writer or self._readers:
                waited = True
                self._writers_ok.wait()
            self._writers_waiting -= 1
            self._writer = True
            return waited

    def release_write(self) -> None:
        with self._lock:
            self._writer = False
            # Writer preference: hand off to a waiting writer if there is
            # one; only when no writer waits may readers be woken. Waking
            # both classes at once lets a reader slip in whenever it wins
            # the race to the monitor before the writer re-evaluates,
            # breaking the preference invariant under simultaneous wakeup.
            if self._writers_waiting:
                self._writers_ok.notify()
            else:
                self._readers_ok.notify_all()


class _LockTable:
    """Process-wide lock attachments for shared objects."""

    def __init__(self):
        self._lock = threading.Lock()
        self._mutex: Dict[SharedObject, threading.Lock] = {}
        self._rw: Dict[SharedObject, RWLock] = {}

    def mutex(self, shared: SharedObject) -> threading.Lock:
        with self._lock:
            return self._mutex.setdefault(shared, threading.Lock())

    def rw(self, shared: SharedObject) -> RWLock:
        with self._lock:
            return self._rw.setdefault(shared, RWLock())


LOCK_TABLE = _LockTable()
GLOBAL_LOCK = threading.Lock()


class _LockProxy:
    __slots__ = ("_txn", "_shared")

    def __init__(self, txn: "LockTransaction", shared: SharedObject):
        object.__setattr__(self, "_txn", txn)
        object.__setattr__(self, "_shared", shared)

    def __getattr__(self, method: str) -> Callable[..., Any]:
        txn = object.__getattribute__(self, "_txn")
        shared = object.__getattribute__(self, "_shared")

        def call(*args: Any, **kwargs: Any) -> Any:
            return txn._invoke(shared, method, args, kwargs)

        return call


class LockTransaction:
    """One transaction under a lock-based scheme.

    ``kind``: ``"mutex"`` | ``"rw"`` | ``"glock"``; ``strict=True`` keeps
    locks to commit (S2PL); ``strict=False`` enables ``done(obj)`` early
    release (2PL).
    """

    def __init__(self, registry: Optional[Registry] = None, *,
                 kind: str = "mutex", strict: bool = True,
                 client_node: Optional[Node] = None):
        assert kind in ("mutex", "rw", "glock")
        self.registry = registry
        self.kind = kind
        self.strict = strict
        self.client_node = client_node
        self.stats = OpStats()
        # (shared, will_write) in declaration order
        self._declared: List[Tuple[SharedObject, bool]] = []
        self._proxies: Dict[SharedObject, _LockProxy] = {}
        self._held: Dict[SharedObject, str] = {}  # shared -> "read"/"write"
        self._started = False
        self._terminated = False

    # -- preamble -------------------------------------------------------------
    def _declare(self, obj: Union[SharedObject, str], will_write: bool) -> _LockProxy:
        shared = self.registry.locate(obj) if isinstance(obj, str) else obj
        self._declared.append((shared, will_write))
        proxy = _LockProxy(self, shared)
        self._proxies[shared] = proxy
        return proxy

    def reads(self, obj, *_sup) -> _LockProxy:
        return self._declare(obj, will_write=False)

    def writes(self, obj, *_sup) -> _LockProxy:
        return self._declare(obj, will_write=True)

    def updates(self, obj, *_sup) -> _LockProxy:
        return self._declare(obj, will_write=True)

    def accesses(self, obj, *_sup) -> _LockProxy:
        return self._declare(obj, will_write=True)

    # -- lifecycle ------------------------------------------------------------
    def begin(self) -> None:
        if self._started:
            return
        self._started = True
        if self.kind == "glock":
            if not GLOBAL_LOCK.acquire(blocking=False):
                self.stats.waits += 1
                GLOBAL_LOCK.acquire()
            return
        # Deadlock avoidance: acquire in global header-uid order. A wait is
        # counted only when the lock was actually contended, so the
        # Eigenbench `waits` column is comparable across frameworks.
        for shared, will_write in sorted(self._declared, key=lambda p: p[0].header.uid):
            if self.kind == "mutex":
                m = LOCK_TABLE.mutex(shared)
                if not m.acquire(blocking=False):
                    self.stats.waits += 1
                    m.acquire()
                self._held[shared] = "write"
            else:
                if will_write:
                    if LOCK_TABLE.rw(shared).acquire_write():
                        self.stats.waits += 1
                    self._held[shared] = "write"
                else:
                    if LOCK_TABLE.rw(shared).acquire_read():
                        self.stats.waits += 1
                    self._held[shared] = "read"

    def _invoke(self, shared: SharedObject, method: str, args: tuple,
                kwargs: dict) -> Any:
        shared.check_reachable()
        mode = shared.mode_of(method)
        v = shared.raw_call(method, args, kwargs, from_node=self.client_node)
        if mode is Mode.READ:
            self.stats.reads += 1
        elif mode is Mode.WRITE:
            self.stats.writes += 1
        else:
            self.stats.updates += 1
        return v

    def done(self, proxy_or_shared: Union[_LockProxy, SharedObject]) -> None:
        """2PL early release: the programmer marks the last access (§4.1)."""
        if self.strict or self.kind == "glock":
            return
        shared = (proxy_or_shared if isinstance(proxy_or_shared, SharedObject)
                  else object.__getattribute__(proxy_or_shared, "_shared"))
        self._release_one(shared)

    def _release_one(self, shared: SharedObject) -> None:
        held = self._held.pop(shared, None)
        if held is None:
            return
        if self.kind == "mutex":
            LOCK_TABLE.mutex(shared).release()
        elif held == "write":
            LOCK_TABLE.rw(shared).release_write()
        else:
            LOCK_TABLE.rw(shared).release_read()

    def commit(self) -> None:
        if self._terminated:
            return
        if self.kind == "glock":
            GLOBAL_LOCK.release()
        else:
            for shared in list(self._held):
                self._release_one(shared)
        self._terminated = True

    # Locking solutions have no rollback; abort == release (used by tests only).
    abort = commit

    def start(self, body: Callable[["LockTransaction"], Any]) -> Any:
        self.begin()
        try:
            return body(self)
        finally:
            self.commit()
