"""SVA — the Supremum Versioning Algorithm (Atomic RMI 1, paper §4.1).

The predecessor baseline: the bare versioning mechanism of §2.1-§2.3,
*operation-type agnostic* — every access (read, write, or update alike)
must pass the access condition and executes directly on the object; a single
per-object supremum drives early release; there is no buffering and no
asynchrony. Kept API-compatible with :class:`~repro.core.transaction.Transaction`
so benchmarks can swap algorithms.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Union

from .api import (
    INF, AbortError, IllegalState, RetrySignal, SupremumViolation, TransactionError,
)
from .buffers import CopyBuffer
from .registry import Node, Registry, SharedObject
from .versioning import dispense_versions
from .api import OpStats

_txn_ids = itertools.count(1)


class _SvaAccess:
    __slots__ = ("shared", "ub", "pv", "count", "st", "seen_instance",
                 "holds_access", "released", "modified")

    def __init__(self, shared: SharedObject, ub: float):
        self.shared = shared
        self.ub = ub
        self.pv = 0
        self.count = 0
        self.st: Optional[CopyBuffer] = None
        self.seen_instance: Optional[int] = None
        self.holds_access = False
        self.released = False
        self.modified = False


class _SvaProxy:
    __slots__ = ("_txn", "_shared")

    def __init__(self, txn: "SvaTransaction", shared: SharedObject):
        object.__setattr__(self, "_txn", txn)
        object.__setattr__(self, "_shared", shared)

    def __getattr__(self, method: str) -> Callable[..., Any]:
        txn = object.__getattribute__(self, "_txn")
        shared = object.__getattribute__(self, "_shared")

        def call(*args: Any, **kwargs: Any) -> Any:
            return txn._invoke(shared, method, args, kwargs)

        return call


class SvaTransaction:
    """Operation-agnostic supremum-versioning transaction."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 client_node: Optional[Node] = None,
                 wait_timeout: Optional[float] = None,
                 irrevocable: bool = False):
        self.id = next(_txn_ids)
        self.registry = registry
        self.client_node = client_node
        self.wait_timeout = wait_timeout
        self.irrevocable = irrevocable
        self.stats = OpStats()
        self._accesses: Dict[SharedObject, _SvaAccess] = {}
        self._order: List[_SvaAccess] = []
        self._started = False
        self._terminated = False

    # -- preamble: SVA takes one combined supremum per object ---------------
    def accesses(self, obj: Union[SharedObject, str], ub: float = INF,
                 *_ignored: float) -> _SvaProxy:
        if self._started:
            raise IllegalState("access set must be declared before start()")
        shared = self.registry.locate(obj) if isinstance(obj, str) else obj
        if shared in self._accesses:
            raise IllegalState(f"object {shared.name!r} already declared")
        acc = _SvaAccess(shared, ub)
        self._accesses[shared] = acc
        self._order.append(acc)
        return _SvaProxy(self, shared)

    # Mode-specific declarations collapse to the agnostic one.
    def reads(self, obj, max_reads: float = INF) -> _SvaProxy:
        return self.accesses(obj, max_reads)

    def writes(self, obj, max_writes: float = INF) -> _SvaProxy:
        return self.accesses(obj, max_writes)

    def updates(self, obj, max_updates: float = INF) -> _SvaProxy:
        return self.accesses(obj, max_updates)

    def commutes(self, obj, max_ops: float = INF, cls=None) -> _SvaProxy:
        """API-compat alias: SVA has no commute groups — a commute-declared
        access degrades to an ordinary bounded access, so benchmarks can
        swap algorithms without changing their preamble."""
        return self.accesses(obj, max_ops)

    def begin(self) -> None:
        if self._started:
            raise IllegalState("transaction already started")
        self._started = True
        pvs = dispense_versions([a.shared.header for a in self._order])
        for a, pv in zip(self._order, pvs):
            a.pv = pv

    def _invoke(self, shared: SharedObject, method: str, args: tuple,
                kwargs: dict) -> Any:
        if self._terminated or not self._started:
            raise IllegalState("transaction not active")
        shared.check_reachable()
        a = self._accesses[shared]
        if a.count + 1 > a.ub:
            self._do_abort()
            self.stats.aborts += 1
            raise SupremumViolation(
                f"access #{a.count + 1} on {shared.name!r} exceeds supremum {a.ub}")
        if not a.holds_access:
            h = shared.header
            if self.irrevocable:
                blocked = h.wait_termination(a.pv, timeout=self.wait_timeout)
            else:
                blocked = h.wait_access(a.pv, timeout=self.wait_timeout)
            if blocked:
                self.stats.waits += 1
            shared.check_reachable()
            with h.lock:
                a.seen_instance = h.instance
            a.st = CopyBuffer(shared.holder.obj, a.seen_instance, home_node=shared.node)
            a.holds_access = True
        self._validity_check()
        shared.touch(self)
        v = shared.raw_call(method, args, kwargs, from_node=self.client_node)
        a.count += 1
        a.modified = True  # agnostic: must assume every access modified state
        self.stats.updates += 1
        if a.count == a.ub:
            shared.header.release_to(a.pv)
            a.released = True
        return v

    def _validity_check(self) -> None:
        for a in self._order:
            if (a.seen_instance is not None
                    and a.shared.header.instance != a.seen_instance):
                self._do_abort()
                self.stats.aborts += 1
                raise AbortError(
                    f"object {a.shared.name!r} invalidated (cascading abort)",
                    forced=True)

    def commit(self) -> None:
        if self._terminated:
            raise IllegalState("transaction already terminated")
        for a in self._order:
            if a.shared.header.wait_termination(a.pv, timeout=self.wait_timeout):
                self.stats.waits += 1
        doomed = any(
            a.seen_instance is not None
            and a.shared.header.instance != a.seen_instance
            for a in self._order)
        if doomed:
            self._do_abort()
            self.stats.aborts += 1
            raise AbortError("commit-time validation failed", forced=True)
        for a in self._order:
            if not a.released:
                a.shared.header.release_to(a.pv)
                a.released = True
            a.shared.header.terminate_to(a.pv)
            a.shared.clear_holder(self)
        self._terminated = True

    def abort(self) -> None:
        self._do_abort()
        self.stats.aborts += 1
        raise AbortError("transaction aborted manually", forced=False)

    def retry(self) -> None:
        self._do_abort()
        self.stats.retries += 1
        raise RetrySignal("transaction retry requested")

    def _do_abort(self) -> None:
        if self._terminated:
            return
        for a in self._order:
            try:
                a.shared.header.wait_termination(a.pv, timeout=self.wait_timeout)
            except TimeoutError:
                pass
        for a in self._order:
            h = a.shared.header
            if a.st is not None and a.modified:
                with h.lock:
                    if h.restore_allowed(a.seen_instance, a.pv):
                        a.st.restore_into(a.shared.holder)
                        h.note_restore(a.pv)
                        h.instance += 1
        for a in self._order:
            if not a.released:
                a.shared.header.release_to(a.pv)
                a.released = True
            a.shared.header.terminate_to(a.pv)
            a.shared.clear_holder(self)
        self._terminated = True

    def start(self, body: Callable[["SvaTransaction"], Any], *,
              max_retries: int = 64) -> Any:
        attempts = 0
        while True:
            attempts += 1
            if not self._started:
                self.begin()
            try:
                result = body(self)
            except RetrySignal:
                if attempts > max_retries:
                    raise AbortError("retry limit exceeded", forced=True) from None
                self._reincarnate()
                continue
            except AbortError:
                raise  # rollback already performed
            except BaseException:
                if not self._terminated:
                    self._do_abort()
                    self.stats.aborts += 1
                raise
            if not self._terminated:
                self.commit()
            return result

    def _reincarnate(self) -> None:
        fresh, mapping = [], {}
        for a in self._order:
            na = _SvaAccess(a.shared, a.ub)
            fresh.append(na)
            mapping[a.shared] = na
        self._order, self._accesses = fresh, mapping
        self._started = False
        self._terminated = False
        self.begin()
