"""Versioning concurrency control primitives (paper §2.1, §2.3).

Every shared object carries a :class:`VersionHeader`:

* ``gv``  — the private-version dispenser. A starting transaction, holding
  the object's version lock, takes ``pv = gv + 1`` and increments ``gv``.
  Dispensing under per-object locks acquired in a *global order* makes the
  assignment atomic across the access set and yields properties (a)-(d) of
  §2.1 and deadlock freedom (§2.10.2).
* ``lv``  — the local version: the pv of the transaction that most recently
  *released* the object (early release, commit, or abort).
* ``ltv`` — the local terminal version: the pv of the transaction that most
  recently *terminated* (committed or aborted) on the object.
* ``instance`` — the object-instance epoch. An aborting transaction that
  restores the object's state bumps this counter; any transaction that
  observed the previous instance is thereby *invalidated* ("marks each
  object in its access set as an invalid instance", §2.3) and will be
  forced to abort at its next validity check.

Conditions (paper §2.1, §2.3):

* access condition:  ``pv - 1 == lv``
* commit/termination condition: ``pv - 1 == ltv``

Irrevocable transactions replace every access-condition wait with a
termination-condition wait (§2.4), so they never observe early-released
(and hence potentially revocable) state.

Wakeups are **event-driven and targeted** (DESIGN.md §1.2): both conditions
are monotonic single-variable threshold predicates (``lv >= pv - 1`` resp.
``ltv >= pv - 1``; the counters only grow), so each header keeps two waiter
min-heaps keyed on the threshold — access waiters on ``lv``, termination
waiters on ``ltv``. ``release_to``/``terminate_to`` pop exactly the waiters
whose threshold the new counter value satisfies and fire their callbacks
(after dropping the version lock, so callbacks may take other locks).
There is no broadcast: a counter change on header A never evaluates a
condition parked on header B, and a change that satisfies no waiter costs
one heap-top comparison. ``instance`` bumps wake nobody — no condition
mentions the epoch; doomed transactions discover it at their next validity
check, exactly as in the seed semantics.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, List, Optional

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import txtrace as _txtrace

_header_ids = itertools.count(1)
_waiter_seq = itertools.count()

# -- pluggable blocking wait (deterministic simulation hook) -----------------
# A thread that must not block on real OS primitives (a simnet actor under
# the virtual clock, DESIGN.md §7) installs a per-thread waiter: a callable
# ``fn(event, timeout) -> bool`` with ``threading.Event.wait`` semantics.
# Default (no hook) is the native event wait — the TCP/in-process paths are
# completely unaffected.
_wait_tl = threading.local()


def set_blocking_wait(fn: Optional[Callable]) -> None:
    """Install (or clear, with ``None``) this thread's blocking-wait hook.

    ``fn(event, timeout)`` must block until ``event`` is set or ``timeout``
    (seconds, possibly virtual) elapses, returning ``event.is_set()`` —
    exactly :meth:`threading.Event.wait`'s contract. Every version-condition
    wait on this thread then routes through it, which is what lets a
    deterministic scheduler own the interleaving of gate waits."""
    _wait_tl.fn = fn


def blocking_wait(event: threading.Event, timeout: Optional[float]) -> bool:
    """Wait for ``event`` via this thread's hook (or natively)."""
    fn = getattr(_wait_tl, "fn", None)
    if fn is None:
        return event.wait(timeout)
    return fn(event, timeout)

# Waiter heap entry: [threshold, seq, callback]; callback is set to None to
# cancel in place (lazy deletion — the drain discards cancelled entries).
_ACCESS = "access"
_TERMINATION = "termination"


class VersionHeader:
    """Concurrency-control state attached to one shared object."""

    __slots__ = (
        "uid", "lock", "gv", "lv", "ltv", "instance",
        "_access_waiters", "_term_waiters", "_listeners", "_restores",
        "cond_evals", "wakeups", "owner_node",
        "obs_tracer", "obs_metrics", "obs_clock", "_handoff_mark",
        "cg_pv", "cg_class", "cg_members", "cg_snapped", "_cg_merge_locks",
    )

    def __init__(self, owner_node: Optional[object] = None):
        self.uid: int = next(_header_ids)      # global order for start-time locking
        self.lock = threading.RLock()          # the object's "version lock"
        self.gv: int = 0
        self.lv: int = 0
        self.ltv: int = 0
        self.instance: int = 0
        self._access_waiters: List[list] = []  # heap on lv threshold
        self._term_waiters: List[list] = []    # heap on ltv threshold
        #: abort/crash restore log: (epoch at restore, restorer's pv) per
        #: instance bump — the version-aware oldest-restore-wins guard
        #: (:meth:`restore_allowed`) reads it.
        self._restores: List[tuple] = []
        # Optional counter-change listeners (seed-era broadcast hook; kept
        # for the benchmark's seed-executor replica, unused otherwise).
        self._listeners: List[Callable[[], None]] = []
        # Instrumentation: how many times a waiter condition was evaluated
        # (at park time + one heap-top comparison per drain) and how many
        # waiters were actually woken. The targeting regression test pins
        # these: releasing another header must not evaluate ours.
        self.cond_evals: int = 0
        self.wakeups: int = 0
        self.owner_node = owner_node
        # Observability (repro.obs, DESIGN.md §9): the owning site's
        # tracer/metrics/clock, stamped at bind time by NodeCore; unset
        # headers (in-process transport) fall back to the thread's
        # current client tracer. ``_handoff_mark`` carries the release
        # timestamp of ``lv``'s last advance so the successor's first
        # access records the version-handoff latency.
        self.obs_tracer = None
        self.obs_metrics = None
        self.obs_clock = None
        self._handoff_mark: Optional[tuple] = None
        # Commute group (DESIGN.md §12): while active, every member of ONE
        # commuting method class shares the single private version
        # ``cg_pv`` — their deltas merge under the class's merge lock
        # instead of serializing on the version chain. ``cg_snapped``
        # flips the moment a non-commuting access dispenses past the
        # group: no further joins, the group drains and dissolves.
        self.cg_pv: int = 0
        self.cg_class: Optional[str] = None
        self.cg_members: int = 0
        self.cg_snapped: bool = False
        self._cg_merge_locks: Optional[dict] = None

    # -- version dispensing -------------------------------------------------
    def dispense(self) -> int:
        """Take the next private version. Caller must hold ``lock``."""
        if self.cg_class is not None:
            # Snap-back (§12): an exact access is entering the chain.
            # The group stops admitting members; its shared version
            # ``cg_pv`` precedes this pv, so full OptSVA ordering gates
            # the newcomer until the last member terminates the group.
            self.cg_snapped = True
        self.gv += 1
        return self.gv

    # -- commute groups (DESIGN.md §12) -------------------------------------
    def commute_join(self, cls: str) -> int:
        """Join (or form) the commute group for method class ``cls``.
        Caller must hold ``lock``. Returns the group's shared private
        version, or 0 if the object must fall back to exact dispensing
        (group of another class, snapped group, or chain not quiescent).

        A group only FORMS at full quiescence (``gv == lv == ltv``): the
        shared version then satisfies both the access and termination
        conditions immediately (``cg_pv - 1 == lv == ltv``), and ``ltv``
        stays at ``cg_pv - 1`` while the group is active — so any exact
        successor (pv > cg_pv) gates behind the group until it dissolves.
        """
        if self.cg_class is not None:
            if self.cg_class == cls and not self.cg_snapped:
                self.cg_members += 1
                return self.cg_pv
            return 0
        if not (self.gv == self.lv == self.ltv):
            return 0
        self.gv += 1
        self.cg_pv = self.gv
        self.cg_class = cls
        self.cg_members = 1
        self.cg_snapped = False
        return self.cg_pv

    def commute_leave(self) -> None:
        """One member finished (fold applied, or abort discarded its
        deltas). When the last member leaves, the group dissolves:
        ``terminate_to(cg_pv)`` advances the chain so gated exact
        successors proceed. Call WITHOUT holding ``lock``."""
        with self.lock:
            self.cg_members -= 1
            if self.cg_members > 0:
                return
            pv = self.cg_pv
            self.cg_pv = 0
            self.cg_class = None
            self.cg_snapped = False
        # Outside the lock, like every counter advance. A racing fresh
        # formation cannot slip in between: forming requires
        # ``gv == lv == ltv``, which cannot hold until this terminate_to
        # lands (gv is already past lv/ltv while the group exists).
        self.terminate_to(pv)

    def commute_merge_lock(self, cls: str) -> threading.Lock:
        """The per-method-class merge lock of this object (lazily made)."""
        with self.lock:
            locks = self._cg_merge_locks
            if locks is None:
                locks = self._cg_merge_locks = {}
            lk = locks.get(cls)
            if lk is None:
                lk = locks[cls] = threading.Lock()
            return lk

    # -- waiter parking -----------------------------------------------------
    def park(self, kind: str, pv: int, callback: Callable[[], None]) -> bool:
        """Register ``callback`` to fire once the ``kind`` condition for
        ``pv`` holds. Returns ``False`` if the condition already holds (the
        callback is NOT invoked — the caller runs the work itself), ``True``
        if the waiter was parked. Monotonicity guarantees the callback fires
        exactly once, when the counter first reaches the threshold."""
        threshold = pv - 1
        with self.lock:
            self.cond_evals += 1
            if kind == _ACCESS:
                if self.lv >= threshold:
                    return False
                heap = self._access_waiters
            else:
                if self.ltv >= threshold:
                    return False
                heap = self._term_waiters
            heapq.heappush(heap, [threshold, next(_waiter_seq), callback])
            return True

    def _drain_ready_locked(self) -> List[Callable[[], None]]:
        """Pop every waiter whose threshold is now satisfied. Caller holds
        ``lock``; returned callbacks must be fired after dropping it."""
        fire: List[Callable[[], None]] = []
        for heap, counter in ((self._access_waiters, self.lv),
                              (self._term_waiters, self.ltv)):
            while heap:
                self.cond_evals += 1
                if heap[0][0] > counter:
                    break
                entry = heapq.heappop(heap)
                if entry[2] is not None:       # skip cancelled waiters
                    self.wakeups += 1
                    fire.append(entry[2])
        return fire

    def _fire(self, callbacks: List[Callable[[], None]]) -> None:
        for cb in callbacks:
            cb()
        if self._listeners:
            for fn in list(self._listeners):
                fn()

    # -- counter updates ----------------------------------------------------
    def _mark_release_locked(self, pv: int) -> None:
        """Timestamp ``lv``'s advance to ``pv`` (caller holds ``lock``)
        so the first access of ``pv + 1`` can record the version-handoff
        latency — the direct measure of early-release pipelining."""
        self._handoff_mark = (pv, (self.obs_clock or time.monotonic)())

    def release_to(self, pv: int) -> None:
        """Set ``lv = pv`` (early release / release-at-termination)."""
        with self.lock:
            if self.lv < pv:
                if _txtrace.enabled:
                    self._mark_release_locked(pv)
                self.lv = pv
            fire = self._drain_ready_locked()
        self._fire(fire)

    def terminate_to(self, pv: int) -> None:
        """Set ``ltv = pv`` (commit/abort). Implies release."""
        with self.lock:
            if self.lv < pv:
                if _txtrace.enabled:
                    self._mark_release_locked(pv)
                self.lv = pv
            if self.ltv < pv:
                self.ltv = pv
            self._compact_restores_locked()
            fire = self._drain_ready_locked()
        self._fire(fire)

    def advance_locked(self, pv: int) -> List[Callable[[], None]]:
        """Advance both counters to ``pv`` while the caller already holds
        ``lock`` (fault-tolerance self-rollback, §3.4). Returns the ready
        callbacks; the caller MUST fire them via :meth:`fire_callbacks`
        after dropping the lock."""
        if self.lv < pv:
            if _txtrace.enabled:
                self._mark_release_locked(pv)
            self.lv = pv
        if self.ltv < pv:
            self.ltv = pv
        self._compact_restores_locked()
        return self._drain_ready_locked()

    def fire_callbacks(self, callbacks: List[Callable[[], None]]) -> None:
        """Fire drained waiter callbacks (outside the version lock)."""
        self._fire(callbacks)

    def restore_allowed(self, seen: Optional[int], pv: int) -> bool:
        """Version-aware oldest-restore-wins (abort step 3 / §3.4 crash
        rollback). Caller holds ``lock``.

        A transaction restoring its checkpoint must skip the restore iff
        an *older* transaction (smaller ``pv``) already restored since the
        checkpoint was taken — that older state subsumes ours. The naive
        ``instance == seen`` guard also skips when only YOUNGER
        transactions restored, which silently keeps the aborting
        transaction's own effects applied: T2 modifies o, T3 (pv 3 > 2)
        opens on top, T3 crashes and restores its checkpoint (which still
        CONTAINS T2's uncommitted writes) bumping the epoch, T2 then
        aborts — under the naive guard T2's restore is skipped and its
        writes survive the abort (lost-money bug, found by the simnet
        seed sweep). Since every epoch bump records ``(epoch, restorer
        pv)`` in ``_restores``, the guard can tell the two cases apart;
        an unaccounted bump falls back to the conservative skip."""
        if seen is None:
            return False
        if self.instance == seen:
            return True
        since = [rpv for epoch, rpv in self._restores if epoch >= seen]
        if len(since) != self.instance - seen:
            return False       # unaccounted bumps: conservative old rule
        return all(rpv > pv for rpv in since)

    def note_restore(self, pv: int) -> None:
        """Record an abort/crash restore by ``pv`` (call under ``lock``,
        BEFORE bumping ``instance``)."""
        self._restores.append((self.instance, pv))

    def _compact_restores_locked(self) -> None:
        """Drop the restore log at full chain quiescence (``gv == lv ==
        ltv``): every dispensed version has terminated, so no live access
        record can still hold a ``seen_instance`` that predates the
        retained window — the log can only be consulted by *future*
        checkpoints, whose epochs are >= the current instance. Keeps
        :meth:`restore_allowed`'s scan O(aborts since last quiescence)
        instead of O(all aborts ever)."""
        if self._restores and self.ltv == self.gv:
            self._restores.clear()

    def bump_instance(self) -> None:
        """Invalidate the current instance (abort restored older state).

        Wakes nobody: no wait condition involves the epoch."""
        with self.lock:
            self.instance += 1

    # -- conditions -----------------------------------------------------------
    def access_ready(self, pv: int) -> bool:
        return pv - 1 <= self.lv

    def termination_ready(self, pv: int) -> bool:
        return pv - 1 <= self.ltv

    # -- observability (repro.obs; called only under ``txtrace.enabled``) ----
    def _obs_site(self):
        return self.obs_tracer or _txtrace.current()

    def _obs_registry(self):
        return self.obs_metrics or _metrics.registry(self._obs_site().site)

    def _obs_handoff(self, pv: int) -> None:
        """Version-handoff latency: ``lv``'s advance to ``pv - 1`` →
        this first access-condition completion of ``pv``."""
        mark = self._handoff_mark
        if mark is None or mark[0] != pv - 1:
            return
        self._handoff_mark = None
        now = (self.obs_clock or time.monotonic)()
        self._obs_registry().histogram("handoff_us").record(
            (now - mark[1]) * 1e6)

    def _obs_blocked(self, kind: str, pv: int, t0: float) -> None:
        """A version-condition wait actually blocked: span + histogram.
        The span carries ``pv`` and the blocking threshold; the export
        attributes it to a transaction by interval containment within
        that transaction's op span on the same site."""
        now = (self.obs_clock or time.monotonic)()
        self._obs_site().emit("vwait", t0, now - t0, pv=pv,
                              detail=f"{kind}:thr={pv - 1}")
        name = "gate_wait_us" if kind == _ACCESS else "term_wait_us"
        self._obs_registry().histogram(name).record((now - t0) * 1e6)
        if kind == _ACCESS:
            self._obs_handoff(pv)

    def _wait(self, kind: str, pv: int, timeout: Optional[float]) -> bool:
        """Block until the ``kind`` condition for ``pv`` holds.

        Returns True iff the caller actually blocked (a real wait, used for
        the per-framework wait statistics). Raises ``TimeoutError`` on
        timeout expiry."""
        ev = threading.Event()
        wake = ev.set                          # one bound method: identity key
        if not self.park(kind, pv, wake):
            if _txtrace.enabled and kind == _ACCESS:
                self._obs_handoff(pv)
            return False
        t0 = ((self.obs_clock or time.monotonic)()
              if _txtrace.enabled else 0.0)
        if blocking_wait(ev, timeout):
            if _txtrace.enabled:
                self._obs_blocked(kind, pv, t0)
            return True
        # Timed out: cancel the parked waiter. If it fired in the race
        # window the wait actually succeeded.
        with self.lock:
            heap = self._access_waiters if kind == _ACCESS else self._term_waiters
            for entry in heap:
                if entry[2] is wake:
                    # Remove eagerly: a stuck version chain (e.g. a crashed
                    # predecessor with no monitor) sees repeated timed-out
                    # retries, and lazily-cancelled entries would pile up in
                    # a heap whose threshold is never reached. The timeout
                    # path is rare, so O(n) removal is fine.
                    heap.remove(entry)
                    heapq.heapify(heap)
                    break
            else:
                return True                    # already drained: we won
        counter = self.lv if kind == _ACCESS else self.ltv
        raise TimeoutError(
            f"{kind} condition timed out (pv={pv}, counter={counter})")

    def wait_access(self, pv: int, *, timeout: Optional[float] = None) -> bool:
        """Block until the access condition ``pv - 1 == lv`` holds.
        Returns True iff the caller actually blocked."""
        return self._wait(_ACCESS, pv, timeout)

    def wait_termination(self, pv: int, *, timeout: Optional[float] = None) -> bool:
        """Block until the commit condition ``pv - 1 == ltv`` holds.
        Returns True iff the caller actually blocked."""
        return self._wait(_TERMINATION, pv, timeout)

    def waiter_counts(self) -> tuple:
        """(access, termination) waiters currently parked (for tests)."""
        with self.lock:
            return (sum(1 for e in self._access_waiters if e[2] is not None),
                    sum(1 for e in self._term_waiters if e[2] is not None))

    # -- seed-era listener hooks (benchmark baseline replica only) ----------
    def add_listener(self, fn: Callable[[], None]) -> None:
        """Register a counter-change listener. The event-driven executor no
        longer uses these; the seed-executor benchmark shim does."""
        with self.lock:
            self._listeners.append(fn)

    def remove_listener(self, fn: Callable[[], None]) -> None:
        with self.lock:
            try:
                self._listeners.remove(fn)
            except ValueError:
                pass

    def __repr__(self) -> str:  # pragma: no cover
        return (f"VersionHeader(uid={self.uid}, gv={self.gv}, lv={self.lv}, "
                f"ltv={self.ltv}, inst={self.instance})")


def skip_version(h: VersionHeader, pv: int) -> None:
    """Advance ``lv``/``ltv`` past an abandoned transaction's ``pv`` *in
    chain order* (paper §3.4): each counter jumps to ``pv`` exactly when it
    reaches ``pv - 1`` — immediately if the abandoned transaction's turn
    already came, otherwise via a waiter parked on the header, so
    successors can never bypass a live predecessor's unreleased state.
    Idempotent: counters are monotonic and a duplicate parked skip fires as
    a no-op."""
    if not h.park(_ACCESS, pv, lambda: h.release_to(pv)):
        h.release_to(pv)
    if not h.park(_TERMINATION, pv, lambda: h.terminate_to(pv)):
        h.terminate_to(pv)


def wait_quiescent(h: VersionHeader, *,
                   timeout: Optional[float] = None) -> bool:
    """Block until every dispensed version of ``h`` has terminated
    (``gv == lv == ltv``) — the migration drain-barrier (DESIGN.md §10).

    The caller must have stopped new dispensing first (the migration mark
    is taken under the header lock before this is called), otherwise the
    barrier chases a moving ``gv``. Blocks through the per-thread
    :func:`blocking_wait` hook, so under simnet the wait is a
    deterministic virtual-time event. Returns False on timeout."""
    while True:
        with h.lock:
            g = h.gv
            if h.ltv >= g and h.lv >= g:
                return True
        try:
            # termination condition for version g+1 is ``ltv >= g``
            h.wait_termination(g + 1, timeout=timeout)
        except TimeoutError:
            return False


def dispense_versions(headers: List[VersionHeader]) -> List[int]:
    """Atomically dispense private versions for an access set (paper §2.10.2).

    Locks the per-object version locks in the global ``uid`` order,
    dispenses, then unlocks — eliminating circular waits during start.
    """
    ordered = sorted(headers, key=lambda h: h.uid)
    for h in ordered:
        h.lock.acquire()
    try:
        return [h.dispense() for h in headers]
    finally:
        for h in reversed(ordered):
            h.lock.release()
