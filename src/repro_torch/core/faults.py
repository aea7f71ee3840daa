"""Fault-tolerance mechanisms (paper §3.4).

Two failure classes:

* **Remote object failures** — crash-stop. Detection is the transport's job
  (here: the ``failed``/``node.alive`` flags); any call into a failed object
  raises :class:`~repro.core.api.RemoteObjectFailure`, which the programmer
  handles (re-run, compensate). A crashed object is removed from the system.

* **Transaction (client) failures** — a client may crash while holding
  objects, leaving them unreleased and possibly inconsistent. Each object
  watches the last time its holding transaction contacted it; on timeout the
  object *rolls itself back*: restores its pre-transaction state, bumps the
  instance epoch (so a resurrected "illusorily crashed" client is forced to
  abort on its next contact), and releases itself by advancing ``lv``/``ltv``
  past the crashed holder's version.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from .registry import Registry, SharedObject


class TransactionMonitor:
    """Watchdog that rolls back objects abandoned by crashed transactions.

    ``clock`` is the failure detector's time source (default: real
    monotonic time). A deterministic simulation passes its virtual clock so
    staleness is judged in virtual seconds and expiry becomes a scheduled
    event instead of a wall-clock race (DESIGN.md §7).
    """

    def __init__(self, registry: Registry, *, timeout: float = 2.0,
                 poll_interval: float = 0.1,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.timeout = timeout
        self.poll_interval = poll_interval
        self.clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rollbacks: List[str] = []

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="txn-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval):
            now = self.clock()
            for shared in self.registry.all_objects().values():
                self._check_object(shared, now)

    def _check_object(self, shared: SharedObject, now: float) -> None:
        with shared._contact_lock:
            txn = shared.holding_txn
            last = shared.last_contact
        if txn is None or now - last < self.timeout:
            return
        self.rollback_object(shared, txn)

    def rollback_object(self, shared: SharedObject, txn: object) -> None:
        """Self-rollback of one abandoned object (paper §3.4)."""
        h = shared.header
        acc = getattr(txn, "_accesses", {}).get(shared)
        if acc is None or not getattr(acc, "holds_access", False):
            # not actually holding (e.g. cleared between checks): just untrack
            shared.clear_holder(txn)
            return
        with h.lock:
            with shared._contact_lock:
                if shared.holding_txn is not txn:
                    return  # already cleaned up / txn resumed and finished
                shared.holding_txn = None
            if (acc.st is not None and acc.modified
                    and h.restore_allowed(acc.seen_instance, acc.pv)):
                acc.st.restore_into(shared.holder)
            # Invalidate: the crashed txn (if merely slow) and anyone who read
            # its early-released state must abort when they next check.
            # Recorded so the version-aware restore guard can account for
            # this bump.
            h.note_restore(acc.pv)
            h.instance += 1
            # Self-release: advance both counters past the crashed holder,
            # collecting the waiters this unblocks.
            woken = h.advance_locked(acc.pv)
        h.fire_callbacks(woken)  # outside the version lock
        self.rollbacks.append(shared.name)
