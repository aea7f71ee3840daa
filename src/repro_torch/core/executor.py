"""The executor thread (paper §3.3) — event-driven (DESIGN.md §1.3).

OptSVA-CF calls for asynchronous tasks (read-only snapshotting, last-write
log application). Spawning a thread per task is costly, so — exactly as in
Atomic RMI 2 — each node runs one always-on executor thread to which
transactions hand *tasks*. A task is gated on one version-counter condition
of one :class:`~repro.core.versioning.VersionHeader`: ``(header, kind, pv)``
with ``kind`` either ``"access"`` (``lv >= pv - 1``) or ``"termination"``
(``ltv >= pv - 1``).

Dispatch is O(woken tasks), with no scan and no timed polling: ``submit``
parks the task directly on the header's waiter queue; when the counter
reaches the threshold the header's drain enqueues the task on this
executor's ready-queue and the worker thread runs it **unconditionally** —
the gating conditions are monotonic, so a task woken by its header can
never become un-ready again (this also closes the seed's task-loss hazard,
where a ready task re-checked outside the lock could be silently dropped).
Per task the condition is evaluated at most twice: once at submit (already
satisfied → straight to the ready-queue) and once as the heap-top
comparison that wakes it.

Task code never blocks (its only precondition IS the condition), so a single
thread cannot deadlock; it can, however, become a throughput bottleneck under
heavy asynchrony — the paper observes the same in §4.3, and ``workers > 1``
is provided to explore beyond it (a beyond-paper knob; default stays 1,
faithful).
"""
from __future__ import annotations

import threading
import traceback
from collections import deque
from typing import List, Optional, Callable

from .api import TransactionError
from .versioning import VersionHeader


class Task:
    """A unit of deferred work gated on a version-counter condition."""

    __slots__ = ("code", "done", "error", "name")

    def __init__(self, code: Callable[[], None], name: str = "task"):
        self.code = code
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.name = name

    def join(self) -> None:
        """Wait for completion; re-raise transactional errors in the caller."""
        self.done.wait()
        if self.error is not None:
            if isinstance(self.error, TransactionError):
                raise self.error
            raise RuntimeError(f"executor task {self.name} failed") from self.error

    def run(self) -> None:
        """Execute unconditionally: the gating condition held when this task
        was enqueued, and monotonicity means it still holds."""
        try:
            self.code()
        except BaseException as e:  # noqa: BLE001 - propagate via join()
            self.error = e
            if not isinstance(e, TransactionError):  # pragma: no cover
                traceback.print_exc()
        finally:
            self.done.set()


_wake_tl = threading.local()


def defer_wake_inline() -> None:
    """Mark the calling thread latency-critical (e.g. a connection reader
    multiplexing many conversations): ``wake_inline`` tasks woken by a
    counter advance on this thread are enqueued to the executor instead of
    running on it, so foreign transactions' service time never stalls it."""
    _wake_tl.defer = True


def _run_trampolined(task: Task) -> None:
    """Run a woken task on the current thread, flattening cascades: if a
    task's release wakes further ``wake_inline`` tasks, they queue on this
    thread-local deque and run iteratively after it — depth-first order,
    constant stack depth."""
    pending = getattr(_wake_tl, "pending", None)
    if pending is not None:          # already inside a cascade: defer
        pending.append(task)
        return
    _wake_tl.pending = pending = deque((task,))
    try:
        while pending:
            pending.popleft().run()
    finally:
        _wake_tl.pending = None


class Executor:
    """Per-node executor consuming a ready-queue fed by header callbacks."""

    def __init__(self, name: str = "executor", workers: int = 1,
                 inline_ready: bool = True):
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._ready: deque[Task] = deque()
        self._inline_ready = inline_ready
        self._stopping = False
        self._dead = False                 # workers joined; nothing drains
        self._threads: List[threading.Thread] = []
        for i in range(max(1, workers)):
            t = threading.Thread(target=self._loop, name=f"{name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def _enqueue(self, task: Task) -> None:
        with self._lock:
            if self._dead:
                # Workers are gone: fail the task instead of parking it on a
                # queue nobody drains (join() would hang forever).
                task.error = RuntimeError("executor is shut down")
                task.done.set()
                return
            self._ready.append(task)
            self._wakeup.notify()

    def submit(self, header: VersionHeader, kind: str, pv: int,
               code: Callable[[], None], name: str = "task",
               inline_ready: Optional[bool] = None,
               wake_inline: bool = False) -> Task:
        """Submit ``code`` gated on ``(header, kind, pv)``.

        If the condition is not yet satisfied the task parks on the header's
        waiter queue and the releasing transaction's drain enqueues it on the
        ready-queue. If it already holds, the task runs *inline* on the
        submitting thread: the work (snapshot / log apply) must complete
        before the object can be released anyway, and two context switches
        through the executor thread are pure scheduling overhead — the
        asynchrony of §2.7/§2.8.4 buys overlap only while the gate is
        closed. (``inline_ready=False`` restores strict asynchrony.)

        ``inline_ready`` overrides the executor-wide default per call (the
        node server decides per call site: one-way kickoffs arriving on a
        connection reader defer ready tasks to the executor, while a
        dispense handler — pool worker, or reader on its uncontended fast
        path, where the work is a bounded state snapshot — runs them
        inline so the result rides back on the dispense reply).

        ``wake_inline=True`` additionally runs a *parked* task directly on
        the thread whose counter advance opened its gate, instead of
        bouncing it through the ready-queue — one fewer context switch on
        every contended wakeup. Task code never blocks (its only
        precondition IS the gate), so this cannot deadlock; a release
        cascade (a woken task whose own release wakes the next) is
        flattened by a per-thread trampoline, so arbitrarily long waiter
        chains run iteratively, never recursively."""
        with self._lock:
            if self._stopping:
                raise RuntimeError("executor is shut down")
        task = Task(code, name)
        inline = self._inline_ready if inline_ready is None else inline_ready
        if wake_inline:
            def on_wake() -> None:
                if getattr(_wake_tl, "defer", False):
                    self._enqueue(task)   # latency-critical waker thread
                else:
                    _run_trampolined(task)
        else:
            def on_wake() -> None:
                self._enqueue(task)
        if not header.park(kind, pv, on_wake):
            if inline:
                task.run()
            else:
                self._enqueue(task)
        return task

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._ready:
                    if self._stopping:
                        return
                    self._wakeup.wait()
                task = self._ready.popleft()
            task.run()

    def shutdown(self) -> None:
        with self._lock:
            self._stopping = True
            self._wakeup.notify_all()
        for t in self._threads:
            t.join(timeout=5.0)
        # A header callback racing shutdown may have enqueued after the
        # workers exited; fail those tasks so joiners unblock.
        with self._lock:
            self._dead = True
            leftovers = list(self._ready)
            self._ready.clear()
        for task in leftovers:
            task.error = RuntimeError("executor is shut down")
            task.done.set()

    def pending_count(self) -> int:
        """Tasks sitting in the ready-queue (parked tasks live on headers)."""
        with self._lock:
            return len(self._ready)
