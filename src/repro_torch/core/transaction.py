"""OptSVA-CF transactions (paper §2.8, API per Figs. 8-9).

The transaction life cycle:

1. *Preamble* — the client declares its access set with ``reads`` /
   ``writes`` / ``updates`` / ``accesses``, optionally with suprema.
2. *Start* — private versions are dispensed atomically for the whole access
   set (global-order version-lock acquisition, §2.10.2); for every
   *read-only* object an asynchronous buffering task is enqueued on the home
   node's executor (§2.7, §2.8.1).
3. *Operations* — dispatched by declared :class:`~repro.core.api.Mode`
   through the rules of §2.8.2-§2.8.4 (buffering, log-writes without
   synchronization, early release at suprema, asynchronous release on last
   write).
4. *Commit / abort* — §2.8.5-§2.8.6: join outstanding tasks, wait the
   commit condition per object, apply stray logs, release, validate
   instances, terminate (restoring state and bumping instance epochs on
   abort, which is what drives cascading aborts).

Implementation notes vs. the paper text (also see DESIGN.md):

* §2.8.4 says the post-last-write clone goes to ``st``; that would clobber
  the abort checkpoint, so we clone to the copy buffer ``buf`` (consistent
  with §2.7 and the OptSVA original) — a typo in the paper.
* "Invalid instance" marking is realized as an *instance epoch* on the
  version header: an aborting transaction that restores state bumps the
  epoch; any transaction that observed the prior epoch is doomed at its
  next validity check. Restores (and epoch bumps) only happen for objects
  the aborting transaction actually modified — restoring an unmodified
  object would spuriously doom successors.

Transport boundary (DESIGN.md §3.1): every operation that touches object
*state* — waiting a gate and checkpointing, snapshotting a buffer, applying
a log, reading through a buffer, restoring on abort — is a method of
:class:`ObjectAccess`, executed where the object lives. This in-process
implementation runs them directly against ``shared.holder``; the TCP
transport (``repro.net``) subclasses :class:`ObjectAccess` so the same
operations become single RPCs executed *on the home node* and only control
information (versions, instance epochs, return values) crosses the wire —
the CF model's delegation of computation to data. :class:`Transaction`
itself is transport-agnostic protocol sequencing.
"""
from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Union

from .api import (
    INF, AbortError, IllegalState, InstanceInvalidated, Mode, OpStats,
    RetrySignal, Suprema, SupremumViolation, TransactionError,
)
from .buffers import CopyBuffer, LogBuffer
from .executor import Task
from .registry import Node, Registry, SharedObject
from .versioning import skip_version

from repro_torch.obs import txtrace as _txtrace

_txn_ids = itertools.count(1)


class Completed:
    """Already-resolved completion handle (the in-process "future").

    The commit/abort hot paths issue their per-node batched operations
    first and await results second (scatter-gather); the in-process
    transport executes at issue time and hands back one of these, so
    :class:`Transaction` sequencing stays transport-agnostic.
    """

    __slots__ = ("_value",)

    def __init__(self, value: Any = None):
        self._value = value

    def result(self, timeout: Optional[float] = None) -> Any:
        return self._value


class ObjectAccess:
    """Transaction-local bookkeeping for one shared object, plus the
    home-node state operations of §2.7-§2.8 (the transport boundary).

    The base class is the in-process transport: state operations execute
    directly against ``shared.holder`` / ``shared.header``. Remote
    transports override the *delegation boundary* methods below so the same
    operations run on the object's home node.
    """

    __slots__ = (
        "txn", "shared", "sup", "pv", "rc", "wc", "uc", "st", "buf", "log",
        "seen_instance", "holds_access", "released", "release_task",
        "modified", "terminated", "lock",
    )

    #: version-lock domain for start-time dispensing (§2.10.2): ``None``
    #: means the in-process domain (per-header locks in uid order); remote
    #: accesses return a sortable per-node key so every client acquires
    #: node-level locks in the same global order.
    dispense_domain: Optional[tuple] = None

    def __init__(self, txn: "Transaction", shared: SharedObject, sup: Suprema):
        self.txn = txn
        self.shared = shared
        self.sup = sup
        self.pv: int = 0
        self.rc = self.wc = self.uc = 0
        self.st: Optional[CopyBuffer] = None      # abort-restore checkpoint
        self.buf: Optional[CopyBuffer] = None     # post-release local-read buffer
        self.log = LogBuffer(home_node=shared.node)
        self.seen_instance: Optional[int] = None  # epoch observed at checkpoint
        self.holds_access = False                 # passed access condition
        self.released = False                     # lv handed over (or task will)
        self.release_task: Optional[Task] = None  # async buffer/apply task
        self.modified = False                     # we touched live state
        self.terminated = False                   # ltv advanced past us
        self.lock = threading.Lock()              # task <-> main thread

    @property
    def accessed_directly(self) -> bool:
        return self.holds_access

    def count_for(self, mode: Mode) -> int:
        return {Mode.READ: self.rc, Mode.WRITE: self.wc, Mode.UPDATE: self.uc}[mode]

    def sup_for(self, mode: Mode) -> float:
        return {Mode.READ: self.sup.reads, Mode.WRITE: self.sup.writes,
                Mode.UPDATE: self.sup.updates}[mode]

    def all_suprema_met(self) -> bool:
        return (self.rc == self.sup.reads and self.wc == self.sup.writes
                and self.uc == self.sup.updates)

    def writes_updates_done(self) -> bool:
        return self.wc == self.sup.writes and self.uc == self.sup.updates

    # ------------------------------------------------------------------ #
    # Delegation boundary: state operations, executed at the home node.  #
    # ------------------------------------------------------------------ #
    def _ro_buffer_code(self) -> None:
        """§2.7 task body: snapshot to ``buf``, then release immediately.
        Shared with the node server's session records, which subclass this
        access and wrap the body with §3.4 expiry checks."""
        if _txtrace.enabled:
            t0 = self._obs_tracer().now()
            self._ro_buffer_body()
            self._obs_span("ro_buffer", t0, detail=self.shared.name)
        else:
            self._ro_buffer_body()

    def _ro_buffer_body(self) -> None:
        shared = self.shared
        with shared.header.lock:
            inst = shared.header.instance
        with self.lock:
            self.seen_instance = inst
            self.buf = CopyBuffer(shared.holder.obj, inst,
                                  home_node=shared.node)
        # Snapshot taken: the object is immediately released (§2.7).
        shared.header.release_to(self.pv)
        with self.lock:
            self.released = True

    def _lw_apply_code(self) -> None:
        """§2.8.4 task body: checkpoint, apply the write log, release."""
        if _txtrace.enabled:
            t0 = self._obs_tracer().now()
            self._lw_apply_body()
            self._obs_span("lw_apply", t0, detail=self.shared.name)
        else:
            self._lw_apply_body()

    def _lw_apply_body(self) -> None:
        shared = self.shared
        with shared.header.lock:
            inst = shared.header.instance
        st = CopyBuffer(shared.holder.obj, inst, home_node=shared.node)
        self.log.apply_to(shared.holder.obj)
        buf = CopyBuffer(shared.holder.obj, inst, home_node=shared.node)
        with self.lock:
            self.seen_instance = inst
            self.st = st
            self.buf = buf
            self.modified = True
            self.holds_access = True
        shared.header.release_to(self.pv)
        with self.lock:
            self.released = True

    def _owner_label(self) -> str:
        return f"T{self.txn.id}"

    # -- observability (repro.obs; call only under ``txtrace.enabled``) -----
    def _obs_uid(self) -> str:
        """Correlation uid matching the wire form's ``#<id>[r<inc>]``
        tail (remote._txn_uid) so client and server spans of one
        transaction merge into one flow. The node server's session
        access overrides this with the full wire uid."""
        inc = getattr(self.txn, "incarnation", 0)
        tid = self.txn.id
        return f"#{tid}r{inc}" if inc else f"#{tid}"

    def _obs_tracer(self):
        """The owning site's tracer: where the state lives (stamped on
        the header by the node server), else this thread's client site."""
        return self.shared.header.obs_tracer or _txtrace.current()

    def _obs_span(self, kind: str, t0: float, **kw: Any) -> None:
        tr = self._obs_tracer()
        tr.emit(kind, t0, tr.now() - t0, txn=self._obs_uid(),
                inc=getattr(self.txn, "incarnation", 0), pv=self.pv, **kw)

    def _obs_instant(self, kind: str, **kw: Any) -> None:
        tr = self._obs_tracer()
        tr.emit(kind, tr.now(), 0.0, txn=self._obs_uid(),
                inc=getattr(self.txn, "incarnation", 0), pv=self.pv, **kw)

    def _submit_task(self, label: str, kind: str,
                     code: Callable[[], None]) -> "Task":
        """Hand a gated task to the home node's executor. The node server
        overrides this to defer ready tasks off its reader thread and to
        push a completion note to the client when the task finishes."""
        return self.shared.node.executor.submit(
            self.shared.header, kind, self.pv, code,
            name=f"{label}:{self.shared.name}:{self._owner_label()}")

    def spawn_ro_buffer(self, kind: str) -> None:
        """§2.7: asynchronously snapshot-and-release a read-only object."""
        self.release_task = self._submit_task("ro-buffer", kind,
                                              self._ro_buffer_code)

    def spawn_lastwrite_apply(self, kind: str) -> None:
        """§2.8.4: asynchronously checkpoint, apply the write log, release."""
        self.release_task = self._submit_task("lw-apply", kind,
                                              self._lw_apply_code)

    def join_release_task(self) -> None:
        """Wait for the outstanding asynchronous buffer/apply task."""
        if self.release_task is not None:
            self.release_task.join()

    def open_access(self, kind: str, timeout: Optional[float]) -> bool:
        """Wait the access (or termination) gate, then checkpoint (§2.8.2).

        Returns True iff the caller actually blocked."""
        shared = self.shared
        h = shared.header
        if kind == "termination":
            blocked = h.wait_termination(self.pv, timeout=timeout)
        else:
            blocked = h.wait_access(self.pv, timeout=timeout)
        shared.check_reachable()
        with h.lock:
            inst = h.instance
        self.seen_instance = inst
        self.st = CopyBuffer(shared.holder.obj, inst, home_node=shared.node)
        self.holds_access = True
        shared.touch(self.txn)
        return blocked

    def open_and_call(self, kind: str, timeout: Optional[float], method: str,
                      args: tuple, kwargs: dict, *, modifies: bool,
                      validity: Optional[Callable[[], None]] = None):
        """First direct access of §2.8.2-3 fused: wait the gate, checkpoint,
        apply any buffered writes, execute the method. One operation at the
        home node — remote transports collapse it into a single RPC.
        ``validity`` (the transaction's cross-object §2.3 check) runs after
        the gate wait and before the call, preserving the in-process
        check-before-execute order; remote transports ignore it — their
        per-object check is enforced by the home node inside the RPC,
        exactly as on every other remote operation. Returns
        ``(blocked, value)``."""
        blocked = self.open_access(kind, timeout)
        self.apply_log()
        if validity is not None:
            validity()
        v = self.raw_call(method, args, kwargs, modifies=modifies)
        return blocked, v

    def raw_call(self, method: str, args: tuple, kwargs: dict, *,
                 modifies: bool) -> Any:
        """Execute a method against the live state at the home node."""
        if _txtrace.enabled:
            t0 = self._obs_tracer().now()
            v = self.shared.raw_call(method, args, kwargs,
                                     from_node=self.txn.client_node)
            self._obs_span("service", t0,
                           detail=f"{self.shared.name}.{method}")
        else:
            v = self.shared.raw_call(method, args, kwargs,
                                     from_node=self.txn.client_node)
        if modifies:
            self.modified = True
        return v

    def write_held(self, method: str, args: tuple, kwargs: dict) -> None:
        """§2.8.4 write while the object is held (preceding reads/updates
        passed the access condition). Pure writes are value-less in the
        paper's model, so transports may pipeline the call: the remote
        transport turns it into a one-way message (deferred errors) once
        the transaction has no reads left on the object."""
        self.raw_call(method, args, kwargs, modifies=True)

    # Operation fusion (``raw_call_batch``/``open_and_call_batch``) is a
    # remote-transport surface only: the fusion guard in Transaction.
    # _fusable_run never fuses accesses whose dispense_domain is None (a
    # per-op in-process call is already as cheap as a batched one), so no
    # base implementation exists — see RemoteObjectAccess.

    def buf_call(self, method: str, args: tuple, kwargs: dict) -> Any:
        """Execute a read against the post-release copy buffer (§2.7)."""
        return self.buf.call(method, args, kwargs)

    def record_write(self, method: str, args: tuple, kwargs: dict) -> None:
        """§2.8.4: log a pure write with no synchronization."""
        self.log.record(method, args, kwargs)

    def apply_log(self) -> None:
        """Replay the pending write log against the live state."""
        if len(self.log):
            self.log.apply_to(self.shared.holder.obj)
            self.modified = True

    def snapshot_buf(self) -> None:
        """Clone live state to ``buf`` for trailing local reads (§2.8.3-4)."""
        shared = self.shared
        with shared.header.lock:
            inst = shared.header.instance
        self.buf = CopyBuffer(shared.holder.obj, inst, home_node=shared.node)

    def snapshot_and_release(self) -> None:
        """§2.8.3-4 release point, fused: buffer for trailing local reads,
        then release. Remote transports turn this into one pipelined
        one-way message — the writer's hot path never waits for it."""
        self.snapshot_buf()
        self.release()

    def ensure_checkpoint(self) -> None:
        """Commit step 3: checkpoint an object never accessed directly."""
        if self.seen_instance is None:
            h = self.shared.header
            with h.lock:
                self.seen_instance = h.instance
            self.st = CopyBuffer(self.shared.holder.obj, self.seen_instance,
                                 home_node=self.shared.node)

    def release(self) -> None:
        if not self.released:
            self.shared.header.release_to(self.pv)
            self.released = True
            if _txtrace.enabled:
                self._obs_instant("release", detail=self.shared.name)

    def wait_termination(self, timeout: Optional[float]) -> bool:
        """Wait the commit condition (§2.8.5). True iff actually blocked."""
        return self.shared.header.wait_termination(self.pv, timeout=timeout)

    def valid(self) -> bool:
        """False iff the observed instance was invalidated (§2.3)."""
        with self.lock:
            seen = self.seen_instance
        return seen is None or self.shared.header.instance == seen

    def valid_commit(self) -> bool:
        """Commit-time validation (step 4 of §2.8.5). In-process this is
        the same check as :meth:`valid`; remote transports override it with
        an authoritative home-node query (per-op checks there are enforced
        server-side instead of client-side)."""
        return self.valid()

    def rollback(self) -> None:
        """Abort step 3: restore from the checkpoint, oldest-restore-wins
        (version-aware: see :meth:`VersionHeader.restore_allowed` — a
        younger transaction's restore must never suppress ours)."""
        h = self.shared.header
        with self.lock:
            seen, st, modified = self.seen_instance, self.st, self.modified
        if st is not None and modified:
            with h.lock:
                if h.restore_allowed(seen, self.pv):
                    st.restore_into(self.shared.holder)
                    h.note_restore(self.pv)
                    h.instance += 1

    def terminate(self) -> None:
        """Advance ltv past us and drop the failure-detector hold (§2.8.5-6)."""
        self.shared.header.terminate_to(self.pv)
        self.shared.clear_holder(self.txn)
        self.terminated = True
        if _txtrace.enabled:
            self._obs_instant("terminate", detail=self.shared.name)

    def prepare_start(self) -> None:
        """Transport hook, called before any version lock is acquired
        (remote transports register liveness here)."""

    def dispense_many(self, domains: List[List["ObjectAccess"]]) -> None:
        """Transport hook: lock-and-dispense for several remote dispense
        domains, already sorted in the global 2PL order. Every access
        class with a non-``None`` ``dispense_domain`` must override this;
        the TCP transport *chains* the request server-to-server (node k
        forwards to node k+1), so a multi-node start costs the client one
        round trip while gates are still acquired in global order and held
        until :meth:`release_version_locks` (2PL preserved)."""
        raise NotImplementedError(
            "remote dispense domains must implement dispense_many "
            "(§2.10.2 global-order lock-and-dispense)")

    def abandon(self) -> None:
        """Failed-start cleanup: skip this access's dispensed version *in
        chain order* (never bypassing a live predecessor's unreleased
        state) without touching object state — nothing was accessed yet."""
        skip_version(self.shared.header, self.pv)

    def valid_commit_batch(self, accs: List["ObjectAccess"]) -> bool:
        """Commit-time validation for all accesses of one dispense domain
        in one step (remote transports batch this into a single RPC)."""
        return all(a.valid_commit() for a in accs)

    # ------------------------------------------------------------------ #
    # Issue/await split: per-domain batched steps of commit and abort.   #
    # The in-process transport executes at issue time and returns        #
    # Completed; remote transports issue one pipelined RPC per node and  #
    # return a wire future, so the per-node round trips of one commit    #
    # step overlap (scatter-gather) instead of accumulating serially.    #
    # ------------------------------------------------------------------ #
    def commit_prep(self) -> None:
        """Commit step 3 for one access: checkpoint if never accessed,
        apply any left-over write log, release."""
        self.ensure_checkpoint()
        self.apply_log()
        self.release()

    def wait_termination_async(self, timeout: Optional[float]) -> Completed:
        """Issue the commit-condition wait (§2.8.5). ``result()`` returns
        True iff the waiter actually blocked."""
        return Completed(self.wait_termination(timeout))

    def wait_termination_batch_async(self, accs: List["ObjectAccess"],
                                     timeout: Optional[float],
                                     best_effort: bool = False) -> Completed:
        """Issue commit step 2 for all accesses of this dispense domain;
        ``result()`` is the number of waits that actually blocked. Remote
        transports run the whole batch in one RPC, and the batches of
        different home nodes wait concurrently. ``best_effort`` (the abort
        path) keeps waiting the remaining accesses when one times out."""
        blocked = 0
        for a in accs:
            try:
                if a.wait_termination(timeout):
                    blocked += 1
            except (TimeoutError, TransactionError):
                if not best_effort:
                    raise
        return Completed(blocked)

    def commit_wave1_async(self, accs: List["ObjectAccess"],
                           timeout: Optional[float]) -> Completed:
        """Commit steps 2-4 for this dispense domain, issued as one unit:
        wait the commit condition per object, then checkpoint/apply/release
        per object, then validate the batch. ``result()`` is ``(blocked,
        ok)`` — how many waits blocked, and the validation verdict. Remote
        transports run the whole wave in a single RPC per node, and the
        waves of different home nodes overlap; termination (step 5) stays a
        separate wave because no object may terminate-as-committed until
        *every* domain's validation verdict is in."""
        blocked = sum(1 for a in accs if a.wait_termination(timeout))
        for a in accs:
            a.commit_prep()
        return Completed((blocked, self.valid_commit_batch(accs)))

    def valid_commit_batch_async(self, accs: List["ObjectAccess"]) -> Completed:
        """Issue commit step 4 for this domain; ``result()`` is the verdict."""
        return Completed(self.valid_commit_batch(accs))

    def commit_solo_async(self, accs: List["ObjectAccess"],
                          timeout: Optional[float]) -> Completed:
        """Commit steps 2-5 when the whole access set lives in ONE dispense
        domain: the validation verdict is local to it, so termination can
        be decided in the same unit — one RPC for the entire commit on a
        remote transport. ``result()`` is ``(blocked, ok)``; on ``ok`` the
        accesses are already terminated, on failure nothing terminated."""
        blocked, ok = self.commit_wave1_async(accs, timeout).result()
        if ok:
            self.finish_batch_async(accs).result()
        return Completed((blocked, ok))

    def finish_batch_async(self, accs: List["ObjectAccess"],
                           best_effort: bool = False) -> Completed:
        """Issue release+terminate for this domain (commit step 5 / abort
        step 4). ``best_effort`` swallows per-access transactional errors —
        the abort path must keep going past dead home nodes."""
        for a in accs:
            try:
                a.release()
                a.terminate()
            except TransactionError:
                if not best_effort:
                    raise
        return Completed()

    def rollback_batch_async(self, accs: List["ObjectAccess"]) -> Completed:
        """Issue abort step 3 (checkpoint restores) for this domain;
        always best-effort (an unreachable home node restores via §3.4)."""
        for a in accs:
            try:
                a.rollback()
            except TransactionError:
                pass
        return Completed()

    def raise_deferred(self) -> None:
        """Sync point: surface deferred errors of this access's pipelined
        one-way operations (remote transports override; in-process
        operations are synchronous, so there is never anything deferred)."""

    def note_contact(self) -> None:
        """§3.4 heartbeat: an actual holder refreshes the failure detector."""
        if self.holds_access and not self.released:
            self.shared.touch(self.txn)
        elif self.released:
            self.shared.clear_holder(self.txn)

    def check_reachable(self) -> None:
        self.shared.check_reachable()

    def finish_session(self) -> None:
        """Transport hook: the transaction terminated on every object."""


class CommuteAccess(ObjectAccess):
    """In-process access restricted to one commuting method class
    (DESIGN.md §12).

    While the object's commute group is *active* (``cg_active``), this
    access holds the group's shared private version: its deltas live only
    in the log buffer until terminate, where they fold into live state
    under the per-class merge lock — no checkpoint, no early release, no
    version-gate wait. If the group could not be joined (another class
    active, snapped group, chain not quiescent) the access falls back to
    exact dispensing and behaves as a plain §2.8.4 log-write access.
    """

    __slots__ = ("cg_active", "_cg_done", "_cg_aborted")

    def __init__(self, txn: "Transaction", shared: SharedObject,
                 sup: Suprema):
        super().__init__(txn, shared, sup)
        self.cg_active = False
        self._cg_done = False
        self._cg_aborted = False

    @property
    def commute_cls(self) -> str:
        return self.sup.commutes

    def record_commute(self, method: str, args: tuple, kwargs: dict) -> None:
        """Buffer one commuting delta (applied at the fold, never before)."""
        self.log.record(method, args, kwargs)

    def join_group_locked(self) -> None:
        """Join (or form) the object's commute group — called by
        :func:`dispense_for` while the header lock is held, inside the 2PL
        window. Falls back to exact dispensing when joining is refused."""
        pv = self.shared.header.commute_join(self.commute_cls)
        if pv:
            self.pv = pv
            self.cg_active = True
        else:
            self.pv = self.shared.header.dispense()

    # While the group is active the access never touches live state before
    # the fold: no checkpoint to take, nothing to release or validate.
    def ensure_checkpoint(self) -> None:
        if not self.cg_active:
            super().ensure_checkpoint()

    def commit_prep(self) -> None:
        if not self.cg_active:
            super().commit_prep()

    def release(self) -> None:
        # An early lv advance would open exact successors' gates before
        # the group's folds finished — release rides the dissolve instead.
        if not self.cg_active:
            super().release()

    def wait_termination(self, timeout: Optional[float]) -> bool:
        if self.cg_active:
            return False   # ltv == cg_pv - 1 by construction: never blocks
        return super().wait_termination(timeout)

    def valid(self) -> bool:
        return True if self.cg_active else super().valid()

    def valid_commit(self) -> bool:
        return True if self.cg_active else super().valid_commit()

    def rollback(self) -> None:
        if not self.cg_active:
            super().rollback()
            return
        # Undelivered deltas are simply discarded: live state was never
        # touched, so there is no restore and no instance bump (§12 —
        # which is also why aborting a commute member dooms nobody).
        self._cg_aborted = True
        self.log.entries.clear()

    def terminate(self) -> None:
        if not self.cg_active:
            super().terminate()
            return
        if self._cg_done:
            return
        self._cg_done = True
        h = self.shared.header
        if not self._cg_aborted and len(self.log):
            with h.commute_merge_lock(self.commute_cls):
                self.log.apply_to(self.shared.holder.obj)
                self.modified = True
        else:
            self.log.entries.clear()
        self.shared.clear_holder(self.txn)
        self.terminated = True
        h.commute_leave()
        if _txtrace.enabled:
            self._obs_instant("terminate", detail=self.shared.name)

    def abandon(self) -> None:
        if not self.cg_active:
            super().abandon()
            return
        self.rollback()
        self.terminate()


def dispense_for(order: List[ObjectAccess]) -> None:
    """Atomically dispense private versions for a (possibly multi-transport)
    access set (paper §2.10.2).

    Version-lock *domains* are acquired in a globally consistent order: the
    in-process domain first (per-header locks in ``uid`` order), then each
    remote node in ``dispense_domain`` sort order, one batched
    lock-and-dispense RPC per node. All locks are held until every domain
    has dispensed — 2PL on version locks — which keeps private-version
    orders consistent across objects (no circular waits later), then
    released. Cost over the wire: one round-trip per *node* plus one
    release round-trip, not one per object.
    """
    local = [a for a in order if a.dispense_domain is None]
    remote: Dict[tuple, List[ObjectAccess]] = {}
    for a in order:
        if a.dispense_domain is not None:
            remote.setdefault(a.dispense_domain, []).append(a)

    # Commute-only fast path (DESIGN.md §12): a transaction touching ONE
    # object on ONE remote domain through a commute-declared access needs
    # no start-time coordination at all — the dispense RPC is skipped and
    # the home node lazily joins the commute group at the first delta (or
    # at commit). If the server must fall back to exact dispensing there,
    # the late join is equivalent to a late start on a single node. The
    # single-OBJECT bound is load-bearing: a transaction that late-joins
    # two objects acquires their versions non-atomically, so its order
    # against a concurrent start-time-dispensed transaction can invert
    # between the objects — a circular wait 2PL start-time dispensing
    # exists to rule out (found by the commute seed sweep). Multi-object
    # commute transactions dispense at start like everyone else; their
    # group joins happen inside the 2PL window (dispense_batch's commute
    # map / join_group_locked below), which keeps cross-object order
    # consistent while still merging their deltas.
    if not local and len(remote) == 1:
        (accs,) = remote.values()
        if len(accs) == 1 and all(
                getattr(a, "can_defer_start", False) for a in accs):
            accs[0].prepare_start()
            for a in accs:
                a.defer_start()
            return

    # Liveness registration first, before any version lock is held —
    # presence setup may block in a TCP connect.
    for accs in remote.values():
        accs[0].prepare_start()

    locked_local = sorted({a.shared.header for a in local},
                          key=lambda h: h.uid)
    for h in locked_local:
        h.lock.acquire()
    remote_domains = [remote[d] for d in sorted(remote)]
    dispensed_remote = False
    try:
        if remote_domains:
            # One chained lock-and-dispense over all remote domains in
            # global order; every domain's gates stay held (2PL).
            remote_domains[0][0].dispense_many(remote_domains)
            dispensed_remote = True
        for a in local:
            join = getattr(a, "join_group_locked", None)
            if join is not None:
                join()       # commute group join, exact fallback inside
            else:
                a.pv = a.shared.header.dispense()
    finally:
        for h in reversed(locked_local):
            h.lock.release()
        if dispensed_remote:
            for accs in remote_domains:
                try:
                    accs[0].release_version_locks()
                except TransactionError:
                    pass   # that node died; its reaper frees the gates


class TxProxy:
    """Client-side stub: forwards method calls through the transaction.

    The Atomic RMI 2 proxy object injects OptSVA-CF concurrency control
    around each method invocation (paper §3.1); here the injection point is
    ``Transaction._invoke``.
    """

    __slots__ = ("_txn", "_shared")

    def __init__(self, txn: "Transaction", shared: SharedObject):
        object.__setattr__(self, "_txn", txn)
        object.__setattr__(self, "_shared", shared)

    def __getattr__(self, method: str) -> Callable[..., Any]:
        txn: Transaction = object.__getattribute__(self, "_txn")
        shared: SharedObject = object.__getattribute__(self, "_shared")

        def call(*args: Any, **kwargs: Any) -> Any:
            return txn._invoke(shared, method, args, kwargs)

        call.__name__ = method
        return call

    def __repr__(self) -> str:  # pragma: no cover
        shared = object.__getattribute__(self, "_shared")
        return f"TxProxy({shared.name})"


class Transaction:
    """An OptSVA-CF transaction (Fig. 8 API)."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 irrevocable: bool = False,
                 client_node: Optional[Node] = None,
                 wait_timeout: Optional[float] = None):
        self.id = next(_txn_ids)
        #: retry incarnation counter: remote transports key their sessions
        #: and task/deferred-error bookkeeping on (id, incarnation), so a
        #: late pipelined notification from a rolled-back incarnation can
        #: never pollute its successor.
        self.incarnation = 0
        self.registry = registry
        self.irrevocable = irrevocable
        self.client_node = client_node
        self.wait_timeout = wait_timeout
        self.stats = OpStats()
        self._accesses: Dict[SharedObject, ObjectAccess] = {}
        self._order: List[ObjectAccess] = []
        self._started = False
        self._terminated = False
        self._doomed = False
        self._obs_t0 = 0.0   # client-window start (txtrace; set in begin())

    # -- observability (client-side spans; gate on ``txtrace.enabled``) ------
    def _obs_uid(self) -> str:
        return (f"#{self.id}r{self.incarnation}" if self.incarnation
                else f"#{self.id}")

    def _obs_span(self, kind: str, t0: float, **kw: Any) -> None:
        tr = _txtrace.current()
        tr.emit(kind, t0, tr.now() - t0, txn=self._obs_uid(),
                inc=self.incarnation, **kw)

    def _obs_instant(self, kind: str, **kw: Any) -> None:
        tr = _txtrace.current()
        tr.emit(kind, tr.now(), 0.0, txn=self._obs_uid(),
                inc=self.incarnation, **kw)

    # ------------------------------------------------------------------ #
    # Preamble (Fig. 8): declaring the access set with suprema.          #
    # ------------------------------------------------------------------ #
    def _declare(self, obj: Union[SharedObject, str], sup: Suprema) -> TxProxy:
        if self._started:
            raise IllegalState("access set must be declared before start()")
        shared = self._resolve(obj)
        sup.validate()
        if shared in self._accesses:
            raise IllegalState(f"object {shared.name!r} already declared")
        acc = shared.make_access(self, sup)
        self._accesses[shared] = acc
        self._order.append(acc)
        return TxProxy(self, shared)

    def _resolve(self, obj: Union[SharedObject, str]) -> SharedObject:
        if not isinstance(obj, str):
            return obj   # any shared-object duck type (in-proc or remote)
        if self.registry is None:
            raise IllegalState("string lookup requires a registry")
        return self.registry.locate(obj)

    def reads(self, obj: Union[SharedObject, str], max_reads: float = INF) -> TxProxy:
        return self._declare(obj, Suprema(reads=max_reads, writes=0, updates=0))

    def writes(self, obj: Union[SharedObject, str], max_writes: float = INF) -> TxProxy:
        return self._declare(obj, Suprema(reads=0, writes=max_writes, updates=0))

    def updates(self, obj: Union[SharedObject, str], max_updates: float = INF) -> TxProxy:
        return self._declare(obj, Suprema(reads=0, writes=0, updates=max_updates))

    def accesses(self, obj: Union[SharedObject, str], max_reads: float = INF,
                 max_writes: float = INF, max_updates: float = INF) -> TxProxy:
        return self._declare(obj, Suprema(max_reads, max_writes, max_updates))

    def commutes(self, obj: Union[SharedObject, str], max_ops: float = INF,
                 cls: Optional[str] = None) -> TxProxy:
        """Declare a *commute-restricted* access (DESIGN.md §12): the
        transaction promises to touch ``obj`` only through methods of the
        commuting class ``cls`` (inferred when the object declares exactly
        one). Such invocations skip version-gated dispensing and merge as
        deltas at the home node."""
        shared = self._resolve(obj)
        if cls is None:
            classes = sorted(set(self._commute_classes(shared).values()))
            if len(classes) != 1:
                raise IllegalState(
                    f"object {shared.name!r} declares {len(classes)} commute "
                    f"classes; pass cls= explicitly")
            cls = classes[0]
        return self._declare(
            shared, Suprema(reads=0, writes=max_ops, updates=0, commutes=cls))

    @staticmethod
    def _commute_classes(shared: SharedObject) -> Dict[str, str]:
        fn = getattr(shared, "commute_classes", None)
        return fn() if fn is not None else {}

    # ------------------------------------------------------------------ #
    # Start (§2.8.1)                                                     #
    # ------------------------------------------------------------------ #
    def begin(self) -> None:
        """Acquire private versions atomically; kick off read-only buffering."""
        if self._started:
            raise IllegalState("transaction already started")
        self._started = True
        self._terminated = False
        # Failover hook (before any version lock): transports with replica
        # chains re-point each access at a promoted follower when its
        # primary died — so dispense domains below are computed against
        # live nodes. In-process shared objects have no such hook.
        for a in self._order:
            ensure = getattr(a.shared, "ensure_primary", None)
            if ensure is not None:
                ensure()
        if _txtrace.enabled:
            self._obs_t0 = _txtrace.current().now()
        try:
            if _txtrace.enabled:
                t0 = _txtrace.current().now()
                dispense_for(self._order)
                self._obs_span("dispense", t0,
                               detail=f"objs={len(self._order)}")
            else:
                dispense_for(self._order)
        except BaseException:
            # Partial start (a remote node died mid-dispense): abandon the
            # versions that were dispensed — skipped in chain order so
            # successors on the surviving nodes unwedge without bypassing
            # live predecessors — and close the transaction.
            for a in self._order:
                if a.pv:
                    try:
                        a.abandon()
                    except TransactionError:
                        pass   # that node is gone; §3.4 cleans up there
            for a in self._order:
                a.finish_session()
            self._terminated = True
            if _txtrace.enabled:
                self._obs_span("txn", self._obs_t0, detail="abort",
                               sev=_txtrace.WARN)
            raise
        # §2.7/§2.8.1: asynchronously snapshot-and-release read-only
        # objects. Remote transports already fired these kickoffs inside
        # the dispense round trip (release_task set); only the in-process
        # domain still needs its tasks spawned here.
        for a in self._order:
            if (a.sup.read_only and a.sup.reads > 0
                    and a.release_task is None):
                a.spawn_ro_buffer(self._gate_kind)

    @property
    def _gate_kind(self) -> str:
        """Access gate — or termination gate for irrevocable txns (§2.4)."""
        return "termination" if self.irrevocable else "access"

    # ------------------------------------------------------------------ #
    # Operation dispatch                                                  #
    # ------------------------------------------------------------------ #
    def _invoke(self, shared: SharedObject, method: str, args: tuple,
                kwargs: dict) -> Any:
        if self._terminated:
            raise IllegalState("transaction already terminated")
        if not self._started:
            raise IllegalState("transaction not started; call begin()/start()")
        shared.check_reachable()
        a = self._accesses[shared]
        if a.sup.commutes is not None:
            return self._commute(a, shared, method, args, kwargs)
        mode = shared.mode_of(method)
        self._check_supremum(a, mode)
        try:
            if mode is Mode.READ:
                v = self._read(a, method, args, kwargs)
                self.stats.reads += 1
            elif mode is Mode.WRITE:
                v = self._write(a, method, args, kwargs)
                self.stats.writes += 1
            else:
                v = self._update(a, method, args, kwargs)
                self.stats.updates += 1
        except InstanceInvalidated as e:
            # Remote transport: the home node detected the invalidation
            # (in-process, _validity_check raises before the operation).
            self._force_abort(str(e))
        # heartbeat: only an actual holder (past the access condition and
        # not yet released) counts for the §3.4 failure detector
        a.note_contact()
        return v

    # -- commute-restricted invocation (DESIGN.md §12) -----------------------
    def _commute(self, a: ObjectAccess, shared: SharedObject, method: str,
                 args: tuple, kwargs: dict) -> None:
        """Buffer one commuting delta. Commute methods are write-only by
        declaration (`@access(Mode.WRITE, commutes=...)`), so the value is
        always ``None``; only methods of the DECLARED class are legal —
        anything else would break the no-coordination promise."""
        ccls = getattr(shared, "commute_of", lambda m: None)(method)
        if ccls != a.sup.commutes:
            raise IllegalState(
                f"method {shared.name}.{method} is not in this access's "
                f"declared commute class {a.sup.commutes!r} (got {ccls!r})")
        self._check_supremum(a, Mode.WRITE)
        a.record_commute(method, args, kwargs)
        a.wc += 1
        self.stats.writes += 1
        a.note_contact()
        return None

    def _check_supremum(self, a: ObjectAccess, mode: Mode) -> None:
        if a.count_for(mode) + 1 > a.sup_for(mode):
            self._force_abort(
                f"supremum violation: {mode.value} #{a.count_for(mode) + 1} on "
                f"{a.shared.name!r} exceeds bound {a.sup_for(mode)}",
                exc=SupremumViolation)

    # -- read (§2.8.2) -------------------------------------------------------
    def _read(self, a: ObjectAccess, method: str, args: tuple, kwargs: dict) -> Any:
        if a.sup.read_only or a.release_task is not None:
            # Read-only buffering, or released asynchronously after last
            # write: wait the task, read from the home-node buffer.
            a.join_release_task()
            self._validity_check()
            a.rc += 1
            return a.buf_call(method, args, kwargs)
        if a.released and a.buf is not None:
            # Released synchronously after last write/update.
            self._validity_check()
            a.rc += 1
            return a.buf_call(method, args, kwargs)
        if not a.holds_access:
            # First direct access: gate wait + checkpoint + log apply +
            # the read itself, fused into one home-node operation.
            blocked, v = a.open_and_call(self._gate_kind, self.wait_timeout,
                                         method, args, kwargs, modifies=False,
                                         validity=self._validity_check)
            if blocked:
                self.stats.waits += 1
        else:
            self._validity_check()
            v = a.raw_call(method, args, kwargs, modifies=False)
        a.rc += 1
        if a.all_suprema_met():   # last operation of any kind: release (§2.8.2)
            a.release()
        return v

    # -- update (§2.8.3) -----------------------------------------------------
    def _update(self, a: ObjectAccess, method: str, args: tuple, kwargs: dict) -> Any:
        if not a.holds_access:
            blocked, v = a.open_and_call(self._gate_kind, self.wait_timeout,
                                         method, args, kwargs, modifies=True,
                                         validity=self._validity_check)
            if blocked:
                self.stats.waits += 1
        else:
            self._validity_check()
            v = a.raw_call(method, args, kwargs, modifies=True)
        a.uc += 1
        if a.writes_updates_done():
            # No further writes/updates: buffer for trailing local reads, release.
            a.snapshot_and_release()
        return v

    # -- write (§2.8.4) ------------------------------------------------------
    def _write(self, a: ObjectAccess, method: str, args: tuple, kwargs: dict) -> Any:
        if a.holds_access:
            # Preceding reads/updates hold the object: operate directly.
            # Pure writes are value-less (the log-buffered path below always
            # returned None), so this path returns None too — which lets the
            # remote transport pipeline trailing writes as one-ways.
            self._validity_check()
            a.write_held(method, args, kwargs)
            a.wc += 1
            if a.writes_updates_done():
                # Paper §2.8.4 says "cloned to st"; that must be buf (see module doc).
                a.snapshot_and_release()
            return None
        # No preceding reads/updates: log-buffer the write, no synchronization.
        a.record_write(method, args, kwargs)
        a.wc += 1
        if a.wc == a.sup.writes and a.sup.updates == 0:
            # Final write (and no updates will follow): asynchronous apply+release.
            a.spawn_lastwrite_apply(self._gate_kind)
        return None

    # -- operation fusion (§2.8 / DESIGN.md §3.1 v3) -------------------------
    def invoke_many(self, proxy: Union[TxProxy, SharedObject, str],
                    ops: List[tuple]) -> List[Any]:
        """Invoke a run of operations against ONE object with *exactly*
        sequential semantics — as if each had been called through the proxy
        in order — fusing consecutive plain direct calls on a held remote
        object into single ``txn_call_batch`` RPCs (operation fusion).

        ``ops`` is ``[(method, args, kwargs), ...]``. The a-priori
        operation plan of the CF model is what makes runs visible before
        execution; anything the fusion rules cannot prove safe (opens,
        buffered reads, release transitions mid-run, in-process objects)
        falls back to the per-operation path, so behavior — including
        supremum aborts, early release points, and mid-run errors (prefix
        applied, suffix not) — is identical either way.
        """
        if isinstance(proxy, TxProxy):
            shared = object.__getattribute__(proxy, "_shared")
        else:
            shared = self._resolve(proxy)
        if self._terminated:
            raise IllegalState("transaction already terminated")
        if not self._started:
            raise IllegalState("transaction not started; call begin()/start()")
        out: List[Any] = []
        i = 0
        while i < len(ops):
            run, opening = self._fusable_run(shared, ops, i)
            if run <= 1:
                method, args, kwargs = ops[i]
                out.append(self._invoke(shared, method, args, kwargs))
                i += 1
            else:
                out.extend(self._invoke_fused(shared, ops[i:i + run],
                                              opening))
                i += run
        return out

    def _fusable_run(self, shared: SharedObject, ops: List[tuple],
                     i: int) -> tuple:
        """``(n, opening)``: length of the maximal fusable run of ``ops``
        starting at ``i``, and whether it begins with the §2.8.2-3 open
        (gate wait + checkpoint fused in — a read-modify-write hop on a
        fresh object is one RPC). A run is plain direct calls against one
        remote object, stopping *before* a supremum violation (the per-op
        path raises it with sequential semantics) and *after* the first op
        whose §2.8.2-4 post-transition fires (release at suprema /
        snapshot-and-release after the last write or update). Returns
        ``(1, False)`` whenever fusing cannot beat the per-op path: an
        in-process object, a released access or pending release task
        (buffered reads are already local), a leading read served by a
        local held-state copy (0 RPCs), or a leading log-buffered write
        (recorded client-side for free, §2.8.4)."""
        a = self._accesses[shared]
        if (a.dispense_domain is None or a.released
                or a.release_task is not None or a.sup.read_only
                or a.sup.commutes is not None):
            return 1, False   # commute deltas are client-side-free already
        opening = not a.holds_access
        first_mode = shared.mode_of(ops[i][0])
        if opening and first_mode is Mode.WRITE:
            return 1, False     # log-buffered write: free, no RPC to fuse
        if (not opening and first_mode is Mode.READ
                and getattr(a, "live_copy", None) is not None):
            return 1, False     # local (0-RPC) read: the per-op path is free
        rc, wc, uc = a.rc, a.wc, a.uc
        n = 0
        for method, _args, _kwargs in ops[i:]:
            mode = shared.mode_of(method)
            if mode is Mode.READ:
                if rc + 1 > a.sup.reads:
                    break
                rc += 1
            elif mode is Mode.WRITE:
                if wc + 1 > a.sup.writes:
                    break
                wc += 1
            else:
                if uc + 1 > a.sup.updates:
                    break
                uc += 1
            n += 1
            if (rc == a.sup.reads and wc == a.sup.writes
                    and uc == a.sup.updates):
                break       # all suprema met: release fires after this op
            if (mode is not Mode.READ and wc == a.sup.writes
                    and uc == a.sup.updates):
                break       # last write/update: snapshot+release fires
        return n, opening

    def _invoke_fused(self, shared: SharedObject, run_ops: List[tuple],
                      opening: bool) -> List[Any]:
        """Execute one fusable run as a single batched home-node operation
        (``opening`` folds the §2.8.2-3 gate wait + checkpoint in), then
        apply the sequential §2.8.2-4 bookkeeping: per-op counters and
        stats for the applied prefix, the original exception of a mid-run
        failure (suffix not executed), and the end-of-run release
        transition of the last op's mode."""
        a = self._accesses[shared]
        shared.check_reachable()
        modes = [shared.mode_of(m) for m, _a, _k in run_ops]
        calls = [(m, args, kwargs, mode is not Mode.READ)
                 for (m, args, kwargs), mode in zip(run_ops, modes)]
        self._validity_check()
        try:
            if opening:
                blocked, values, error = a.open_and_call_batch(
                    self._gate_kind, self.wait_timeout, calls)
                if blocked:
                    self.stats.waits += 1
            else:
                values, error = a.raw_call_batch(
                    calls, all_writes=all(m is Mode.WRITE for m in modes))
        except InstanceInvalidated as e:
            self._force_abort(str(e))
        last_mode = None
        for mode in modes[:len(values)]:
            if mode is Mode.READ:
                a.rc += 1
                self.stats.reads += 1
            elif mode is Mode.WRITE:
                a.wc += 1
                self.stats.writes += 1
            else:
                a.uc += 1
                self.stats.updates += 1
            last_mode = mode
        if error is not None:
            if isinstance(error, InstanceInvalidated):
                self._force_abort(str(error))
            raise error
        if last_mode is Mode.READ:
            if a.all_suprema_met():
                a.release()
        elif a.writes_updates_done():
            a.snapshot_and_release()
        a.note_contact()
        # Pure writes are value-less (see _write): mask their positions.
        return [None if mode is Mode.WRITE else v
                for v, mode in zip(values, modes)]

    # -- shared helpers --------------------------------------------------------
    def _validity_check(self) -> None:
        """Force an abort as soon as any observed instance was invalidated (§2.3)."""
        for a in self._order:
            if not a.valid():
                self._force_abort(
                    f"object {a.shared.name!r} was invalidated by a cascading abort")

    def _force_abort(self, msg: str, exc: type = AbortError) -> None:
        self._do_abort()
        self.stats.aborts += 1
        err = exc(msg) if exc is SupremumViolation else exc(msg, forced=True)
        raise err

    # ------------------------------------------------------------------ #
    # Commit (§2.8.5)                                                    #
    # ------------------------------------------------------------------ #
    def commit(self) -> None:
        if not _txtrace.enabled:
            self._commit_impl()
            return
        t0 = _txtrace.current().now()
        try:
            self._commit_impl()
        except BaseException:
            self._obs_span("commit", t0, detail="abort", sev=_txtrace.WARN)
            raise
        self._obs_span("commit", t0, detail="ok")
        self._obs_span("txn", self._obs_t0, detail="commit")

    def _commit_impl(self) -> None:
        if self._terminated:
            raise IllegalState("transaction already terminated")
        if not self._started:
            raise IllegalState("transaction not started")
        # 1. Wait for extant asynchronous tasks.
        task_error: Optional[BaseException] = None
        for a in self._order:
            try:
                a.join_release_task()
            except TransactionError as e:
                task_error = e
        if task_error is not None:
            self._do_abort()
            self.stats.aborts += 1
            raise AbortError(f"asynchronous task failed: {task_error}", forced=True)
        groups = self._domain_groups()
        try:
            if len(groups) == 1:
                # Single dispense domain: steps 2-5 are one unit (one RPC
                # on a remote transport) — the validation verdict needs no
                # cross-domain gather before termination.
                (accs,) = groups.values()
                blocked, ok = accs[0].commit_solo_async(
                    accs, self.wait_timeout).result()
                self.stats.waits += blocked
            else:
                remote = sorted(
                    ((dom, accs) for dom, accs in groups.items()
                     if dom is not None), key=lambda kv: kv[0])
                domains = [accs for _dom, accs in remote]
                local = groups.get(None)
                chain_fn = (getattr(domains[0][0], "commit_chain_async",
                                    None) if domains else None)
                if chain_fn is not None:
                    # Chained commit decision (DESIGN.md §8): validate the
                    # in-process group first (steps 2-4, zero messages),
                    # then hand the WHOLE remote commit — waves, decision,
                    # termination — to the first remote node in global
                    # domain order as ONE RPC. The commit/abort decision is
                    # made server-side: a client crash after that send can
                    # no longer strand a partially terminated commit (the
                    # §3.4 step-5 window, CLOSED).
                    ok = True
                    if local is not None:
                        blocked, ok = local[0].commit_wave1_async(
                            local, self.wait_timeout).result()
                        self.stats.waits += blocked
                    if ok:
                        if len(domains) == 1:
                            # One remote domain left: its verdict is local
                            # to it — steps 2-5 in one solo RPC.
                            blocked, ok = domains[0][0].commit_solo_async(
                                domains[0], self.wait_timeout).result()
                        else:
                            blocked, ok = chain_fn(
                                domains, self.wait_timeout).result()
                        self.stats.waits += blocked
                else:
                    # 2-4. One scatter-gathered wave per dispense domain:
                    # wait the commit condition, checkpoint untouched
                    # objects / apply left-over logs / release, validate —
                    # a single RPC per remote node, all nodes proceeding
                    # concurrently. (Releasing one node's objects before
                    # another node's commit condition passed is safe: step
                    # 3 released before step 4 validated already, and a
                    # later abort restores + bumps epochs exactly as
                    # before.)
                    wave1 = [accs[0].commit_wave1_async(accs,
                                                        self.wait_timeout)
                             for accs in groups.values()]
                    ok = True
                    for f in wave1:
                        blocked, valid = f.result()
                        self.stats.waits += blocked
                        ok = ok and valid
            if not ok:
                self._do_abort()
                self.stats.aborts += 1
                raise AbortError(
                    "commit-time validation failed (cascading abort)",
                    forced=True)
            if len(groups) > 1:
                # 5. Terminate: advance ltv on every object — only after
                # every domain's validation verdict is in. Domains the
                # chained decision already terminated server-side are
                # skipped (their accesses are marked); in practice that
                # leaves the in-process group, finished here at zero
                # message cost.
                ffuts = [accs[0].finish_batch_async(accs)
                         for accs in groups.values()
                         if not all(a.terminated for a in accs)]
                for f in ffuts:
                    f.result()
            # Final sync point: any deferred error of a pipelined one-way
            # op (early release notifications etc.) surfaces before the
            # commit is reported successful.
            for accs in groups.values():
                accs[0].raise_deferred()
        except TimeoutError as e:
            # A predecessor never terminated (e.g. crashed with no monitor):
            # leaving our objects unreleased would wedge every successor, so
            # route through the abort path like _do_abort does.
            self._do_abort()
            self.stats.aborts += 1
            raise AbortError(f"commit condition timed out: {e}",
                             forced=True) from e
        except InstanceInvalidated as e:
            self._force_abort(str(e))
        except AbortError:
            raise               # rollback already performed above
        except TransactionError:
            # A home node died mid-commit (RemoteObjectFailure etc.): roll
            # back the surviving objects before surfacing it — leaving them
            # unreleased would wedge every successor (§3.4).
            self._do_abort()
            self.stats.aborts += 1
            raise
        for a in self._order:
            a.finish_session()
        self._terminated = True

    # ------------------------------------------------------------------ #
    # Abort (§2.8.6) and retry                                            #
    # ------------------------------------------------------------------ #
    def abort(self) -> None:
        """Manual abort (Fig. 9). Raises AbortError to unwind the atomic block."""
        self._do_abort()
        self.stats.aborts += 1
        raise AbortError("transaction aborted manually", forced=False)

    def retry(self) -> None:
        """Manual retry: abort, then signal ``start`` to re-run the block."""
        self._do_abort()
        self.stats.retries += 1
        raise RetrySignal("transaction retry requested")

    def _domain_groups(self) -> Dict[Optional[tuple], List[ObjectAccess]]:
        """Accesses grouped by dispense domain (one group per remote node,
        plus the in-process group), remote domains first: issuing a wave
        over the groups in this order sends every remote (non-blocking)
        RPC before the in-process group's Completed executes-at-issue —
        otherwise a mixed-transport commit would serialize the local wait
        in front of the remote ones instead of overlapping them."""
        groups: Dict[Optional[tuple], List[ObjectAccess]] = {}
        for a in self._order:
            groups.setdefault(a.dispense_domain, []).append(a)
        if None in groups:
            groups[None] = groups.pop(None)   # move in-process group last
        return groups

    def _do_abort(self) -> None:
        if self._terminated:
            return
        # 1. Wait for extant tasks (they may still be mutating state).
        for a in self._order:
            try:
                a.join_release_task()
            except TransactionError:
                pass
        # 2. Wait for the commit condition per object (issued per dispense
        # domain, then awaited — remote waits overlap across nodes).
        waits = []
        for accs in self._domain_groups().values():
            try:
                waits.append(accs[0].wait_termination_batch_async(
                    accs, self.wait_timeout, best_effort=True))
            except (TimeoutError, TransactionError):
                pass  # predecessor crashed, or our home node/session is gone
        for w in waits:
            try:
                w.result()
            except (TimeoutError, TransactionError):
                pass  # (§3.4) — either way the monitor machinery cleans up
        # 3. Restore modified objects from their checkpoints,
        # oldest-restore-wins; per-node batches in one concurrent wave.
        # Already-terminated accesses are skipped (partial commit step 5
        # before a later object's node died): a successor may have
        # committed on the object since — restoring would erase its writes.
        groups = {dom: [a for a in accs if not a.terminated]
                  for dom, accs in self._domain_groups().items()}
        rfuts = []
        for accs in groups.values():
            if not accs:
                continue
            try:
                rfuts.append(accs[0].rollback_batch_async(accs))
            except TransactionError:
                pass  # home node unreachable/expired: its monitor restores
        for f in rfuts:
            try:
                f.result()
            except TransactionError:
                pass
        # 4. Release and terminate every object (best-effort per node).
        ffuts = []
        for accs in groups.values():
            if not accs:
                continue
            try:
                ffuts.append(accs[0].finish_batch_async(accs,
                                                        best_effort=True))
            except TransactionError:
                pass  # home node unreachable/expired: self-releases there
        for f in ffuts:
            try:
                f.result()
            except TransactionError:
                pass
        for a in self._order:
            a.finish_session()
        self._terminated = True
        if _txtrace.enabled:
            self._obs_instant("abort", sev=_txtrace.WARN)
            self._obs_span("txn", self._obs_t0, detail="abort",
                           sev=_txtrace.WARN)

    # ------------------------------------------------------------------ #
    # start(): run an atomic block with commit/abort/retry handling       #
    # ------------------------------------------------------------------ #
    def start(self, body: Callable[["Transaction"], Any], *,
              max_retries: int = 64) -> Any:
        """Run ``body(self)``; commit on fall-through (Fig. 9 semantics).

        ``retry()`` re-runs the block under a fresh transaction incarnation
        (new private versions, same declared access set). Manual and forced
        aborts propagate as :class:`AbortError` after rollback completes.
        """
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
                raise  # rollback already performed by abort()/_force_abort
            except BaseException:
                # Any exception escaping the block — including remote-object
                # failures (§3.4) — aborts the transaction (§3.2).
                if not self._terminated:
                    self._do_abort()
                    self.stats.aborts += 1
                raise
            if not self._terminated:
                self.commit()
            return result

    def _reincarnate(self) -> None:
        """Rebuild per-object records for a retry: fresh versions, same set."""
        fresh: List[ObjectAccess] = []
        mapping: Dict[SharedObject, ObjectAccess] = {}
        for a in self._order:
            na = a.shared.make_access(self, a.sup)
            fresh.append(na)
            mapping[a.shared] = na
        self._order = fresh
        self._accesses = mapping
        self.incarnation += 1
        self._started = False
        self._terminated = False
        self.begin()

    # -- context-manager sugar -------------------------------------------------
    def __enter__(self) -> "Transaction":
        if not self._started:
            self.begin()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            if not self._terminated:
                self.commit()
            return False
        if not self._terminated and not isinstance(exc, TransactionError):
            self._do_abort()
            self.stats.aborts += 1
        return False
