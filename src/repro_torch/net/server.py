"""The node server process (DESIGN.md §3.1).

Hosts a :class:`~repro.core.registry.Registry` with one
:class:`~repro.core.registry.Node` — the real OS-process realization of the
paper's remote host: the ``SharedObject``s, their ``VersionHeader``s, the
per-node :class:`~repro.core.executor.Executor`, and the §3.4
:class:`~repro.core.faults.TransactionMonitor` all live here.

**Delegation boundary.** For every client transaction the server keeps a
*session* holding the home-node halves of the client's ``ObjectAccess``
records. Those halves *are* ``ObjectAccess`` subclasses
(:class:`_ServerAccess`): checkpointing, buffering, log application
(through :class:`~repro.core.buffers.LogBuffer`), release, rollback, and
termination run the same base methods the in-process transport runs —
the wire handlers only marshal arguments. The §2.7/§2.8.4 task bodies are
overridden to add the §3.4 expiry checks a multi-process world needs, but
delegate the actual log replay to ``LogBuffer.apply_to``.

**Multiplexed connections.** One framed socket per client process carries
tagged requests, one-way messages, replies, and server pushes
(``wire.py``). The per-connection reader handles quick operations inline
and hands potentially-blocking ones (gate waits, dispensing, task joins,
service-time-bearing method calls) to a thread each, so a parked RPC never
stalls the link — replies complete out of order, matched by request id.
One-way messages are always processed inline, which gives them FIFO
ordering relative to later requests on the same connection (a pipelined
kickoff is guaranteed to be registered before the join that follows it,
and a deferred-ack trailing write is guaranteed to be applied before any
later synchronous operation observes the object); their failures are
pushed back as ``oneway_err`` notes (error deferral). Operation fusion
(DESIGN.md §3.1 v3) executes client-visible *runs* server-side:
``txn_call_batch`` (and the ``tail=`` batch of ``open_call``) runs a
FIFO-atomic call sequence against one held access with an error-index
reply — prefix applied, suffix never executed.
When a §2.7/§2.8.4 task completes, a ``task_done`` note — carrying the
read buffer's state when small (piggyback read protocol) — is pushed on
the owning client's connection(s).

**Version-lock service.** ``dispense_batch`` implements the server side of
start-time global-order version acquisition (§2.10.2): it acquires this
node's per-object dispensing gates in header-uid order, dispenses private
versions for the whole per-node batch, and *holds* the gates until the
client's ``release_version_locks`` (2PL on version locks across nodes —
one round-trip per node, not per object). Gates are plain ``Lock``s, not
the header ``RLock``s, because they must be releasable from a different
connection thread; dispensing itself still happens under the header lock.

**Failure detection (§3.4).** Sessions are refreshed by client heartbeats
(one-way messages riding the mux link); a client process that dies stops
heartbeating (session reaper, detector timeout) and — faster — its mux
connection drops (immediate: the connection doubles as the presence
signal). Either way ``_expire_session`` performs the paper's self-rollback
for everything the session dispensed on: restore the checkpoint where
state was modified (oldest-restore-wins on the instance epoch), bump the
epoch so readers of the dead transaction's state cascade-abort, and
advance ``lv``/``ltv`` past its private version so survivors' chains
unwedge, then commit. Dead clients' held version-lock gates are
force-released the same way. The object-level :class:`TransactionMonitor`
still runs for in-process users of an embedded server's registry.

Run standalone::

    python -m repro.net.server --name node0 --port 0 --announce

which prints ``LISTENING host:port`` on stdout for the parent to parse
(:mod:`repro.net.spawn` automates this).
"""
from __future__ import annotations

import argparse
import logging
import os
import pickle
import queue
import socket
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.api import (INF, InstanceInvalidated, Mode,
                            RemoteObjectFailure, Suprema,
                            TransactionError, commute_classes, method_mode)
from repro_torch.core.buffers import CopyBuffer
from repro_torch.core.executor import Task, defer_wake_inline
from repro_torch.core.faults import TransactionMonitor
from repro_torch.core.registry import Registry, SharedObject
from repro_torch.core.transaction import ObjectAccess
from repro_torch.core.versioning import blocking_wait, skip_version, wait_quiescent

from repro_torch.obs import metrics as _metrics
from repro_torch.obs import txtrace as _txtrace

from .leases import LeaseManager, LeaseRearming, ObjectMovedError
from .replication import ReplicaRecord, ReplicationManager
from .wal import FileStorage, Wal, fold_payload
from .wire import (ConnectionClosed, ERR, FrameReader, NOTE, OK,
                   PIGGYBACK_MAX, WireError, encode_error,
                   frame as wire_frame, oob, send_frames, send_msg)

log = logging.getLogger("repro_torch.net.server")

_SERVER_SUP = Suprema(reads=INF, writes=INF, updates=INF)

#: Auto-migration trigger (§10): a remote affinity group must cast at
#: least this many votes on an object AND lead every other group 2:1
#: before a lease handoff is queued — hysteresis against ping-ponging a
#: hot object between two balanced accessors.
MIGRATE_THRESHOLD = 8


class _WouldBlock(Exception):
    """A non-blocking fast-path attempt hit contention: redo on the pool."""


class _Conn:
    """Per-connection send state: one lock serializes the socket's write
    side across worker threads, pushes, and reply piggybacks.
    ``pending_out`` holds the unsent tail of a partially written push
    frame — it MUST go out before any other frame on this socket."""

    __slots__ = ("sock", "send_lock", "notes", "pending_out", "client_id")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.send_lock = threading.Lock()
        self.notes: List[dict] = []          # pending piggyback notes
        self.pending_out = b""               # spilled partial push frame
        self.client_id: Optional[str] = None  # set by mux_hello


class _WorkerPool:
    """Grow-on-demand thread pool with idle-worker reuse.

    Potentially-blocking RPCs need a thread each (a capped pool would
    deadlock: gate-wait RPCs could occupy every worker while the release
    that frees them queues behind), but spawning a fresh thread per request
    costs real latency on the hot path — so idle workers are reused and the
    pool only grows when every worker is busy."""

    def __init__(self, name: str = "op"):
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._idle = 0
        self._spawned = 0
        self._name = name

    def submit(self, fn: Callable[[], None]) -> None:
        with self._lock:
            grow = self._idle == 0
            if grow:
                self._spawned += 1
                n = self._spawned
            else:
                self._idle -= 1
        if grow:
            threading.Thread(target=self._run, name=f"{self._name}-{n}",
                             daemon=True).start()
        self._q.put(fn)

    def _run(self) -> None:
        while True:
            fn = self._q.get()
            if fn is None:
                return
            try:
                fn()
            except Exception:  # noqa: BLE001 - handlers report their own errors
                pass
            with self._lock:
                self._idle += 1

    def stop(self) -> None:
        with self._lock:
            n = self._spawned
        for _ in range(n):
            self._q.put(None)


class _ServerAccess(ObjectAccess):
    """Home-node half of one transaction's ``ObjectAccess`` record.

    A real :class:`ObjectAccess` whose owning "transaction" is the server
    session — checkpoint/rollback/buffer/log logic lives once, on the base
    class. Only the §2.7/§2.8.4 task
    bodies are overridden: in a multi-process world they must no-op after a
    §3.4 expiry (a dead client's log must never be applied), which needs
    the expiry check and the apply to share the header lock.
    """

    __slots__ = ("server", "push_conn", "task_result", "push_done",
                 "inline_tasks", "ship_state", "aborted", "repl_origin",
                 "repl_done", "oneway_entries")

    def __init__(self, server: "NodeServer", session: "_Session",
                 shared: SharedObject, pv: int):
        super().__init__(session, shared, _SERVER_SUP)
        self.pv = pv
        self.server = server
        #: connection to push the task-done note to; ``None`` while a
        #: carrier RPC (the dispense reply) may still deliver it instead.
        self.push_conn: Optional[_Conn] = None
        self.task_result: Optional[tuple] = None  # (error, buf payload)
        self.push_done = False
        #: ship held-state copies to the client while it holds access?
        #: flips off permanently once the state proves too big/unpicklable.
        self.ship_state = True
        #: set (under the header lock) by the abort path: a stale commit
        #: wave that wakes afterwards must not apply this access's log.
        self.aborted = False
        #: coordinator address of the commit wave currently prepping this
        #: access (chained commit): shipped with tentative replication so
        #: a promoting follower knows whom to ask for the decision.
        self.repl_origin: Optional[str] = None
        #: tentative replication already shipped (commit_prep ran): the
        #: release below it may skip the pin-state snapshot.
        self.repl_done = False
        #: True while the spawner runs on a worker thread (dispense): an
        #: open-gated task may run inline there, completing within the RPC
        #: so its result rides the reply. False from the conn reader (a
        #: one-way kickoff), where inline work would stall the link.
        self.inline_tasks = False
        #: §12 commute deltas shipped ahead of commit as ``commute_delta``
        #: one-ways. They precede whatever entries ride the commit RPC
        #: (same FIFO connection), so :meth:`absorb_entries` prepends them.
        self.oneway_entries: List[tuple] = []

    @property
    def session(self) -> "_Session":
        return self.txn

    def open_access(self, kind: str, timeout: Optional[float]) -> bool:
        """§2.8.2 open with a §3.4 expiry re-check after the gate wait.

        A crashed client's in-flight open parks on the access gate; the
        expiry's own chain-order ``skip_version`` is then exactly what
        opens that gate — without this check the woken handler would
        apply a dead transaction's operation to live state *after* the
        self-rollback ran, leaving it applied-unrestored (found by the
        simnet seed sweep). Checked under the header lock, which the
        expiry also holds while deciding what to restore."""
        blocked = super().open_access(kind, timeout)
        with self.shared.header.lock:
            if self.session.expired or self.aborted:
                raise InstanceInvalidated(
                    f"transaction {self.session.txn_uid!r} was rolled back "
                    f"while waiting to open {self.shared.name!r} "
                    f"(§3.4 crash-stop)")
        return blocked

    def _ro_buffer_code(self) -> None:
        if self.session.expired:
            return        # §3.4: the expiry advanced our version already
        super()._ro_buffer_code()

    def _lw_apply_code(self) -> None:
        # Full override (no super() call): re-wrap with the obs span the
        # base class would have emitted.
        if _txtrace.enabled:
            t0 = self._obs_tracer().now()
            self._lw_apply_server()
            self._obs_span("lw_apply", t0, detail=self.shared.name)
        else:
            self._lw_apply_server()

    def _lw_apply_server(self) -> None:
        shared = self.shared
        # The expired check and the apply happen under the header lock,
        # which _expire_session also takes before deciding whether to
        # restore: either we see the expiry and no-op, or the expiry sees
        # our checkpoint (self.st) and restores it — a dead transaction's
        # log can never slip through unrestored.
        with shared.header.lock:
            if self.session.expired:
                return    # §3.4: never apply a dead transaction's log
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

    def commit_prep(self) -> None:
        """Commit step 3 under the header lock, guarded against a stale
        wave: a ``commit_wave1`` worker that was parked in its commit
        condition while the client aborted (rollback + terminate + session
        end) must never apply the dead transaction's log afterwards. The
        abort marks ``aborted`` under the same header lock that serializes
        the checkpoint/apply here, so exactly one of the two orders holds:
        prep-then-rollback (the restore erases the applied log — the
        checkpoint was taken first) or rollback-then-prep (raises)."""
        with self.shared.header.lock:
            if self.aborted or self.session.expired:
                raise InstanceInvalidated(
                    f"access on {self.shared.name!r} was rolled back "
                    f"before commit step 3 could run")
            self.ensure_checkpoint()
            self.apply_log()
            if self.modified:
                # Tentative replication. The payload must be THIS
                # transaction's resulting state: if the object was
                # early-released (§2.7/§2.8.3-4 last use), successors have
                # already executed against live state, so ship the
                # release-time snapshot (``buf``); otherwise the header
                # lock still excludes successors and live state is ours.
                with self.lock:
                    snap = self.buf if self.released else None
                state = (snap.state if snap is not None
                         else self.shared.holder.obj)
                self.server.replication.on_commit_prep(
                    self.session.txn_uid, self.shared.name,
                    state, self.pv, self.repl_origin)
                self.repl_done = True
        # Release outside the lock: it wakes successors (possibly running
        # their tasks on this thread) and must not do so under our hold.
        self.release()

    def release(self) -> None:
        """Early release must pin this transaction's resulting state
        first: once successors run, live state is no longer ours, and the
        commit-time tentative replication (:meth:`commit_prep`) needs the
        release-time snapshot. The §2.7/§2.8.4 task bodies and
        ``snap_release`` already buffer before releasing; this covers the
        plain ``release`` one-way a client with a live held-state copy
        sends for a modified object."""
        if (not self.released and self.modified and not self.aborted
                and not self.repl_done and self.buf is None
                and self.server.replication.followers_of(self.shared.name)):
            self.snapshot_buf()
        super().release()

    def mark_aborted(self) -> None:
        with self.shared.header.lock:
            self.aborted = True

    def absorb_entries(self, entries: list) -> None:
        """Install the commit-shipped write log, preceded by any deltas
        that already arrived as ``commute_delta`` one-ways (client-issue
        order == wire order on the FIFO connection == this concatenation)."""
        if self.oneway_entries:
            merged = list(self.oneway_entries)
            self.oneway_entries = []
            merged.extend(entries)
            self.log.entries = merged
        elif entries:
            self.log.entries = list(entries)

    def _owner_label(self) -> str:
        return self.session.txn_uid

    def _obs_uid(self) -> str:
        # Full wire uid ("<client_id>#<id>[r<inc>]"): the export merges it
        # with client-side spans by the "#..." tail.
        return self.session.txn_uid

    def _submit_task(self, label: str, kind: str,
                     code: Callable[[], None]) -> Task:
        """Submit off the reader thread (``inline_ready=False`` — running
        the snapshot inline would stall every conversation on the socket)
        and deliver a ``task_done`` note to the client on completion.

        Delivery handshake (race-free under ``self.lock``): the completed
        task records its result; if ``push_conn`` is set it pushes, and if
        not — a carrier RPC (the dispense reply that spawned it) is still
        in flight and will piggyback the result instead. Whichever side
        runs second delivers."""
        server, session, name = self.server, self.session, self.shared.name

        def wrapped() -> None:
            error: Optional[BaseException] = None
            try:
                code()
            except BaseException as e:  # noqa: BLE001 - note + re-raise
                error = e
                raise
            finally:
                payload = (server._buf_payload(self)
                           if error is None else None)
                with self.lock:
                    self.task_result = (
                        encode_error(error) if error is not None else None,
                        payload)
                    conn = self.push_conn
                    if conn is not None:
                        self.push_done = True
                if conn is not None:
                    server._push_task_done(session, name, conn,
                                           self.task_result)

        # wake_inline: when a release opens this task's gate, it runs on
        # the releasing thread (trampolined) — the snapshot/apply and its
        # completion push cost the client exactly one wakeup.
        return self.shared.node.executor.submit(
            self.shared.header, kind, self.pv, wrapped,
            name=f"{label}:{name}:{self._owner_label()}",
            inline_ready=self.inline_tasks, wake_inline=True)


class _ServerCommuteAccess(_ServerAccess):
    """Home-node access record for a commute-group member (DESIGN.md §12).

    The server-side mirror of :class:`repro.core.transaction.CommuteAccess`
    in its group-active state — it only ever EXISTS while active; when
    :meth:`NodeCore._make_access` cannot join the group it builds a plain
    :class:`_ServerAccess` instead, and the client-shipped deltas become
    ordinary §2.8.4 log entries (the fallback is invisible to the client:
    commute methods are pure writes returning ``None`` either way).

    While the group lives, its deltas touch nothing locally: no
    checkpoint, no ``lv`` advance at release — the fold happens at
    *terminate*, strictly after the commit decision, under the object's
    per-class merge lock. Replication is the one thing that must NOT wait
    for the decision: ``commit_prep`` ships the member's entry list as a
    DELTA tentative (step 3, before the wave reply), so the §8
    tentative-before-decision invariant covers commute commits; the
    follower folds the delta into its committed snapshot when the final
    (or the decision) resolves it. All of a group's tentatives share
    ``seq == cg_pv``, which is why the follower's apply guard accepts
    equal sequence numbers (deltas fold — resolution order across members
    is free, because the method class commutes).
    """

    __slots__ = ("commute_cls", "_cg_left")

    def __init__(self, server: "NodeServer", session: "_Session",
                 shared: SharedObject, pv: int, commute_cls: str):
        super().__init__(server, session, shared, pv)
        self.commute_cls = commute_cls
        self._cg_left = False

    def commute_depart(self) -> None:
        """Leave the commute group exactly once. ``commute_leave``
        decrements the member count (NOT idempotent), and terminate, the
        §3.4 expiry, and a dispense-time expired re-check can race on the
        same access — the flag (under ``self.lock``) picks one winner."""
        with self.lock:
            if self._cg_left:
                return
            self._cg_left = True
        self.shared.header.commute_leave()

    # No state was touched before the fold: nothing to checkpoint,
    # validate, restore, or early-release.
    def ensure_checkpoint(self) -> None:
        pass

    def wait_termination(self, timeout: Optional[float]) -> bool:
        return False   # ltv == cg_pv - 1 by construction: never blocks

    def valid_commit(self) -> bool:
        return True

    def commit_prep(self) -> None:
        # Staleness check + DELTA tentative replication. The fold itself
        # must wait for the commit DECISION (terminate) — prepping applies
        # nothing locally — but the deltas ship to the followers NOW,
        # before the wave reply that feeds the decision. Without this the
        # §8 invariant (every tentative is at the followers before any
        # decision exists) would not cover commute commits: a primary
        # crashing between decision and fold would take the only copy of
        # the deltas with it while the promoted follower acks the decide.
        with self.shared.header.lock:
            if self.aborted or self.session.expired:
                raise InstanceInvalidated(
                    f"commute access on {self.shared.name!r} was rolled "
                    f"back before commit could run")
            with self.lock:
                entries = self.oneway_entries + self.log.entries
            if entries:
                self.server.replication.on_commute_prep(
                    self.session.txn_uid, self.shared.name, entries,
                    self.pv, self.repl_origin)
                with self.lock:
                    self.repl_done = True

    def release(self) -> None:
        # An lv advance would open exact successors' gates before the
        # group's folds landed — release rides the dissolve instead.
        with self.lock:
            self.released = True

    def rollback(self) -> None:
        self.mark_aborted()
        with self.lock:
            self.log.entries.clear()
            self.oneway_entries = []

    def terminate(self) -> None:
        if self.terminated:
            return
        self.terminated = True
        shared, session = self.shared, self.session
        with self.lock:
            # Capture the delta list under the access lock: a racing §3.4
            # expiry clears these same lists, and the fold below iterates
            # outside this lock.
            entries = self.oneway_entries + self.log.entries
            self.oneway_entries = []
            self.log.entries = []
            fold = (bool(entries) and not self.aborted
                    and not session.expired)
        if fold:
            h = shared.header
            with h.commute_merge_lock(self.commute_cls):
                obj = shared.holder.obj
                for method, args, kwargs in entries:
                    getattr(obj, method)(*args, **(kwargs or {}))
                with self.lock:
                    self.modified = True
                self.server.n_merged_deltas += len(entries)
            # Replication already happened: the DELTA tentative shipped at
            # commit_prep (step 3, before the decision), and the final
            # rides the caller's ``on_terminate`` right after this returns
            # — the follower folds its buffered copy of the same entries
            # then (or already did, if the decision broadcast beat us).
        shared.clear_holder(session)
        self.commute_depart()


class _Session:
    """All server-side state of one client transaction (its txn record).

    Duck-types the transaction for the monitor and for the base
    ``ObjectAccess`` methods: ``_accesses`` maps shared object → access
    record exactly like ``Transaction._accesses``, and the session is what
    ``shared.touch``/``clear_holder`` see as the holding transaction.
    """

    client_node = None      # ObjectAccess.raw_call's from_node

    def __init__(self, txn_uid: str, client_id: str,
                 now: Optional[float] = None):
        self.txn_uid = txn_uid
        self.client_id = client_id
        self._accesses: Dict[SharedObject, _ServerAccess] = {}
        self.tasks: Dict[str, Task] = {}     # object name -> release task
        self.held_gates: List[threading.Lock] = []
        self.last_contact = time.monotonic() if now is None else now
        self.expired = False      # set by §3.4 expiry; parked tasks no-op
        self.lock = threading.Lock()

    @property
    def id(self) -> str:
        return self.txn_uid

    def __repr__(self) -> str:  # pragma: no cover
        return f"_Session({self.txn_uid})"


class NodeCore:
    """Transport-independent node engine: sessions, op dispatch, §3.4.

    Everything a home node *is* — the registry node with its
    ``SharedObject``s and executor, the per-transaction sessions holding
    :class:`_ServerAccess` records, the version-lock dispensing gates, the
    full ``_op_*`` protocol surface, and the §3.4 crash-stop expiry — lives
    here, with NO knowledge of sockets, frames, threads-per-connection, or
    real time. Concrete transports subclass it:

    * :class:`NodeServer` adds the TCP machinery (listener, multiplexed
      connections, worker pool, pusher, real-time reaper);
    * :class:`repro.net.simnet.SimNode` delivers messages directly under a
      seeded virtual-time scheduler.

    The transport boundary is a handful of hooks:

    * ``_clock()``            — time source for the failure detector
      (real monotonic vs. the simulation's virtual clock);
    * ``_gate_acquire(gate)`` — how a dispense gate blocks (a real
      ``Lock.acquire`` vs. a virtual-time backoff loop);
    * ``_queue_note(conn, note)`` — how a server push reaches the client;
    * ``_push_target(conn, client_id)`` — which "connection" a task
      completion note should ride;
    * ``_peer(address)``      — the server-to-server transport for
      chained dispensing (§2.10.2);
    * ``_oob(payload)``       — wire-v3 out-of-band marking (identity off
      the TCP wire);
    * ``INLINE_KICKOFF_TASKS`` — whether §2.7/§2.8.4 kickoff tasks whose
      gate is already open run on the delivering thread (the simulation
      needs this for determinism; the TCP reader must not stall).
    """

    #: Ops whose handler needs the originating connection (to route task
    #: completion pushes back the way the kickoff came).
    _CONN_OPS = frozenset({"ro_buffer", "lw_apply", "dispense_batch"})

    #: §2.7/§2.8.4 kickoff tasks with an open gate: run on the delivering
    #: thread (True) or strictly asynchronously on the executor (False)?
    INLINE_KICKOFF_TASKS = False

    def __init__(self, node_name: str = "node0", *,
                 registry: Optional[Registry] = None,
                 monitor_timeout: float = 2.0, monitor_poll: float = 0.05,
                 executor_workers: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 wal: Optional[Wal] = None):
        self.registry = registry if registry is not None else Registry()
        self.node_name = node_name
        self._clock = clock
        try:
            self.node = self.registry.node(node_name)
        except KeyError:
            self.node = self.registry.add_node(
                node_name, executor_workers=executor_workers)
        self.monitor = TransactionMonitor(
            self.registry, timeout=monitor_timeout, poll_interval=monitor_poll,
            clock=clock)
        self._peers: Dict[str, Any] = {}          # addr -> peer transport
        self._sessions: Dict[str, _Session] = {}
        self._gates: Dict[str, threading.Lock] = {}   # per-object dispense gate
        self._lock = threading.Lock()
        #: replica chains + decision ledger (DESIGN.md §8)
        self.replication = ReplicationManager(self)
        #: ownership leases + epoch fencing + redirect tombstones (§10)
        self.leases = LeaseManager(self)
        #: migration drain-barriers in flight: name -> threading.Event
        #: (set when the migration resolves either way); per-object
        #: access-affinity votes: name -> {node_addr: count}.
        self._migrating: Dict[str, threading.Event] = {}
        self._affinity: Dict[str, Dict[str, int]] = {}
        self._migrate_queue: List[Tuple[str, str]] = []
        self.migrate_auto = False       # affinity-triggered handoff opt-in
        self.n_migrations = 0
        #: §12 commute counters: deltas folded into live state at
        #: terminate, and deltas that arrived as ``commute_delta`` one-ways
        #: (the coordination-avoidance fraction of the write traffic).
        self.n_merged_deltas = 0
        self.n_commute_oneways = 0
        #: observability: one trace track + metric namespace per node,
        #: reading THIS node's clock domain (monotonic vs. sim-virtual).
        #: Created even when tracing is off — a bare Tracer holds no ring
        #: until the first emit, so the disabled cost is one object.
        self.obs_tracer = _txtrace.tracer(f"node:{node_name}", clock=clock)
        self.obs_metrics = _metrics.registry(f"node:{node_name}")
        for shared in self.registry.all_objects().values():
            if shared.node is self.node:
                self._obs_stamp(shared)
        #: write-ahead ledger (§11): None keeps durability entirely off —
        #: the TCP server opts in via --wal-dir, simnet always wires a
        #: seeded VirtualDisk so restart schedules are deterministic.
        self.wal = wal
        self._recovered = wal.recover() if wal is not None else None
        if self._recovered is not None:
            self._apply_wal_recovery(self._recovered)

    def _apply_wal_recovery(self, rec) -> None:
        """Offline half of the §11 restart: rebuild this node's pre-crash
        roles from the replayed ledger. Tombstones and follower replica
        records come back verbatim; the decision ledger is restored so we
        can answer ``txn_status``/``txn_decision`` for transactions we
        coordinated before the crash. Primaries are NOT rebound here —
        whether this node still owns them is decided against the live
        chain in :meth:`rejoin_chains` (epoch monotonicity: a successor's
        higher epoch wins and our fenced state is discarded)."""
        repl = self.replication
        with repl.lock:
            repl.decisions.update(rec.decisions)
        for name, (target, epoch, followers) in rec.tombstones.items():
            self.leases.moved[name] = (target, epoch, list(followers))
        for name, info in rec.objects.items():
            if info["role"] != "follower":
                continue
            r = ReplicaRecord(name, info["primary"], list(info["order"]),
                              info["epoch"], info["payload"],
                              (info["epoch"], info["seq"]))
            r.recovering = True     # not promotable until caught up (§11)
            repl.replicas[name] = r
        # undecided tentatives we buffered as a follower go back into the
        # record so promotion resolves them against the coordinator
        for (txn, name), (epoch, seq, payload, head) in rec.pending.items():
            r = repl.replicas.get(name)
            if r is not None and txn not in repl.decisions:
                r.tentative[txn] = (epoch, seq, payload, head)

    def _obs_stamp(self, shared: SharedObject) -> None:
        """Point the object's version header at this node's obs sinks, so
        versioning's gate-wait/handoff instrumentation lands on the track
        of the node that owns the state."""
        h = shared.header
        h.obs_tracer = self.obs_tracer
        h.obs_metrics = self.obs_metrics
        h.obs_clock = self._clock

    #: transport address peers/followers reach this node at; concrete
    #: transports override (TCP property / simnet attribute).
    address: Optional[str] = None

    def has_binding(self, name: str) -> bool:
        try:
            shared = self.registry.locate(name)
        except KeyError:
            return False
        return shared.node is self.node

    def bind_local(self, name: str, obj: Any) -> None:
        """Bind ``obj`` here under a FRESH version header (promotion path:
        the dead primary's private versions are meaningless on this node —
        in-flight transactions abort and retry against the new header)."""
        try:
            shared = self.registry.bind(name, obj, node=self.node)
        except ValueError:
            return   # already bound here: promotion is idempotent
        self._obs_stamp(shared)
        with self._lock:
            self._gates.setdefault(name, threading.Lock())

    # -- transport hooks -----------------------------------------------------
    @staticmethod
    def _oob(payload: bytes) -> Any:
        """Mark a bulk payload for the transport (overridden per wire)."""
        return payload

    def _gate_acquire(self, gate: threading.Lock, nb: bool = False) -> None:
        """Acquire a version-lock dispensing gate. ``nb`` gives up with
        :class:`_WouldBlock` instead of blocking (reader fast path)."""
        if nb:
            if not gate.acquire(blocking=False):
                raise _WouldBlock
        else:
            gate.acquire()

    def _queue_note(self, conn: Any, note: dict) -> None:
        """Deliver one server push (``task_done`` / ``oneway_err``) on
        ``conn``."""
        raise NotImplementedError

    def _push_target(self, conn: Any, client_id: str) -> Any:
        """The connection a task-completion push for ``client_id`` should
        ride, given the connection the kickoff arrived on (``conn`` may
        belong to a chain-forwarding peer server instead)."""
        return conn

    def reap_stale(self, now: float) -> bool:
        """Expire every session whose client stopped heartbeating before
        ``now - monitor.timeout`` (§3.4) — the one staleness scan shared
        by the TCP real-time reaper thread and the simulation's
        virtual-clock reaper events. Returns True iff sessions remain
        (the caller decides whether to keep polling).

        Lease renewal rides the same cadence: one-way ``lease_renew``
        sends are non-blocking, so the tick is safe in both the TCP
        reaper thread and the simulation's scheduler loop."""
        self.leases.tick(now)
        with self._lock:
            stale = [(uid, s) for uid, s in self._sessions.items()
                     if now - s.last_contact > self.monitor.timeout]
        for uid, session in stale:
            self._expire_session(session)
            with self._lock:
                self._sessions.pop(uid, None)
        with self._lock:
            return bool(self._sessions)

    def _handle_oneway(self, conn: _Conn, op: str, kw: Dict[str, Any]) -> None:
        try:
            self._dispatch(op, kw)
        except BaseException as e:  # noqa: BLE001 - defer to the client
            self._queue_note(conn, {
                "kind": "oneway_err", "op": op, "txn": kw.get("txn"),
                "name": kw.get("name"), "error": encode_error(e)})

    def _push_task_done(self, session: _Session, name: str, conn: _Conn,
                        result: tuple) -> None:
        # The target is the connection the kickoff arrived on: its loss
        # means the whole client process is crash-stop dead (the client
        # fails all local task waits itself), so no fallback is needed.
        error, payload = result
        self._queue_note(conn, {"kind": "task_done", "txn": session.txn_uid,
                                "name": name, "error": error,
                                "buf": payload})

    def _buf_payload(self, acc: _ServerAccess) -> Optional[bytes]:
        """Pickled read-buffer state iff it is small enough to ship (the
        piggyback read protocol); ``None`` keeps reads home-node-only.
        Shares the sticky ``ship_state`` opt-out with the held-state
        piggyback, so a big/unpicklable object pays the wasted
        serialization at most once per access."""
        if not acc.ship_state:
            return None
        with acc.lock:
            buf = acc.buf
        if buf is None:
            return None
        try:
            payload = pickle.dumps(buf.state, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:  # noqa: BLE001 - unpicklable state stays home
            acc.ship_state = False
            return None
        if len(payload) > PIGGYBACK_MAX:
            acc.ship_state = False
            return None
        return self._oob(payload)   # out-of-band on wire v3; raw in sim

    def _held_payload(self, acc: _ServerAccess) -> Optional[bytes]:
        """Held-state copy for the piggyback live-read protocol: while the
        client holds the access, nobody else can modify the object, so its
        pure reads may run against a shipped copy that every modifying
        reply refreshes. ``None`` (too big / unpicklable) keeps reads
        home-node-only; the decision is sticky per access."""
        if not acc.ship_state:
            return None
        try:
            payload = pickle.dumps(acc.shared.holder.obj,
                                   protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:  # noqa: BLE001
            acc.ship_state = False
            return None
        if len(payload) > PIGGYBACK_MAX:
            acc.ship_state = False
            return None
        return self._oob(payload)   # out-of-band on wire v3; raw in sim

    def _client_vanished(self, client_id: str) -> None:
        """Last mux connection dropped: crash-stop the client's sessions."""
        with self._lock:
            sessions = [s for s in self._sessions.items()
                        if s[1].client_id == client_id]
        for uid, session in sessions:
            self._expire_session(session)
            with self._lock:
                self._sessions.pop(uid, None)

    def _expire_session(self, session: _Session) -> None:
        """Crash-stop one client transaction (paper §3.4).

        Performs the complete self-rollback for every object the session
        dispensed on, directly (not via the object-level monitor — a
        handoff raced successor transactions becoming the holder, dropping
        the rollback and leaving the crashed version unterminated): under
        the version lock, restore the checkpoint if the session modified
        live state and nothing newer restored already (oldest-restore-wins
        on the epoch), bump the instance epoch so observers of the dead
        transaction's state cascade-abort, and skip its private version in
        chain order (:func:`~repro.core.versioning.skip_version`) so
        successors unwedge without ever bypassing a live predecessor — this
        covers held, released-but-unterminated, and never-accessed objects
        alike. Version-lock gates the session still holds are
        force-released.

        ``session.expired`` is set first: the advance below drains waiters,
        including the session's own parked §2.7/§2.8.4 tasks — woken, they
        must no-op rather than apply a dead transaction's buffered writes."""
        session.expired = True
        if _txtrace.enabled:
            self.obs_tracer.instant("expire", txn=session.txn_uid,
                                    detail="§3.4 crash-stop self-rollback",
                                    sev=_txtrace.WARN)
        self._release_gates(session)
        with session.lock:
            accesses = list(session._accesses.items())
        for shared, acc in accesses:
            h = shared.header
            if isinstance(acc, _ServerCommuteAccess):
                # §12: a dead commute member's undelivered deltas are simply
                # discarded — live state was never touched (no restore, no
                # instance bump, nobody cascades). Its private version is
                # the GROUP's shared cg_pv: skipping it would terminate the
                # group under its surviving members, so the member departs
                # instead (the last departure dissolves the group).
                with acc.lock:
                    acc.log.entries.clear()
                    acc.oneway_entries = []
                shared.clear_holder(session)
                acc.commute_depart()
                self.monitor.rollbacks.append(shared.name)
                self.replication.on_abort(session.txn_uid, shared.name)
                continue
            with h.lock:
                # Read access state under the header lock: an lw-apply task
                # holding it is either fully applied (its checkpoint is
                # visible and restored here) or will see `expired` and
                # no-op — never applied-but-unrestored.
                with acc.lock:
                    seen, st, modified = (acc.seen_instance, acc.st,
                                          acc.modified)
                with shared._contact_lock:
                    if shared.holding_txn is session:
                        shared.holding_txn = None
                if (st is not None and modified
                        and h.restore_allowed(seen, acc.pv)):
                    st.restore_into(shared.holder)
                    h.note_restore(acc.pv)
                    h.instance += 1
            skip_version(h, acc.pv)
            self.monitor.rollbacks.append(shared.name)
            # §3.4 expiry IS the abort: discard the dead transaction's
            # tentative replication (followers drop the buffered state).
            self.replication.on_abort(session.txn_uid, shared.name)

    # ------------------------------------------------------------------ #
    # op dispatch                                                         #
    # ------------------------------------------------------------------ #
    def _dispatch(self, op: str, kw: Dict[str, Any]) -> Any:
        handler = getattr(self, f"_op_{op}", None)
        if handler is None:
            raise WireError(f"unknown op {op!r}")
        if _txtrace.enabled:
            # One span per handled op, named after the op itself — so
            # dispense_batch / commit_wave1 / repl_apply / repl_final
            # slices read directly in the Perfetto UI.
            t0 = self.obs_tracer.now()
            v = handler(**kw)
            self.obs_tracer.emit(op, t0, self.obs_tracer.now() - t0,
                                 txn=kw.get("txn") or "", detail="op")
            return v
        return handler(**kw)

    # -- helpers ------------------------------------------------------------
    def _shared(self, name: str) -> SharedObject:
        try:
            return self.registry.locate(name)
        except KeyError:
            # A migrated-away binding: the name is gone from the local
            # registry but the lease layer keeps the epoch-fenced redirect
            # tombstone — raise the redirect (which clients follow) rather
            # than a bare KeyError no transport can act on. Never-bound
            # names still get the KeyError.
            self.leases.check_grant(name)
            rec = self._recovered
            if (rec is not None and name in rec.objects
                    and rec.objects[name].get("role") == "primary"):
                # Restarted primary mid-rejoin (§11): the WAL proves the
                # object was served here, but recovery hasn't written
                # the redirect tombstone (or resurrected the binding)
                # yet — refuse service retryably instead of claiming the
                # name never existed. Restarted followers keep the bare
                # KeyError: they never served it.
                raise RemoteObjectFailure(
                    f"{name!r} is recovering on this node after a "
                    f"restart; retry") from None
            raise

    def _session(self, txn: str) -> _Session:
        with self._lock:
            session = self._sessions.get(txn)
        if session is None:
            # The session was expired (§3.4 crash-stop suspicion) — an
            # "illusorily crashed" client coming back must abort, exactly
            # like a transaction whose observed instance was invalidated.
            raise InstanceInvalidated(
                f"transaction {txn!r} has no live session on this node "
                f"(rolled back by the failure detector)")
        session.last_contact = self._clock()
        return session

    def _acc(self, txn: str, name: str) -> _ServerAccess:
        session = self._session(txn)
        shared = self._shared(name)
        acc = session._accesses.get(shared)
        if acc is None:
            raise InstanceInvalidated(
                f"transaction {txn!r} holds no access on {name!r}")
        return acc

    def _check_valid(self, acc: _ServerAccess) -> None:
        """Per-operation §2.3 validity check, enforced at the home node."""
        if not acc.valid():
            raise InstanceInvalidated(
                f"object {acc.shared.name!r} was invalidated by a cascading "
                f"abort (home-node check)")

    def _peer(self, address: str):
        """Client connection to a peer node server (chain dispensing)."""
        from .client import NodeClient   # lazy: client imports nothing of us
        with self._lock:
            peer = self._peers.get(address)
        if peer is not None and peer.alive:
            return peer
        fresh = NodeClient(address, conns=1)
        with self._lock:
            cur = self._peers.get(address)
            if cur is not None and cur.alive:
                peer = cur
            else:
                self._peers[address] = peer = fresh
        if peer is not fresh:
            fresh.close()
        return peer

    def _release_gates(self, session: _Session) -> None:
        with session.lock:
            gates, session.held_gates = session.held_gates, []
        for g in reversed(gates):
            try:
                g.release()
            except RuntimeError:  # pragma: no cover - already released
                pass

    # -- ownership migration (§10) --------------------------------------------
    def _spawn_bg(self, fn: Callable[[], None], name: str = "bg") -> None:
        """Run a blocking background job (migration drain). The simulation
        overrides this to run the job on a handler actor, on virtual time."""
        threading.Thread(target=fn, name=f"{name}-{self.node_name}",
                         daemon=True).start()

    def _affinity_vote(self, name: str, affinity: str) -> None:
        """Per-object access-affinity tally (§10): every dispense carries
        the client's locality hint; a sustained dominant remote accessor
        triggers a lease handoff to it. Votes are cheap bookkeeping — the
        migration itself is queued and drained off the op path."""
        if not affinity:
            return
        with self._lock:
            tally = self._affinity.setdefault(name, {})
            tally[affinity] = tally.get(affinity, 0) + 1
            if not self.migrate_auto or affinity == self.address:
                return
            votes = tally[affinity]
            rest = max((v for a, v in tally.items() if a != affinity),
                       default=0)
            if votes < MIGRATE_THRESHOLD or votes < 2 * max(rest, 1):
                return
            if (name in self._migrating
                    or any(n == name for n, _t in self._migrate_queue)):
                return
            tally.clear()
            self._migrate_queue.append((name, affinity))

    def _drain_migrations(self) -> None:
        with self._lock:
            pending, self._migrate_queue = self._migrate_queue, []
        for name, target in pending:
            self._spawn_bg(lambda n=name, t=target: self._do_migrate(n, t),
                           name="migrate")

    def _do_migrate(self, name: str, target: str) -> bool:
        """Ownership handoff as a drain-barrier (§10).

        1. Mark the object migrating *under its header lock* — paired with
           the grant check in ``_op_dispense_batch``, so no new version is
           dispensed after the mark.
        2. Drain: wait until every dispensed version terminated
           (``gv == lv == ltv``). After the drain there are no in-flight
           accesses and no undecided tentatives for this object, so the
           applied state is the whole truth — a fresh header at the target
           is exact, like the promotion path.
        3. Ship state + epoch + 1 + the new chain (old primary joins it as
           a follower) via a synchronous ``migrate_in``.
        4. Atomically re-point: unbind here, leave an epoch-fenced redirect
           tombstone; parked dispensers wake, re-check, and raise
           :class:`ObjectMovedError`, which clients follow without
           reconnecting.
        """
        try:
            shared = self._shared(name)
        except KeyError:
            return False
        if shared.node is not self.node or target == self.address:
            return False
        h = shared.header
        ev = threading.Event()
        with h.lock:
            if name in self._migrating:
                return False
            try:
                self.leases.check_grant(name)
            except RemoteObjectFailure:
                return False        # fenced or already moved: nothing to do
            except LeaseRearming:
                return False        # re-ack round in flight: retry later
            self._migrating[name] = ev
        t0 = self.obs_tracer.now() if _txtrace.enabled else 0.0
        ok = False
        try:
            if not wait_quiescent(h, timeout=5 * self.leases.ttl):
                return False        # drain never settled: abort the handoff
            payload = pickle.dumps(shared.holder.obj,
                                   protocol=pickle.HIGHEST_PROTOCOL)
            epoch = self.replication.epochs.get(name, 0) + 1
            chain = [self.address] + [
                f for f in self.replication.followers_of(name)
                if f != target and f != self.address]
            self._peer(target).call("migrate_in", name=name, payload=payload,
                                    epoch=epoch, followers=chain)
            self.replication.drop_primary(name)
            self.registry.unbind(name)
            self.leases.drop_local(name, target, epoch, chain)
            with self._lock:
                self._affinity.pop(name, None)
                self.n_migrations += 1
            ok = True
            return True
        except Exception as e:  # noqa: BLE001 - target died mid-handoff
            log.warning("migration of %r -> %s failed: %r", name, target, e)
            return False
        finally:
            with h.lock:
                self._migrating.pop(name, None)
            ev.set()
            if _txtrace.enabled:
                self.obs_tracer.emit(
                    "migrate", t0, self.obs_tracer.now() - t0,
                    detail=f"{name}->{target}"
                           f"{'' if ok else ' (failed)'}")

    # -- restart + chain rejoin (§11) -----------------------------------------
    def _check_grant_blocking(self, name: str) -> None:
        """``check_grant`` that waits out an idle-lapse re-ack round: a
        :class:`LeaseRearming` parks the handler OUTSIDE the lease/header
        locks on the round's event, then re-checks — the round resolves
        into serving (chain re-acked the epoch), a fence, or a redirect,
        and the re-check surfaces whichever it was."""
        while True:
            try:
                self.leases.check_grant(name)
                return
            except LeaseRearming as e:
                blocking_wait(e.event, self.leases.ttl)

    def _demote_to_follower(self, name: str, successor: str) -> None:
        """A permanently fenced primary demotes itself into the
        successor's chain (§11): drain what's left in flight (every new
        grant already redirects), drop the stale local copy, and rejoin
        as the tail follower so the chain regrows to its bound width.
        Spawned by the lease layer's permanent-fence handler."""
        try:
            shared = self.registry.locate(name)
        except KeyError:
            shared = None
        if shared is not None and shared.node is self.node:
            wait_quiescent(shared.header, timeout=5 * self.leases.ttl)
            self.replication.drop_primary(name)
            try:
                self.registry.unbind(name)
            except KeyError:
                pass
        backoff = max(self.leases.ttl / 2, 4 * self.monitor.poll_interval)
        for _ in range(5):
            if self._rejoin_as_follower(name, successor):
                return
            blocking_wait(threading.Event(), backoff)
        log.warning("deposed primary of %r could not rejoin %s",
                    name, successor)

    def rejoin_chains(self) -> None:
        """Networked half of the §11 restart protocol, run once per boot
        after transports are up. For each object the replayed ledger says
        we participated in:

        1. **Probe** the last known chain members (``chain_probe``).
        2. A live primary at our epoch or higher → we are stale: discard
           fenced local state per epoch monotonicity, rehydrate a redirect
           tombstone at its epoch, and **rejoin** its chain as the tail
           follower via anti-entropy catch-up (``repl_rejoin``).
        3. No primary but a live chain member → drive promotion there
           (first-alive-in-order — the same deterministic failover order
           clients use), then rejoin the winner.
        4. Nobody reachable and the ledger says the object was ours with
           **no followers** → resurrect immediately: nobody else could
           have promoted, so the WAL image is the whole truth. With
           followers we keep probing (they hold the later-epoch evidence)
           and only resurrect as a last resort after the retry window —
           the one residual stale-serve window left open (DESIGN.md §11).
        """
        rec = self._recovered
        if rec is None:
            return
        for name, info in rec.objects.items():
            try:
                self._recover_object(name, info, rec)
            except Exception as e:  # noqa: BLE001 - recovery best-effort
                log.warning("restart recovery of %r failed: %r", name, e)

    def _probe_chain(self, addr: str, name: str) -> Optional[Dict[str, Any]]:
        try:
            p = self._peer(addr).call("chain_probe", name=name,
                                      rpc_timeout=5 * self.leases.ttl)
            return p if isinstance(p, dict) else None
        except Exception:  # noqa: BLE001 - dead peers read as no answer
            return None

    def _recover_object(self, name: str, info: Dict[str, Any],
                        rec: Any, attempts: int = 25) -> None:
        me = self.address
        peers: List[str] = []
        for a in ([info.get("primary")] + list(info.get("order") or ())
                  + list(info.get("followers") or ())):
            if a and a != me and a not in peers:
                peers.append(a)
        backoff = max(self.leases.ttl / 2, 4 * self.monitor.poll_interval)
        for attempt in range(attempts):
            best = None              # (epoch, addr, probe) of live primary
            candidates: List[str] = []   # live followers, failover order
            recovering: List[Dict[str, Any]] = []   # §11 replayed images
            rival = None             # (epoch, addr) of best rival claim
            for addr in peers:
                p = self._probe_chain(addr, name)
                if p is None:
                    continue
                role = p.get("role")
                if role == "moved":
                    t = p.get("target")
                    if t and t != me and t not in peers:
                        peers.append(t)   # chase the redirect next pass
                elif role == "primary":
                    if best is None or p["epoch"] > best[0]:
                        best = (p["epoch"], addr, p)
                elif role == "recovering-primary":
                    # another replayed image also claims the object:
                    # reconcile by (epoch, address) — the greater claim
                    # resurrects, the lesser waits and rejoins it
                    if rival is None or (p["epoch"], addr) > rival:
                        rival = (p["epoch"], addr)
                elif role == "follower" and not p.get("promoted"):
                    if p.get("recovering"):
                        # a replayed, not-yet-caught-up image: refuses
                        # promotion, but its ledger may hold later-epoch
                        # evidence — chase ITS primary too
                        recovering.append(p)
                        pr = p.get("primary")
                        if pr and pr != me and pr not in peers:
                            peers.append(pr)
                    else:
                        candidates.append(addr)
            deferred = (info["role"] == "primary" and rival is not None
                        and rival > (info["epoch"], me))
            if best is not None:
                epoch, addr, p = best
                if info["role"] == "primary":
                    # superseded while down: epoch monotonicity — drop our
                    # fenced image, leave a redirect for stale bindings
                    order = [a for a in p.get("order", ()) if a != addr]
                    self.leases.moved[name] = (addr, epoch, list(order))
                    if self.wal is not None:
                        self.wal.tombstone(name, addr, epoch, list(order))
                if self._rejoin_as_follower(name, addr):
                    return
            elif candidates:
                # headless chain: drive promotion at the first live
                # follower, then rejoin whoever won on the next pass
                try:
                    self._peer(candidates[0]).call(
                        "lease_acquire", names=[name],
                        rpc_timeout=5 * self.leases.ttl)
                except Exception:  # noqa: BLE001 - busy/dead: retry
                    pass
            elif (info["role"] == "primary" and not deferred
                  and recovering and all(
                      p.get("primary") == me
                      and p.get("epoch", 0) <= info["epoch"]
                      for p in recovering)):
                # Every reachable chain member is a recovering follower of
                # OUR epoch (a whole-chain outage, §11): none of them can
                # promote (the recovering guard refuses), so no write has
                # landed since our crash and our own synced ledger — every
                # commit is final'd before the client ack — is the
                # authoritative image. Resurrect; they rejoin us next pass.
                self._resurrect_primary(name, info, rec)
                return
            elif info["role"] == "primary" and not deferred and (
                    not peers or attempt == attempts - 1):
                if peers:
                    log.warning("resurrecting %r with chain %r dark: "
                                "last-resort, state may be stale", name,
                                peers)
                self._resurrect_primary(name, info, rec)
                return
            elif info["role"] == "follower" and attempt == attempts - 1:
                # whole chain dark: keep the replayed replica record —
                # promotion stays client-driven, later restarts rejoin us
                return
            blocking_wait(threading.Event(), backoff)
        log.warning("gave up rejoining chain for %r after %d attempts",
                    name, attempts)

    def _rejoin_as_follower(self, name: str, primary: str) -> bool:
        """Anti-entropy catch-up (§11): ask the live primary to splice us
        back in as the tail follower. The reply is a quiesced snapshot —
        the chain's native replication unit — which replaces whatever
        stale image we replayed (the stale record is popped first so the
        ``repl_init`` staleness guard cannot reject the fresh epoch)."""
        try:
            r = self._peer(primary).call(
                "repl_rejoin", name=name, addr=self.address,
                rpc_timeout=10 * self.leases.ttl)
        except Exception:  # noqa: BLE001 - primary died mid-rejoin: retry
            return False
        if not isinstance(r, dict) or r.get("busy") or "payload" not in r:
            return False
        with self.replication.lock:
            self.replication.replicas.pop(name, None)
        self.replication.repl_init(
            name=name, primary=r["primary"], order=list(r["order"]),
            epoch=r["epoch"], seq=r["seq"], payload=r["payload"])
        return True

    def _resurrect_primary(self, name: str, info: Dict[str, Any],
                           rec: Any) -> None:
        """Rebind a WAL-recovered primary at ``epoch + 1``. Undecided
        tentatives (we crashed between prep and terminate) are resolved
        against their coordinator's decision ledger first. Unlike the
        promotion path (where epoch fencing discards a returning rival's
        contradicting fold), resurrection has no rival chain to defer to
        — so an *unreachable* coordinator here may itself be mid-restart
        holding a durable ``commit``, and dooming on first contact would
        split the decision (§11). Poll through unreachability for the
        full horizon; only a coordinator that stays dark past it (or one
        that is reachable with no record) dooms the tentative to abort."""
        epoch, seq = info["epoch"], info["seq"]
        payload = info["payload"]
        for (txn, n), t in sorted(rec.pending.items()):
            if n != name:
                continue
            head = t[3]
            status = "none"
            if head and head != self.address:
                # a live coordinator still "pending" must eventually abort
                # (its commit wave cannot succeed against our dead
                # sessions) — poll it out briefly, then doom
                for _ in range(10):
                    status = self.replication._query_head(head, txn)
                    if status not in ("pending", "unreachable"):
                        break
                    blocking_wait(threading.Event(), self.leases.ttl / 2)
            d = self.replication.record_decision(
                txn, "commit" if status == "commit" else "abort")
            if d == "commit" and (t[0], t[1]) >= (epoch, seq):
                # fold_payload: a §12 commute delta folds into the
                # recovered snapshot; an exact tentative replaces it.
                epoch, seq = t[0], t[1]
                payload = fold_payload(payload, t[2])
        new_epoch = epoch + 1
        self.bind_local(name, pickle.loads(payload))
        followers = [f for f in info.get("followers", ()) if f != self.address]
        self.replication.adopt(name, followers, new_epoch, payload)
        self.leases.grant_local(name, new_epoch)

    # -- directory ----------------------------------------------------------
    def _op_ping(self) -> Dict[str, Any]:
        return {"node": self.node_name, "time": time.time(),
                "objects": len(self.registry.all_objects())}

    @staticmethod
    def _declared_modes(obj: Any) -> Dict[str, Mode]:
        """All ``@access``-annotated methods of ``obj``'s class — shipped
        with bindings so clients never pay a ``mode_of`` round trip."""
        modes: Dict[str, Mode] = {}
        for n in dir(type(obj)):
            if n.startswith("_"):
                continue
            mode = getattr(getattr(type(obj), n, None), "__access_mode__",
                           None)
            if mode is not None:
                modes[n] = mode
        return modes

    @staticmethod
    def _declared_commutes(obj: Any) -> Dict[str, str]:
        """All ``@access(..., commutes=)`` declarations of ``obj``'s class
        — shipped with bindings like the modes, so commute-aware clients
        build :class:`~repro.net.remote.RemoteCommuteAccess` records
        without a round trip. Empty for undeclared classes (the common
        case), keeping the wire byte-identical to the pre-§12 protocol."""
        return commute_classes(obj)

    def _op_list_bindings(self) -> Dict[str, Any]:
        objs = self.registry.all_objects()
        followers = {name: fl for name in objs
                     if (fl := self.replication.followers_of(name))}
        commutes = {name: cm for name, shared in objs.items()
                    if (cm := self._declared_commutes(shared.holder.obj))}
        out = {"node": self.node_name,
               "bindings": {name: self._declared_modes(shared.holder.obj)
                            for name, shared in sorted(objs.items())},
               "followers": followers}
        if commutes:
            out["commutes"] = commutes
        return out

    def _op_bind(self, name: str, obj: Any,
                 followers: List[str] = ()) -> Dict[str, Any]:
        self._obs_stamp(self.registry.bind(name, obj, node=self.node))
        with self._lock:
            self._gates[name] = threading.Lock()
        # unconditional: follower-less binds still hit the WAL (when one
        # is configured) so the object is resurrectable after a crash
        self.replication.set_followers(name, list(followers), obj)
        # Ownership starts as a lease (§10): granted at the binding epoch,
        # renewed over the chain. Follower-less binds self-renew trivially.
        self.leases.grant_local(name, self.replication.epochs.get(name, 0))
        return {"modes": self._declared_modes(obj),
                "commutes": self._declared_commutes(obj)}

    def _op_commute_classes(self, name: str) -> Dict[str, str]:
        return self._declared_commutes(self._shared(name).holder.obj)

    def _op_mode_of(self, name: str, method: str) -> Mode:
        return method_mode(self._shared(name).holder.obj, method)

    def _op_raw_call(self, name: str, method: str, args: tuple,
                     kwargs: dict) -> Any:
        """Non-transactional direct invocation (Registry-level access)."""
        self._check_grant_blocking(name)
        return self._shared(name).raw_call(method, args, kwargs)

    # -- header surface (RemoteHeader duck type) -----------------------------
    def _op_header_state(self, name: str) -> Dict[str, int]:
        h = self._shared(name).header
        with h.lock:
            return {"gv": h.gv, "lv": h.lv, "ltv": h.ltv,
                    "instance": h.instance}

    def _op_header_wait(self, name: str, kind: str, pv: int,
                        timeout: Optional[float]) -> bool:
        h = self._shared(name).header
        if kind == "termination":
            return h.wait_termination(pv, timeout=timeout)
        return h.wait_access(pv, timeout=timeout)

    def _op_header_release(self, name: str, pv: int) -> None:
        self._shared(name).header.release_to(pv)

    def _op_header_terminate(self, name: str, pv: int) -> None:
        self._shared(name).header.terminate_to(pv)

    # -- start: batched version dispensing (§2.10.2) -------------------------
    def _op_dispense_batch(self, txn: str, client_id: str, names: List[str],
                           ro_names: List[str] = (), kind: str = "access",
                           chain: List[dict] = (), affinity: str = "",
                           commute: Optional[Dict[str, str]] = None,
                           _conn: Optional[_Conn] = None,
                           _nb: bool = False) -> Dict[str, Any]:
        """Lock-and-dispense for this node's batch; then *forward the
        chain*: the remaining per-node batches, in global 2PL order, go
        server-to-server (this node calls the next) while this node's
        gates stay held — a multi-node start costs the end client one
        round trip, and every gate-hold window spans a server hop instead
        of a client bounce. The aggregated reply carries all nodes' pvs.

        The §2.7 read-only buffering kickoffs for ``ro_names`` ride along:
        tasks whose gate is already open complete during this RPC and
        their results (buffer state included, when small) ride back on the
        reply — the uncontended §2.7 hot path costs *zero* messages beyond
        the dispense itself."""
        with self._lock:
            session = self._sessions.get(txn)
            if session is None:
                session = self._sessions[txn] = _Session(
                    txn, client_id, now=self._clock())
        objs = [(self._shared(n), n) for n in names]
        objs.sort(key=lambda sn: sn[0].header.uid)   # node-local global order
        pvs: Dict[str, int] = {}
        made: Dict[str, _ServerAccess] = {}
        acquired: List[threading.Lock] = []
        try:
            for shared, name in objs:
                with self._lock:
                    gate = self._gates.setdefault(name, threading.Lock())
                # Reader fast path (``_nb``): give up (and redo on the
                # pool) rather than block the connection on a held gate.
                # How a *blocking* acquire blocks is the transport's
                # business (virtual-time backoff under simnet).
                self._gate_acquire(gate, nb=_nb)
                acquired.append(gate)
            for shared, name in objs:
                # Lease fence + drain-barrier (§10): no version is ever
                # granted by a fenced primary or while a migration is
                # draining the header. Both checks sit under the header
                # lock, paired with `_do_migrate` which marks the object
                # under the same lock — so a grant and a drain snapshot
                # can never interleave.
                cls = commute.get(name) if commute else None
                joined = False
                while True:
                    rearm = None
                    with shared.header.lock:
                        ev = self._migrating.get(name)
                        if ev is None:
                            try:
                                self.leases.check_grant(name)
                                # §12: a commute-declared access tries the
                                # group first; 0 (other class / snapped /
                                # chain not quiescent) falls back to exact
                                # dispensing — invisible to the client.
                                joined = bool(
                                    cls is not None
                                    and (pv := shared.header.commute_join(
                                        cls)))
                                if not joined:
                                    pv = shared.header.dispense()
                                break
                            except LeaseRearming as e:
                                # idle-lapse re-ack round (§10): park
                                # OUTSIDE the header lock until the chain
                                # re-acks (or fences) the epoch, then redo
                                rearm = e.event
                    blocking_wait(rearm if rearm is not None else ev,
                                  self.leases.ttl if rearm is not None
                                  else None)
                self._affinity_vote(name, affinity)
                acc = (_ServerCommuteAccess(self, session, shared, pv, cls)
                       if joined else
                       _ServerAccess(self, session, shared, pv))
                with session.lock:   # heartbeats iterate _accesses live
                    session._accesses[shared] = acc
                made[name] = acc
                pvs[name] = pv
        except BaseException:
            for g in reversed(acquired):
                g.release()
            raise
        with session.lock:
            session.held_gates.extend(acquired)
        # §3.4 re-check: the client may have crashed (and its session been
        # expired and dropped) while this handler was parked on the gates
        # — the expiry saw no accesses and no held gates, so whatever we
        # just dispensed would live in a *ghost* session no reaper ever
        # visits, wedging every successor on the version chain forever
        # (found by the simnet seed sweep). Converge it ourselves: skip
        # the dispensed versions in chain order and free the gates — both
        # idempotent against a racing expiry that did see partial state.
        if session.expired:
            self._release_gates(session)
            for name, pv in pvs.items():
                acc = made[name]
                if isinstance(acc, _ServerCommuteAccess):
                    # the group's shared version must not be skipped under
                    # its surviving members — depart instead (idempotent
                    # against a racing expiry that saw the access)
                    acc.commute_depart()
                else:
                    skip_version(self._shared(name).header, pv)
            raise InstanceInvalidated(
                f"transaction {txn!r} crash-stopped during dispense "
                f"(§3.4); dispensed versions skipped")
        # Completion-note target: the connection the request came in on if
        # it belongs to the end client, else (chain-forwarded: the request
        # came from a peer server) a connection the end client keeps to
        # this node. A miss is safe — joins fall back to task_join.
        push_to = self._push_target(_conn, client_id)
        ro: Dict[str, Optional[dict]] = {}
        for name in ro_names:
            acc = self._acc(txn, name)
            acc.inline_tasks = True   # open gate ⇒ complete within this RPC
            acc.spawn_ro_buffer(kind)
            acc.inline_tasks = False
            session.tasks[name] = acc.release_task
            # Delivery handshake (see _ServerAccess._submit_task): if the
            # task already completed, carry its result on this reply;
            # otherwise arm the push and the completion will send a note.
            with acc.lock:
                if acc.task_result is not None and not acc.push_done:
                    acc.push_done = True
                    ro[name] = {"error": acc.task_result[0],
                                "buf": acc.task_result[1]}
                else:
                    acc.push_conn = push_to
                    ro[name] = None
        if chain:
            head, rest = chain[0], list(chain[1:])
            fwd: Dict[str, Any] = {}
            if head.get("commute"):
                fwd["commute"] = head["commute"]
            sub = self._peer(head["address"]).call(
                "dispense_batch", txn=txn, client_id=client_id,
                names=head["names"], ro_names=head["ro_names"], kind=kind,
                chain=rest, **fwd)
            pvs.update(sub["pvs"])
            ro.update(sub["ro"])
        return {"pvs": pvs, "ro": ro}

    def _op_release_version_locks(self, txn: str) -> None:
        self._release_gates(self._session(txn))

    # -- §2.7 / §2.8.4: asynchronous home-node tasks -------------------------
    def _op_ro_buffer(self, txn: str, name: str, kind: str,
                      _conn: Any = None) -> None:
        session = self._session(txn)
        acc = self._acc(txn, name)
        acc.push_conn = _conn
        acc.inline_tasks = self.INLINE_KICKOFF_TASKS
        try:
            acc.spawn_ro_buffer(kind)
        finally:
            acc.inline_tasks = False
        session.tasks[name] = acc.release_task

    def _op_lw_apply(self, txn: str, name: str, kind: str,
                     entries: List[tuple],
                     _conn: Any = None) -> None:
        session = self._session(txn)
        acc = self._acc(txn, name)
        acc.push_conn = _conn
        acc.log.entries = list(entries)
        acc.inline_tasks = self.INLINE_KICKOFF_TASKS
        try:
            acc.spawn_lastwrite_apply(kind)
        finally:
            acc.inline_tasks = False
        session.tasks[name] = acc.release_task

    def _op_task_join(self, txn: str, name: str) -> Dict[str, Any]:
        session = self._session(txn)
        task = session.tasks.get(name)
        if task is None:
            raise InstanceInvalidated(
                f"transaction {txn!r} has no pending task on {name!r}")
        task.join()   # re-raises transactional task errors to the client
        return {"buf": self._buf_payload(self._acc(txn, name))}

    # -- synchronous session state operations --------------------------------
    def _op_open_access(self, txn: str, name: str, kind: str,
                        timeout: Optional[float]) -> Dict[str, Any]:
        acc = self._acc(txn, name)
        blocked = acc.open_access(kind, timeout)
        return {"blocked": blocked, "instance": acc.seen_instance}

    def _op_open_call(self, txn: str, name: str, kind: str,
                      timeout: Optional[float], entries: List[tuple],
                      method: str, args: tuple, kwargs: dict,
                      modifies: bool, want_state: bool = True,
                      tail: List[tuple] = ()) -> Dict[str, Any]:
        """§2.8.2-3 first direct access, fused into one RPC: gate wait +
        checkpoint + buffered-write apply + the method call itself — plus
        ``tail``, the rest of a fusable operation run ``[(method, args,
        kwargs, modifies), ...]`` executed FIFO right behind it (operation
        fusion: the whole read-modify-write hop of a bank-transfer chain
        is one round trip). A mid-tail failure reports ``(error_index,
        error)`` with the prefix applied, like ``txn_call_batch``.
        ``want_state`` (the client still has pure reads ahead) requests a
        held-state copy on the reply."""
        acc = self._acc(txn, name)
        blocked = acc.open_access(kind, timeout)
        if entries:
            acc.log.entries = list(entries)
            acc.apply_log()
        self._check_valid(acc)
        values: List[Any] = [acc.raw_call(method, args, kwargs,
                                          modifies=modifies)]
        error = error_index = None
        for i, (m, a, k, mod) in enumerate(tail):
            try:
                self._check_valid(acc)
                values.append(acc.raw_call(m, a, k, modifies=mod))
            except BaseException as e:  # noqa: BLE001 - serialize to peer
                error, error_index = encode_error(e), i + 1
                break
        acc.note_contact()
        return {"blocked": blocked, "instance": acc.seen_instance,
                "value": values[0], "values": values,
                "error_index": error_index, "error": error,
                "state": (self._held_payload(acc)
                          if want_state and error is None else None)}

    def _op_txn_call(self, txn: str, name: str, method: str, args: tuple,
                     kwargs: dict, modifies: bool,
                     want_state: bool = True) -> Any:
        acc = self._acc(txn, name)
        self._check_valid(acc)
        v = acc.raw_call(method, args, kwargs, modifies=modifies)
        acc.note_contact()
        if modifies:
            # Refresh the client's held-state copy (piggyback live reads):
            # the state can only change through this transaction's own
            # modifying calls, each of which renews the copy. Skipped when
            # the client has no pure reads left to serve from it.
            return {"value": v,
                    "state": self._held_payload(acc) if want_state else None}
        return v

    def _op_txn_call_batch(self, txn: str, name: str, calls: List[tuple],
                           want_state: bool = True,
                           raise_errors: bool = False) -> Dict[str, Any]:
        """Operation fusion (§2.8): a run of consecutive operations against
        one *held* object, executed FIFO-atomically in a single RPC.
        ``calls`` is ``[(method, args, kwargs, modifies), ...]``. Atomicity
        is by exclusion — the transaction holds the access, so nothing
        interleaves — and errors carry an **index**: on a failure at call
        ``i`` the prefix ``[0, i)`` is applied, the suffix is not executed,
        and the reply reports ``(error_index, error)`` so the client can
        restore exact sequential semantics (counters for the prefix, the
        original exception for call ``i``).

        Also accepted as a **one-way** (an all-write batch past the
        transaction's last read needs no values): ``raise_errors`` makes a
        mid-batch failure raise after the prefix applied, so the one-way
        machinery defers it as an ``oneway_err`` note to the next sync
        point instead of it vanishing with the discarded reply."""
        acc = self._acc(txn, name)
        values: List[Any] = []
        error = error_index = None
        modified = False
        for i, (method, args, kwargs, modifies) in enumerate(calls):
            try:
                self._check_valid(acc)
                values.append(acc.raw_call(method, args, kwargs,
                                           modifies=modifies))
                modified = modified or modifies
            except BaseException as e:  # noqa: BLE001 - serialize to peer
                if raise_errors:
                    raise
                error, error_index = encode_error(e), i
                break
        acc.note_contact()
        state = (self._held_payload(acc)
                 if modified and want_state and error is None else None)
        return {"values": values, "error_index": error_index,
                "error": error, "state": state}

    def _op_buf_call(self, txn: str, name: str, method: str, args: tuple,
                     kwargs: dict, want_buf: bool = False) -> Any:
        """Buffered read. ``want_buf`` additionally returns the buffer's
        pickled state when small (piggyback read protocol) so the client's
        subsequent reads of this buffer are local."""
        acc = self._acc(txn, name)
        self._check_valid(acc)
        with acc.lock:
            buf = acc.buf
        if buf is None:
            raise RuntimeError(f"no read buffer for {name!r} in {txn!r}")
        v = buf.call(method, args, kwargs)
        if want_buf:
            return {"value": v, "buf": self._buf_payload(acc)}
        return v

    def _op_apply_log(self, txn: str, name: str,
                      entries: List[tuple]) -> None:
        acc = self._acc(txn, name)
        self._check_valid(acc)
        acc.log.entries = list(entries)
        acc.apply_log()

    def _op_buffer_snapshot(self, txn: str, name: str) -> Optional[bytes]:
        acc = self._acc(txn, name)
        acc.snapshot_buf()
        return self._buf_payload(acc)

    def _op_snap_release(self, txn: str, name: str) -> None:
        """§2.8.3-4 release point as a one-way: snapshot for trailing
        reads, then release. The buffer stays home; the client's first
        trailing read fetches it via ``buf_call(want_buf=True)``."""
        acc = self._acc(txn, name)
        acc.snapshot_buf()
        acc.release()

    def _op_ensure_checkpoint(self, txn: str, name: str) -> int:
        acc = self._acc(txn, name)
        with acc.lock:
            if acc.seen_instance is not None:
                return acc.seen_instance
        acc.ensure_checkpoint()
        return acc.seen_instance

    def _op_release(self, txn: str, name: str) -> None:
        self._acc(txn, name).release()

    def _op_wait_termination(self, txn: str, name: str,
                             timeout: Optional[float]) -> bool:
        return self._acc(txn, name).wait_termination(timeout)

    def _op_wait_termination_batch(self, txn: str, names: List[str],
                                   timeout: Optional[float],
                                   best_effort: bool = False) -> int:
        """Commit step 2 for this node's batch: one RPC, one server thread
        parked on the slowest commit condition. Returns how many of the
        waits actually blocked (the client's ``waits`` statistic). The
        batch semantics (best-effort continuation) are the base class's —
        session accesses ARE ObjectAccess records."""
        accs = [self._acc(txn, n) for n in names]
        if not accs:
            return 0
        return accs[0].wait_termination_batch_async(
            accs, timeout, best_effort=best_effort).result()

    def _op_validate(self, txn: str, names: List[str]) -> List[str]:
        """Commit step 4, batched per node: names whose instance moved."""
        return [name for name in names if not self._acc(txn, name).valid()]

    def _lazy_commute_acc(self, txn: str, client_id: Optional[str],
                          name: str, cls: str) -> _ServerAccess:
        """Get-or-create the access record for a late commute join (§12).

        A commute-only single-domain transaction skips the dispense RPC
        entirely (coordination avoidance): its session and access are
        created lazily at the first ``commute_delta`` one-way or at
        ``commit_solo``. Joining the group needs no 2PL window — one
        object, one domain — so the dispense gate is taken only for the
        join itself (serializing with migration drains) and released
        immediately. When the group cannot be joined the access falls back
        to exact dispensing: a late start on a single node, gated like any
        newcomer behind the chain it joined late."""
        with self._lock:
            session = self._sessions.get(txn)
            if session is None:
                session = self._sessions[txn] = _Session(
                    txn, client_id or txn, now=self._clock())
        session.last_contact = self._clock()
        shared = self._shared(name)
        with session.lock:
            acc = session._accesses.get(shared)
        if acc is not None:
            return acc
        with self._lock:
            gate = self._gates.setdefault(name, threading.Lock())
        self._gate_acquire(gate)
        try:
            while True:
                rearm = None
                with shared.header.lock:
                    ev = self._migrating.get(name)
                    if ev is None:
                        try:
                            self.leases.check_grant(name)
                            joined = bool(
                                pv := shared.header.commute_join(cls))
                            if not joined:
                                pv = shared.header.dispense()
                            break
                        except LeaseRearming as e:
                            rearm = e.event
                blocking_wait(rearm if rearm is not None else ev,
                              self.leases.ttl if rearm is not None else None)
        finally:
            gate.release()
        acc = (_ServerCommuteAccess(self, session, shared, pv, cls)
               if joined else
               _ServerAccess(self, session, shared, pv))
        with session.lock:
            session._accesses[shared] = acc
        # §3.4 re-check, mirroring dispense_batch: a session expired while
        # we were parked above must not leave a ghost version behind.
        if session.expired:
            if isinstance(acc, _ServerCommuteAccess):
                acc.commute_depart()
            else:
                skip_version(shared.header, pv)
            raise InstanceInvalidated(
                f"transaction {txn!r} crash-stopped during its late "
                f"commute join on {name!r} (§3.4)")
        return acc

    def _op_commute_delta(self, txn: str, client_id: str, name: str,
                          cls: str, entries: List[tuple]) -> None:
        """One flushed batch of commuting deltas, shipped as a one-way
        ahead of commit (§12). Buffered on the access — NEVER applied here:
        the fold waits for the commit decision (terminate). Arrives on the
        client's FIFO connection, so buffer order == issue order, and the
        commit RPC that follows it can never overtake."""
        acc = self._lazy_commute_acc(txn, client_id, name, cls)
        with acc.lock:
            acc.oneway_entries.extend(entries)
        self.n_commute_oneways += len(entries)

    def _op_commit_wave1(self, txn: str, items: List[tuple],
                         timeout: Optional[float],
                         origin: Optional[str] = None) -> Dict[str, Any]:
        """Commit steps 2-4 for this node's whole batch in one RPC: wait
        the commit condition per object, checkpoint/apply/release per
        object, then validate the batch. ``items`` is ``[(name, log
        entries), ...]``. Termination (step 5) is deliberately NOT here —
        it must wait for every node's validation verdict. ``origin`` names
        the chained commit's coordinator (None outside a chain): tentative
        replication ships it so a promoting follower knows whom to ask."""
        # Lease fence (§10): a primary that lost its lease must not apply
        # commits — the promoted follower's epoch owns the object now. The
        # abort/rollback paths deliberately stay fence-free (converging
        # versions must always work, or survivors wedge).
        for name, _entries in items:
            self._check_grant_blocking(name)
        blocked = 0
        for name, _entries in items:
            if self._acc(txn, name).wait_termination(timeout):
                blocked += 1
        for name, entries in items:
            acc = self._acc(txn, name)
            acc.absorb_entries(entries)
            acc.repl_origin = origin
            acc.commit_prep()
        bad = [name for name, _e in items
               if not self._acc(txn, name).valid()]
        return {"blocked": blocked, "bad": bad}

    def _op_commit_solo(self, txn: str, items: List[tuple],
                        timeout: Optional[float],
                        client_id: Optional[str] = None,
                        commute: Optional[Dict[str, str]] = None,
                        commute_counts: Optional[Dict[str, int]] = None
                        ) -> Dict[str, Any]:
        """Steps 2-5 of a single-domain commit in one RPC: this node holds
        the whole access set, so its validation verdict alone decides
        termination, and the session ends with it.

        ``commute`` maps commute-declared access names to their method
        class (§12): a deferred-start transaction (commute-only, single
        domain) never dispensed, so its accesses are created here — the
        late group join IS its start. Names already dispensed come back
        from :meth:`_lazy_commute_acc` unchanged."""
        if commute:
            for name, cls in commute.items():
                self._lazy_commute_acc(txn, client_id, name, cls)
        if commute_counts:
            # Torn-delta fence: every delta the client recorded must be
            # here (one-way flushes + commit-riding remainder) or the fold
            # would commit a partial effect set — possible only when an
            # illusory-crash expiry discarded the flushed prefix before
            # this commit lazily re-created the session. Abort instead.
            by_name = dict(items)
            for name, total in commute_counts.items():
                acc = self._acc(txn, name)
                with acc.lock:
                    got = (len(acc.oneway_entries)
                           + len(by_name.get(name) or ()))
                if got != total:
                    raise InstanceInvalidated(
                        f"commute delta set on {name!r} is torn "
                        f"({got}/{total} deltas reached the home node); "
                        f"transaction {txn!r} must abort")
        res = self._op_commit_wave1(txn, items, timeout)
        if not res["bad"]:
            self._op_finish_batch(txn, [n for n, _e in items], end=True)
        return res

    # -- chained commit decision (DESIGN.md §8) ------------------------------
    def _op_commit_wave(self, txn: str, items: List[tuple],
                        timeout: Optional[float] = None,
                        chain: List[dict] = (),
                        origin: Optional[str] = None) -> Dict[str, Any]:
        """One hop of the chained commit wave: steps 2-4 for this node,
        then forward the remaining per-node batches server-to-server. A
        bad verdict short-circuits (no decision can follow, so running the
        remaining waves buys nothing — the client's abort path converges
        every node either way). A dead downstream node raises back along
        the chain to the coordinator, which surfaces it to the client."""
        res = self._op_commit_wave1(txn, items, timeout, origin=origin)
        blocked, bad = res["blocked"], list(res["bad"])
        if not bad and chain:
            nxt, rest = chain[0], list(chain[1:])
            sub = self._peer(nxt["address"]).call(
                "commit_wave", txn=txn, items=nxt["items"], timeout=timeout,
                chain=rest, origin=origin)
            blocked += sub["blocked"]
            bad.extend(sub["bad"])
        return {"blocked": blocked, "bad": bad}

    def _op_commit_chain(self, txn: str, items: List[tuple],
                         timeout: Optional[float] = None,
                         chain: List[dict] = ()) -> Dict[str, Any]:
        """The coordinator end of the chained multi-domain commit: ONE
        client RPC covers steps 2-5 for *every* remote domain.

        This node (first in global domain order) runs its own wave, chains
        the remaining waves server-to-server, and — iff every domain
        validated — makes the commit decision *here*, not at the client:
        record it, replicate it to this node's own followers (with the
        remaining decision chain, so the decision survives this node), then
        terminate locally and drive the decision chain. The client merely
        learns the outcome; its crash after send can no longer leave a
        partially terminated commit (the §3.4 step-5 window, now CLOSED).
        """
        res = self._op_commit_wave(txn, items, timeout=timeout, chain=chain,
                                   origin=self.address)
        if res["bad"]:
            return {"blocked": res["blocked"], "bad": res["bad"],
                    "decided": False}
        decision_chain = [{"address": e["address"],
                           "names": [n for n, _e in e["items"]],
                           "followers": e.get("followers") or {}}
                          for e in chain]
        self.replication.record_decision(txn, "commit", decision_chain)
        self.replication.broadcast_decision(txn, decision_chain)
        try:
            self._op_finish_batch(txn, [n for n, _e in items],
                                  best_effort=True, end=True)
        except TransactionError as e:
            # A §3.4 expiry raced the decision (detector timeout ≪ commit
            # latency — misconfiguration): epochs keep state consistent,
            # the commit still drives to completion everywhere else.
            log.warning("coordinator-local finish failed for %r: %r", txn, e)
        self._drive_decision(txn, decision_chain)
        self.replication.mark_ended(txn)   # ledger GC: retirable once acked
        return {"blocked": res["blocked"], "bad": [], "decided": True}

    def _op_commit_decide(self, txn: str, names: List[str],
                          followers: Optional[Dict[str, List[str]]] = None,
                          chain: List[dict] = ()) -> Dict[str, Any]:
        """One hop of the chained commit *decision* (step 5): record the
        decision (idempotent, first-writer-wins), finish the local batch if
        this node holds the session (primary path) — a follower that was
        promoted mid-commit instead applies its buffered tentatives via the
        decision ledger — and forward one hop. An unreachable downstream
        node is reported back to the driver as ``failed_chain`` for
        redirection to that node's followers."""
        self.replication.record_decision(txn, "commit")
        with self._lock:
            has_session = txn in self._sessions
        # A redirect can land here with a *dead* node's names while this
        # node holds a live session for the same txn (it was a participant
        # domain too): finish only names actually bound here, and keep the
        # session open unless this hop covers its own full batch — the
        # node's own decide hop is still in flight.
        local = [n for n in names if self.has_binding(n)]
        if has_session and local:
            try:
                self._op_finish_batch(txn, local, best_effort=True,
                                      end=len(local) == len(names))
            except TransactionError as e:
                log.warning("decision finish failed for %r on %s: %r",
                            txn, self.node_name, e)
        if not chain:
            return {}
        nxt, rest = chain[0], list(chain[1:])
        try:
            sub = self._peer(nxt["address"]).call(
                "commit_decide", txn=txn, names=nxt["names"],
                followers=nxt.get("followers"), chain=rest) or {}
        except Exception:  # noqa: BLE001 - downstream node died mid-chain
            return {"failed_chain": [dict(e) for e in chain]}
        if sub.get("failed_chain"):
            return {"failed_chain": sub["failed_chain"]}
        return {}

    def _drive_decision(self, txn: str, chain: List[dict]) -> None:
        """Drive the commit decision down the chain, redirecting around
        dead nodes: when a hop fails, the failed entry's names get the
        decision delivered directly to their replica followers (idempotent
        — the ledger is first-writer-wins) and the drive continues with the
        rest of the chain. Best-effort by design: every alive node with a
        stake in ``txn`` ends up with the decision; names whose primary
        died with no replica configured die with it (documented residual).
        """
        chain = [dict(e) for e in chain]
        for _ in range(len(chain) + 4):
            if not chain:
                return
            nxt, rest = chain[0], chain[1:]
            try:
                sub = self._peer(nxt["address"]).call(
                    "commit_decide", txn=txn, names=nxt["names"],
                    followers=nxt.get("followers"), chain=rest) or {}
                failed = sub.get("failed_chain")
            except Exception:  # noqa: BLE001 - first hop died
                failed = chain
            if not failed:
                return
            entry, chain = dict(failed[0]), [dict(e) for e in failed[1:]]
            self._redirect_decision(txn, entry)
        log.warning("decision drive for %r did not converge", txn)

    def _redirect_decision(self, txn: str, entry: Dict[str, Any]) -> None:
        """Deliver the commit decision for a dead node's names to their
        replica followers, first-alive-in-order (the same order every
        client's failover uses, so primaries converge deterministically)."""
        followers = entry.get("followers") or {}
        for name in entry["names"]:
            fl = list(followers.get(name) or ())
            for addr in fl:
                try:
                    self._peer(addr).call(
                        "commit_decide", txn=txn, names=[name],
                        followers={name: fl}, chain=[])
                    break
                except Exception:  # noqa: BLE001 - try the next follower
                    continue
            else:
                log.warning("commit decision for %r undeliverable for %r "
                            "(primary dead, no live replica)", txn, name)

    def _op_rollback(self, txn: str, name: str) -> None:
        acc = self._acc(txn, name)
        acc.mark_aborted()     # a stale commit wave must not apply after us
        acc.rollback()
        self.replication.on_abort(txn, name)

    def _op_rollback_batch(self, txn: str, names: List[str]) -> None:
        for name in names:
            acc = self._acc(txn, name)
            acc.mark_aborted()
            acc.rollback()
            self.replication.on_abort(txn, name)

    def _op_terminate(self, txn: str, name: str) -> None:
        acc = self._acc(txn, name)
        acc.terminate()
        with acc.lock:
            acc.released = True
        self.replication.on_terminate(txn, name)

    def _op_finish_batch(self, txn: str, names: List[str],
                         best_effort: bool = False,
                         end: bool = False) -> None:
        """Commit step 5 / abort step 4 for this node's batch: release and
        terminate every named access. ``end`` additionally drops the
        session (folds the trailing ``end_txn`` message into this RPC).
        ``best_effort`` keeps finishing past a dead access but still
        reports the first failure afterwards — on the one-way commit path
        that becomes an ``oneway_err`` note, so a terminate racing a §3.4
        expiry is at least visible at the client."""
        first_error: Optional[BaseException] = None
        for name in names:
            try:
                acc = self._acc(txn, name)
                acc.release()
                acc.terminate()
                with acc.lock:
                    acc.released = True
                self.replication.on_terminate(txn, name)
            except TransactionError as e:
                if not best_effort:
                    raise
                if first_error is None:
                    first_error = e
        if end:
            self._op_end_txn(txn)
        if first_error is not None:
            raise first_error

    # -- liveness ------------------------------------------------------------
    def _op_touch(self, txn: str, name: str) -> None:
        session = self._session(txn)
        self._shared(name).touch(session)

    def _op_clear_holder(self, txn: str, name: str) -> None:
        session = self._session(txn)
        self._shared(name).clear_holder(session)

    def _op_heartbeat(self, client_id: str, txns: List[str]) -> None:
        now = self._clock()
        for uid in txns:
            with self._lock:
                session = self._sessions.get(uid)
            if session is None:
                continue
            session.last_contact = now
            with session.lock:
                accesses = list(session._accesses.items())
            for shared, acc in accesses:
                # Refresh the failure detector for every object this live
                # session still nominally holds — including released-but-
                # unterminated ones (their last_contact would otherwise
                # freeze while the client blocks in commit, and the object
                # monitor would spuriously roll a *live* client back).
                with shared._contact_lock:
                    if shared.holding_txn is session:
                        shared.last_contact = now

    def _op_end_txn(self, txn: str) -> None:
        with self._lock:
            session = self._sessions.pop(txn, None)
        if session is None:
            return
        with session.lock:
            unterminated = any(not acc.terminated
                               for acc in session._accesses.values())
        if unterminated:
            # Ending a session that still owns live versions (e.g. the
            # client closed out after a partially-failed chained start it
            # never learned the versions of): run the §3.4 self-rollback
            # so the dispensed versions are skipped, not leaked — a leaked
            # version wedges every successor forever.
            self._expire_session(session)
        else:
            # A dispense handler for this very transaction may still be
            # parked on a gate (chained start whose head node died before
            # this close-out arrived): flag the popped session so the
            # handler's post-gate re-check skips whatever it dispenses
            # into it — otherwise those gates and versions leak in a
            # ghost session no reaper ever visits.
            session.expired = True
            self._release_gates(session)
        # Quiet point: queued affinity-triggered handoffs start now, off
        # the op path (the drain would stall this reply otherwise).
        self._drain_migrations()

    def _op_abandon(self, txn: str) -> None:
        """Failed-start cleanup: expire the session now (chain-order skip
        of its dispensed versions; nothing was accessed, so no restores)."""
        with self._lock:
            session = self._sessions.pop(txn, None)
        if session is not None:
            self._expire_session(session)

    # -- replica chains + failover (DESIGN.md §8) ----------------------------
    def _op_repl_init(self, **kw: Any) -> None:
        self.replication.repl_init(**kw)

    def _op_repl_apply(self, **kw: Any) -> None:
        self.replication.repl_apply(**kw)

    def _op_repl_final(self, **kw: Any) -> None:
        self.replication.repl_final(**kw)

    def _op_repl_drop(self, **kw: Any) -> None:
        self.replication.repl_drop(**kw)

    def _op_repl_decision(self, **kw: Any) -> None:
        self.replication.repl_decision(**kw)

    def _op_promote(self, names: List[str]) -> Dict[str, List[str]]:
        """Caller-driven failover: try to become primary for ``names``
        (idempotent). See :meth:`ReplicationManager.promote`."""
        return self.replication.promote(list(names))

    # -- restart protocol (§11) ----------------------------------------------
    def _op_chain_probe(self, name: str) -> Dict[str, Any]:
        """A restarting node asks: what is ``name`` to you, right now?
        Pure read — primaries report their chain, followers their record,
        tombstones their redirect. The prober folds the answers into the
        §11 recovery decision (rejoin / drive promotion / resurrect)."""
        # tombstone first: a deposed primary may briefly keep its stale
        # binding while the demotion drain runs — it is NOT the primary
        m = self.leases.moved.get(name)
        if m is not None:
            return {"role": "moved", "target": m[0], "epoch": m[1]}
        if self.has_binding(name):
            return {"role": "primary",
                    "epoch": self.replication.epochs.get(name, 0),
                    "order": self.replication.followers_of(name)}
        rec = self.replication.replicas.get(name)
        if rec is not None:
            return {"role": "follower", "epoch": rec.applied[0],
                    "primary": rec.primary, "order": list(rec.order),
                    "promoted": rec.promoted,
                    "recovering": rec.recovering}
        w = self._recovered
        if w is not None and name in w.objects \
                and w.objects[name].get("role") == "primary":
            # Restarted, not yet rebound, but the ledger says the object
            # was served HERE: answer with the claim + epoch so two
            # recovering images reconcile by epoch instead of both
            # resurrecting (§11).
            return {"role": "recovering-primary",
                    "epoch": w.objects[name]["epoch"]}
        return {"role": "none"}

    def _op_repl_rejoin(self, name: str, addr: str) -> Dict[str, Any]:
        """Primary side of a restarted node's chain rejoin (§11): run the
        same drain-barrier as a migration — after quiescence there are no
        in-flight versions and no undecided tentatives, so the snapshot
        handed to the rejoiner is exactly the committed state (a live
        object may hold uncommitted in-place writes; snapshotting without
        the drain would bake aborted writes into the new tail)."""
        try:
            shared = self._shared(name)
        except KeyError:
            return {"busy": False}      # not primary here: re-probe
        if shared.node is not self.node:
            return {"busy": False}
        # An idle primary's lease re-arms on first touch (§10): wait the
        # re-ack round out here — every retry would lapse it afresh and
        # bounce busy forever on a quiet chain.
        self._check_grant_blocking(name)
        h = shared.header
        ev = threading.Event()
        with h.lock:
            if name in self._migrating:
                return {"busy": True}
            try:
                self.leases.check_grant(name)
            except LeaseRearming:
                return {"busy": True}   # raced a fresh lapse: retry
            self._migrating[name] = ev
        try:
            if not wait_quiescent(h, timeout=5 * self.leases.ttl):
                return {"busy": True}   # drain never settled: retry later
            payload = pickle.dumps(shared.holder.obj,
                                   protocol=pickle.HIGHEST_PROTOCOL)
            # the rejoiner may have been written off mid-outage: renewal
            # rounds must start reaching it again
            self.leases.departed.discard(addr)
            return self.replication.rejoin_accept(name, addr, payload)
        finally:
            with h.lock:
                self._migrating.pop(name, None)
            ev.set()

    def _op_repl_chain(self, **kw: Any) -> None:
        self.replication.repl_chain(**kw)

    # -- leases + ownership migration (§10) -----------------------------------
    def _op_lease_renew(self, name: str, epoch: int, ttl: float,
                        primary: str) -> None:
        self.leases.on_renew(name, epoch, ttl, primary)

    def _op_lease_ack(self, name: str, epoch: int, ok: bool, cur_epoch: int,
                      node: str) -> None:
        self.leases.on_ack(name, epoch, ok, cur_epoch, node)

    def _op_lease_grant(self, name: str, epoch: int, primary: str) -> bool:
        return self.leases.on_grant(name, epoch, primary)

    def _op_lease_acquire(self, names: List[str]) -> Dict[str, List[str]]:
        """Lease-based takeover (§10): ``ensure_primary``'s server half.

        Refuses *busy* while the current primary's promise is still live
        (it self-fences before the promise lapses — waiting it out is what
        makes the takeover split-brain free); then promotes through the
        replication state machine (which grants the local lease at the new
        epoch) and collects the quorum-of-chain acknowledgement with
        synchronous ``lease_grant`` calls to the remaining followers."""
        busy: List[str] = []
        for n in names:
            if self.has_binding(n):
                continue
            p = self.leases.promised_primary(n)
            if p is None:
                continue
            if self._provably_dead(p):
                # Crash-stop fast path: a *refused* connection means the
                # promised primary's process is gone for good — void the
                # promise instead of waiting out a TTL that can never be
                # exercised again.
                self.leases.void_promise(n, p)
            else:
                busy.append(n)
        if busy:
            return {"promoted": [], "busy": busy}
        res = self.replication.promote(list(names))
        for name in list(res["promoted"]):
            epoch = self.replication.epochs.get(name, 0)
            for addr in self.replication.followers_of(name):
                try:
                    ok = self._peer(addr).call(
                        "lease_grant", name=name, epoch=epoch,
                        primary=self.address)
                except Exception:  # noqa: BLE001 - dead follower: departs
                    self.leases.departed.add(addr)
                    continue
                if not ok:
                    # the follower knows a successor epoch: our promotion
                    # was stale — fence it permanently and report busy so
                    # the caller re-resolves.
                    self.leases.on_ack(name, epoch, ok=False,
                                       cur_epoch=epoch + 1, node=addr)
                    res["promoted"].remove(name)
                    res["busy"].append(name)
                    break
        return res

    def _provably_dead(self, address: str) -> bool:
        """Probe a promised primary before honoring its promise. Only a
        *synchronously refused* connection is proof of death (crash-stop:
        the process is gone and never returns). A ping reply means alive;
        silence, a reset, or any in-flight failure could be a partition —
        then the promise must be waited out (§10 split-brain freedom)."""
        try:
            fut = self._peer(address).call_async("ping")
        except Exception:  # noqa: BLE001 - refused at connect/send: dead
            return True
        try:
            fut.result(timeout=max(2 * self.leases.ttl, 0.05))
        except Exception:  # noqa: BLE001 - ambiguous: treat as alive
            return False
        return False

    def _op_migrate(self, name: str, target: str) -> bool:
        """Forced lease handoff (admin/benchmarks/sweeps): synchronous —
        the reply means the drain-barrier completed one way or the other."""
        return self._do_migrate(name, target)

    def _op_migrate_in(self, name: str, payload: bytes, epoch: int,
                       followers: List[str]) -> bool:
        """Target side of the §10 handoff: bind the shipped state under a
        fresh header, adopt the chain at the shipped epoch, take the lease.
        Idempotent — a retried handoff finds the binding already here."""
        if not self.has_binding(name):
            self.bind_local(name, pickle.loads(payload))
        self.replication.adopt(name, list(followers), epoch, payload)
        self.leases.grant_local(name, epoch)
        return True

    def _op_repl_decision_ack(self, **kw: Any) -> None:
        self.replication.repl_decision_ack(**kw)

    def _op_repl_retire(self, **kw: Any) -> None:
        self.replication.repl_retire(**kw)

    def _op_txn_status(self, txn: str) -> str:
        """The coordinator's decision memo, queried by a promoting
        follower before it dooms an undecided tentative: ``commit`` /
        ``abort`` (decided), ``pending`` (session still live here — the
        decision is coming; retry), or ``none`` (never heard of it, or
        already expired without deciding: dooming is safe)."""
        d = self.replication.decision_of(txn)
        if d is not None:
            return d
        with self._lock:
            live = txn in self._sessions
        return "pending" if live else "none"

    def _op_txn_decision(self, txn: str) -> str:
        """A recovering client (its coordinator died mid-commit) asks a
        follower of the coordinator for the transaction's fate. ``commit``
        additionally re-drives the recorded decision chain so every
        surviving participant terminates; no recorded decision dooms the
        transaction to abort (first-writer-wins). Before dooming, consult
        the coordinator's own ledger if we can still name it (§11): the
        coordinator may have restarted since the client's RPC failed, and
        its replayed WAL is then the only durable copy of a ``commit``
        that was never broadcast — seeding an abort here without looking
        would split the decision across ledgers."""
        if self.replication.decision_of(txn) is None:
            head = self.replication.head_of(txn)
            if head is None and self._recovered is not None:
                # live replica buffers may already have been replaced by
                # the restarted chain's repl_init (which clears them) —
                # our own replayed WAL image still names the coordinator
                for (t, _n), tt in self._recovered.pending.items():
                    if t == txn:
                        head = tt[3]
                        break
            if head and head != self.address and \
                    self.replication._query_head(head, txn) == "commit":
                self.replication.record_decision(txn, "commit")
        d, chain = self.replication.txn_decision(txn)
        if d == "commit" and chain:
            self._drive_decision(txn, chain)
        return d

    # -- introspection / control (tests, benchmarks) -------------------------
    def _op_stats(self) -> Dict[str, Any]:
        with self._lock:
            sessions = len(self._sessions)
        return {"node": self.node_name, "sessions": sessions,
                "rollbacks": list(self.monitor.rollbacks),
                "repl_sent": self.replication.n_sent,
                "leases": self.leases.stats(),
                "ledger": self.replication.ledger_stats(),
                "migrations": self.n_migrations,
                "wal_appends": 0 if self.wal is None else self.wal.n_appends,
                "wal_syncs": 0 if self.wal is None else self.wal.n_syncs,
                "merged_deltas": self.n_merged_deltas,
                "commute_oneways": self.n_commute_oneways,
                "metrics": self.obs_metrics.snapshot()}

    def _op_trace_dump(self, reset: bool = False) -> List[dict]:
        """Pull this node's trace ring (merged-export collection for TCP
        topologies, where the rings live in the server process). Issued
        only by explicit trace exports — never on the bench hot path."""
        evs = self.obs_tracer.events()
        if reset:
            self.obs_tracer.reset()
        return evs



class NodeServer(NodeCore):
    """One registry node served over TCP (the real-wire transport).

    Adds to :class:`NodeCore` everything socket-shaped: the listener and
    per-connection reader threads, the multiplexed framed protocol
    (requests / one-ways / replies / pushes), the grow-on-demand worker
    pool for potentially-blocking ops with the uncontended inline fast
    paths, the non-blocking note pusher, and the real-time session reaper.
    """

    #: Ops that may block (version gates, dispensing 2PL, task joins) or
    #: burn service time (object methods, log application): each gets its
    #: own thread so a parked RPC never stalls the multiplexed connection.
    #: Unknown ops are threaded too — blocking is the conservative guess.
    _INLINE_OPS = frozenset({
        "ping", "list_bindings", "mode_of", "header_state", "header_release",
        "header_terminate", "validate", "release", "terminate",
        "finish_batch", "rollback_batch", "end_txn", "release_version_locks",
        "ensure_checkpoint", "buffer_snapshot", "snap_release", "stats",
        "touch", "clear_holder", "heartbeat", "abandon", "ro_buffer",
        "lw_apply", "repl_init", "repl_apply", "repl_final", "repl_drop",
        "repl_decision", "repl_decision_ack", "repl_retire", "txn_status",
        "lease_renew", "lease_ack", "lease_grant", "migrate_in",
        "chain_probe", "repl_chain", "commute_classes",
    })

    #: wire v3 ships bulk payloads as out-of-band segments.
    _oob = staticmethod(oob)

    def __init__(self, node_name: str = "node0", host: str = "127.0.0.1",
                 port: int = 0, *, registry: Optional[Registry] = None,
                 monitor_timeout: float = 2.0, monitor_poll: float = 0.05,
                 executor_workers: int = 1, wal_dir: Optional[str] = None):
        # durability is strictly opt-in over TCP (--wal-dir): without it
        # the hot path is byte-for-byte the pre-§11 one
        wal = (Wal(FileStorage(os.path.join(wal_dir, f"{node_name}.wal")))
               if wal_dir else None)
        super().__init__(node_name, registry=registry,
                         monitor_timeout=monitor_timeout,
                         monitor_poll=monitor_poll,
                         executor_workers=executor_workers, wal=wal)
        self._pool = _WorkerPool(name=f"op-{node_name}")
        self._note_q: "queue.SimpleQueue" = queue.SimpleQueue()
        threading.Thread(target=self._pusher_loop,
                         name=f"note-pusher-{node_name}",
                         daemon=True).start()
        self._costs: Dict[str, float] = {}      # per-object service-time EWMA
        self._mux: Dict[str, List[_Conn]] = {}          # client_id -> conns
        self._conns: set = set()                        # live connections
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ #
    # lifecycle                                                           #
    # ------------------------------------------------------------------ #
    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def start(self) -> "NodeServer":
        self._listener.listen(128)
        self.monitor.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"accept-{self.port}", daemon=True)
        self._accept_thread.start()
        threading.Thread(target=self._reaper_loop, name="session-reaper",
                         daemon=True).start()
        if self._recovered is not None and self._recovered.objects:
            # networked half of the restart (§11): probe, rejoin, or
            # resurrect — off the accept path, once the listener is up
            threading.Thread(target=self.rejoin_chains,
                             name=f"rejoin-{self.node_name}",
                             daemon=True).start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:   # crash-stop for connected peers (embedded servers)
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self.monitor.stop()
        self._pool.stop()
        self._note_q.put(None)
        with self._lock:
            peers = list(self._peers.values())
            self._peers.clear()
        for p in peers:
            p.close()
        self.registry.shutdown()

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.wait(0.2):
                pass
        except KeyboardInterrupt:  # pragma: no cover
            pass
        finally:
            self.stop()

    # ------------------------------------------------------------------ #
    # TCP connection handling (NodeServer)                                 #
    # ------------------------------------------------------------------ #
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _addr = self._listener.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(sock,),
                             name="conn", daemon=True).start()

    def _serve_conn(self, sock: socket.socket) -> None:
        conn = _Conn(sock)
        reader = FrameReader(sock)
        # This thread multiplexes many conversations: tasks woken by the
        # counter advances of its inline ops run on the executor, never
        # here (foreign service time must not stall the link).
        defer_wake_inline()
        with self._lock:
            self._conns.add(sock)
        try:
            while not self._stop.is_set():
                try:
                    req_id, op, kw = reader.recv_msg()
                except (ConnectionClosed, WireError, OSError):
                    break
                if op == "mux_hello":
                    # The mux connection doubles as the §3.4 presence
                    # signal: its drop means this client process died.
                    conn.client_id = kw["client_id"]
                    with self._lock:
                        self._mux.setdefault(conn.client_id, []).append(conn)
                    try:
                        self._send_reply(conn, req_id, OK, None)
                    except (ConnectionClosed, OSError):
                        break
                    continue
                if op in self._CONN_OPS:
                    kw = dict(kw, _conn=conn)   # push notes return this way
                if req_id is None:
                    # One-way: execute inline (FIFO vs later requests on
                    # this connection); failures become deferred-error
                    # notes pushed back to the sender.
                    self._handle_oneway(conn, op, kw)
                elif op in self._INLINE_OPS:
                    if not self._handle_request(conn, req_id, op, kw):
                        break
                elif self._try_fast(conn, req_id, op, kw):
                    pass   # handled inline (uncontended fast path)
                else:
                    self._pool.submit(
                        lambda c=conn, r=req_id, o=op, k=kw:
                        self._handle_timed(c, r, o, k))
        finally:
            with self._lock:
                self._conns.discard(sock)
                last_of_client = False
                if conn.client_id is not None:
                    conns = self._mux.get(conn.client_id, [])
                    if conn in conns:
                        conns.remove(conn)
                    if not conns:
                        self._mux.pop(conn.client_id, None)
                        last_of_client = True
            try:
                sock.close()
            except OSError:
                pass
            if last_of_client:
                self._client_vanished(conn.client_id)

    def _handle_request(self, conn: _Conn, req_id: int, op: str,
                        kw: Dict[str, Any]) -> bool:
        try:
            value = self._dispatch(op, kw)
            status = OK
        except BaseException as e:  # noqa: BLE001 - serialize to peer
            status, value = ERR, encode_error(e)
        try:
            self._send_reply(conn, req_id, status, value)
        except (ConnectionClosed, OSError):
            # The reader (or another worker) will observe the broken socket;
            # make sure it does even if it is parked in recv.
            try:
                conn.sock.close()
            except OSError:
                pass
            return False
        return True

    #: EWMA of per-call service time above which an object's method calls
    #: are dispatched to the worker pool instead of inline on the reader:
    #: genuinely compute-bearing CF methods (the paper models ~3 ms) must
    #: not stall the multiplexed link, but the two thread handoffs of a
    #: pool dispatch dominate the cost of a *quick* method by an order of
    #: magnitude — and for a sub-millisecond method the stall is no worse
    #: than the handoff it replaces. Wall-clock EWMAs on a loaded host
    #: include scheduler noise, so the threshold is deliberately generous.
    INLINE_SLOW_S = 0.002

    def _note_cost(self, name: Optional[str], dt: float) -> None:
        if name is not None:
            old = self._costs.get(name, dt)
            self._costs[name] = 0.7 * old + 0.3 * dt

    def _fast_call(self, conn: _Conn, req_id: int, op: str,
                   kw: Dict[str, Any], weight: int = 1) -> bool:
        """Inline a non-blocking method-bearing op on the reader when the
        object's observed service time says it is quick (optimistically
        inline at first sight; a slow object is learned once and pooled
        thereafter). ``weight`` scales the estimate for batches."""
        name = kw.get("name")
        if self._costs.get(name, 0.0) * weight > self.INLINE_SLOW_S:
            return False
        t0 = time.perf_counter()
        self._handle_request(conn, req_id, op, kw)
        self._note_cost(name, (time.perf_counter() - t0) / max(weight, 1))
        return True

    def _open_ready(self, txn: str, name: str, kind: str) -> bool:
        """True iff the §2.8.2 open would not block: the access (or
        termination) gate is already open for this session's pv.
        (Monotonic counters: once true, stays true.) Errors — no session,
        unknown object — return True: raising is quick, do it inline."""
        try:
            acc = self._acc(txn, name)
        except BaseException:  # noqa: BLE001 - error replies are cheap
            return True
        h = acc.shared.header
        with h.lock:
            done = h.ltv if kind == "termination" else h.lv
            return done >= acc.pv - 1

    #: Pool-dispatched ops whose duration still feeds the service-time
    #: EWMA, so a transiently-inflated estimate (scheduler noise) decays
    #: back under the inline threshold instead of sticking forever.
    #: ``open_call`` is deliberately absent: its pooled duration includes
    #: the gate *wait*, which is contention, not service time.
    _COST_OPS = frozenset({"txn_call", "buf_call", "raw_call",
                           "txn_call_batch"})

    def _handle_timed(self, conn: _Conn, req_id: int, op: str,
                      kw: Dict[str, Any]) -> bool:
        if op not in self._COST_OPS:
            return self._handle_request(conn, req_id, op, kw)
        weight = 1
        if op == "txn_call_batch":
            weight = len(kw.get("calls") or ()) or 1
        t0 = time.perf_counter()
        handled = self._handle_request(conn, req_id, op, kw)
        self._note_cost(kw.get("name"), (time.perf_counter() - t0) / weight)
        return handled

    def _try_fast(self, conn: _Conn, req_id: int, op: str,
                  kw: Dict[str, Any]) -> bool:
        """Uncontended fast paths for normally-threaded ops: when the op
        provably won't block (gates free, commit conditions already open,
        no logs to burn service time on), run it inline on the reader and
        skip two thread handoffs. Contention falls back to the pool.

        Inline work here may include bounded state *snapshots* (§2.7
        buffers, commit checkpoints) — the same class of work the
        ``buffer_snapshot``/``snap_release`` inline ops already do on the
        reader — and, new in v3, *method calls on objects whose measured
        service time is quick* (the EWMA guard of :meth:`_fast_call`):
        the common zero-to-cheap-compute call answers on the reader with
        zero server-side handoffs, while compute-bearing objects keep the
        pool. Gate-blocking opens fall back unless the gate is provably
        open (:meth:`_open_ready`)."""
        if op in ("txn_call", "buf_call", "raw_call"):
            return self._fast_call(conn, req_id, op, kw)
        if op == "txn_call_batch":
            return self._fast_call(conn, req_id, op, kw,
                                   weight=len(kw.get("calls") or ()) or 1)
        if op == "open_call" and not kw.get("entries"):
            if self._open_ready(kw["txn"], kw["name"], kw.get("kind",
                                                             "access")):
                return self._fast_call(conn, req_id, op, kw,
                                       weight=1 + len(kw.get("tail") or ()))
            return False
        if op == "dispense_batch" and not kw.get("chain"):
            try:
                value, status = self._dispatch(op, dict(kw, _nb=True)), OK
            except _WouldBlock:
                return False
            except BaseException as e:  # noqa: BLE001 - serialize to peer
                value, status = encode_error(e), ERR
            try:
                self._send_reply(conn, req_id, status, value)
            except (ConnectionClosed, OSError):
                try:
                    conn.sock.close()
                except OSError:
                    pass
            return True
        if op in ("commit_wave1", "commit_solo"):
            if self._wave1_ready(kw.get("txn"), kw.get("items", ())):
                self._handle_request(conn, req_id, op, kw)
                return True
        return False

    def _wave1_ready(self, txn: str, items: List[tuple]) -> bool:
        """True iff commit steps 2-4 would run without blocking or service
        time: every commit condition already holds and no stray write log
        needs applying. (Monotonic counters: once true, stays true.)"""
        try:
            for name, entries in items:
                if entries:
                    return False
                acc = self._acc(txn, name)
                if acc.oneway_entries:
                    return False   # §12 deltas pending: fold needs a worker
                h = acc.shared.header
                with h.lock:
                    if h.ltv < acc.pv - 1:
                        return False
            return True
        except BaseException:  # noqa: BLE001 - let the pool path raise it
            return False

    # -- sending (replies, pushes, piggybacked notes) ------------------------
    def _send_reply(self, conn: _Conn, req_id: int, status: str,
                    value: Any) -> None:
        with conn.send_lock:
            if conn.pending_out:        # a spilled push frame goes first
                conn.sock.sendall(conn.pending_out)
                conn.pending_out = b""
            notes, conn.notes = conn.notes, []
            try:
                send_msg(conn.sock, (req_id, status, value, notes))
            except (ConnectionClosed, OSError):
                raise
            except Exception as e:  # noqa: BLE001 - unpicklable OK value
                # Keep the connection: report the serialization failure
                # instead of dying (the client would mark the whole server
                # crash-stop dead).
                send_msg(conn.sock, (req_id, ERR, encode_error(e), notes))

    def _queue_note(self, conn: _Conn, note: dict) -> None:
        """Deliver a note on ``conn``: normally a direct *non-blocking*
        push (``MSG_DONTWAIT`` — the queuing thread may be another
        client's reader or the executor, and must never block on this
        client's stalled receive buffer); on a full socket buffer the
        frame's tail spills to the pusher thread, and queued notes also
        ride the next departing reply (piggyback)."""
        spill = False
        with conn.send_lock:
            if conn.pending_out:
                conn.notes.append(note)   # strict frame order: spill more
                spill = True
            else:
                data = wire_frame((None, NOTE, None, [note]))
                try:
                    sent = conn.sock.send(data, socket.MSG_DONTWAIT)
                except (BlockingIOError, InterruptedError):
                    sent = 0
                except OSError:
                    return                # conn dying: client will learn
                if sent != len(data):
                    conn.pending_out = data[sent:]
                    spill = True
        if spill:
            self._note_q.put(conn)

    def _pusher_loop(self) -> None:
        """Flushes spilled push frames and queued notes, blocking only on
        the one connection being flushed (cross-client isolation)."""
        while True:
            conn = self._note_q.get()
            if conn is None:
                return
            try:
                with conn.send_lock:
                    chunks = []
                    if conn.pending_out:
                        chunks.append(conn.pending_out)
                        conn.pending_out = b""
                    notes, conn.notes = conn.notes, []
                    if notes:
                        chunks.append(wire_frame((None, NOTE, None, notes)))
                    if chunks:
                        # spilled tail + queued notes: one vectored send
                        send_frames(conn.sock, chunks)
            except Exception:  # noqa: BLE001 - conn dying: client will learn
                pass

    def _push_target(self, conn: Optional[_Conn],
                     client_id: str) -> Optional[_Conn]:
        """The kickoff's own connection when it belongs to the end client,
        else (chain-forwarded from a peer server) any mux connection the
        end client keeps to this node."""
        if conn is not None and conn.client_id == client_id:
            return conn
        with self._lock:
            conns = self._mux.get(client_id)
            return conns[0] if conns else None

    def _reaper_loop(self) -> None:
        """Expire sessions whose client stopped heartbeating (§3.4).

        Covers clients whose mux connection outlives their heartbeats, and
        — unlike the object-level monitor — also transactions that
        dispensed versions but never *held* anything: their private
        versions must still be advanced past, or every successor wedges on
        the version chain. The staleness scan itself is
        :meth:`NodeCore.reap_stale`, shared with the simulation's
        virtual-clock reaper."""
        while not self._stop.wait(self.monitor.poll_interval):
            self.reap_stale(self._clock())

    # -- control -------------------------------------------------------------
    def _op_shutdown(self) -> None:
        threading.Thread(target=self.stop, daemon=True).start()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="node0")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--monitor-timeout", type=float, default=2.0)
    ap.add_argument("--monitor-poll", type=float, default=0.05)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--wal-dir", default=None,
                    help="directory for this node's write-ahead ledger "
                         "(§11); enables crash-restart recovery")
    ap.add_argument("--path", action="append", default=[],
                    help="extra sys.path entries (for unpickling bound "
                         "object classes); repeatable")
    ap.add_argument("--announce", action="store_true",
                    help="print 'LISTENING host:port' once bound")
    args = ap.parse_args(argv)
    for p in args.path:
        if p not in sys.path:
            sys.path.insert(0, p)
    # RPC replies ride thread wakeups (reader -> worker -> reader); the
    # default 5 ms GIL switch interval adds multi-ms convoy latency under
    # load, so run the server with a tighter interval.
    sys.setswitchinterval(0.001)
    _metrics.install_sigusr2()   # live metric dump: kill -USR2 <pid>
    server = NodeServer(args.name, args.host, args.port,
                        monitor_timeout=args.monitor_timeout,
                        monitor_poll=args.monitor_poll,
                        executor_workers=args.workers,
                        wal_dir=args.wal_dir)
    # start (and in particular listen()) BEFORE announcing: the parent
    # connects the moment it reads the line, and must not race the accept
    # loop into a connection refusal.
    server.start()
    if args.announce:
        print(f"LISTENING {server.address}", flush=True)
    try:
        while not server._stop.wait(0.2):
            pass
    except KeyboardInterrupt:  # pragma: no cover
        pass
    finally:
        server.stop()


if __name__ == "__main__":
    main()
