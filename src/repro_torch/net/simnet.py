"""Deterministic simulation transport (simnet) — DESIGN.md §7.

Runs every "node" of an N-node OptSVA-CF deployment inside ONE process
under a **virtual clock**, with a seeded scheduler owning ALL transport
nondeterminism: message delivery order and latency, one-way vs. reply
interleaving, heartbeat and failure-detector timing, and fault injection
(crash-stop a client process at any labeled protocol step, or a home node
at a chosen virtual time). FoundationDB-style: the same seed always
produces the same schedule, so a failing seed *is* a reproducible bug
report — ``trace_text()`` prints the replayable schedule.

How determinism is achieved
---------------------------
Everything inside the simulation executes **serially** under a single run
token:

* *client actors* — workload threads spawned with :meth:`SimNet.spawn`
  that run ordinary :class:`~repro.core.transaction.Transaction` code over
  :class:`SimTransport` endpoints;
* *handler actors* — pooled threads that execute one delivered message
  against a :class:`SimNode` (the transport-independent
  :class:`~repro.net.server.NodeCore` engine — the very same sessions /
  ``_op_*`` dispatch / §3.4 expiry code the TCP server runs).

Exactly one actor runs at a time; every blocking point yields the token
back to the scheduler: RPC awaits (``SimFuture.result``), task joins,
version-condition waits (via :func:`repro.core.versioning.
set_blocking_wait` — the hookable-wait refactor), and dispensing-gate
acquisition (a virtual-time backoff loop). The scheduler resumes exactly
one runnable actor at a time, in a deterministic order, and advances the
virtual clock only by popping the seeded event heap. Since all scheduling
decisions derive from the seeded RNG and the (serial, deterministic)
execution between yield points, the schedule — and therefore the whole
run — replays bit-for-bit.

Message semantics mirror the TCP transport exactly where the protocol
depends on them: per-direction FIFO delivery (latencies are drawn per
message but delivery times are clamped monotone per link — TCP cannot
reorder a connection), one-way messages complete before any later message
of the same link starts (the TCP reader executes them inline), while
requests may park server-side and complete out of order (the worker
pool). Frames are delivered directly — the wire-v3 framing and the
leader/follower demux are TCP-only machinery below the Transport
interface — but every message payload is pickle-roundtripped, so state
isolation between "processes" is real and unpicklable arguments fail
like they would on the wire.

Fault injection (§3.4)
----------------------
:meth:`SimNet.inject_crash` crashes a simulated client process at the
``nth`` occurrence of a named op, ``before_send`` or ``after_send`` —
the labeled protocol steps of interest:

* ``dispense_batch`` after_send  — mid-dispense: the server holds gates
  and a session for a client that no longer exists;
* ``open_call`` after_send      — mid-(chained-)open;
* ``lw_apply`` after_send       — during §2.8.4 last-write application;
* ``commit_chain`` before_send  — the client dies without ever asking for
  a commit: full §3.4 rollback everywhere;
* ``commit_chain`` after_send   — the client dies with the commit request
  in flight: the coordinator decides and drives steps 2-5 autonomously
  (the chained commit decision, DESIGN.md §8 — the old client-driven
  step-5 partial-commit window is CLOSED; the transfer applies everywhere
  or nowhere).

:meth:`SimNet.inject_node_crash` instead crashes a home *node* at the nth
delivery of a chosen op — ``commit_chain`` / ``commit_wave`` /
``commit_decide`` / ``repl_apply`` / ``repl_final`` — exercising the
decision chain's redirect-around-dead-nodes path and the replica chain's
follower promotion at every protocol step.

A crashed client sends nothing further (its cleanup raises
:class:`SimCrash`, a BaseException, so no abort-path RPC can leak out —
crash-stop means *silence*); the server converges via the presence-drop
path or the heartbeat-timeout reaper (the seed decides which), running
the same ``_expire_session`` §3.4 self-rollback as the TCP server.
:meth:`SimNet.crash_node_at` kills a home node at a virtual time instead:
every transport to it fails in-flight work with ``RemoteObjectFailure``
and parked handlers unwind.
"""
from __future__ import annotations

import heapq
import pickle
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import random

from repro_torch.core import versioning
from repro_torch.core.api import RemoteObjectFailure
from repro_torch.core.registry import Registry
from repro_torch.obs import txtrace as _txtrace

from .server import ERR, NodeCore, OK, _WouldBlock, encode_error
from .transport import Transport
from .wal import VirtualDisk, Wal

__all__ = ["SimCrash", "SimDeadlock", "SimNet", "SimNode", "SimTransport",
           "build_simnet"]


class SimCrash(BaseException):
    """Unwinds a crashed simulated client. A BaseException on purpose:
    crash-stop means the client does NOTHING more — not even the abort
    path's cleanup RPCs, which ``except Exception`` handlers would
    otherwise run."""


class SimDeadlock(RuntimeError):
    """The simulation wedged: live actors remain but no event can run.
    Carries the replayable schedule in ``trace``."""

    def __init__(self, msg: str, trace: str):
        super().__init__(f"{msg}\n--- replayable schedule ---\n{trace}")
        self.trace = trace


class _Actor:
    """One token-gated thread inside the simulation."""

    __slots__ = ("name", "kind", "sem", "thread", "finished", "fn",
                 "node", "poisoned", "crashed")

    def __init__(self, name: str, kind: str):
        self.name = name
        self.kind = kind                  # "client" | "handler"
        self.sem = threading.Semaphore(0)
        self.thread: Optional[threading.Thread] = None
        self.finished = False
        self.fn: Optional[Callable[[], None]] = None
        self.node: Optional["SimNode"] = None   # handler's current node
        self.poisoned = False             # node died under this handler
        self.crashed = False              # client unwound via SimCrash


class _Link:
    """One direction of one simulated connection (FIFO, like TCP)."""

    __slots__ = ("queue", "locked", "last_time", "deferred")

    def __init__(self):
        self.queue: List[tuple] = []
        self.locked = False               # a one-way handler is running
        self.last_time = 0.0
        self.deferred = 0                 # pumps swallowed while locked


class SimConn:
    """Server-side view of a client link (duck-types ``_Conn.client_id``)."""

    __slots__ = ("client_id", "transport")

    def __init__(self, transport: "SimTransport"):
        self.client_id = transport.client_id
        self.transport = transport


class SimFuture:
    """Completion handle for one in-flight simulated request; ``result``
    yields the run token to the scheduler until the reply event fires."""

    __slots__ = ("_done", "_value", "_error", "simnet", "abandoned")

    def __init__(self, simnet: "SimNet"):
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        self.simnet = simnet
        self.abandoned = False

    def set_result(self, value: Any) -> None:
        self._value = value
        self._done.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.is_set():
            if not self.simnet.wait_event(self._done, timeout):
                self.abandoned = True   # its late reply will be dropped
                raise TimeoutError("RPC reply did not arrive in time")
        if self._error is not None:
            raise self._error
        return self._value


class SimTransport(Transport):
    """The simulated client endpoint for ONE (client process, node) pair.

    Implements the narrow :class:`~repro.net.transport.Transport` surface;
    the shared bookkeeping (deferred errors, task waits, liveness sets) is
    the base class's — byte-identical protocol semantics with TCP."""

    scheme = "sim"

    def __init__(self, simnet: "SimNet", node: "SimNode", client_id: str):
        super().__init__(node.address, client_id=client_id)
        self.simnet = simnet
        self.node = node
        self.conn = SimConn(self)
        self.crashed = False
        self._req_ids = 0
        self._pending: Dict[int, SimFuture] = {}
        self.to_server = _Link()
        self.to_client = _Link()
        self._hb_armed = False
        self.affinity = simnet._affinity.get(client_id)
        simnet._register_transport(self)

    # -- message primitives ---------------------------------------------------
    def _check_sendable(self, op: str) -> None:
        if self.crashed:
            raise SimCrash(f"{self.client_id} is crash-stopped")
        self.simnet._check_injection(self, op, "before_send")
        if not self.alive or not self.node.alive:
            # node.alive also covers a transport built AFTER the node
            # crashed (e.g. a fresh server-to-server chain link) — the
            # TCP analogue is the refused connect.
            raise RemoteObjectFailure(
                f"node server {self.address} is unreachable (crash-stop)")

    def call_async(self, op: str, **kwargs: Any) -> SimFuture:
        self._check_sendable(op)
        fut = SimFuture(self.simnet)
        self._req_ids += 1
        req_id = self._req_ids
        with self._lock:
            self.n_rpc += 1
            self._pending[req_id] = fut
        self.simnet._send(self, req_id, op, kwargs, fut)
        self.simnet._check_injection(self, op, "after_send")
        return fut

    def notify(self, op: str, **kwargs: Any) -> None:
        self._check_sendable(op)
        self._oneway.inc()   # exact, lock-free (per-thread cells)
        self.simnet._send(self, None, op, kwargs, None)
        self.simnet._check_injection(self, op, "after_send")

    def _obs_tracer(self):
        # Determinism: every sim-side span must read the virtual clock.
        # Actor/handler threads carry their own bound tracer; calls from
        # unbound threads (topology setup on the host thread) fall back
        # to this client's own virtual-clock site instead of the
        # process-wide monotonic one.
        return (_txtrace.thread_tracer()
                or _txtrace.tracer(f"client:{self.client_id}",
                                   clock=self.simnet.now))

    def join_task(self, txn_uid: str, name: str):
        """Join a home-node task: yield to the scheduler until the pushed
        ``task_done`` note resolves the wait (virtual time — no grace
        polling needed; a lost push is impossible in-sim short of a crash,
        and crashes fail the wait)."""
        if self.crashed:
            raise SimCrash(f"{self.client_id} is crash-stopped")
        wait = self._task_wait(txn_uid, name)
        self.simnet.wait_event(wait.done, None)
        return wait

    def register_txn(self, txn_uid: str) -> None:
        if self.crashed:
            raise SimCrash(f"{self.client_id} is crash-stopped")
        with self._lock:
            self._active_txns.add(txn_uid)
        self.simnet._arm_heartbeat(self)

    def sleep(self, seconds: float) -> None:
        """Transport-clocked backoff (failover grace / promote retries):
        virtual time inside the simulation, a short native wait outside."""
        self.simnet.sleep(seconds)

    def failover_grace(self) -> float:
        """Virtual-clock failure-detection grace, derived from the
        simulated link latencies (100x the worst one-way) instead of a
        wall-clock constant — so sweeps with stretched latencies keep the
        detection-time >> flight-time assumption by construction."""
        return max(100.0 * self.simnet.latency[1], 1e-4)

    def close(self) -> None:
        self.alive = False

    # -- inbound (called by the scheduler, under the token) -------------------
    def _deliver_reply(self, req_id: int, status: str, value: Any) -> None:
        with self._lock:
            fut = self._pending.pop(req_id, None)
        if fut is None or fut.abandoned:
            self.simnet._trace(f"drop {self.node.node_name}->"
                               f"{self.client_id} reply#{req_id} (late)")
            return
        self.n_inline += 1
        if status == OK:
            fut.set_result(value)
        else:
            fut.set_error(value)

    # -- failure --------------------------------------------------------------
    def _mark_dead(self, reason: str) -> None:
        """The home node crash-stopped: fail all in-flight work (§3.4)."""
        with self._lock:
            self.alive = False
            pending = list(self._pending.values())
            self._pending.clear()
            waits = list(self._tasks.values())
        err = RemoteObjectFailure(
            f"node server {self.address} is unreachable ({reason})")
        for fut in pending:
            fut.set_error(err)
        self._fail_task_waits(waits, err)

    def _crash(self) -> None:
        """This simulated client process crash-stopped."""
        self.crashed = True
        err = SimCrash(f"{self.client_id} crashed")
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
            waits = list(self._tasks.values())
        for fut in pending:
            fut.set_error(err)
        self._fail_task_waits(waits, err)

    def __repr__(self) -> str:  # pragma: no cover
        return f"SimTransport({self.client_id}->{self.node.node_name})"


class SimNode(NodeCore):
    """A simulated home node: the full NodeCore protocol engine, its own
    private :class:`Registry` (state isolation, like a separate process),
    no sockets, no real-time threads — expiry runs off virtual-clock
    reaper events and pushes are scheduler deliveries."""

    #: determinism: gate-open kickoff tasks run on the delivering actor.
    INLINE_KICKOFF_TASKS = True

    def __init__(self, simnet: "SimNet", node_name: str, *,
                 monitor_timeout: float, monitor_poll: float):
        # Durability is always on under simnet: the node's ledger lives on
        # the net's per-name VirtualDisk, which survives a simulated
        # restart — appends are local (zero messages), so fault-free
        # message plans are byte-identical with and without it.
        super().__init__(node_name, registry=Registry(),
                         monitor_timeout=monitor_timeout,
                         monitor_poll=monitor_poll,
                         clock=simnet.now,
                         wal=Wal(simnet._disk(node_name)))
        self.simnet = simnet
        self.alive = True
        self._reaper_armed = False

    @property
    def address(self) -> str:
        return f"sim://{self.node_name}"

    # -- transport hooks ------------------------------------------------------
    def _queue_note(self, conn: SimConn, note: dict) -> None:
        self.simnet._send_note(self, conn.transport, note)

    def _push_target(self, conn: Optional[SimConn],
                     client_id: str) -> Optional[SimConn]:
        if conn is not None and conn.client_id == client_id:
            return conn
        t = self.simnet._transport_for(client_id, self.node_name)
        return t.conn if t is not None else None

    def _gate_acquire(self, gate: threading.Lock, nb: bool = False) -> None:
        if nb:  # pragma: no cover - sim has no reader fast path
            if not gate.acquire(blocking=False):
                raise _WouldBlock
            return
        # Virtual-time backoff instead of a real block: the gate holder is
        # another parked actor that can only progress once we yield.
        while not gate.acquire(blocking=False):
            self.simnet.sleep(0.0005)

    def _peer(self, address: str) -> SimTransport:
        """Server-to-server link for chained dispensing (§2.10.2)."""
        peer = self._peers.get(address)
        if peer is None or not peer.alive:
            node = self.simnet.node_by_address(address)
            peer = SimTransport(self.simnet, node,
                                client_id=f"peer:{self.node_name}")
            self._peers[address] = peer
        return peer

    def _spawn_bg(self, fn: Callable[[], None], name: str = "bg") -> None:
        """Background jobs (migration drains) run on a handler actor: they
        may block at virtual-time waits, and must never block the
        scheduler loop itself. Outside a run (setup/teardown execute in
        ``_immediate`` mode) there is no scheduler to resume an actor —
        run the job inline on the caller like every other immediate op."""
        if not self.simnet._running:
            fn()
            return
        self.simnet._spawn_handler(fn, self)

    # -- tracing hooks --------------------------------------------------------
    def _op_dispense_batch(self, *args: Any, **kwargs: Any):
        out = super()._op_dispense_batch(*args, **kwargs)
        self.simnet._arm_reaper(self)
        return out

    def _expire_session(self, session) -> None:
        self.simnet._trace(
            f"expire {self.node_name} "
            f"txn={self.simnet._txn_label(session.txn_uid)}")
        super()._expire_session(session)


class SimNet:
    """The deterministic simulation: virtual clock + seeded scheduler +
    nodes + transports + trace. See the module docstring."""

    def __init__(self, seed: int, *, latency: Tuple[float, float] = (50e-6,
                                                                     500e-6),
                 heartbeat_interval: float = 0.25,
                 monitor_timeout: float = 1.0, monitor_poll: float = 0.25):
        self.seed = seed
        self.rng = random.Random(f"simnet:{seed}")   # str-seeding: stable sha512
        self.latency = latency
        self.heartbeat_interval = heartbeat_interval
        self.monitor_timeout = monitor_timeout
        self.monitor_poll = monitor_poll
        self._now = 0.0
        self._seq = 0
        self._events: List[tuple] = []      # (time, seq, kind, payload)
        self._watchers: List[list] = []     # [actor, event, active]
        self._trace_lines: List[str] = []
        self._txn_labels: Dict[str, str] = {}
        self._nodes: Dict[str, SimNode] = {}
        self._disks: Dict[str, VirtualDisk] = {}   # survive node restarts
        self._transports: Dict[Tuple[str, str], SimTransport] = {}
        self._clients: List[_Actor] = []
        self._idle_handlers: List[_Actor] = []
        self._all_handlers: List[_Actor] = []
        self._injections: List[dict] = []
        self._op_counts: Dict[Tuple[str, str], int] = {}
        self._node_injections: List[dict] = []
        self._node_op_counts: Dict[Tuple[str, str], int] = {}
        self._crashed_clients: Dict[str, str] = {}   # client_id -> label
        self.fired_injections: List[str] = []
        self._partitions: List[dict] = []   # active cuts: {a, b, label}
        self._affinity: Dict[str, str] = {}   # client_id -> home address
        self._sched_sem = threading.Semaphore(0)
        self._tl = threading.local()
        self._running = False
        self._real_watchdog = 120.0
        # -- accounting (no-lost/double-frame invariants) --------------------
        self.sent = 0
        self.delivered = 0
        self.dropped = 0

    # -- time -----------------------------------------------------------------
    def now(self) -> float:
        """The virtual clock (passed as ``clock=`` into NodeCore/monitor)."""
        return self._now

    def _draw_latency(self) -> float:
        lo, hi = self.latency
        return self.rng.uniform(lo, hi)

    # -- topology -------------------------------------------------------------
    def add_node(self, name: str) -> SimNode:
        if name in self._nodes:
            raise ValueError(f"sim node {name!r} already exists")
        node = SimNode(self, name, monitor_timeout=self.monitor_timeout,
                       monitor_poll=self.monitor_poll)
        self._nodes[name] = node
        return node

    def node_by_address(self, address: str) -> SimNode:
        name = address.split("://", 1)[1] if "://" in address else address
        return self._nodes[name]

    def _disk(self, name: str) -> VirtualDisk:
        """The node's durable device (§11): keyed by *name*, not node
        object, so a restarted node replays the image its predecessor
        wrote. Re-opening un-halts a device parked by a crash."""
        d = self._disks.get(name)
        if d is None:
            d = self._disks[name] = VirtualDisk()
        else:
            d.halt = False
        return d

    def _register_transport(self, t: SimTransport) -> None:
        self._transports[(t.client_id, t.node.node_name)] = t

    def _transport_for(self, client_id: str,
                       node_name: str) -> Optional[SimTransport]:
        return self._transports.get((client_id, node_name))

    def set_affinity(self, client_id: str, address: str) -> None:
        """Declare a client process's locality group (a node address): it
        rides every dispense batch the client sends and feeds the home
        node's per-object affinity counters (§10 lease migration)."""
        self._affinity[client_id] = address
        for (cid, _n), t in self._transports.items():
            if cid == client_id:
                t.affinity = address

    # -- partitions (§10 split-brain exploration) ------------------------------
    def partition(self, a_nodes: List[str], b_nodes: List[str],
                  start: float, duration: float,
                  label: Optional[str] = None) -> None:
        """Cut the server-to-server links between node groups ``a`` and
        ``b`` during ``[start, start + duration)`` of virtual time. Client
        links stay up on BOTH sides — the split-brain scenario: clients
        keep talking to a primary that can no longer renew its lease while
        the other side promotes. Cut peer frames are dropped (one-ways
        silently; requests/replies fail the in-flight future, the TCP-RST
        analogue), all counted in ``dropped``."""
        cut = {"a": frozenset(a_nodes), "b": frozenset(b_nodes),
               "label": label or f"{'+'.join(a_nodes)}|{'+'.join(b_nodes)}"}
        self._push(start, "partition_on", cut)
        self._push(start + duration, "partition_off", cut)

    def _is_cut(self, sender: str, receiver: str) -> bool:
        for cut in self._partitions:
            if ((sender in cut["a"] and receiver in cut["b"])
                    or (sender in cut["b"] and receiver in cut["a"])):
                return True
        return False

    def client_registry(self, client_id: str) -> Registry:
        """A client-side :class:`Registry` for one simulated client
        *process*: one :class:`SimTransport` per node, federated bindings
        — the sim analogue of ``Registry.connect("host:port")``."""
        reg = Registry()
        for node in self._nodes.values():
            reg.connect(node.address,
                        client=SimTransport(self, node, client_id))
        return reg

    # -- fault injection ------------------------------------------------------
    def inject_crash(self, client_id: str, op: str, nth: int = 1,
                     phase: str = "after_send",
                     label: Optional[str] = None) -> None:
        """Crash-stop ``client_id`` at the ``nth`` send of ``op``
        (``before_send`` or ``after_send``)."""
        assert phase in ("before_send", "after_send"), phase
        self._injections.append({
            "client_id": client_id, "op": op, "nth": nth, "phase": phase,
            "label": label or f"{op}/{phase}#{nth}"})

    def crash_node_at(self, node_name: str, at: float) -> None:
        """Crash-stop a home node at virtual time ``at``."""
        self._push(at, "node_crash", node_name)

    def restart_node_at(self, node_name: str, at: float) -> None:
        """Restart a crashed home node at virtual time ``at`` under its
        old identity (§11): a fresh process replays the surviving disk
        image and runs the rejoin protocol against the live chains."""
        self._push(at, "node_restart", node_name)

    def inject_wal_crash(self, node_name: str, nth: int = 1,
                         label: Optional[str] = None) -> None:
        """Crash-stop a node at its ``nth`` WAL frame append, tearing
        that frame (the ``node-mid-wal-append`` label): the write itself
        is the crash point, so the frame can never land whole — replay
        must truncate it."""
        disk = self._disk(node_name)
        spec = {"node": node_name, "nth": nth, "n": 0, "fired": False,
                "label": label or f"{node_name}:node-mid-wal-append#{nth}"}

        def hook(d: VirtualDisk, spec: dict = spec) -> None:
            if not self._running:
                return      # setup binds don't count: fire mid-schedule
            spec["n"] += 1
            if spec["fired"] or spec["n"] != spec["nth"]:
                return
            spec["fired"] = True
            self.fired_injections.append(spec["label"])
            d.tear_tail(self.rng)
            d.halt = True
            # never raise mid-handler: the crash lands right after the
            # writer's synchronous slice, like an after_deliver injection
            self._push(self._now, "node_crash", spec["node"])

        disk.on_append = hook

    def inject_node_crash(self, node_name: str, op: str, nth: int = 1,
                          phase: str = "before_deliver",
                          label: Optional[str] = None) -> None:
        """Crash-stop a home node at the ``nth`` delivery of ``op`` to it
        (any sender — client or server-to-server peer link). With
        ``before_deliver`` the message is lost with the node (the caller's
        in-flight future fails, §3.4); with ``after_deliver`` the node
        crashes right after its handler's synchronous slice — i.e. after
        the op ran, or mid-op at its first blocking point. Targets the
        chained-commit / replication steps: ``commit_chain`` (coordinator),
        ``commit_wave`` (mid-wave), ``commit_decide`` (mid-decision-chain),
        ``repl_apply`` / ``repl_final`` (replica chain)."""
        assert phase in ("before_deliver", "after_deliver"), phase
        self._node_injections.append({
            "node": node_name, "op": op, "nth": nth, "phase": phase,
            "fired": False,
            "label": label or f"{node_name}:{op}/{phase}#{nth}"})

    def _check_node_injection(self, node: "SimNode", op: str) -> None:
        if not self._node_injections or not node.alive:
            return
        key = (node.node_name, op)
        self._node_op_counts[key] = n = self._node_op_counts.get(key, 0) + 1
        for spec in self._node_injections:
            if (spec["node"] == node.node_name and spec["op"] == op
                    and spec["nth"] == n and not spec["fired"]):
                spec["fired"] = True
                self.fired_injections.append(spec["label"])
                if spec["phase"] == "before_deliver":
                    self._do_node_crash(node.node_name)
                else:
                    # Fires after the delivering handler's synchronous
                    # slice (the scheduler pops it next).
                    self._push(self._now, "node_crash", node.node_name)

    def _check_injection(self, t: SimTransport, op: str, phase: str) -> None:
        if t.client_id.startswith("peer:") or not self._injections:
            return
        if phase == "before_send":
            # Count each client-visible send attempt once, at before_send.
            key = (t.client_id, op)
            self._op_counts[key] = self._op_counts.get(key, 0) + 1
        n = self._op_counts.get((t.client_id, op), 0)
        for spec in self._injections:
            if (spec["client_id"] == t.client_id and spec["op"] == op
                    and spec["phase"] == phase and spec["nth"] == n
                    and t.client_id not in self._crashed_clients):
                self._crash_client(t.client_id, spec["label"])
                raise SimCrash(f"{t.client_id} crashed at {spec['label']}")

    def _crash_client(self, client_id: str, label: str) -> None:
        self._crashed_clients[client_id] = label
        self.fired_injections.append(label)
        self._trace(f"crash {client_id} label={label}")
        transports = [t for (cid, _n), t in self._transports.items()
                      if cid == client_id]
        for t in transports:
            t._crash()
        # The presence signal: half the seeds drop the "connection"
        # promptly (instant detection), half go silent and leave it to the
        # heartbeat-timeout reaper — both §3.4 detection paths explored.
        if self.rng.random() < 0.5:
            for t in transports:
                self._send_raw(t, t.to_server, "vanish", None, None, None)
        for node in self._nodes.values():
            self._arm_reaper(node)

    def _do_node_crash(self, node_name: str) -> None:
        node = self._nodes.get(node_name)
        if node is None or not node.alive:
            return
        node.alive = False
        self._trace(f"node-crash {node_name}")
        disk = self._disks.get(node_name)
        if disk is not None:
            # settle unsynced WAL frames with ordered-device semantics
            # (seeded: a prefix lands, one frame may land torn)
            disk.crash(self.rng)
        for (cid, nname), t in list(self._transports.items()):
            if nname != node_name:
                continue
            dropped = len(t.to_server.queue) + len(t.to_client.queue)
            self.dropped += dropped
            t.to_server.queue.clear()
            t.to_client.queue.clear()
            t._mark_dead("node crashed")
        # Unwind handler actors parked inside the dead node: their waits
        # will never fire (the node's counters are gone with it).
        for entry in list(self._watchers):
            actor = entry[0]
            if (entry[2] and actor.kind == "handler"
                    and actor.node is node):
                entry[2] = False
                self._watchers.remove(entry)
                actor.poisoned = True
                self._resume(actor)

    def _do_node_restart(self, node_name: str) -> None:
        """§11 restart: a fresh SimNode under the old identity replays
        the surviving disk image (``SimNode.__init__`` builds its Wal
        over the same VirtualDisk) and rejoins its chains on a handler
        actor. Every transport keyed to the name is re-pointed at the
        reborn process and revived — the sim analogue of reconnecting to
        the same host:port."""
        old = self._nodes.get(node_name)
        if old is None or old.alive:
            return
        node = SimNode(self, node_name, monitor_timeout=self.monitor_timeout,
                       monitor_poll=self.monitor_poll)
        # The reborn process reads the same "config" the old one ran
        # with — a restarted node with a mismatched lease TTL would ack
        # renewals and compute promise windows on a different clock than
        # the rest of the deployment.
        node.leases.ttl = old.leases.ttl
        node.migrate_auto = old.migrate_auto
        self._nodes[node_name] = node
        self._trace(f"node-restart {node_name}")
        for (cid, nname), t in list(self._transports.items()):
            if nname != node_name:
                continue
            with t._lock:
                t.node = node
                t.alive = True
        if node._recovered is not None and node._recovered.objects:
            node._spawn_bg(node.rejoin_chains, name="rejoin")

    # -- sending --------------------------------------------------------------
    def _send(self, t: SimTransport, req_id: Optional[int], op: str,
              kwargs: dict, fut: Optional[SimFuture]) -> None:
        if not self._running:
            # Setup/teardown (topology binds, final state reads): execute
            # synchronously — these happen outside the simulated schedule.
            self._immediate(t, req_id, op, kwargs, fut)
            return
        self._send_raw(t, t.to_server, "req", req_id, op, (kwargs, fut))

    def _immediate(self, t: SimTransport, req_id: Optional[int], op: str,
                   kwargs: dict, fut: Optional[SimFuture]) -> None:
        op, kwargs = self._roundtrip((op, kwargs))
        if op in t.node._CONN_OPS:
            kwargs = dict(kwargs, _conn=t.conn)
        if req_id is None:
            t.node._handle_oneway(t.conn, op, kwargs)
            return
        try:
            value, status = t.node._dispatch(op, kwargs), OK
        except BaseException as e:  # noqa: BLE001 - serialize to peer
            status, value = ERR, encode_error(e)
        status, value = self._roundtrip((status, value))
        if fut is not None:
            if status == OK:
                fut.set_result(value)
            else:
                fut.set_error(value)

    def _send_reply(self, node: SimNode, t: SimTransport, req_id: int,
                    status: str, value: Any) -> None:
        self._send_raw(t, t.to_client, "reply", req_id, status, value)

    def _send_note(self, node: SimNode, t: SimTransport, note: dict) -> None:
        if not self._running:
            t._handle_note(self._roundtrip(note))
            return
        self._send_raw(t, t.to_client, "note", None, None, note)

    def _send_raw(self, t: SimTransport, link: _Link, kind: str,
                  req_id: Optional[int], a: Any, b: Any) -> None:
        if not self._running:
            raise RuntimeError("simnet is not running (setup uses call())")
        self.sent += 1
        at = max(self._now + self._draw_latency(), link.last_time)
        link.last_time = at
        link.queue.append((kind, req_id, a, b))
        self._push(at, "pump", (t, link))

    # -- event heap -----------------------------------------------------------
    def _push(self, at: float, kind: str, payload: Any) -> None:
        self._seq += 1
        heapq.heappush(self._events, (at, self._seq, kind, payload))

    # -- timers ---------------------------------------------------------------
    def _arm_heartbeat(self, t: SimTransport) -> None:
        if not t._hb_armed:
            t._hb_armed = True
            self._push(self._now + self.heartbeat_interval, "hb", t)

    def _arm_reaper(self, node: SimNode) -> None:
        if not node._reaper_armed and node.alive:
            node._reaper_armed = True
            self._push(self._now + node.monitor.poll_interval, "reaper", node)

    # -- actors ---------------------------------------------------------------
    def spawn(self, fn: Callable[[], None], name: str) -> _Actor:
        """Register a client actor; it starts running when :meth:`run`
        schedules it (all actors start at time 0, in spawn order)."""
        actor = _Actor(name, "client")

        def main() -> None:
            self._tl.actor = actor
            versioning.set_blocking_wait(self.wait_event)
            # Client-side spans of this virtual client land on its own
            # track and read the virtual clock (trace determinism).
            _txtrace.set_thread_tracer(
                _txtrace.tracer(f"client:{name}", clock=self.now))
            actor.sem.acquire()
            try:
                fn()
            except SimCrash:
                actor.crashed = True
            except BaseException as e:  # noqa: BLE001 - seed failure report
                actor.crashed = True
                self._trace(f"actor-error {name}: {type(e).__name__}: {e}")
                raise
            finally:
                actor.finished = True
                self._sched_sem.release()

        actor.thread = threading.Thread(target=main, name=f"sim-{name}",
                                        daemon=True)
        actor.thread.start()
        self._clients.append(actor)
        self._push(0.0, "start", actor)
        return actor

    def _spawn_handler(self, fn: Callable[[], None],
                       node: SimNode) -> None:
        if self._idle_handlers:
            actor = self._idle_handlers.pop()
        else:
            actor = _Actor(f"handler-{len(self._all_handlers)}", "handler")
            self._all_handlers.append(actor)

            def loop(a: _Actor = actor) -> None:
                self._tl.actor = a
                versioning.set_blocking_wait(self.wait_event)
                while True:
                    a.sem.acquire()
                    job = a.fn
                    if job is None:
                        return
                    # Pooled handler threads serve different nodes over
                    # time: bind the serving node's tracer per job so
                    # e.g. chained-dispense peer RPCs issued from here
                    # land on that node's track, on the virtual clock.
                    if _txtrace.enabled:
                        _txtrace.set_thread_tracer(
                            a.node.obs_tracer if a.node is not None
                            else None)
                    try:
                        job()
                    except SimCrash:
                        pass        # poisoned: node died under us
                    except BaseException as e:  # noqa: BLE001
                        self._trace(f"handler-error: "
                                    f"{type(e).__name__}: {e}")
                    a.fn = None
                    a.node = None
                    a.poisoned = False
                    self._idle_handlers.append(a)
                    self._sched_sem.release()

            actor.thread = threading.Thread(target=loop,
                                            name=f"sim-{actor.name}",
                                            daemon=True)
            actor.thread.start()
        actor.fn = fn
        actor.node = node
        actor.poisoned = False
        self._resume(actor)

    def _resume(self, actor: _Actor) -> None:
        """Hand the run token to ``actor``; returns when it yields, parks,
        or finishes. A real-time watchdog converts an un-hooked real block
        into a diagnosable failure instead of a silent hang."""
        actor.sem.release()
        if not self._sched_sem.acquire(timeout=self._real_watchdog):
            raise SimDeadlock(
                f"actor {actor.name} blocked on a real (un-hooked) "
                f"primitive for {self._real_watchdog}s", self.trace_text())

    def _yield_token(self, actor: _Actor) -> None:
        self._sched_sem.release()
        actor.sem.acquire()

    # -- blocking points ------------------------------------------------------
    def wait_event(self, ev: threading.Event,
                   timeout: Optional[float] = None) -> bool:
        """The simulation's universal blocking wait (installed as the
        versioning wait hook, used by futures, joins, and sleeps): park
        this actor until ``ev`` is set or ``timeout`` virtual seconds
        pass. Returns ``ev.is_set()``."""
        actor = getattr(self._tl, "actor", None)
        if actor is None:
            # Not inside the simulation (setup/teardown code): native wait.
            return ev.wait(timeout if timeout is not None else 5.0)
        if ev.is_set():
            return True
        entry = [actor, ev, True]
        self._watchers.append(entry)
        if timeout is not None:
            self._push(self._now + timeout, "timeout", entry)
        self._yield_token(actor)
        if actor.poisoned:
            raise SimCrash(f"node died under {actor.name}")
        return ev.is_set()

    def sleep(self, dt: float) -> None:
        """Advance this actor by ``dt`` virtual seconds."""
        self.wait_event(threading.Event(), dt)

    # -- scheduler ------------------------------------------------------------
    def run(self, max_virtual: float = 600.0) -> None:
        """Run the simulation to quiescence: all client actors finished
        and every queued event drained."""
        self._running = True
        try:
            while True:
                if self._wake_ready_watcher():
                    continue
                if not self._events:
                    if all(a.finished for a in self._clients):
                        return
                    self._deadlock("no runnable actor and no pending event")
                t, _seq, kind, payload = heapq.heappop(self._events)
                if t > max_virtual:
                    self._deadlock(f"virtual time cap {max_virtual}s hit")
                self._now = max(self._now, t)
                self._execute(kind, payload)
        finally:
            self._running = False

    def _wake_ready_watcher(self) -> bool:
        for entry in self._watchers:
            actor, ev, active = entry
            if active and ev.is_set():
                entry[2] = False
                self._watchers.remove(entry)
                self._resume(actor)
                return True
        return False

    def _deadlock(self, why: str) -> None:
        parked = [e[0].name for e in self._watchers if e[2]]
        raise SimDeadlock(
            f"simnet seed={self.seed} wedged ({why}); parked={parked}",
            self.trace_text())

    def _execute(self, kind: str, payload: Any) -> None:
        if kind == "start":
            self._trace(f"start {payload.name}")
            self._resume(payload)
        elif kind == "pump":
            self._pump(*payload)
        elif kind == "timeout":
            actor, _ev, active = payload
            if active:
                payload[2] = False
                try:
                    self._watchers.remove(payload)
                except ValueError:
                    pass
                self._resume(actor)
        elif kind == "hb":
            self._fire_heartbeat(payload)
        elif kind == "reaper":
            self._fire_reaper(payload)
        elif kind == "node_crash":
            self._do_node_crash(payload)
        elif kind == "node_restart":
            self._do_node_restart(payload)
        elif kind == "partition_on":
            self._partitions.append(payload)
            self._trace(f"partition-on {payload['label']}")
        elif kind == "partition_off":
            if payload in self._partitions:
                self._partitions.remove(payload)
                self._trace(f"partition-off {payload['label']}")
        elif kind == "unlock":
            t, link = payload
            link.locked = False
            if link.deferred > 0 and link.queue:
                link.deferred -= 1
                self._push(self._now, "pump", (t, link))
        else:  # pragma: no cover
            raise AssertionError(f"unknown event {kind!r}")

    # -- delivery -------------------------------------------------------------
    def _pump(self, t: SimTransport, link: _Link) -> None:
        if link.locked:
            # This pump's message cannot start until the in-flight one-way
            # completes (TCP's inline-FIFO guarantee); the unlock re-pumps.
            link.deferred += 1
            return
        if not link.queue:
            return
        kind, req_id, a, b = link.queue.pop(0)
        if link is t.to_server:
            self._deliver_to_server(t, link, kind, req_id, a, b)
        else:
            self._deliver_to_client(t, kind, req_id, a, b)
        # Chain deliveries whose pump events fired while the link was
        # locked (their scheduled times have already passed).
        if not link.locked and link.deferred > 0 and link.queue:
            link.deferred -= 1
            self._push(self._now, "pump", (t, link))

    def _roundtrip(self, obj: Any) -> Any:
        """State isolation between simulated processes: every payload is
        pickled across the 'wire', exactly like TCP framing would."""
        return pickle.loads(pickle.dumps(obj))

    def _deliver_to_server(self, t: SimTransport, link: _Link, kind: str,
                           req_id: Optional[int], a: Any, b: Any) -> None:
        node = t.node
        if kind == "vanish":
            self._trace(f"deliver {t.client_id}->{node.node_name} vanish")
            self.delivered += 1
            node._client_vanished(t.client_id)
            return
        op, (kwargs, fut) = a, b
        if (self._partitions and t.client_id.startswith("peer:")
                and self._is_cut(t.client_id[5:], node.node_name)):
            # A cut peer link: the frame is lost. One-ways go silently
            # (lease renewals starve — that is the point); a request's
            # sender learns promptly (the TCP-RST analogue), so no actor
            # is stranded awaiting a reply that can never come.
            self._trace(f"drop {t.client_id}->{node.node_name} "
                        f"{self._msg_label(req_id, op, kwargs)} (partition)")
            self.dropped += 1
            if fut is not None and not fut.done():
                fut.set_error(RemoteObjectFailure(
                    f"link {t.client_id}->{node.address} partitioned with "
                    f"{op!r} in flight"))
            return
        self._check_node_injection(node, op)
        if not node.alive:
            self._trace(f"drop {t.client_id}->{node.node_name} "
                        f"{self._msg_label(req_id, op, kwargs)} (node dead)")
            self.dropped += 1
            if fut is not None and not fut.done():
                # The node died while this request was in flight: its
                # reply will never come — fail the caller (§3.4), exactly
                # like the TCP client's _mark_dead does for in-flight
                # futures on a broken connection.
                fut.set_error(RemoteObjectFailure(
                    f"node server {node.address} crash-stopped with "
                    f"{op!r} in flight"))
            return
        self.delivered += 1
        self._trace(f"deliver {t.client_id}->{node.node_name} "
                    f"{self._msg_label(req_id, op, kwargs)}")
        try:
            op, kwargs = self._roundtrip((op, kwargs))
        except Exception as e:  # noqa: BLE001 - unpicklable argument
            if req_id is not None:
                self._send_reply(node, t, req_id, ERR, encode_error(e))
            return
        if op in node._CONN_OPS:
            kwargs = dict(kwargs, _conn=t.conn)
        if req_id is None:
            # One-way: completes before any later message on this link
            # starts (the TCP reader's inline-FIFO guarantee).
            link.locked = True

            def oneway_job() -> None:
                try:
                    node._handle_oneway(t.conn, op, kwargs)
                finally:
                    self._push(self._now, "unlock", (t, link))

            self._spawn_handler(oneway_job, node)
            return

        def request_job() -> None:
            try:
                value, status = node._dispatch(op, kwargs), OK
            except SimCrash:
                raise
            except BaseException as e:  # noqa: BLE001 - serialize to peer
                status, value = ERR, encode_error(e)
            if node.alive:
                self._send_reply(node, t, req_id, status, value)

        self._spawn_handler(request_job, node)

    def _deliver_to_client(self, t: SimTransport, kind: str,
                           req_id: Optional[int], a: Any, b: Any) -> None:
        node = t.node
        if t.crashed:
            self._trace(f"drop {node.node_name}->{t.client_id} "
                        f"{kind}#{req_id} (client crashed)")
            self.dropped += 1
            return
        if (self._partitions and t.client_id.startswith("peer:")
                and self._is_cut(node.node_name, t.client_id[5:])):
            self._trace(f"drop {node.node_name}->{t.client_id} "
                        f"{kind}#{req_id} (partition)")
            self.dropped += 1
            if kind == "reply":
                with t._lock:
                    fut = t._pending.pop(req_id, None)
                if fut is not None and not fut.abandoned:
                    fut.set_error(RemoteObjectFailure(
                        f"link {node.address}->{t.client_id} partitioned "
                        f"with reply#{req_id} in flight"))
            return
        self.delivered += 1
        if kind == "reply":
            status, value = a, b
            self._trace(f"deliver {node.node_name}->{t.client_id} "
                        f"reply#{req_id} {status}")
            try:
                status, value = self._roundtrip((status, value))
            except Exception as e:  # noqa: BLE001
                status, value = ERR, RuntimeError(f"undecodable reply: {e}")
            t._deliver_reply(req_id, status, value)
        else:   # note
            note = b
            self._trace(f"deliver {node.node_name}->{t.client_id} "
                        f"note {note.get('kind')} "
                        f"txn={self._txn_label(note.get('txn'))} "
                        f"obj={note.get('name')}")
            try:
                note = self._roundtrip(note)
            except Exception:  # noqa: BLE001 - like a corrupt push: drop
                return
            t._handle_note(note)

    # -- timers ---------------------------------------------------------------
    def _fire_heartbeat(self, t: SimTransport) -> None:
        if t.crashed or not t.alive:
            t._hb_armed = False
            return
        with t._lock:
            txns = sorted(t._active_txns)
        if not txns:
            t._hb_armed = False
            return
        self.n_heartbeats = getattr(self, "n_heartbeats", 0) + 1
        self._send_raw(t, t.to_server, "req", None, "heartbeat",
                       ({"client_id": t.client_id, "txns": txns}, None))
        self._push(self._now + self.heartbeat_interval, "hb", t)

    def _fire_reaper(self, node: SimNode) -> None:
        if not node.alive:
            node._reaper_armed = False
            return
        if node.reap_stale(self._now):     # sessions remain: keep polling
            self._push(self._now + node.monitor.poll_interval, "reaper",
                       node)
        else:
            node._reaper_armed = False

    # -- trace ----------------------------------------------------------------
    def _txn_label(self, uid: Optional[str]) -> str:
        """Normalize transaction uids (which embed process-global counters)
        to first-appearance labels, so traces replay byte-identically."""
        if uid is None:
            return "-"
        label = self._txn_labels.get(uid)
        if label is None:
            label = f"T{len(self._txn_labels) + 1}"
            self._txn_labels[uid] = label
        return label

    def _msg_label(self, req_id: Optional[int], op: str,
                   kwargs: dict) -> str:
        tag = f"req#{req_id}" if req_id is not None else "oneway"
        parts = [tag, op]
        txn = kwargs.get("txn")
        if txn is not None:
            parts.append(f"txn={self._txn_label(txn)}")
        name = kwargs.get("name")
        if name is not None:
            parts.append(f"obj={name}")
        names = kwargs.get("names")
        if names:
            parts.append(f"objs={','.join(names)}")
        return " ".join(parts)

    def _trace(self, line: str) -> None:
        self._trace_lines.append(f"{self._now:.6f} {line}")

    def trace_text(self) -> str:
        """The replayable schedule: every delivery, timer, crash, and
        expiry decision the scheduler made, in order, in virtual time.
        Byte-identical across runs of the same seed."""
        return "\n".join(self._trace_lines) + "\n"

    # -- inspection / teardown ------------------------------------------------
    def converged(self) -> List[str]:
        """Names of shared objects whose version chain did NOT converge
        to quiescence (``gv == lv == ltv``) — leaked/wedged versions, the
        §3.4 rollback-to-oldest invariant. Empty means all clean. Dead
        nodes are skipped (their objects left the system)."""
        bad = []
        for node in self._nodes.values():
            if not node.alive:
                continue
            for name, shared in node.registry.all_objects().items():
                h = shared.header
                if not (h.gv == h.lv == h.ltv):
                    bad.append(f"{name}: gv={h.gv} lv={h.lv} ltv={h.ltv}")
        return bad

    def shutdown(self) -> None:
        for actor in self._all_handlers:
            actor.fn = None
            actor.sem.release()
        for node in self._nodes.values():
            node.registry.shutdown()


def build_simnet(seed: int, n_nodes: int, **kw: Any) -> SimNet:
    """A SimNet with ``n_nodes`` nodes named ``node0..node{n-1}``."""
    net = SimNet(seed, **kw)
    for i in range(n_nodes):
        net.add_node(f"node{i}")
    return net
