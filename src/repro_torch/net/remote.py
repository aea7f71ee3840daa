"""Client-side proxies duck-typing the in-process surface (DESIGN.md §3.1).

* :class:`RemoteNode` — stands where :class:`~repro.core.registry.Node`
  stands: one per node server, owning the :class:`~repro.net.client.NodeClient`.
* :class:`RemoteSharedObject` — duck-types
  :class:`~repro.core.registry.SharedObject` (``name``, ``raw_call``,
  ``mode_of``, ``check_reachable``, ``touch``/``clear_holder``, ``header``,
  ``make_access``) so ``Transaction``, ``TransactionMonitor``-facing code,
  and ``txstore`` run unchanged over TCP.
* :class:`RemoteHeader` — the version-header surface
  (``wait_access``/``wait_termination``/``release_to``/``terminate_to``,
  counter reads) as RPCs against the home node's real header.
* :class:`RemoteObjectAccess` — the transport override of
  :class:`~repro.core.transaction.ObjectAccess`, built on the multiplexed
  pipelined connection:

  - §2.7 read-only buffering and §2.8.4 last-write log application are
    **fire-and-forget one-way kickoffs**; the home node pushes a completion
    note (with the read buffer's state when small — the piggyback read
    protocol), so joining the task is usually a local wait and buffered
    reads usually cost zero round trips;
  - early release and single terminates are **one-way notifications**;
    their server-side failures are deferred and surfaced at the
    transaction's next sync point (``raise_deferred``);
  - **operation fusion** (DESIGN.md §3.1 v3): a run of consecutive
    operations on one held object is one ``txn_call_batch`` RPC
    (error-index semantics: prefix applied, suffix not), a run starting
    at first access rides the ``open_call`` RPC (``tail=``), and writes
    past the transaction's last read of the object — single or an
    all-write run — are one-ways with deferred acks;
  - the commit/abort steps issue **per-node batched RPCs asynchronously**
    (``*_async`` → :class:`~repro.net.client.Future`), so one commit wave
    costs one overlapped round trip across all home nodes;
  - genuinely synchronous operations (gate wait + checkpoint, live-state
    method calls, dispensing) remain single awaited RPCs — they are the
    ones whose *results* the operation semantics need before proceeding.

  The write log is recorded locally (pure writes need no synchronization,
  §2.8.4) and ships once, at apply time. Live object state never crosses
  the wire; only read-buffer *snapshots* small enough to ship do.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from repro_torch.core.api import RemoteObjectFailure, Suprema, warn_deprecated
from repro_torch.core.transaction import Completed, ObjectAccess

from .client import Future, NodeClient
from .leases import LeaseFencedError, ObjectMovedError
from .transport import CLIENT_ID, Transport, load_buf

# The failure-detection grace before promoting a follower (DESIGN.md §8)
# is transport-supplied (`Transport.failover_grace`): one detection period
# >> the maximum one-way latency, so every frame a dead primary queued
# before crashing has landed by promotion time — 50 ms real time on TCP,
# derived from the virtual link latencies under simnet.


class _RemoteBufMarker:
    """Client-side stand-in for a copy buffer that lives on the home node."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover
        return "<buffer @ home node>"


_REMOTE_BUF = _RemoteBufMarker()


class RemoteTask:
    """Join handle for an asynchronous task running on the home node.

    The kickoff was pipelined (one-way, or riding the dispense RPC); the
    home node pushes a ``task_done`` note at completion — or delivered it
    on the dispense reply already — so ``join`` normally blocks on a
    *local* wait: zero round trips. How the wait blocks is the transport's
    business (:meth:`~repro.net.transport.Transport.join_task`): the TCP
    client parks on a real event with a ``task_join`` RPC fallback, the
    sim transport yields to the virtual-time scheduler. Either way the
    transport's crash-stop handling fails the wait if the node dies, so
    no joiner can hang on a vanished server.
    """

    __slots__ = ("acc",)

    def __init__(self, acc: "RemoteObjectAccess"):
        self.acc = acc

    def join(self) -> None:
        acc = self.acc
        client = acc.client
        client.raise_deferred(acc.txn_uid)   # sync point: kickoff errors
        wait = client.join_task(acc.txn_uid, acc.shared.name)
        if wait.error is not None:
            raise wait.error
        acc._mark_task_complete(wait.buf)


class RemoteHeader:
    """Version-header surface of a remotely homed object.

    ``lock`` is client-local (API compatibility for ``with header.lock``
    idioms); it provides no cross-client mutual exclusion — real mutual
    exclusion happens on the home node inside each RPC.
    """

    __slots__ = ("shared", "lock")

    def __init__(self, shared: "RemoteSharedObject"):
        self.shared = shared
        self.lock = threading.RLock()

    def _state(self) -> Dict[str, int]:
        return self.shared.client.call("header_state", name=self.shared.name)

    @property
    def gv(self) -> int:
        return self._state()["gv"]

    @property
    def lv(self) -> int:
        return self._state()["lv"]

    @property
    def ltv(self) -> int:
        return self._state()["ltv"]

    @property
    def instance(self) -> int:
        return self._state()["instance"]

    def wait_access(self, pv: int, *, timeout: Optional[float] = None) -> bool:
        return self.shared.client.call(
            "header_wait", name=self.shared.name, kind="access", pv=pv,
            timeout=timeout)

    def wait_termination(self, pv: int, *,
                         timeout: Optional[float] = None) -> bool:
        return self.shared.client.call(
            "header_wait", name=self.shared.name, kind="termination", pv=pv,
            timeout=timeout)

    def release_to(self, pv: int) -> None:
        self.shared.client.call("header_release", name=self.shared.name, pv=pv)

    def terminate_to(self, pv: int) -> None:
        self.shared.client.call("header_terminate", name=self.shared.name,
                                pv=pv)

    def __repr__(self) -> str:  # pragma: no cover
        return f"RemoteHeader({self.shared.name}@{self.shared.node.address})"


class RemoteNode:
    """Client-side handle for one node server process.

    The wire behind it is any :class:`~repro.net.transport.Transport`:
    by default a TCP :class:`NodeClient` is built for ``address``, while a
    pre-built transport (e.g. a simnet :class:`~repro.net.simnet.
    SimTransport`) can be injected via ``client=`` — everything above this
    point (proxies, access records, ``Transaction``) is transport-blind.
    """

    def __init__(self, address: str, client: Optional[Transport] = None,
                 **client_kw: Any):
        self.address = address
        self.client = (client if client is not None
                       else NodeClient(address, **client_kw))
        self.name = address          # refined to the server's node name
        self.alive = True
        self.network_delay = 0.0     # the wire is honest now
        self.registry = None         # set by Registry.connect (federation)

    def reconnect(self) -> bool:
        """Re-dial a node that crash-stopped and restarted at the same
        address (§11 durable identity). Transport-blind: transports
        without a ``reconnect`` (simnet routes by address and survives
        restarts natively) just report their liveness."""
        rc = getattr(self.client, "reconnect", None)
        ok = rc() if rc is not None else bool(self.client.alive)
        if ok:
            self.alive = True
        return ok

    def fetch_bindings(self) -> List["RemoteSharedObject"]:
        info = self.client.call("list_bindings")
        self.name = info["node"]
        followers = info.get("followers", {})
        commutes = info.get("commutes", {})
        out = []
        for n, modes in info["bindings"].items():
            shared = RemoteSharedObject(n, self)
            shared._modes.update(modes)   # no mode_of round trips later
            shared._commutes = dict(commutes.get(n, {}))
            shared.followers = list(followers.get(n, ()))
            out.append(shared)
        return out

    def bind(self, name: str, obj: Any, *args: Any,
             followers: List[str] = (), wal: Any = None,
             lease: Any = None) -> "RemoteSharedObject":
        """Bind ``obj`` under ``name`` on the remote server (ships the
        initial object state once; it lives server-side thereafter).

        The unified publish signature (DESIGN.md §12): keyword-only
        ``followers=()`` configures the object's replica chain (peer node
        addresses, in promotion order — the server seeds each replica and
        forwards committed state along the chain); ``wal``/``lease`` are
        node-level planes on the server, so only their defaults are
        accepted here. The legacy positional ``bind(name, obj, followers)``
        form still works but warns once. When this node was obtained via
        ``Registry.connect``, the new binding is registered there too, so
        ``locate`` sees it without re-connecting."""
        if args:
            warn_deprecated(
                "RemoteNode.bind:positional",
                "RemoteNode.bind(name, obj, followers) with positional "
                "followers is deprecated; use bind(name, obj, "
                "followers=...) — the unified keyword-only publish "
                "signature")
            followers = args[0]
        if wal is not None or lease is not None:
            raise ValueError(
                "wal/lease are configured node-wide on the server; "
                "RemoteNode.bind accepts only their defaults")
        res = self.client.call("bind", name=name, obj=obj,
                               followers=list(followers))
        if isinstance(res, dict) and "modes" in res:
            modes, commutes = res["modes"], res.get("commutes", {})
        else:             # legacy reply shape: the bare modes dict
            modes, commutes = res, {}
        shared = RemoteSharedObject(name, self)
        shared._modes.update(modes or {})
        shared._commutes = dict(commutes or {})
        shared.followers = list(followers)
        if self.registry is not None:
            self.registry.register_remote(shared)
        return shared

    def ping(self) -> Dict[str, Any]:
        return self.client.call("ping")

    def simulate_network(self, from_node: Optional[object]) -> None:
        """No-op: latency is real on this transport."""

    def crash(self) -> None:
        self.alive = False

    def shutdown(self) -> None:
        self.client.close()

    def __repr__(self) -> str:  # pragma: no cover
        return f"RemoteNode({self.name}@{self.address})"


class RemoteSharedObject:
    """Proxy for a shared object homed on a remote node server."""

    def __init__(self, name: str, node: RemoteNode):
        self.name = name
        self.node = node
        self.header = RemoteHeader(self)
        self.failed = False
        self._modes: Dict[str, Any] = {}
        #: {method: commute class} as declared at the home node (§12);
        #: None until fetched (bind/list_bindings ship it for free).
        self._commutes: Optional[Dict[str, str]] = None
        #: replica chain (DESIGN.md §8): peer addresses in promotion order.
        self.followers: List[str] = []

    @property
    def client(self) -> NodeClient:
        return self.node.client

    def make_access(self, txn: object, sup: Suprema) -> "RemoteObjectAccess":
        if getattr(sup, "commutes", None) is not None:
            return RemoteCommuteAccess(txn, self, sup)
        return RemoteObjectAccess(txn, self, sup)

    def mode_of(self, method: str):
        mode = self._modes.get(method)
        if mode is None:
            mode = self.client.call("mode_of", name=self.name, method=method)
            self._modes[method] = mode
        return mode

    def commute_of(self, method: str) -> Optional[str]:
        """Declared commute-class label of ``method``, or None (§12)."""
        return self.commute_classes().get(method)

    def commute_classes(self) -> Dict[str, str]:
        """All ``{method: commute class}`` declarations of this object."""
        if self._commutes is None:
            self._commutes = dict(
                self.client.call("commute_classes", name=self.name))
        return self._commutes

    def check_reachable(self) -> None:
        if self.failed or not self.client.alive or not self.node.alive:
            raise RemoteObjectFailure(
                f"remote object {self.name!r} @ {self.node.address} is "
                f"unreachable")

    def fail(self) -> None:
        self.failed = True

    # -- failover (DESIGN.md §8) ---------------------------------------------
    def _follower_node(self, addr: str) -> RemoteNode:
        reg = self.node.registry
        if reg is not None:
            try:
                node = reg.node(addr)    # pre-connected (sim / federation)
            except KeyError:
                return reg.connect(addr)
            client = getattr(node, "client", None)
            if client is not None and not (node.alive and client.alive):
                node.reconnect()         # §11: same address, reborn process
            return node
        return RemoteNode(addr)

    def follow_move(self, e: ObjectMovedError) -> None:
        """Follow an epoch-fenced redirect (§10 migration): re-point the
        binding at the new primary without reconnecting — the registry
        either already holds a connection to the target (sim/federation)
        or dials one lazily."""
        self.node = self._follower_node(e.target)
        self.failed = False
        if e.followers:
            self.followers = [a for a in e.followers if a != e.target]

    def ensure_primary(self) -> None:
        """Lease acquisition with quorum-of-chain acknowledgement (§10):
        fail over iff the current primary is dead (crash-stop: a node that
        looks dead IS dead) or fenced. Every client — and the decision
        chain's server-side redirect — walks the same configured order, so
        they converge on the same new primary. ``lease_acquire`` reports
        *busy* while the old primary's lease promise is still live (it
        self-fences before the promise lapses — waiting it out is the
        split-brain-freedom condition) or while a buffered tentative's
        coordinator is alive but undecided; both windows are bounded by
        one lease TTL, which the retry budget here outlasts."""
        if not self.failed and self.node.alive and self.client.alive:
            return
        if not self.followers:
            raise RemoteObjectFailure(
                f"remote object {self.name!r} @ {self.node.address} died "
                f"with no replica chain configured")
        # Failure-detection grace: promotion must not outrun frames the
        # dead primary queued before it crashed — in-flight tentatives and
        # decision redirects travel on OTHER links and carry committed
        # state. Crash-stop assumes detection time >> one-way latency (the
        # same assumption the §3.4 expiry reaper makes); sleeping one
        # detection period here makes it explicit. Transport-clocked:
        # virtual under simnet, 50ms real on TCP.
        self.client.sleep(self.client.failover_grace())
        for _attempt in range(90):
            busy_node = None
            for i, addr in enumerate(list(self.followers)):
                try:
                    node = self._follower_node(addr)
                    res = node.client.call("lease_acquire",
                                           names=[self.name])
                except Exception:  # noqa: BLE001 - this follower is dead too
                    continue
                if self.name in res.get("promoted", ()):
                    self.node = node
                    self.failed = False
                    self.followers = self.followers[i + 1:]
                    return
                if self.name in res.get("busy", ()):
                    busy_node = node
                    break   # this follower WILL promote; wait for it
                # unknown here (e.g. its init was lost): try the next one
            if busy_node is None:
                break
            busy_node.client.sleep(0.02)
        raise RemoteObjectFailure(
            f"no follower of {self.name!r} could be promoted")

    def raw_call(self, method: str, args: tuple = (), kwargs: dict = None,
                 from_node: Optional[object] = None) -> Any:
        """Non-transactional direct invocation at the home node (fails
        over to a promoted follower when the primary is dead or fenced,
        follows migration redirects — bounded hops, no reconnect)."""
        for _hop in range(3):
            self.ensure_primary()
            self.check_reachable()
            try:
                return self.client.call("raw_call", name=self.name,
                                        method=method, args=args,
                                        kwargs=kwargs or {})
            except ObjectMovedError as e:
                self.follow_move(e)
            except LeaseFencedError:
                self.fail()    # next hop resolves through the chain
        raise RemoteObjectFailure(
            f"raw_call on {self.name!r} kept redirecting (ownership moving "
            f"faster than the client can chase)")

    def touch(self, txn: object) -> None:
        uid = _txn_uid(txn, self.client.client_id)
        if uid is not None:
            self.client.notify("touch", txn=uid, name=self.name)

    def clear_holder(self, txn: object) -> None:
        uid = _txn_uid(txn, self.client.client_id)
        if uid is not None:
            self.client.notify("clear_holder", txn=uid, name=self.name)

    def __repr__(self) -> str:  # pragma: no cover
        return f"RemoteSharedObject({self.name}@{self.node.address})"


def _txn_uid(txn: object, client_id: str = CLIENT_ID) -> Optional[str]:
    tid = getattr(txn, "id", None)
    if tid is None:
        return None
    inc = getattr(txn, "incarnation", 0)
    # The incarnation makes retries distinct server-side: a late pipelined
    # note or end_txn of a rolled-back incarnation can't touch its successor.
    # ``client_id`` is the transport's process identity — the real process
    # id on TCP, a deterministic simulated-process id under simnet (which is
    # also what lets a fault injection crash ONE simulated client).
    return f"{client_id}#{tid}" if not inc else f"{client_id}#{tid}r{inc}"


class _WireCompletion:
    """Future adapter running a client-side epilogue at await time."""

    __slots__ = ("fut", "epilogue")

    def __init__(self, fut: Future, epilogue=None):
        self.fut = fut
        self.epilogue = epilogue

    def result(self, timeout: Optional[float] = None) -> Any:
        value = self.fut.result(timeout)
        if self.epilogue is not None:
            return self.epilogue(value)
        return value


class RemoteObjectAccess(ObjectAccess):
    """One transaction's access record for a remotely homed object.

    State stays on the home node; this record keeps only control state
    (counters, pv, flags) plus the locally recorded write log. ``st`` is
    never populated client-side — the abort checkpoint is taken and
    restored by the server session. ``buf`` holds either a marker (the
    buffer exists on the home node) or a :class:`_LocalBuf` copy shipped by
    the piggyback read protocol, in which case buffered reads are local.

    ``live_copy`` is the *held-state* piggyback: while this transaction
    holds the access, nothing else can modify the object, so the home node
    ships a (size-gated) state copy on ``open_call`` and refreshes it on
    every modifying call — pure reads in between run locally with zero
    round trips. Staleness is impossible by exclusion; an illusory-crash
    restore (§3.4) bumps the instance epoch and commit validation catches
    it, exactly as for §2.7 buffered reads.
    """

    __slots__ = ("live_copy",)

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.live_copy = None

    # -- identity -----------------------------------------------------------
    @property
    def txn_uid(self) -> str:
        return _txn_uid(self.txn, self.shared.client.client_id)

    @property
    def client(self) -> Transport:
        return self.shared.client

    @property
    def dispense_domain(self) -> tuple:
        # (scheme, address) — a node-level version-lock domain key that
        # sorts identically on every client (global 2PL order, §2.10.2),
        # across transports.
        return (self.shared.client.scheme, self.shared.node.address)

    # -- start (§2.10.2): batched per-node version dispensing ----------------
    def prepare_start(self) -> None:
        """Register liveness (mux hello + heartbeat) for this transaction —
        called *before* any version lock is acquired: connection setup can
        block in a TCP connect and must not stall other transactions
        parked behind our locked headers."""
        self.client.register_txn(self.txn_uid)

    def dispense_many(self, domains: List[List["RemoteObjectAccess"]]) -> None:
        """Chained lock-and-dispense over every remote node of the access
        set in ONE client round trip: the head node dispenses its batch
        (holding its gates), forwards the remainder of the chain to the
        next node in global order, and the aggregated reply returns every
        node's private versions. Acquisition order and hold discipline are
        exactly the sequential 2PL's — only the client bounces between
        nodes are gone, which also shrinks every gate-hold window to a
        server-to-server hop.

        The §2.7 read-only buffering kickoffs ride along for every node:
        tasks whose gate is already open complete during the dispense and
        their results (buffer state included) come back on the same reply
        — the uncontended read-only hot path costs zero extra messages."""
        uid = self.txn_uid
        kind = ("termination"
                if getattr(self.txn, "irrevocable", False) else "access")
        metas = []
        for accs in domains:
            ro_accs = [a for a in accs
                       if a.sup.read_only and a.sup.reads > 0]
            for a in ro_accs:
                a.client.task_wait(uid, a.shared.name)   # pre-register
            metas.append((accs, ro_accs))
        def commute_map(accs):
            return {a.shared.name: a.sup.commutes for a in accs
                    if getattr(a.sup, "commutes", None) is not None}

        head_accs, head_ro = metas[0]
        chain = []
        for accs, ro_accs in metas[1:]:
            ent = {"address": accs[0].shared.node.address,
                   "names": [a.shared.name for a in accs],
                   "ro_names": [a.shared.name for a in ro_accs]}
            cm = commute_map(accs)
            if cm:
                ent["commute"] = cm
            chain.append(ent)
        head_kw = {}
        head_cm = commute_map(head_accs)
        if head_cm:   # non-commute requests stay byte-identical on the wire
            head_kw["commute"] = head_cm
        try:
            res = self.client.call(
                "dispense_batch", txn=uid, client_id=self.client.client_id,
                names=[a.shared.name for a in head_accs],
                ro_names=[a.shared.name for a in head_ro], kind=kind,
                chain=chain,
                affinity=getattr(self.client, "affinity", None) or "",
                **head_kw)
        except ObjectMovedError as e:
            # Drop the start-time liveness registrations on the ORIGINAL
            # transports BEFORE any candidate re-pointing: end_txn must
            # reach the node that opened the session, or its reaper keeps
            # the ghost session alive while our heartbeats keep feeding
            # it — a self-sustaining wedge.
            for accs, _ro in metas:
                accs[0].client.finish_txn(uid)
            # §10 migration redirect: re-point the binding now so the
            # retried transaction dispenses at the new home directly.
            for accs, _ro in metas:
                for a in accs:
                    if a.shared.name == e.name:
                        a.shared.follow_move(e)
            raise
        except LeaseFencedError as e:
            for accs, _ro in metas:
                accs[0].client.finish_txn(uid)
            # the primary self-fenced (partition suspicion): treat it like
            # a dead home — the retry resolves through the follower chain.
            for accs, _ro in metas:
                for a in accs:
                    if a.shared.name == e.name:
                        a.shared.fail()
            raise
        pvs = res["pvs"]
        for accs, ro_accs in metas:
            for a in accs:
                a.pv = pvs[a.shared.name]
            for a in ro_accs:
                note = res["ro"].get(a.shared.name)
                if note is not None:   # completed during the dispense
                    a.client.resolve_task(uid, a.shared.name,
                                          note["error"], note["buf"])
                a.release_task = RemoteTask(a)

    def release_version_locks(self) -> None:
        """One-way: the gates free as soon as the server processes it; no
        reply to wait for (failures defer to the next sync point)."""
        self.client.notify("release_version_locks", txn=self.txn_uid)

    # -- §2.7 / §2.8.4: fire-and-forget kickoffs of home-node tasks ----------
    def spawn_ro_buffer(self, kind: str) -> None:
        self.client.task_wait(self.txn_uid, self.shared.name)  # pre-register
        self.client.notify("ro_buffer", txn=self.txn_uid,
                           name=self.shared.name, kind=kind)
        self.release_task = RemoteTask(self)

    def spawn_lastwrite_apply(self, kind: str) -> None:
        entries = list(self.log.entries)
        self.log.entries.clear()
        self.client.task_wait(self.txn_uid, self.shared.name)  # pre-register
        self.client.notify("lw_apply", txn=self.txn_uid,
                           name=self.shared.name, kind=kind, entries=entries)
        self.release_task = RemoteTask(self)

    def _mark_task_complete(self, buf=None) -> None:
        """A joined home-node task released the object and holds its state;
        ``buf`` carries the piggybacked local read buffer, if shipped."""
        with self.lock:
            self.released = True
            self.buf = buf if buf is not None else _REMOTE_BUF
            if not self.sup.read_only:
                self.holds_access = True
                self.modified = True

    def join_release_task(self) -> None:
        if self.release_task is not None:
            self.release_task.join()

    # -- synchronous state operations (single RPCs) --------------------------
    def open_access(self, kind: str, timeout: Optional[float]) -> bool:
        self.client.raise_deferred(self.txn_uid)
        res = self.client.call("open_access", txn=self.txn_uid,
                               name=self.shared.name, kind=kind,
                               timeout=timeout)
        self.seen_instance = res["instance"]
        self.holds_access = True
        return res["blocked"]

    def open_and_call(self, kind: str, timeout: Optional[float], method: str,
                      args: tuple, kwargs: dict, *, modifies: bool,
                      validity=None):
        """First direct access in one RPC: gate wait + checkpoint + log
        apply + the method call (the in-process path's three steps).
        ``validity`` is ignored: the home node enforces §2.3 inside the
        RPC, as on every other remote operation."""
        self.client.raise_deferred(self.txn_uid)
        entries = list(self.log.entries)
        self.log.entries.clear()
        res = self.client.call("open_call", txn=self.txn_uid,
                               name=self.shared.name, kind=kind,
                               timeout=timeout, entries=entries,
                               method=method, args=args, kwargs=kwargs,
                               modifies=modifies,
                               want_state=self._reads_ahead(0 if modifies
                                                            else 1))
        self.seen_instance = res["instance"]
        self.holds_access = True
        if modifies or entries:
            self.modified = True
        self.live_copy = load_buf(res.get("state"))
        return res["blocked"], res["value"]

    def open_and_call_batch(self, kind: str, timeout: Optional[float],
                            calls: List[tuple]) -> tuple:
        """Operation fusion across the open: gate wait + checkpoint +
        buffered-write apply + the whole FIFO run ``[(method, args,
        kwargs, modifies), ...]`` in ONE RPC — a read-modify-write hop on
        a fresh object costs a single round trip. Returns ``(blocked,
        values, error)`` with ``txn_call_batch`` error-index semantics
        (prefix applied, suffix not)."""
        self.client.raise_deferred(self.txn_uid)
        entries = list(self.log.entries)
        self.log.entries.clear()
        m0, a0, k0, mod0 = calls[0]
        n_reads = sum(1 for c in calls if not c[3])
        res = self.client.call("open_call", txn=self.txn_uid,
                               name=self.shared.name, kind=kind,
                               timeout=timeout, entries=entries,
                               method=m0, args=a0, kwargs=k0, modifies=mod0,
                               want_state=self._reads_ahead(n_reads),
                               tail=[tuple(c) for c in calls[1:]])
        self.seen_instance = res["instance"]
        self.holds_access = True
        values, error = res["values"], res["error"]
        if entries or any(c[3] for c in calls[:len(values)]):
            self.modified = True
        self.live_copy = load_buf(res.get("state"))
        return res["blocked"], values, error

    def raw_call(self, method: str, args: tuple, kwargs: dict, *,
                 modifies: bool) -> Any:
        self.client.raise_deferred(self.txn_uid)
        if not modifies:
            lc = self.live_copy
            if lc is not None:
                # Held-state piggyback: exclusive access means the copy is
                # exact — the pure read costs zero round trips.
                return lc.call(method, args, kwargs)
            return self.client.call("txn_call", txn=self.txn_uid,
                                    name=self.shared.name, method=method,
                                    args=args, kwargs=kwargs, modifies=False)
        res = self.client.call("txn_call", txn=self.txn_uid,
                               name=self.shared.name, method=method,
                               args=args, kwargs=kwargs, modifies=True,
                               want_state=self._reads_ahead(0))
        self.modified = True
        self.live_copy = load_buf(res.get("state"))
        return res["value"]

    def _reads_ahead(self, pending: int) -> bool:
        """Will this transaction still perform pure reads on this object
        (beyond ``pending`` in flight)? If not, a held-state copy has no
        consumer — don't ask the server to serialize one."""
        return self.sup.reads - self.rc - pending > 0

    def write_held(self, method: str, args: tuple, kwargs: dict) -> None:
        """§2.8.4 write on a held object. Past the transaction's last read
        of this object the value-less write needs no synchronous reply: it
        ships as a pipelined one-way — FIFO ahead of every later request
        on the same connection, so any subsequent synchronous operation
        observes it — with server-side failures deferred to the next sync
        point. One round trip saved per trailing write. While reads remain,
        the synchronous path keeps refreshing the held-state copy that
        serves them locally."""
        if self._reads_ahead(0):
            self.raw_call(method, args, kwargs, modifies=True)
            return
        self.client.notify("txn_call", txn=self.txn_uid,
                           name=self.shared.name, method=method, args=args,
                           kwargs=kwargs, modifies=True, want_state=False)
        self.modified = True
        self.live_copy = None   # live state moved without a refresh

    def raw_call_batch(self, calls: List[tuple], *,
                       all_writes: bool = False) -> tuple:
        """Operation fusion: one ``txn_call_batch`` RPC executes the whole
        run FIFO-atomically at the home node (atomic by exclusion — we
        hold the access) and replies with the values plus an error index
        on a mid-run failure, from which the caller restores sequential
        semantics. An all-write run past the last read degenerates to a
        single one-way (no values to wait for; errors deferred)."""
        self.client.raise_deferred(self.txn_uid)
        if all_writes and not self._reads_ahead(0):
            self.client.notify("txn_call_batch", txn=self.txn_uid,
                               name=self.shared.name, calls=list(calls),
                               want_state=False, raise_errors=True)
            self.modified = True
            self.live_copy = None
            return [None] * len(calls), None
        n_reads = sum(1 for c in calls if not c[3])
        any_mod = n_reads < len(calls)
        res = self.client.call(
            "txn_call_batch", txn=self.txn_uid, name=self.shared.name,
            calls=list(calls),
            want_state=any_mod and self._reads_ahead(n_reads))
        values, error = res["values"], res["error"]
        if any(c[3] for c in calls[:len(values)]):
            self.modified = True
            # The reply refreshes the held-state copy or invalidates it
            # (state moved; no refresh shipped on error / by request).
            self.live_copy = load_buf(res.get("state"))
        return values, error

    def buf_call(self, method: str, args: tuple, kwargs: dict) -> Any:
        self.client.raise_deferred(self.txn_uid)
        with self.lock:
            buf = self.buf
        if buf is not None and buf is not _REMOTE_BUF:
            # Piggybacked local copy: zero round trips.
            return buf.call(method, args, kwargs)
        # First read of a home-node buffer: ask for the buffer state to
        # ride along (piggyback), so subsequent reads are local.
        res = self.client.call("buf_call", txn=self.txn_uid,
                               name=self.shared.name, method=method,
                               args=args, kwargs=kwargs, want_buf=True)
        local = load_buf(res["buf"])
        if local is not None:
            with self.lock:
                self.buf = local
        return res["value"]

    def apply_log(self) -> None:
        if len(self.log):
            entries = list(self.log.entries)
            self.log.entries.clear()
            self.client.call("apply_log", txn=self.txn_uid,
                             name=self.shared.name, entries=entries)
            self.modified = True
            self.live_copy = None   # live state moved without a refresh

    def snapshot_buf(self) -> None:
        payload = self.client.call("buffer_snapshot", txn=self.txn_uid,
                                   name=self.shared.name)
        # The reply piggybacks the buffer state when small: trailing reads
        # after the last write/update are then local.
        self.buf = load_buf(payload) or _REMOTE_BUF

    def snapshot_and_release(self) -> None:
        """§2.8.3-4 release point as one pipelined one-way message: the
        writer's hot path never waits for it. With a live held-state copy
        (refreshed by the last modifying reply) the copy *is* the §2.8.3-4
        read buffer — trailing reads are local immediately and the server
        only needs the release. Without one, the buffer stays home and the
        first trailing read fetches it (with piggyback) via ``buf_call``."""
        lc = self.live_copy
        if lc is not None:
            self.client.notify("release", txn=self.txn_uid,
                               name=self.shared.name)
            self.buf = lc
        else:
            self.client.notify("snap_release", txn=self.txn_uid,
                               name=self.shared.name)
            self.buf = _REMOTE_BUF
        self.released = True

    def ensure_checkpoint(self) -> None:
        if self.seen_instance is None:
            self.seen_instance = self.client.call(
                "ensure_checkpoint", txn=self.txn_uid, name=self.shared.name)

    def release(self) -> None:
        """Early release is a one-way notification: successors unblock as
        soon as the server processes it, and this client's hot path never
        waits for the round trip. Errors defer to the next sync point."""
        if not self.released:
            self.client.notify("release", txn=self.txn_uid,
                               name=self.shared.name)
            self.released = True

    def wait_termination(self, timeout: Optional[float]) -> bool:
        self.client.raise_deferred(self.txn_uid)
        return self.client.call("wait_termination", txn=self.txn_uid,
                                name=self.shared.name, timeout=timeout)

    def valid(self) -> bool:
        """Cheap per-operation check: the home node enforces §2.3 on every
        state-touching RPC (raising InstanceInvalidated), so there is
        nothing to evaluate client-side between operations."""
        return True

    def valid_commit(self) -> bool:
        """Authoritative commit-time validation at the home node."""
        bad = self.client.call("validate", txn=self.txn_uid,
                               names=[self.shared.name])
        return not bad

    def valid_commit_batch(self, accs: List["RemoteObjectAccess"]) -> bool:
        """One validation RPC for the whole per-node batch (commit step 4)."""
        return self.valid_commit_batch_async(accs).result()

    # -- commit/abort steps: per-node batched, pipelined RPCs ----------------
    def wait_termination_batch_async(self, accs: List["RemoteObjectAccess"],
                                     timeout: Optional[float],
                                     best_effort: bool = False):
        """Commit step 2 for this node in one RPC, issued without waiting:
        the termination waits of all home nodes overlap."""
        if not best_effort:
            self.client.raise_deferred(self.txn_uid)
        return _WireCompletion(self.client.call_async(
            "wait_termination_batch", txn=self.txn_uid,
            names=[a.shared.name for a in accs], timeout=timeout,
            best_effort=best_effort))

    def commit_wave1_async(self, accs: List["RemoteObjectAccess"],
                           timeout: Optional[float]):
        """Commit steps 2-4 for this node in a single pipelined RPC: wait
        the commit condition, checkpoint/apply/release, validate. The
        waves of different home nodes run concurrently."""
        self.client.raise_deferred(self.txn_uid)
        items = []
        for a in accs:
            entries = list(a.log.entries)
            a.log.entries.clear()
            items.append((a.shared.name, entries))

        def epilogue(res: Dict[str, Any]):
            for a, (_n, entries) in zip(accs, items):
                if a.seen_instance is None:
                    a.seen_instance = -1   # checkpointed server-side
                if entries:
                    a.modified = True
                a.released = True
            return res["blocked"], not res["bad"]

        return _WireCompletion(
            self.client.call_async("commit_wave1", txn=self.txn_uid,
                                   items=items, timeout=timeout), epilogue)

    def valid_commit_batch_async(self, accs: List["RemoteObjectAccess"]):
        fut = self.client.call_async(
            "validate", txn=self.txn_uid,
            names=[a.shared.name for a in accs])
        return _WireCompletion(fut, lambda bad: not bad)

    def finish_batch_async(self, accs: List["RemoteObjectAccess"],
                           best_effort: bool = False):
        """Step 5 (terminate). On the commit path this is a pipelined
        one-way: by the time it is sent the client holds every domain's
        validation verdict — the only input termination needs — so waiting
        for a reply buys nothing. Successors parked on our versions wake
        as soon as the message lands (half a round trip), and a client
        that dies before delivery is exactly the paper's step-5 crash:
        §3.4 expiry converges the session. The abort path
        (``best_effort``) keeps the await: callers of an *aborted*
        transaction may immediately observe server state and must find the
        objects released."""
        uid = self.txn_uid
        names = [a.shared.name for a in accs]
        if best_effort:
            fut = self.client.call_async("finish_batch", txn=uid,
                                         names=names, best_effort=True,
                                         end=True)
        else:
            self.client.notify("finish_batch", txn=uid, names=names,
                               best_effort=True, end=True)
            fut = None
        for a in accs:
            a.released = True
            a.terminated = True
        self.client.mark_session_ended(uid)
        return Completed(None) if fut is None else _WireCompletion(fut)

    def commit_solo_async(self, accs: List["RemoteObjectAccess"],
                          timeout: Optional[float]):
        """Single-domain commit: steps 2-5 in ONE RPC (the validation
        verdict is local to this node, so it can terminate in the same
        unit and drop the session)."""
        self.client.raise_deferred(self.txn_uid)
        uid = self.txn_uid
        items = []
        for a in accs:
            entries = list(a.log.entries)
            a.log.entries.clear()
            items.append((a.shared.name, entries))
        # Commute-restricted accesses (§12) may have deferred dispensing
        # entirely: ship what the server needs to lazily join/dispense at
        # commit time. Absent for ordinary commits (byte-identical wire).
        extra: Dict[str, Any] = {}
        commute = {a.shared.name: a.sup.commutes for a in accs
                   if getattr(a.sup, "commutes", None) is not None}
        if commute:
            extra = {"client_id": self.client.client_id, "commute": commute}
            # Torn-delta fence: when one-way flushes preceded this commit,
            # ship the total delta count — the server refuses to fold a
            # partial set (an illusory-crash expiry may have discarded the
            # flushed prefix before the lazy commit re-created the session).
            counts = {a.shared.name: a.flushed + len(e)
                      for a, (_n, e) in zip(accs, items)
                      if getattr(a, "flushed", 0)}
            if counts:
                extra["commute_counts"] = counts

        def epilogue(res: Dict[str, Any]):
            ok = not res["bad"]
            for a, (_n, entries) in zip(accs, items):
                if a.seen_instance is None:
                    a.seen_instance = -1
                if entries:
                    a.modified = True
                a.released = True
                if ok:
                    a.terminated = True
            if ok:
                self.client.mark_session_ended(uid)
            return res["blocked"], ok

        fut = self.client.call_async("commit_solo", txn=uid, items=items,
                                     timeout=timeout, **extra)

        def recover(err: BaseException):
            """Home node died mid-RPC: same indeterminacy as a dead chain
            coordinator — the commit may have applied and replicated
            before the reply was lost. ``repl_final`` precedes the reply
            on every follower link, so after one detection grace a
            follower's decision ledger is authoritative: a recorded
            commit is reported as success, anything else dooms to abort
            (first-writer-wins, same as the chain path)."""
            if isinstance(err, LeaseFencedError):
                for a in accs:       # fenced primary: re-resolve next txn
                    if a.shared.name == err.name:
                        a.shared.fail()
            self.client.sleep(self.client.failover_grace())
            targets: List[str] = []
            for a in accs:
                for addr in a.shared.followers:
                    if addr not in targets:
                        targets.append(addr)
            for addr in targets:
                try:
                    node = accs[0].shared._follower_node(addr)
                    d = node.client.call("txn_decision", txn=uid)
                except Exception:  # noqa: BLE001 - that follower died too
                    continue
                if d == "commit":
                    for a in accs:
                        if a.seen_instance is None:
                            a.seen_instance = -1
                        a.modified = True
                        a.released = True
                        a.terminated = True
                    self.client.mark_session_ended(uid)
                    return 0, True
                break   # authoritative abort
            raise err

        class _SoloCompletion:
            def result(_self, rpc_timeout: Optional[float] = None):
                try:
                    res = fut.result(rpc_timeout)
                except RemoteObjectFailure as e:
                    return recover(e)
                return epilogue(res)

        return _SoloCompletion()

    def commit_chain_async(self, domains: List[List["RemoteObjectAccess"]],
                           timeout: Optional[float]):
        """Chained multi-domain commit (DESIGN.md §8): ONE RPC to the
        first node in global domain order covers steps 2-5 for EVERY
        remote domain. The coordinator node runs its wave, chains the
        remaining waves server-to-server, makes the commit decision, and
        drives termination down the chain — the client's old N wave RPCs
        plus N terminate one-ways collapse into a single round trip, and
        a client crash after send can no longer strand a partial commit.

        If the coordinator dies mid-call, the decision may still have been
        made and replicated: recovery asks the coordinator's replica
        followers for the transaction's fate (``txn_decision``) before
        concluding abort — a recorded commit is re-driven there and
        reported as success here.
        """
        uid = self.txn_uid
        self.client.raise_deferred(uid)
        per_domain = []
        for accs in domains:
            items = []
            for a in accs:
                entries = list(a.log.entries)
                a.log.entries.clear()
                items.append((a.shared.name, entries))
            per_domain.append((accs, items))
        head_accs, head_items = per_domain[0]
        chain = [{"address": accs[0].shared.node.address,
                  "items": items,
                  "followers": {a.shared.name: list(a.shared.followers)
                                for a in accs if a.shared.followers}}
                 for accs, items in per_domain[1:]]
        fut = self.client.call_async("commit_chain", txn=uid,
                                     items=head_items, timeout=timeout,
                                     chain=chain)

        def mark_terminated() -> None:
            for accs, _items in per_domain:
                for a in accs:
                    a.released = True
                    a.terminated = True
                accs[0].client.mark_session_ended(uid)

        def epilogue(res: Dict[str, Any]):
            for accs, items in per_domain:
                for a, (_n, entries) in zip(accs, items):
                    if a.seen_instance is None:
                        a.seen_instance = -1   # checkpointed server-side
                    if entries:
                        a.modified = True
                    a.released = True
            ok = not res["bad"]
            if ok and res.get("decided"):
                mark_terminated()
            return res["blocked"], ok

        def recover(err: BaseException):
            """Coordinator died mid-RPC: its followers know the fate."""
            # The decision broadcast precedes every effect of the decision
            # but travels on other links: wait one detection grace so a
            # decision the dead coordinator DID replicate has landed
            # before we ask (else we could doom a committed transaction).
            if isinstance(err, LeaseFencedError):
                for accs, _items in per_domain:
                    for a in accs:   # fenced primary: re-resolve next txn
                        if a.shared.name == err.name:
                            a.shared.fail()
            self.client.sleep(self.client.failover_grace())
            targets: List[str] = []
            for a in head_accs:
                for addr in a.shared.followers:
                    if addr not in targets:
                        targets.append(addr)
            for addr in targets:
                try:
                    node = head_accs[0].shared._follower_node(addr)
                    d = node.client.call("txn_decision", txn=uid)
                except Exception:  # noqa: BLE001 - that follower died too
                    continue
                if d == "commit":
                    mark_terminated()
                    return 0, True
                break   # authoritative abort (first-writer-wins doom)
            raise err

        class _ChainCompletion:
            def result(_self, rpc_timeout: Optional[float] = None):
                try:
                    res = fut.result(rpc_timeout)
                except RemoteObjectFailure as e:
                    return recover(e)
                return epilogue(res)

        return _ChainCompletion()

    def rollback_batch_async(self, accs: List["RemoteObjectAccess"]):
        return _WireCompletion(self.client.call_async(
            "rollback_batch", txn=self.txn_uid,
            names=[a.shared.name for a in accs]))

    def raise_deferred(self) -> None:
        """Sync point for this access's pipelined one-way operations."""
        self.client.raise_deferred(self.txn_uid)

    def abandon(self) -> None:
        """Failed-start cleanup: the home node skips this transaction's
        dispensed versions in chain order and drops the session."""
        self.client.call("abandon", txn=self.txn_uid)

    def rollback(self) -> None:
        self.client.call("rollback", txn=self.txn_uid, name=self.shared.name)

    def terminate(self) -> None:
        self.client.notify("terminate", txn=self.txn_uid,
                           name=self.shared.name)
        self.terminated = True

    def note_contact(self) -> None:
        """No-op: every session RPC refreshes the server-side detector, and
        the client heartbeat covers idle stretches."""

    def check_reachable(self) -> None:
        self.shared.check_reachable()

    def finish_session(self) -> None:
        self.client.finish_txn(self.txn_uid)


#: Client-side delta buffer high-water mark (§12): a commute-restricted
#: access ships its buffered deltas as one ``commute_delta`` one-way per
#: this many entries; the remainder rides the commit RPC. Low enough to
#: bound client memory on long hot-key transactions, high enough that
#: short ones (< DELTA_FLUSH deltas) cost zero extra messages.
DELTA_FLUSH = 8


class RemoteCommuteAccess(RemoteObjectAccess):
    """Commute-restricted access record for a remotely homed object (§12).

    The transaction promised to touch the object only through methods of
    one commuting class, so nothing here needs synchronization:

    - **deferred dispensing**: when the whole access set is commute-only
      on one remote node, ``dispense_for`` skips the dispense RPC entirely
      (``defer_start``); the home node lazily joins the object's commute
      group — or falls back to an exact version — at the first delta
      one-way or at commit, whichever arrives first;
    - **mergeable deltas**: invocations are recorded locally (a §2.8.4
      log) and ship as pipelined ``commute_delta`` one-ways past
      ``DELTA_FLUSH`` entries — FIFO on the same mux connection as the
      commit RPC that follows, so the server always folds a complete
      delta set. One-ways are only used on the deferred (single-domain)
      path: a multi-domain commit forwards its items server-to-server,
      which would race client-issued one-ways;
    - whether the server *actually* joined a commute group or fell back
      to exact dispensing (snap-back, §12) is invisible here: commute
      methods are write-only, so there is no value to return either way.
    """

    __slots__ = ("deferred_start", "flushed")

    #: dispense_for may skip the dispense RPC for an all-commute
    #: single-remote-domain access set (§12 deferred start).
    can_defer_start = True

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.deferred_start = False
        self.flushed = 0

    @property
    def commute_cls(self) -> str:
        return self.sup.commutes

    def defer_start(self) -> None:
        """Skip dispensing: the home node joins/dispenses lazily."""
        self.deferred_start = True
        self.pv = 0

    def record_commute(self, method: str, args: tuple, kwargs: dict) -> None:
        self.log.record(method, args, kwargs)
        if self.deferred_start and len(self.log.entries) >= DELTA_FLUSH:
            entries = list(self.log.entries)
            self.log.entries.clear()
            self.flushed += len(entries)
            self.client.notify(
                "commute_delta", txn=self.txn_uid,
                client_id=self.client.client_id, name=self.shared.name,
                cls=self.commute_cls, entries=entries)
            self.modified = True
