"""RPC client: multiplexed pipelined connections with **leader/follower
demultiplexing** (DESIGN.md §3.1 v3).

One :class:`NodeClient` per (client process, node server), owning a small
fixed set of framed TCP connections with per-thread affinity. Every request
is tagged with a request id; :meth:`NodeClient.call_async` issues without
waiting — the pipelining primitive the transaction hot path is built on.

**Leader/follower.** A caller blocked on a :class:`Future` does not park
behind a reader thread: it takes over its connection's read loop (becomes
the *leader*), demultiplexes incoming frames inline — resolving other
callers' futures and handling pushes as they appear — and returns the
moment its own reply arrives, promoting a waiting *follower* to leader on
the way out. The common RPC therefore completes with **zero thread
handoffs**: the reply is read by the very thread that wants it, on its own
timeslice. A per-connection *fallback* reader thread covers the windows
when nobody is waiting (pushed task notes, deferred-error notes, one-way
traffic, idle links): it sleeps while a leader holds the connection and
only drains frames that arrive leaderless, so it never steals a reply a
caller could have read inline. Leadership hygiene: a departing leader
first drains every frame already sitting in its buffered reader (a frame
buffered but unread is invisible to the fallback's readiness poll), and a
leader that times out mid-wait releases the socket and promotes a
follower — no frame is lost or delivered twice because exactly one thread
ever reads the connection.

**One-way messages** (:meth:`notify`) carry no request id and expect no
reply: §2.7 read-only-buffering kickoffs, §2.8.4 last-write apply kickoffs,
trailing held-object writes (operation fusion, §2.8), release/terminate
notifications, heartbeats. Server-side failures of one-way ops come back
as ``oneway_err`` *notes* and are recorded per transaction;
:meth:`raise_deferred` surfaces them at the transaction's next sync point
(error deferral, per the paper's asynchrony model: an asynchronous
operation's error belongs to the operation that awaits it).

**Pushed task notes**: when a §2.7/§2.8.4 home-node task completes, the
server pushes a ``task_done`` note on this same connection (piggybacked on
an in-flight reply when one is departing, a standalone push otherwise),
carrying the task's outcome and — when small — the pickled state of the
read buffer it produced. ``join`` of a release task is then a local wait,
and buffered reads execute against the shipped state: usually zero extra
round trips.

Failure mapping (§3.4): any socket-level failure flips the client to
``alive = False`` (crash-stop — a node that vanished is *removed from the
system*), **fails every in-flight future and task wait** so no caller
hangs, and surfaces as :class:`~repro.core.api.RemoteObjectFailure`, which
the transaction machinery already routes through its abort path.

Liveness rides the same link: the connection announces itself with
``mux_hello`` (the server maps it to this process's sessions — the OS
closing it is the instant crash-stop signal), and while this process has
live transactions a daemon thread sends one-way ``heartbeat`` messages
naming them.
"""
from __future__ import annotations

import collections
import itertools
import logging
import random
import select
import socket
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.api import RemoteObjectFailure
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import txtrace as _txtrace

from .transport import (CLIENT_ID, LocalBuf, TaskWait, Transport, load_buf)
from .wire import (ConnectionClosed, FrameReader, NOTE, OK, WireError,
                   parse_address, recv_msg, send_msg)

log = logging.getLogger("repro_torch.net.client")

#: Mux-connect retry budget: first retry after ~50 ms, doubling to a
#: 500 ms cap, each jittered to 50–150% — worst case well under the
#: failure detector's timeout, so a genuinely dead server still reads as
#: crash-stop promptly.
_CONNECT_ATTEMPTS = 4

# Backwards-compatible aliases: the bookkeeping classes moved to
# repro.net.transport when the Transport interface was carved out.
_LocalBuf = LocalBuf
_TaskWait = TaskWait

#: Fallback reader's yield interval while replies are owed and their
#: about-to-lead callers should read them inline (see _fallback_loop).
FALLBACK_GRACE = 0.002

#: How long a task join waits for the pushed completion note before falling
#: back to an explicit ``task_join`` RPC (covers any lost-push edge case
#: — e.g. a chain-dispensed node that had no client connection to push
#: on — with one bounded round trip instead of a hang).
JOIN_PUSH_GRACE = 1.0


class Future:
    """Completion handle for one in-flight request.

    When issued by :meth:`NodeClient.call_async`, :meth:`result` does not
    merely park on an event — it enters the connection's leader/follower
    protocol, so the waiter reads its own reply inline whenever the
    connection is free.
    """

    __slots__ = ("_done", "_value", "_error", "on_done", "_client", "_mux")

    def __init__(self):
        self._done = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None
        #: invoked (once set) right after completion — the follower wakeup
        #: hook of the leader/follower protocol.
        self.on_done = None
        self._client: Optional["NodeClient"] = None
        self._mux: Optional["_Mux"] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self._done.set()
        cb = self.on_done
        if cb is not None:
            cb()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._done.set()
        cb = self.on_done
        if cb is not None:
            cb()

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.is_set():
            if self._client is not None and self._mux is not None:
                self._client._await_reply(self._mux, self, timeout)
            else:
                self._done.wait(timeout)
        if not self._done.is_set():
            raise TimeoutError("RPC reply did not arrive in time")
        if self._error is not None:
            raise self._error
        return self._value


class _Mux:
    """One established multiplexed connection.

    ``leader_lock`` is the read-side leadership token: its holder — a
    blocked caller, or the fallback thread during leaderless windows — is
    the only thread that may touch ``reader``. ``lead_free`` mirrors the
    lock for waiters that must park until leadership is released;
    ``followers`` holds the wakeup events of callers parked behind the
    current leader, in arrival order, for promotion on leader exit.
    """

    __slots__ = ("sock", "send_lock", "reader", "leader_lock", "lead_free",
                 "followers", "f_lock", "owed")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.send_lock = threading.Lock()
        self.reader = FrameReader(sock)
        self.leader_lock = threading.Lock()
        self.lead_free = threading.Event()
        self.lead_free.set()
        self.followers: "collections.deque" = collections.deque()
        self.f_lock = threading.Lock()
        #: replies owed on this connection (in-flight request count,
        #: guarded by the client lock) — the fallback reader's signal
        #: that a caller-leader is imminent and the socket is theirs.
        self.owed = 0


class NodeClient(Transport):
    """Multiplexed RPC endpoint for one node server (the TCP transport).

    A small fixed set of mux connections (``conns``) is shared by all
    caller threads with *per-thread affinity*: each thread is pinned to one
    connection, so every message sequence a single transaction produces is
    FIFO on its wire (one-way kickoffs are processed before the requests
    pipelined behind them), while independent client threads get
    independent reader/writer pipelines. The read side of each connection
    is driven by whichever caller is currently awaiting a reply on it
    (leader/follower, see module docstring); the per-connection fallback
    thread only reads during leaderless windows.
    """

    def __init__(self, address: str, *, connect_timeout: float = 5.0,
                 heartbeat_interval: float = 0.5, conns: int = 4):
        super().__init__(address)
        self.host, self.port = parse_address(address)
        self.connect_timeout = connect_timeout
        self.heartbeat_interval = heartbeat_interval
        self._muxes: List[Optional[_Mux]] = [None] * max(1, conns)
        self._tl = threading.local()            # per-thread conn affinity
        self._rr = itertools.count()            # round-robin assignment
        self._conn_lock = threading.Lock()      # connection establishment
        self._req_ids = itertools.count(1)
        self._pending: Dict[int, Future] = {}
        self._hb_thread: Optional[threading.Thread] = None
        self._closed = threading.Event()

    # -- connection ----------------------------------------------------------
    def _mux_for_thread(self) -> _Mux:
        idx = getattr(self._tl, "idx", None)
        if idx is None:
            idx = next(self._rr) % len(self._muxes)
            self._tl.idx = idx
        mux = self._muxes[idx]
        return mux if mux is not None else self._establish(idx)

    def _establish(self, idx: int) -> _Mux:
        with self._conn_lock:
            if self._muxes[idx] is not None:
                return self._muxes[idx]
            if not self.alive or self._closed.is_set():
                raise RemoteObjectFailure(
                    f"node server {self.address} is unreachable (crash-stop)")
            # Transient refusals (backlog overflow, port exhaustion, a
            # server still binding its listener) get a bounded, jittered
            # exponential backoff before the connection counts as dead —
            # jitter decorrelates a thundering herd of clients retrying
            # into the same backlog that just overflowed.
            err: Optional[Exception] = None
            for attempt in range(_CONNECT_ATTEMPTS):
                if attempt:
                    delay = (min(0.05 * (2 ** (attempt - 1)), 0.5)
                             * (0.5 + random.random()))
                    if _txtrace.enabled:
                        self._obs_tracer().instant(
                            "connect_retry",
                            detail=f"{self.address} #{attempt} "
                                   f"+{delay * 1000:.0f}ms",
                            sev=_txtrace.WARN)
                    time.sleep(delay)
                    if not self.alive or self._closed.is_set():
                        break
                try:
                    sock = socket.create_connection(
                        (self.host, self.port), timeout=self.connect_timeout)
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                    # Handshake before any reader exists: announce this
                    # process (the server maps the connection to our
                    # sessions — the drop of our last connection is the
                    # §3.4 instant crash-stop signal) and await the ack on
                    # the still-private socket.
                    send_msg(sock,
                             (0, "mux_hello", {"client_id": self.client_id}))
                    req_id, status, value, _notes = recv_msg(sock)
                    if req_id != 0 or status != OK:
                        raise ConnectionClosed("mux_hello rejected")
                    sock.settimeout(None)   # replies may take long
                    err = None
                    break
                except (OSError, ConnectionClosed, WireError) as e:
                    err = e
            if err is not None:
                # Still refused after the backoff budget. Establishing a
                # *supplementary* connection must not crash-stop the whole
                # client while an established healthy connection exists:
                # re-pin this thread onto one instead.
                for i, mux in enumerate(self._muxes):
                    if mux is not None and self.alive:
                        self._tl.idx = i
                        return mux
                self._mark_dead(f"connect failed: {err}")
                raise RemoteObjectFailure(
                    f"node server {self.address} is unreachable: "
                    f"{err}") from err
            mux = _Mux(sock)
            self._muxes[idx] = mux
            threading.Thread(
                target=self._fallback_loop, args=(mux,),
                name=f"mux-fallback-{self.address}-{idx}", daemon=True).start()
            return mux

    def _send(self, msg: Any) -> _Mux:
        mux = self._mux_for_thread()
        self._send_on(mux, msg)
        return mux

    def _send_on(self, mux: _Mux, msg: Any) -> None:
        try:
            with mux.send_lock:
                send_msg(mux.sock, msg)
        except (OSError, WireError) as e:
            self._mark_dead(f"send failed: {e}")
            raise RemoteObjectFailure(
                f"node server {self.address} failed mid-send: {e}") from e

    # -- read side: leader/follower demux ------------------------------------
    def _dispatch_msg(self, msg: Any, own: Optional[Future] = None,
                      mux: Optional[_Mux] = None) -> None:
        """Demultiplex one inbound message (notes, pushes, replies) to its
        consumers. ``own`` is the dispatching leader's awaited future, for
        the inline-vs-handoff statistics; ``mux`` the connection the
        message arrived on, for its owed-reply account."""
        req_id, status, value, notes = msg
        for note in notes or ():
            self._handle_note(note)
        if req_id is None or status == NOTE:
            return
        with self._lock:
            fut = self._pending.pop(req_id, None)
            if fut is not None:
                if mux is not None and mux.owed > 0:
                    mux.owed -= 1
                if fut is own:
                    self.n_inline += 1
                else:
                    self.n_handoff += 1
        if fut is None:
            # Late reply after a client-side timeout abandoned the
            # call: drop it — the conversation moved on. Recorded as a
            # structured WARN event on the trace (was an ad-hoc warning
            # line), so timeout storms show up per-connection in the
            # merged trace instead of scrolling past on stderr.
            if _txtrace.enabled:
                _txtrace.current().instant(
                    "late_reply", sev=_txtrace.WARN,
                    detail=f"req={req_id} from {self.address}")
            log.debug("dropping reply with unknown request id %r "
                      "from %s (late reply after timeout?)",
                      req_id, self.address)
            return
        if status == OK:
            fut.set_result(value)
        else:
            fut.set_error(value)

    def _await_reply(self, mux: _Mux, fut: Future,
                     timeout: Optional[float]) -> None:
        """Wait for ``fut`` by the leader/follower protocol (the core loop
        is :meth:`_drive`)."""
        self._drive(mux, fut, fut,
                    None if timeout is None else time.monotonic() + timeout)

    def _drive(self, mux: _Mux, waitable: Any, own: Optional[Future],
               deadline: Optional[float]) -> None:
        """The leader/follower core: wait for ``waitable`` (a
        :class:`Future`) by leading the connection's read loop when
        leadership is free, otherwise parking as a follower until
        completion, a departing leader's promotion, or the deadline.
        Returns with the waitable done or the deadline passed.

        Only *reply* waits drive the read loop. Task joins (§2.7/§2.8.4)
        deliberately do not: they are gated on other transactions'
        progress and may park for a long time — a long-lived leader
        funnels every concurrent caller's reply through itself (thread
        handoffs for everyone, measured 3-4x worse under contention).
        RPC waits are short-lived by comparison: leadership turns over at
        every completed reply."""
        is_done = waitable.done
        wake = threading.Event()
        waitable.on_done = wake.set
        if is_done():
            return
        while True:
            if is_done():
                return
            if deadline is not None and time.monotonic() >= deadline:
                return
            if mux.leader_lock.acquire(blocking=False):
                mux.lead_free.clear()
                try:
                    self._lead(mux, is_done, own, deadline)
                finally:
                    mux.leader_lock.release()
                    mux.lead_free.set()
                    self._promote(mux)
                if is_done():
                    return
                continue    # led until timeout (or marked dead): loop exits
            # Follower: park until completion, a promotion, or the
            # deadline. The wait is sliced (0.5 s) so any lost-promotion
            # race heals at the next slice instead of hanging.
            with mux.f_lock:
                mux.followers.append(wake)
            try:
                slice_ = (0.5 if deadline is None
                          else max(0.0, min(0.5, deadline - time.monotonic())))
                wake.wait(slice_)
            finally:
                with mux.f_lock:
                    try:
                        mux.followers.remove(wake)
                    except ValueError:
                        pass    # consumed by a promotion
            wake.clear()

    def _lead(self, mux: _Mux, is_done: Any, fut: Optional[Future],
              deadline: Optional[float]) -> None:
        """Drive the connection's read loop until the awaited completion
        (``is_done``) fires — and the buffered reader holds no further
        frame: a buffered-but-unread frame would be invisible to the
        fallback's readiness poll — or the deadline passes. Exactly one
        thread runs this per connection (the ``leader_lock`` holder), so
        no frame is ever read twice."""
        reader, sock = mux.reader, mux.sock
        while True:
            if reader.has_frame():
                try:
                    self._dispatch_msg(reader.recv_msg(), fut, mux)
                except WireError as e:
                    self._mark_dead(f"connection corrupt: {e}")
                    return
                continue
            if is_done():
                return
            try:
                if deadline is None:
                    # No deadline: block straight in recv (one syscall per
                    # drain) — our reply, or the crash-stop EOF, ends it.
                    self._dispatch_msg(reader.recv_msg(), fut, mux)
                    continue
                wait = deadline - time.monotonic()
                if wait <= 0:
                    return      # timed out as leader: caller promotes
                readable, _, _ = select.select([sock], [], [], wait)
                if not readable:
                    return      # timed out as leader
                self._dispatch_msg(reader.recv_msg(), fut, mux)
            except (ConnectionClosed, WireError, OSError, ValueError) as e:
                if not self._closed.is_set():
                    self._mark_dead(f"connection lost: {e}")
                return

    def _promote(self, mux: _Mux) -> None:
        """Leader handoff: wake the longest-parked follower so it can take
        over the read loop. A lost race (a fresh caller grabs leadership
        first) is harmless — the promoted follower just parks again, and
        the fallback thread is the liveness backstop either way."""
        with mux.f_lock:
            if mux.followers:
                mux.followers.popleft().set()

    def _fallback_loop(self, mux: _Mux) -> None:
        """Reader of last resort: drains frames that arrive while *no
        caller* is awaiting a reply (pushed task notes, deferred-error
        notes, idle links). Parks whenever a leader holds the connection.
        The discriminator is the connection's **owed-reply account**
        (``mux.owed``). While replies are owed, their callers take
        leadership within microseconds — a fallback sitting in select
        would wake for every one of them (a spurious context switch per
        message, the exact cost the demux removes), so it just yields in
        short beats instead, bounded so a never-awaited future cannot
        starve pushes. With nothing owed, arriving data can only be a
        push: the fallback parks in select and delivers it the instant it
        lands (a §2.7 join note must not wait on a poll interval)."""
        sock = mux.sock
        spins = 0
        try:
            while not self._closed.is_set() and self.alive:
                if not mux.lead_free.wait(0.5):
                    continue            # a leader is reading; stay parked
                with self._lock:
                    owed = mux.owed
                if owed > 0 and spins < 25:
                    spins += 1          # a caller-leader is imminent
                    time.sleep(FALLBACK_GRACE)
                    continue
                spins = 0
                readable, _, _ = select.select([sock], [], [], 0.5)
                if not readable:
                    continue
                if not mux.leader_lock.acquire(blocking=False):
                    continue            # a caller beat us to the frames
                mux.lead_free.clear()
                try:
                    while True:
                        if not mux.reader.has_frame():
                            readable, _, _ = select.select([sock], [], [], 0)
                            if not readable:
                                break
                        self._dispatch_msg(mux.reader.recv_msg(), mux=mux)
                finally:
                    mux.leader_lock.release()
                    mux.lead_free.set()
                    self._promote(mux)
        except (ConnectionClosed, WireError, OSError, ValueError) as e:
            if not self._closed.is_set():
                self._mark_dead(f"connection lost: {e}")

    # -- RPC -----------------------------------------------------------------
    def call_async(self, op: str, **kwargs: Any) -> Future:
        """Issue ``op`` without waiting; returns a :class:`Future` whose
        ``result()`` participates in the leader/follower demux."""
        fut = Future()
        mux = self._mux_for_thread()   # may connect; never under the lock
        with self._lock:
            if not self.alive:
                raise RemoteObjectFailure(
                    f"node server {self.address} is unreachable (crash-stop)")
            req_id = next(self._req_ids)
            self._pending[req_id] = fut
            self.n_rpc += 1
            mux.owed += 1   # before the send: the reply may race us back
        try:
            self._send_on(mux, (req_id, op, kwargs))
        except BaseException:
            with self._lock:
                self._pending.pop(req_id, None)
                if mux.owed > 0:
                    mux.owed -= 1
            raise
        fut._mux = mux
        fut._client = self
        return fut

    def call(self, op: str, rpc_timeout: Optional[float] = None,
             **kwargs: Any) -> Any:
        """Invoke ``op`` and wait for its reply (value or re-raised error).

        ``rpc_timeout`` bounds the *wait*, not the server-side execution: on
        expiry the future is abandoned (its late reply will be dropped by
        whoever reads it) and :class:`TimeoutError` raised."""
        if _txtrace.enabled:
            return self._traced_call(op, rpc_timeout, kwargs)
        fut = self.call_async(op, **kwargs)
        try:
            return fut.result(rpc_timeout)
        except TimeoutError:
            with self._lock:
                stale = [rid for rid, f in self._pending.items() if f is fut]
                for rid in stale:
                    del self._pending[rid]
                mux = fut._mux
                if stale and mux is not None and mux.owed > 0:
                    mux.owed -= 1   # its late reply won't settle the account
            raise

    def _traced_call(self, op: str, rpc_timeout: Optional[float],
                     kwargs: Dict[str, Any]) -> Any:
        """``call`` with an ``rpc`` span (client clock domain) — the wire
        side of the tracereport phase decomposition."""
        tr = _txtrace.current()
        t0 = tr.now()
        txn = kwargs.get("txn") or ""
        fut = self.call_async(op, **kwargs)
        try:
            v = fut.result(rpc_timeout)
        except TimeoutError:
            with self._lock:
                stale = [rid for rid, f in self._pending.items() if f is fut]
                for rid in stale:
                    del self._pending[rid]
                mux = fut._mux
                if stale and mux is not None and mux.owed > 0:
                    mux.owed -= 1
            tr.emit("rpc", t0, tr.now() - t0, txn=txn, detail=op,
                    sev=_txtrace.WARN)
            raise
        dur = tr.now() - t0
        tr.emit("rpc", t0, dur, txn=txn, detail=op)
        _metrics.registry(tr.site).histogram("rpc_us").record(dur * 1e6)
        return v

    def notify(self, op: str, **kwargs: Any) -> None:
        """Fire-and-forget one-way message: no reply, errors deferred
        (server reports them as ``oneway_err`` notes; see
        :meth:`raise_deferred`)."""
        self._oneway.inc()   # exact, lock-free (per-thread cells)
        self._send((None, op, kwargs))

    # -- task joins -----------------------------------------------------------
    def join_task(self, txn_uid: str, name: str) -> TaskWait:
        """Join a home-node task: wait briefly for the pushed completion
        note, then fall back to one explicit ``task_join`` RPC.

        Deliberately a plain event wait, NOT a leadership-taking drive: a
        join is gated on OTHER transactions' progress and can park for a
        long time — holding the connection's read leadership that long
        would funnel every concurrent caller's reply through this thread
        (measured 3-4x worse under contention). The note is delivered by
        whichever leader or fallback reads it."""
        wait = self._task_wait(txn_uid, name)
        if not wait.done.wait(JOIN_PUSH_GRACE):
            # No note yet: ask explicitly (blocks server-side until the
            # task completes; re-raises its transactional error).
            res = self.call("task_join", txn=txn_uid, name=name)
            if not wait.done.is_set():
                self.resolve_task(txn_uid, name, None, res.get("buf"))
        return wait

    # -- failure (§3.4 crash-stop) -------------------------------------------
    def _mark_dead(self, reason: str) -> None:
        with self._lock:
            already = not self.alive
            self.alive = False
            muxes = [m for m in self._muxes if m is not None]
            self._muxes = [None] * len(self._muxes)
            pending = list(self._pending.values())
            self._pending.clear()
            waits = list(self._tasks.values())
        if already and not muxes and not pending and not waits:
            return
        err = RemoteObjectFailure(
            f"node server {self.address} is unreachable ({reason})")
        # No waiter hangs: every in-flight future and task join observes
        # the death immediately (leaders and followers wake via on_done).
        for fut in pending:
            fut.set_error(err)
        self._fail_task_waits(waits, err)
        for mux in muxes:
            try:
                mux.sock.close()
            except OSError:
                pass

    def reconnect(self) -> bool:
        """Re-dial a crash-stopped server that restarted at the same
        address (§11). ``_mark_dead`` is final for every in-flight future
        — those stay failed; this only re-opens the transport for NEW
        work once the reborn process is listening. Returns ``True`` iff a
        fresh connection (and mux hello) succeeded."""
        if self._closed.is_set():
            return False
        with self._lock:
            self.alive = True
            self._hb_thread = None   # old loop exited on death; re-armable
        try:
            self._mux_for_thread()
        except RemoteObjectFailure:
            return False             # still down: _establish re-marked dead
        return True

    # -- transaction liveness ------------------------------------------------
    def register_txn(self, txn_uid: str) -> None:
        """Track a live transaction: liveness (hello + heartbeat) rides the
        mux connection."""
        with self._lock:
            self._active_txns.add(txn_uid)
            need_hb = self._hb_thread is None
        self._mux_for_thread()
        if need_hb:
            t = threading.Thread(target=self._heartbeat_loop,
                                 name=f"hb-{self.address}", daemon=True)
            with self._lock:
                if self._hb_thread is None:
                    self._hb_thread = t
                    t.start()

    def _heartbeat_loop(self) -> None:
        while not self._closed.wait(self.heartbeat_interval):
            with self._lock:
                txns = list(self._active_txns)
                alive = self.alive
            if not alive:
                return
            if not txns:
                continue
            try:
                self.notify("heartbeat", client_id=self.client_id, txns=txns)
            except RemoteObjectFailure:
                return             # the mux died; crash-stop already handled

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._closed.set()
        with self._lock:
            muxes = [m for m in self._muxes if m is not None]
            self._muxes = [None] * len(self._muxes)
            pending = list(self._pending.values())
            self._pending.clear()
            waits = list(self._tasks.values())
        err = RemoteObjectFailure(f"client for {self.address} closed")
        for fut in pending:
            fut.set_error(err)
        self._fail_task_waits(waits, err)
        for mux in muxes:
            try:
                mux.sock.close()
            except OSError:
                pass

    def __repr__(self) -> str:  # pragma: no cover
        return f"NodeClient({self.address}, alive={self.alive})"
