"""The narrow client-side transport interface (DESIGN.md §3.1, §7).

Everything :mod:`repro.net.remote` needs from a wire is a small surface —
issue a request and await its reply (``call`` / ``call_async``), send a
fire-and-forget one-way (``notify``), join a home-node task, and the
per-transaction bookkeeping that rides on top (deferred one-way errors,
task-completion waits, liveness registration). :class:`Transport` is that
surface plus the transport-*independent* half of the bookkeeping, shared by
its two implementations:

* :class:`repro.net.client.NodeClient` — the real TCP transport: the
  multiplexed pipelined connections, wire-v3 framing, and the
  leader/follower demux all live **below** this interface and stay
  TCP-only;
* :class:`repro.net.simnet.SimTransport` — the deterministic simulation
  transport: frames are delivered directly between in-process endpoints by
  a seeded virtual-time scheduler, no sockets, no reader threads.

What is shared here (identical semantics on every transport):

* the **deferred-error** protocol: server-side failures of one-way
  messages come back as ``oneway_err`` notes, recorded per transaction and
  raised at its next sync point (:meth:`raise_deferred`);
* the **task-note** protocol: §2.7/§2.8.4 home-node task completions
  arrive as ``task_done`` notes (with the read buffer's pickled state
  attached when small — the piggyback read protocol) and resolve local
  :class:`TaskWait` handles;
* transaction liveness bookkeeping (``register_txn`` / ``finish_txn`` /
  ``mark_session_ended``) and the per-transaction message statistics the
  benchmarks report (``n_rpc`` / ``n_oneway`` / ...).
"""
from __future__ import annotations

import logging
import os
import pickle
import socket
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.api import RemoteObjectFailure
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import txtrace as _txtrace

log = logging.getLogger("repro_torch.net.transport")

#: Stable identity of this client *process* across all its transactions.
#: (Simulated client processes carry their own deterministic ids instead.)
CLIENT_ID = f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:6]}"


class LocalBuf:
    """Client-side copy of a home-node read buffer (piggyback protocol).

    Holds the unpickled ``__tx_snapshot__`` state a ``task_done`` note (or a
    ``buffer_snapshot`` reply) shipped because it was small; buffered reads
    then execute locally with zero round trips. Duck-types the ``call``
    surface of :class:`~repro.core.buffers.CopyBuffer`.
    """

    __slots__ = ("state",)

    def __init__(self, state: Any):
        self.state = state

    def call(self, method: str, args: tuple, kwargs: dict) -> Any:
        return getattr(self.state, method)(*args, **kwargs)

    def __repr__(self) -> str:  # pragma: no cover
        return f"LocalBuf({type(self.state).__name__})"


def load_buf(payload: Optional[bytes]) -> Optional[LocalBuf]:
    """Unpickle a piggybacked buffer state; ``None`` stays ``None``."""
    if payload is None:
        return None
    try:
        return LocalBuf(pickle.loads(payload))
    except Exception:  # noqa: BLE001 - class not importable here: read remotely
        return None


class TaskWait:
    """Local completion state of one fire-and-forget home-node task.

    Resolution goes through :meth:`resolve`, which fires the optional
    ``on_done`` hook after setting the event — the same completion shape
    as the TCP client's ``Future``. How a joiner *waits* on ``done`` is the
    transport's business (:meth:`Transport.join_task`).
    """

    __slots__ = ("done", "error", "buf", "on_done")

    def __init__(self):
        self.done = threading.Event()
        self.error: Optional[BaseException] = None
        self.buf: Optional[LocalBuf] = None
        self.on_done = None

    def resolve(self) -> None:
        self.done.set()
        cb = self.on_done
        if cb is not None:
            cb()


class _PerThreadCounter:
    """Exact multi-threaded counter with lock-free increments: every
    thread bumps a private cell (registered once, under the lock); reads
    sum the cells. The bench's ``c.n_oneway = 0`` reset-by-assignment
    folds into ``base`` via :meth:`set`. This replaces the former bare
    ``self.n_oneway += 1`` — an unlocked read-modify-write that could
    drop increments when pipelined writers raced the client thread,
    skewing the exact sim gate's per-txn message counts."""

    __slots__ = ("_lock", "_cells", "_tl", "_base")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cells: List[List[int]] = []
        self._tl = threading.local()
        self._base = 0

    def inc(self) -> None:
        c = getattr(self._tl, "c", None)
        if c is None:
            c = [0]
            with self._lock:
                self._cells.append(c)
            self._tl.c = c
        c[0] += 1

    def value(self) -> int:
        with self._lock:
            return self._base + sum(c[0] for c in self._cells)

    def set(self, v: int) -> None:
        with self._lock:
            for c in self._cells:
                c[0] = 0
            self._base = v


class Transport:
    """Abstract client-side transport to ONE home node (see module doc).

    Subclasses implement the message-moving primitives (``call_async``,
    ``notify``, ``join_task``, ``register_txn``, ``close``) and share the
    transaction-scoped bookkeeping implemented here. All shared state is
    guarded by ``self._lock``, which subclasses may also use for their own
    state (the TCP client does — one lock, exactly as before the split).
    """

    #: short transport-scheme tag; part of the dispense-domain sort key
    #: (must be identical for every client talking to the same node).
    scheme = "tcp"

    def __init__(self, address: str, client_id: str = CLIENT_ID):
        self.address = address
        self.client_id = client_id
        self.alive = True
        #: optional locality hint (a node address) shipped with dispense
        #: batches — feeds the home node's per-object access-affinity
        #: counters that drive lease migration (DESIGN.md §10).
        self.affinity: Optional[str] = None
        self._lock = threading.Lock()
        self._tasks: Dict[Tuple[str, str], TaskWait] = {}
        self._deferred: Dict[str, List[BaseException]] = {}
        self._active_txns: Set[str] = set()
        self._ended: Set[str] = set()           # server already dropped these
        # -- transport statistics (per-txn wire metrics in the bench) --------
        self.n_rpc = 0          # round-trip requests issued
        self._oneway = _PerThreadCounter()   # one-ways: see n_oneway property
        self.n_inline = 0       # replies read by their own awaiting caller
        self.n_handoff = 0      # replies delivered across a thread handoff

    # -- abstract message primitives -----------------------------------------
    def call_async(self, op: str, **kwargs: Any):
        """Issue ``op`` without waiting; returns a future with
        ``result(timeout)`` / ``done()`` semantics."""
        raise NotImplementedError

    @property
    def n_oneway(self) -> int:
        """One-way messages sent — exact under concurrency (per-thread
        cells, summed here; the bench's ``c.n_oneway = 0`` reset goes
        through the setter)."""
        return self._oneway.value()

    @n_oneway.setter
    def n_oneway(self, v: int) -> None:
        self._oneway.set(v)

    def _obs_tracer(self):
        """Site for this transport's client-side rpc spans — the calling
        thread's bound tracer by default; the sim transport overrides the
        fallback so even setup-phase calls read the virtual clock."""
        return _txtrace.current()

    def call(self, op: str, rpc_timeout: Optional[float] = None,
             **kwargs: Any) -> Any:
        """Invoke ``op`` and wait for its reply (value or re-raised error)."""
        if _txtrace.enabled:
            tr = self._obs_tracer()
            t0 = tr.now()
            v = self.call_async(op, **kwargs).result(rpc_timeout)
            dur = tr.now() - t0
            tr.emit("rpc", t0, dur, txn=kwargs.get("txn") or "", detail=op)
            _metrics.registry(tr.site).histogram("rpc_us").record(dur * 1e6)
            return v
        return self.call_async(op, **kwargs).result(rpc_timeout)

    def notify(self, op: str, **kwargs: Any) -> None:
        """Fire-and-forget one-way message: no reply, errors deferred."""
        raise NotImplementedError

    def join_task(self, txn_uid: str, name: str) -> TaskWait:
        """Block until the named home-node task's completion is known
        locally; returns its resolved :class:`TaskWait` (the caller
        re-raises ``wait.error``)."""
        raise NotImplementedError

    def register_txn(self, txn_uid: str) -> None:
        """Track a live transaction (presence + heartbeat setup)."""
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        """Transport-clocked backoff (failover promote retries): real time
        on TCP, virtual time under the simulation transport."""
        time.sleep(seconds)

    def failover_grace(self) -> float:
        """Failure-detection grace before promoting a follower or querying
        a decision ledger (DESIGN.md §8): one detection period >> the
        maximum one-way latency, so every frame a dead primary queued
        before crashing has landed by promotion time. Transport-supplied
        so the simulation derives it from its *virtual* link latencies
        instead of a wall-clock constant."""
        return 0.05

    def close(self) -> None:
        raise NotImplementedError

    # -- deferred errors and task notes (shared) ------------------------------
    def raise_deferred(self, txn_uid: str) -> None:
        """Sync point: raise the first deferred one-way error of ``txn_uid``
        recorded since the last sync point, if any."""
        with self._lock:
            errors = self._deferred.pop(txn_uid, None)
        if errors:
            raise errors[0]

    def _task_wait(self, txn_uid: str, name: str) -> TaskWait:
        with self._lock:
            return self._tasks.setdefault((txn_uid, name), TaskWait())

    def task_wait(self, txn_uid: str, name: str) -> TaskWait:
        """The local completion handle of a fire-and-forget home-node task
        (created on kickoff, resolved by the pushed ``task_done`` note, a
        carrier reply via :meth:`resolve_task`, or transport death)."""
        return self._task_wait(txn_uid, name)

    def resolve_task(self, txn_uid: str, name: str,
                     error: Optional[BaseException],
                     buf: Optional[bytes]) -> None:
        """Resolve a task wait from a result that rode back on a carrier
        reply (e.g. an inline-completed §2.7 task on the dispense reply)."""
        wait = self._task_wait(txn_uid, name)
        wait.error = error
        wait.buf = load_buf(buf)
        wait.resolve()

    def _handle_note(self, note: Dict[str, Any]) -> None:
        """Process one server note (``task_done`` / ``oneway_err``) —
        identical protocol on every transport."""
        kind = note.get("kind")
        if kind == "task_done":
            key = (note["txn"], note["name"])
            with self._lock:
                if note["txn"] not in self._active_txns:
                    log.debug("dropping task note for finished txn %r", key)
                    return
                wait = self._tasks.setdefault(key, TaskWait())
            wait.error = note.get("error")
            wait.buf = load_buf(note.get("buf"))
            wait.resolve()
        elif kind == "oneway_err":
            txn = note.get("txn")
            err = note.get("error") or RuntimeError("one-way op failed")
            log.debug("deferred one-way error for txn %r op %r: %r",
                      txn, note.get("op"), err)
            if txn is None:
                return
            with self._lock:
                active = txn in self._active_txns
                if active:
                    self._deferred.setdefault(txn, []).append(err)
            if not active:
                # Arrived after the transaction finished locally (e.g. a
                # pipelined step-5 terminate racing a §3.4 expiry): there
                # is no sync point left to raise it at — the epoch
                # machinery keeps the system consistent, but make the
                # partial termination visible as a structured WARN event
                # on the trace (severity-tagged, correlated to the txn)
                # instead of an ad-hoc stderr line.
                if _txtrace.enabled:
                    _txtrace.current().instant(
                        "oneway_err", txn=txn or "",
                        detail=f"{note.get('op')}: {err!r}"[:120],
                        sev=_txtrace.WARN)
                log.debug("one-way %r failed for finished txn %r: %r",
                          note.get("op"), txn, err)
                return
            # A failed kickoff never produces a completion note: fail the
            # task wait too, or its joiner would hang forever.
            if note.get("op") in ("ro_buffer", "lw_apply") and note.get("name"):
                wait = self._task_wait(txn, note["name"])
                wait.error = err
                wait.resolve()
        else:  # pragma: no cover - forward compatibility
            log.warning("ignoring unknown note kind %r from %s",
                        kind, self.address)

    # -- transaction lifecycle (shared) ---------------------------------------
    def mark_session_ended(self, txn_uid: str) -> None:
        """The server already dropped this session (``finish_batch`` with
        ``end``): :meth:`finish_txn` skips its trailing ``end_txn``."""
        with self._lock:
            self._ended.add(txn_uid)

    def finish_txn(self, txn_uid: str) -> None:
        """The transaction terminated everywhere: drop the server session
        and every local trace of the transaction."""
        with self._lock:
            if txn_uid not in self._active_txns:
                return
            self._active_txns.discard(txn_uid)
            self._deferred.pop(txn_uid, None)
            ended = txn_uid in self._ended
            self._ended.discard(txn_uid)
            for key in [k for k in self._tasks if k[0] == txn_uid]:
                del self._tasks[key]
        if ended:
            return
        try:
            self.notify("end_txn", txn=txn_uid)
        except RemoteObjectFailure:
            pass  # server is gone; nothing left to clean up there

    def _fail_task_waits(self, waits, err: BaseException) -> None:
        """Resolve unfinished task waits with ``err`` (crash-stop: no
        joiner may hang on a vanished server)."""
        for w in waits:
            if not w.done.is_set():
                w.error = err
                w.resolve()
