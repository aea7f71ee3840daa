"""Lease-based ownership + epoch fencing (DESIGN.md §10).

Every replicated object's primary holds a time-bounded, epoch-fenced
ownership *lease* over it. The lease is renewed with one-way messages to
the object's follower chain riding the existing reaper cadence
(``NodeCore.reap_stale``): real time on TCP, the virtual clock under
simnet — so renewal schedules are deterministic per seed.

Safety argument, in the model's terms:

* **Durations, never absolute times, cross the wire.** ``time.monotonic``
  is per-process on TCP; a follower that receives ``lease_renew`` with a
  ``ttl`` records ``promise_until = follower_now + ttl`` — which, because
  the message spent time in flight, ends strictly *later* than the
  primary's own ``expires = send_time + ttl``. The safe direction: the
  primary self-fences before any follower's promise lapses.
* **Self-fencing.** A primary that sent renewals and reached ``expires``
  without a quorum of follower acks *fences*: it stops granting versions
  (``check_grant`` raises), refuses commit finalization, and refuses
  non-transactional reads — so a partitioned old primary can neither ack
  unreplicated commits nor serve stale state while a promoted follower
  moves on. Fencing requires *evidence of refusal* (an unanswered renewal
  round); a lease that merely lapsed while the node was idle (the reaper
  disarms with no sessions) re-arms by a **quorum-of-chain
  re-acknowledgement**: the first grant after an idle lapse starts a
  renewal round and *refuses to serve* (``LeaseRearming`` — the op
  handler parks outside the locks and retries) until every live follower
  re-acks the epoch, so a primary that was superseded while idle learns
  the successor's higher epoch *before* acting, not after.
* **Promise = promotion refusal.** A follower holding a live promise
  answers ``lease_acquire``/``promote`` with *busy* until the promise
  lapses; by construction the old primary fenced before that, so no two
  nodes ever act as primary for one object in the same epoch
  (split-brain freedom — auditable via :func:`set_split_brain_auditor`).
* **Epoch fencing.** Promotion and migration bump the epoch. A fenced
  primary keeps retrying renewals; an ack reporting a *higher* epoch is
  proof a successor exists: the fence becomes permanent and the binding
  turns into a redirect tombstone clients follow without reconnecting.
* **Elastic membership.** A follower whose renewal *send* fails
  (crash-stop: the node is gone, not silent) is removed from the lease
  quorum — a dead follower must not wedge a live primary, and no
  promotion can originate from a dead node. Silence (sends succeed,
  acks never come — a partition) is what fences.

Ownership *migration* (the drain-barrier in ``NodeCore._do_migrate``)
reuses the same epoch machinery: the target binds at ``epoch + 1`` and
the old primary keeps a redirect tombstone, exactly like a permanent
fence that knows its successor.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.api import RemoteObjectFailure

#: Lease duration (seconds; virtual under simnet). Renewal fires at the
#: half-life, so one full renewal round trip fits well inside the window;
#: the promotion busy-retry loop in ``ensure_primary`` (60 x 20 ms) spans
#: more than one TTL, so a client outlasts any promise it must wait out.
LEASE_TTL = 1.0


class LeaseFencedError(RemoteObjectFailure):
    """Raised by a self-fenced primary instead of acting as one.

    Clients treat it like a dead home node: fail over (the follower chain
    either holds a live promise — retried as *busy* — or promotes).
    """

    def __init__(self, name: str, epoch: int, node: str = "?"):
        super().__init__(
            f"lease for {name!r} (epoch {epoch}) is fenced at {node}")
        self.name = name
        self.epoch = epoch
        self.node = node

    def __reduce__(self):   # multi-arg ctor: survive the wire's pickle
        return (LeaseFencedError, (self.name, self.epoch, self.node))


class ObjectMovedError(RemoteObjectFailure):
    """Epoch-fenced redirect: the object migrated to ``target``.

    Carries everything the client needs to re-point its binding without
    reconnecting: the new home address, the new epoch, and the new
    follower chain.
    """

    def __init__(self, name: str, target: str, epoch: int,
                 followers: Tuple[str, ...] = ()):
        super().__init__(f"object {name!r} moved to {target} "
                         f"(epoch {epoch})")
        self.name = name
        self.target = target
        self.epoch = epoch
        self.followers = list(followers)

    def __reduce__(self):   # multi-arg ctor: survive the wire's pickle
        return (ObjectMovedError,
                (self.name, self.target, self.epoch, tuple(self.followers)))


class LeaseRearming(Exception):
    """Internal (never crosses the wire): an idle-lapsed lease is
    re-arming and must not serve until the quorum-of-chain
    re-acknowledgement round completes. The op handler waits on
    ``event`` OUTSIDE the header/lease locks, then retries
    ``check_grant`` — which either serves (round completed), raises the
    fence (round refused/unanswered), or re-raises this (still in
    flight)."""

    def __init__(self, name: str, event: threading.Event):
        super().__init__(f"lease for {name!r} is re-arming")
        self.name = name
        self.event = event


# -- split-brain auditor (sweep invariant hook) ------------------------------
_auditor: Optional[Callable[[str, int, str], None]] = None


def set_split_brain_auditor(fn: Optional[Callable[[str, int, str], None]]
                            ) -> None:
    """Install ``fn(name, epoch, node_name)``, called every time a node
    *acts as primary* for ``name`` at ``epoch`` (grants a version, binds,
    promotes, or accepts a migration). The simsweep invariant asserts no
    ``(name, epoch)`` is ever acted on by two nodes."""
    global _auditor
    _auditor = fn


def _audit(name: str, epoch: int, node: str) -> None:
    fn = _auditor
    if fn is not None:
        fn(name, epoch, node)


class _Owned:
    """Primary-side lease state for one object."""

    __slots__ = ("epoch", "expires", "awaiting", "renew_sent", "fenced",
                 "rearm")

    def __init__(self, epoch: int, expires: float):
        self.epoch = epoch
        self.expires = expires
        self.awaiting: Set[str] = set()   # followers whose ack is pending
        self.renew_sent: float = -1.0     # -1: no renewal round in flight
        self.fenced = False
        #: idle-lapse re-arm barrier: set when the quorum re-ack round
        #: resolves (completed, self-renewed, or fenced); None otherwise
        self.rearm: Optional[threading.Event] = None


class LeaseManager:
    """Per-node lease table: primary-side owned leases, follower-side
    promises, and redirect tombstones for migrated/moved objects.

    ``core`` is the hosting :class:`~repro.net.server.NodeCore`; the only
    surface used is ``address``, ``node_name``, ``_clock``, ``_peer`` and
    ``replication.followers`` — so the manager is transport-blind and the
    test stubs stay valid.
    """

    def __init__(self, core, ttl: float = LEASE_TTL):
        self.core = core
        self.ttl = ttl
        self.lock = threading.RLock()
        self.owned: Dict[str, _Owned] = {}
        #: follower-side promises: name -> (epoch, until, primary_addr)
        self.promises: Dict[str, Tuple[int, float, str]] = {}
        #: redirect tombstones: name -> (target_addr, epoch, followers)
        self.moved: Dict[str, Tuple[str, int, List[str]]] = {}
        #: crash-stop departures observed while renewing (elastic
        #: membership: dead followers leave the quorum, never re-join)
        self.departed: Set[str] = set()
        self.n_renews = 0        # renewal one-ways sent (bench metric)
        self.n_fences = 0
        self.n_acks = 0

    # -- primary side ---------------------------------------------------------
    def grant_local(self, name: str, epoch: int) -> None:
        """This node becomes (or confirms itself as) primary for ``name``
        at ``epoch``: bind, promotion, or migration-in."""
        now = self.core._clock()
        with self.lock:
            self.owned[name] = _Owned(epoch, now + self.ttl)
            self.promises.pop(name, None)
            self.moved.pop(name, None)
        wal = getattr(self.core, "wal", None)
        if wal is not None:
            wal.lease(name, epoch)
        _audit(name, epoch, self.core.node_name)

    def drop_local(self, name: str, target: str, epoch: int,
                   followers: List[str]) -> None:
        """Ownership left this node: keep an epoch-fenced redirect."""
        with self.lock:
            self.owned.pop(name, None)
            self.moved[name] = (target, epoch, list(followers))
        wal = getattr(self.core, "wal", None)
        if wal is not None:
            wal.tombstone(name, target, epoch, list(followers))

    def epoch_of(self, name: str) -> int:
        with self.lock:
            o = self.owned.get(name)
            return o.epoch if o is not None else -1

    def _followers(self, name: str) -> List[str]:
        chain = self.core.replication.followers.get(name, ())
        return [a for a in chain if a not in self.departed]

    @staticmethod
    def _rearm_done(o: _Owned) -> None:
        """The idle-lapse re-ack round resolved (quorum ack, self-renew,
        or fence): wake the parked grant attempts so they retry."""
        if o.rearm is not None:
            o.rearm.set()
            o.rearm = None

    def _send_renewals(self, name: str, o: _Owned, now: float) -> None:
        """One renewal round: one-way ``lease_renew`` to every live
        follower. Caller holds ``self.lock``."""
        targets = self._followers(name)
        if not targets:
            # no quorum to consult: self-renew (unreplicated object, or
            # every follower provably departed — crash-stop)
            o.expires = now + self.ttl
            o.renew_sent = -1.0
            o.awaiting.clear()
            o.fenced = False
            self._rearm_done(o)
            return
        o.renew_sent = now
        o.awaiting = set(targets)
        for addr in targets:
            try:
                self.core._peer(addr).notify(
                    "lease_renew", name=name, epoch=o.epoch, ttl=self.ttl,
                    primary=self.core.address)
                self.n_renews += 1
            except Exception:  # noqa: BLE001 - crash-stop: follower is gone
                self.departed.add(addr)
                o.awaiting.discard(addr)
        if not o.awaiting:          # every follower departed mid-round
            o.expires = now + self.ttl
            o.renew_sent = -1.0
            o.fenced = False
            self._rearm_done(o)

    def tick(self, now: float) -> None:
        """Renewal/fencing pass, riding ``reap_stale`` (the reaper thread
        on TCP; the virtual-clock reaper event under simnet)."""
        with self.lock:
            for name, o in self.owned.items():
                if name in self.moved:
                    continue
                if o.renew_sent >= 0 and o.awaiting and now >= o.expires:
                    # a full renewal round went unanswered: refusal
                    # evidence — fence (kept retrying below; acks with our
                    # epoch un-fence, a higher epoch makes it permanent)
                    if not o.fenced:
                        o.fenced = True
                        self.n_fences += 1
                        self._trace_fence(name, o.epoch)
                        self._rearm_done(o)   # waiters retry → fence
                    self._send_renewals(name, o, now)
                elif o.renew_sent < 0 and now >= o.expires - self.ttl / 2:
                    self._send_renewals(name, o, now)

    def on_renew(self, name: str, epoch: int, ttl: float,
                 primary: str) -> None:
        """Follower side of ``lease_renew``: record the promise, ack."""
        now = self.core._clock()
        ok, cur = True, epoch
        with self.lock:
            mine = self.owned.get(name)
            if mine is not None and mine.epoch > epoch:
                ok, cur = False, mine.epoch      # I superseded you
            else:
                pe, pu, pp = self.promises.get(name, (-1, -1.0, ""))
                if pe > epoch:
                    ok, cur = False, pe          # promised to a successor
                else:
                    self.promises[name] = (epoch, now + ttl, primary)
        try:
            self.core._peer(primary).notify(
                "lease_ack", name=name, epoch=epoch, ok=ok, cur_epoch=cur,
                node=self.core.address)
        except Exception:  # noqa: BLE001 - primary died; its lease lapses
            pass

    def on_ack(self, name: str, epoch: int, ok: bool, cur_epoch: int,
               node: str) -> None:
        """Primary side of ``lease_ack``."""
        deposed = False
        with self.lock:
            o = self.owned.get(name)
            if o is None or o.epoch != epoch:
                return
            self.n_acks += 1
            if not ok and cur_epoch > o.epoch:
                # a successor exists: permanent fence + redirect tombstone
                # (the refusing follower is the best-known successor)
                o.fenced = True
                self.owned.pop(name, None)
                self.moved[name] = (node, cur_epoch, [])
                self._trace_fence(name, o.epoch, permanent=True)
                self._rearm_done(o)   # waiters retry → redirect
                wal = getattr(self.core, "wal", None)
                if wal is not None:
                    wal.tombstone(name, node, cur_epoch, [])
                deposed = True
            else:
                o.awaiting.discard(node)
                if not o.awaiting and o.renew_sent >= 0:
                    o.expires = o.renew_sent + self.ttl
                    o.renew_sent = -1.0
                    o.fenced = False      # quorum re-confirmed this epoch
                    self._rearm_done(o)
        if deposed:
            # Demote into the successor's chain (§11): a deposed primary
            # that only redirects forever leaves the chain one follower
            # short — rejoin it as the tail instead. Runs in the
            # background: the ack handler must not block on the drain.
            demote = getattr(self.core, "_demote_to_follower", None)
            spawn = getattr(self.core, "_spawn_bg", None)
            if demote is not None and spawn is not None:
                spawn(lambda: demote(name, node), name=f"demote-{name}")

    def check_grant(self, name: str) -> None:
        """Primary-side act-as-primary check: called before granting a
        version, finalizing a commit, or serving a non-transactional
        read. Raises the redirect or the fence; silently re-arms an
        idle-lapsed lease (see module docstring)."""
        now = self.core._clock()
        with self.lock:
            m = self.moved.get(name)
            if m is not None:
                raise ObjectMovedError(name, m[0], m[1], tuple(m[2]))
            o = self.owned.get(name)
            if o is None:
                return                # unleased (e.g. legacy bind path)
            if o.fenced:
                # Retry one round before refusing — the same healing
                # ``tick`` performs: a fence whose refusal evidence was a
                # follower that has since *crash-stopped* (its send is now
                # refused) departs the quorum here and self-renews; a mere
                # partition (silent) keeps us fenced until a quorum ack or
                # a successor's higher epoch (permanent) arrives.
                self._send_renewals(name, o, now)
                if o.fenced:
                    raise LeaseFencedError(name, o.epoch,
                                           self.core.node_name)
            if now >= o.expires:
                if o.renew_sent >= 0 and o.awaiting:
                    o.fenced = True   # unanswered round: fence lazily
                    self.n_fences += 1
                    self._trace_fence(name, o.epoch)
                    self._rearm_done(o)
                    # Same healing round as the fenced branch above: if
                    # the silence was a follower that has since crash-
                    # stopped (refused send), it departs and we self-renew
                    # instead of refusing forever; a silent partition
                    # keeps the fence.
                    self._send_renewals(name, o, now)
                    if o.fenced:
                        raise LeaseFencedError(name, o.epoch,
                                               self.core.node_name)
                else:
                    # idle lapse (reaper was disarmed): start a renewal
                    # round and refuse to serve until the chain re-acks
                    # this epoch (quorum-of-chain re-acknowledgement —
                    # a successor elected while we idled answers with
                    # its higher epoch, turning this into a redirect
                    # instead of a stale grant)
                    o.expires = now + self.ttl
                    self._send_renewals(name, o, now)
                    if o.renew_sent >= 0 and o.rearm is None:
                        o.rearm = threading.Event()
            if o.rearm is not None:
                # a re-ack round is still in flight: not serving yet
                raise LeaseRearming(name, o.rearm)
            epoch = o.epoch
        _audit(name, epoch, self.core.node_name)

    def promise_busy(self, name: str) -> bool:
        """Follower side: is a promotion/acquisition refused right now
        because the current primary's promise is still live?"""
        now = self.core._clock()
        with self.lock:
            pe, pu, _pp = self.promises.get(name, (-1, -1.0, ""))
            return pu > now

    def promised_primary(self, name: str) -> Optional[str]:
        """The primary address behind a still-live promise, or ``None``."""
        now = self.core._clock()
        with self.lock:
            pe, pu, pp = self.promises.get(name, (-1, -1.0, ""))
            return pp if pu > now else None

    def void_promise(self, name: str, primary: str) -> None:
        """Crash-stop evidence arrived: ``primary`` is provably dead (its
        connection is *refused*, not silent), so the promise it holds can
        never be exercised again — void it and let takeover proceed."""
        with self.lock:
            pe, pu, pp = self.promises.get(name, (-1, -1.0, ""))
            if pp == primary:
                self.promises.pop(name, None)

    def on_grant(self, name: str, epoch: int, primary: str) -> bool:
        """Follower side of the *synchronous* ``lease_grant`` sent by a
        freshly promoted/acquiring primary: acknowledge the new epoch
        (quorum-of-chain acknowledgement). Refuse only a stale epoch."""
        now = self.core._clock()
        with self.lock:
            pe, pu, _pp = self.promises.get(name, (-1, -1.0, ""))
            if pe > epoch:
                return False
            mine = self.owned.get(name)
            if mine is not None and mine.epoch >= epoch:
                return False
            self.promises[name] = (epoch, now + self.ttl, primary)
        return True

    def stats(self) -> Dict[str, int]:
        with self.lock:
            fenced = sum(1 for o in self.owned.values() if o.fenced)
            return {"owned": len(self.owned), "fenced": fenced,
                    "moved": len(self.moved), "renews": self.n_renews,
                    "acks": self.n_acks, "fences": self.n_fences}

    def _trace_fence(self, name: str, epoch: int,
                     permanent: bool = False) -> None:
        tr = getattr(self.core, "obs_tracer", None)
        if tr is not None:
            from repro_torch.obs import txtrace
            if txtrace.enabled:
                tr.instant("lease_fence",
                           detail=f"{name}@e{epoch}"
                                  f"{'!' if permanent else ''}",
                           sev=txtrace.WARN)
