"""Per-object replica chains: primary-side forwarding, follower-side state,
and the promotion state machine (DESIGN.md §8).

Each shared object may be bound with an ordered *follower* list. The
primary replicates in two phases keyed by the object's private version
(the §2.8.4 write log is applied at the primary first, and the *resulting
state* is what ships — direct ``txn_call`` modifications are covered too):

* **tentative** (``repl_apply``): sent at commit step 3 (``commit_prep``),
  under the object's header lock, *before* the wave reply that feeds the
  commit decision — so by the time any decision exists, every tentative is
  already in flight on a FIFO link that survives the primary's death;
* **final** (``repl_final``): sent at step 5 (terminate) — the follower
  applies the buffered tentative exactly once (``(epoch, seq)`` guard);
* **drop** (``repl_drop``): sent on abort/expiry — the tentative is
  discarded.

Commute-group members (§12) keep the same shape with one twist: their
fold is deferred past the commit decision, so the step-3 tentative ships
the *delta* (the buffered entry list, ``DELTA_MAGIC``-prefixed) instead
of a resulting-state snapshot, and the follower folds it into its
committed snapshot at resolution time. The tentative-before-decision
invariant therefore covers commute commits too.

The chained commit decision additionally records a
per-transaction commit/abort *decision ledger* at followers
(``repl_decision`` / first-writer-wins doom), which is what makes a
primary crash between decision and terminate recoverable: a promoted
follower resolves dangling tentatives against the ledger, querying the
coordinator's decision memo (``txn_status``) for undecided ones and
dooming them to abort only when no coordinator survives to decide
otherwise.

Promotion is caller-driven and deterministic: every client (and the
decision chain's redirect) tries a dead primary's followers in the same
configured order, so they converge on the same new primary. A promoted
follower binds the replica payload into its registry under a FRESH version
header (old private versions are meaningless there; in-flight transactions
against the dead primary abort and retry) and continues replicating to the
followers after itself in the original order, at ``epoch + 1`` so its new
version sequence cannot be confused with the dead primary's.
"""
from __future__ import annotations

import logging
import pickle
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.net.wal import encode_delta, fold_payload
from repro_torch.obs import txtrace as _txtrace

log = logging.getLogger("repro_torch.net.replication")

#: Follower-side decision-ledger backstop (§10 GC): entries are normally
#: retired by the head's ``repl_retire`` once every chain member acked the
#: decision; the cap only bites when the head died before retiring, and
#: evicts oldest-first among entries no live tentative still references.
LEDGER_CAP = 512

#: Retired-commit memo (§10 GC): retirement must not make a committed
#: transaction indistinguishable from a never-decided one — a client whose
#: coordinator crashed after driving the full chain (acks in, entry
#: retired) but before its reply was delivered still recovers via
#: ``txn_decision``, and dooming that txn to abort would contradict the
#: already-applied commit. Only commits ever retire (aborts are never
#: broadcast), so a fixed-size ring of retired txn ids suffices: recovery
#: happens within a failover grace of the crash, far inside the ring's
#: horizon. Ids only — no chains, no payloads — so the ledger stays bounded.
RETIRED_MEMO_CAP = 512


class ReplicaRecord:
    """Follower-side state of one replicated object."""

    __slots__ = ("name", "primary", "order", "epoch", "payload",
                 "applied", "tentative", "promoted", "recovering")

    def __init__(self, name: str, primary: str, order: List[str],
                 epoch: int, payload: bytes, applied: Tuple[int, int]):
        self.name = name
        self.primary = primary
        self.order = list(order)         # follower addresses, primary first
        self.epoch = epoch
        self.payload = payload           # pickled last-applied state
        self.applied = applied           # (epoch, seq) of `payload`
        #: buffered tentatives: txn uid -> (epoch, seq, payload, head addr)
        self.tentative: Dict[str, Tuple[int, int, bytes, str]] = {}
        self.promoted = False
        #: True for a record rebuilt from a WAL replay (§11): the image
        #: may be missing commits that landed while this node was dead
        #: and departed from the quorum, so it must NOT be promotable
        #: until the anti-entropy rejoin replaces it with a live snapshot.
        self.recovering = False


class ReplicationManager:
    """Both halves of the replica-chain protocol for one node.

    Primary half: follower configuration, tentative/final/drop forwarding
    (one-ways, counted in ``n_sent`` for the bench's
    ``replication_oneways_per_txn``), and the coordinator's decision memo.
    Follower half: replica records, the decision ledger, and promotion.

    All state is guarded by one reentrant lock; sends happen outside it
    (a one-way to a slow peer must not stall the op path).
    """

    def __init__(self, core: Any):
        self.core = core                 # NodeCore (``_peer``, ``address``)
        self.lock = threading.RLock()
        # -- primary side ----------------------------------------------------
        self.followers: Dict[str, List[str]] = {}
        self.epochs: Dict[str, int] = {}
        self.pending: Dict[Tuple[str, str], Tuple[int, int]] = {}
        self.n_sent = 0                  # replication one-ways sent
        # -- decision ledger (coordinator memo + follower recoverability) ----
        self.decisions: Dict[str, str] = {}          # txn -> commit | abort
        self.chains: Dict[str, List[dict]] = {}      # txn -> decision chain
        # -- ledger GC (§10): head-side ack tracking + retirement -------------
        self._acks: Dict[str, set] = {}            # txn -> followers unacked
        self._retire_targets: Dict[str, List[str]] = {}
        self._ended: set = set()                    # txns safe to retire
        self.n_retired = 0
        #: retired *commit* ids (head and follower side): keeps a retired
        #: commit answerable — never doomed to abort — during the client
        #: recovery window. Bounded ring, oldest evicted first.
        self._retired_commits: "OrderedDict[str, None]" = OrderedDict()
        # -- follower side ---------------------------------------------------
        self.replicas: Dict[str, ReplicaRecord] = {}

    # ------------------------------------------------------------------ #
    # plumbing                                                           #
    # ------------------------------------------------------------------ #
    def _notify(self, address: str, op: str, *, count: bool = True,
                **kw: Any) -> None:
        try:
            self.core._peer(address).notify(op, **kw)
            if count:
                with self.lock:
                    self.n_sent += 1
        except Exception as e:  # noqa: BLE001 - dead follower: chain degrades
            log.debug("replication one-way %s -> %s failed: %r",
                      op, address, e)

    @property
    def _wal(self):
        """The hosting node's write-ahead ledger (§11), or None. Every
        durable fact is appended *before* the network send that announces
        it (WAL-before-network), so a crash between the two replays the
        fact instead of losing it."""
        return getattr(self.core, "wal", None)

    def _wal_decision(self, txn: str, decision: str, first: bool) -> None:
        if first and self._wal is not None:
            self._wal.decision(txn, decision)

    # ------------------------------------------------------------------ #
    # primary side                                                       #
    # ------------------------------------------------------------------ #
    def set_followers(self, name: str, followers: List[str],
                      obj: Any) -> None:
        """Configure the follower chain at bind time and seed each replica
        with the initial state (epoch 0, seq 0)."""
        followers = [f for f in followers if f != self.core.address]
        with self.lock:
            self.followers[name] = followers
            self.epochs.setdefault(name, 0)
        if not followers and self._wal is None:
            return
        payload = pickle.dumps(obj)
        if self._wal is not None:
            self._wal.bind(name, payload, followers, self.epochs[name])
        for f in followers:
            self._notify(f, "repl_init", count=False, name=name,
                         primary=self.core.address, order=list(followers),
                         epoch=self.epochs[name], payload=payload, seq=0)

    def followers_of(self, name: str) -> List[str]:
        with self.lock:
            return list(self.followers.get(name, ()))

    def on_commit_prep(self, txn: str, name: str, obj: Any, seq: int,
                       origin: Optional[str]) -> None:
        """Tentative replication at commit step 3: snapshot the applied
        state (caller holds the header lock — the snapshot must precede the
        release that wakes successors) and forward it to every follower."""
        fl = self.followers_of(name)
        if not fl and self._wal is None:
            return
        with self.lock:
            epoch = self.epochs.get(name, 0)
            self.pending[(txn, name)] = (epoch, seq)
        payload = pickle.dumps(obj)
        head = origin or self.core.address
        if self._wal is not None:
            self._wal.tentative(txn, name, epoch, seq, payload, head)
        for f in fl:
            self._notify(f, "repl_apply", name=name, txn=txn, epoch=epoch,
                         seq=seq, payload=payload, head=head)

    def on_commute_prep(self, txn: str, name: str, entries: List[tuple],
                        seq: int, origin: Optional[str]) -> None:
        """Tentative replication for a commute-group member (§12). The
        fold is deferred past the commit decision (it runs at terminate,
        under the merge lock), so what ships at step 3 is the *delta* —
        the member's buffered entry list, marked by :data:`DELTA_MAGIC`.
        Followers fold it into their committed snapshot on final/decision
        instead of overwriting (:meth:`_apply`), which keeps the §8
        invariant — every tentative is in flight before any decision
        exists — true for commute commits too: a primary crashing between
        decision and fold no longer takes the only copy of the deltas
        with it while the promoted follower acks the decide."""
        fl = self.followers_of(name)
        if not fl and self._wal is None:
            return
        with self.lock:
            epoch = self.epochs.get(name, 0)
            self.pending[(txn, name)] = (epoch, seq)
        payload = encode_delta(entries)
        head = origin or self.core.address
        if self._wal is not None:
            self._wal.tentative(txn, name, epoch, seq, payload, head)
        for f in fl:
            self._notify(f, "repl_apply", name=name, txn=txn, epoch=epoch,
                         seq=seq, payload=payload, head=head)

    def on_terminate(self, txn: str, name: str) -> None:
        """Final replication at step 5: promote the pending tentative."""
        with self.lock:
            key = self.pending.pop((txn, name), None)
        if key is None:
            return
        epoch, seq = key
        if self._wal is not None:
            # Durability point: the committed write is WAL'd (and the
            # batch fsynced) before the finals go out / the op returns.
            self._wal.final(txn, name, epoch, seq)
        for f in self.followers_of(name):
            self._notify(f, "repl_final", name=name, txn=txn, epoch=epoch,
                         seq=seq)

    def on_abort(self, txn: str, name: str) -> None:
        """Abort/expiry: the tentative (if any) must be discarded."""
        with self.lock:
            key = self.pending.pop((txn, name), None)
        if key is None:
            return
        if self._wal is not None:
            self._wal.drop(txn, name)
        for f in self.followers_of(name):
            self._notify(f, "repl_drop", name=name, txn=txn)

    # ------------------------------------------------------------------ #
    # decision ledger                                                    #
    # ------------------------------------------------------------------ #
    def record_decision(self, txn: str, decision: str,
                        chain: Optional[List[dict]] = None) -> str:
        """First-writer-wins decision ledger. Returns the winning decision
        (which may differ from ``decision`` if one was already recorded)."""
        with self.lock:
            first = txn not in self.decisions
            d = self.decisions.setdefault(txn, decision)
            self._wal_decision(txn, d, first)
            if chain is not None and d == decision:
                self.chains.setdefault(txn, list(chain))
            if d == "commit":
                self._resolve_tentatives_commit(txn)
            elif d == "abort":
                self._resolve_tentatives_abort(txn)
            self._trim_ledger()
        if _txtrace.enabled and first:
            # The commit/abort decision point (DESIGN.md §8) — the moment
            # the outcome became durable on this node's ledger.
            self.core.obs_tracer.instant(
                "commit_decide", txn=txn, detail=d,
                sev=_txtrace.INFO if d == "commit" else _txtrace.WARN)
        return d

    def decision_of(self, txn: str) -> Optional[str]:
        with self.lock:
            d = self.decisions.get(txn)
            if d is None and txn in self._retired_commits:
                return "commit"   # retired entries were all commits (§10 GC)
            return d

    def chain_of(self, txn: str) -> List[dict]:
        with self.lock:
            return list(self.chains.get(txn, ()))

    def broadcast_decision(self, txn: str, chain: List[dict]) -> None:
        """Make the commit decision recoverable before acting on it: ship
        it (with the remaining decision chain) to every follower of this
        node's own objects. If this node dies mid-drive, any one of them
        can re-drive the chain when a recovering client asks."""
        targets: set = set()
        with self.lock:
            for fl in self.followers.values():
                targets.update(fl)
            # GC bookkeeping: this node is the ledger *head* for ``txn``.
            # The entry retires (here and at every target) once every
            # target acked the decision AND the transaction ended locally.
            self._acks[txn] = set(targets)
            self._retire_targets[txn] = sorted(targets)
        for t in sorted(targets):
            self._notify(t, "repl_decision", txn=txn, decision="commit",
                         chain=chain, head=self.core.address)

    # ------------------------------------------------------------------ #
    # follower side                                                      #
    # ------------------------------------------------------------------ #
    def _apply(self, rec: ReplicaRecord, epoch: int, seq: int,
               payload: bytes) -> None:
        # ``>=``, not ``>``: every member of one commute group (§12) ships
        # its delta tentative at the group's shared seq ``cg_pv`` — an
        # equal-seq resolution must still fold, or the follower would keep
        # only the FIRST member's effect. fold_payload folds a delta into
        # the committed snapshot and lets a snapshot replace it; each
        # tentative resolves at most once (pop semantics everywhere), so
        # equal-seq folds never double-apply. Exact commits are unaffected
        # (their seqs are distinct, their payloads full snapshots). The
        # quiescence rule makes the guard safe for deltas too: a group only
        # forms when every earlier commit's final has been sent on this
        # same FIFO link, so a delta can never fold over a snapshot that is
        # missing a predecessor.
        if (epoch, seq) >= rec.applied:
            rec.payload = fold_payload(rec.payload, payload)
            rec.applied = (epoch, seq)

    def _resolve_tentatives_commit(self, txn: str) -> None:
        for rec in self.replicas.values():
            t = rec.tentative.pop(txn, None)
            if t is not None and not rec.promoted:
                self._apply(rec, t[0], t[1], t[2])

    def _resolve_tentatives_abort(self, txn: str) -> None:
        for rec in self.replicas.values():
            rec.tentative.pop(txn, None)

    def repl_init(self, name: str, primary: str, order: List[str],
                  epoch: int, payload: bytes, seq: int) -> None:
        with self.lock:
            rec = self.replicas.get(name)
            if rec is not None and (rec.promoted
                                    or rec.applied > (epoch, seq)):
                return   # stale (re)init from an older generation
            self.replicas[name] = ReplicaRecord(
                name, primary, order, epoch, payload, (epoch, seq))
        if self._wal is not None:
            self._wal.init(name, primary, list(order), epoch, seq, payload)
        leases = getattr(self.core, "leases", None)
        if leases is not None:
            # Implicit promise (§10): accepting a chain seat IS a promise
            # not to promote past this primary until its lease could have
            # lapsed. Without it, a takeover in the window before the
            # first renewal round would race a healthy, un-fenced primary
            # (promises otherwise only appear on ``lease_renew``).
            leases.on_grant(name, epoch, primary)

    def repl_apply(self, name: str, txn: str, epoch: int, seq: int,
                   payload: bytes, head: str) -> None:
        with self.lock:
            rec = self.replicas.get(name)
            if rec is None or rec.promoted or epoch < rec.epoch:
                return   # stale primary generation
            d = self.decisions.get(txn)
            if d == "abort":
                return   # drop on the floor
            if self._wal is not None:
                self._wal.tentative(txn, name, epoch, seq, payload, head)
            if d == "commit":
                self._apply(rec, epoch, seq, payload)
            else:
                rec.tentative[txn] = (epoch, seq, payload, head)

    def repl_final(self, name: str, txn: str, epoch: int, seq: int) -> None:
        with self.lock:
            rec = self.replicas.get(name)
            if rec is not None and epoch < rec.epoch:
                return   # fenced-out primary generation (§10): reject
            self.decisions.setdefault(txn, "commit")
            self._trim_ledger()
            if self._wal is not None:
                # the final record doubles as the commit decision at
                # replay (recover() folds it into the decision ledger)
                self._wal.final(txn, name, epoch, seq)
            if rec is None or rec.promoted:
                return
            t = rec.tentative.pop(txn, None)
            if t is not None:
                self._apply(rec, t[0], t[1], t[2])

    def repl_drop(self, name: str, txn: str) -> None:
        with self.lock:
            rec = self.replicas.get(name)
            if rec is not None:
                rec.tentative.pop(txn, None)

    def repl_decision(self, txn: str, decision: str,
                      chain: List[dict], head: Optional[str] = None) -> None:
        self.record_decision(txn, decision, chain)
        if head and head != self.core.address:
            # Ack the ledger head so it can retire the entry (§10 GC).
            self._notify(head, "repl_decision_ack", count=False,
                         txn=txn, node=self.core.address)

    # ------------------------------------------------------------------ #
    # ledger GC (§10)                                                    #
    # ------------------------------------------------------------------ #
    def repl_decision_ack(self, txn: str, node: str) -> None:
        with self.lock:
            pending = self._acks.get(txn)
            if pending is not None:
                pending.discard(node)
        self._maybe_retire(txn)

    def mark_ended(self, txn: str) -> None:
        """The transaction's commit drive completed on this node — its
        ledger entry may retire as soon as every follower has acked."""
        with self.lock:
            if txn not in self.decisions:
                return
            self._ended.add(txn)
        self._maybe_retire(txn)

    def _memo_retired(self, txn: str) -> None:
        """Remember a retired commit id (lock held by caller)."""
        self._retired_commits[txn] = None
        self._retired_commits.move_to_end(txn)
        while len(self._retired_commits) > RETIRED_MEMO_CAP:
            self._retired_commits.popitem(last=False)

    def _maybe_retire(self, txn: str) -> None:
        with self.lock:
            pending = self._acks.get(txn)
            if pending is None or pending or txn not in self._ended:
                return
            self._acks.pop(txn, None)
            self._ended.discard(txn)
            targets = self._retire_targets.pop(txn, [])
            self.decisions.pop(txn, None)
            self.chains.pop(txn, None)
            self._memo_retired(txn)
            self.n_retired += 1
        for t in targets:   # sends outside the lock, like every one-way
            self._notify(t, "repl_retire", count=False, txn=txn)

    def repl_retire(self, txn: str) -> None:
        """Head says every chain member acked: drop the ledger entry. Any
        tentative for ``txn`` was resolved before this node's ack went out
        (FIFO link: repl_apply ≺ repl_decision ≺ our ack ≺ repl_retire)."""
        with self.lock:
            self.decisions.pop(txn, None)
            self.chains.pop(txn, None)
            self._memo_retired(txn)

    def fully_acked_unretired(self) -> int:
        """Invariant probe: at convergence this is 0 — every fully-acked,
        ended entry has been retired (simsweep ledger-boundedness check)."""
        with self.lock:
            return sum(1 for txn, pending in self._acks.items()
                       if not pending and txn in self._ended)

    def ledger_stats(self) -> Dict[str, int]:
        with self.lock:
            return {"decisions": len(self.decisions),
                    "heads_unretired": len(self._acks),
                    "fully_acked_unretired": self.fully_acked_unretired(),
                    "retired": self.n_retired,
                    "retired_memo": len(self._retired_commits)}

    def _trim_ledger(self) -> None:
        """Follower-side backstop: bound the ledger even if heads died
        before retiring. Must be called with the lock held."""
        if len(self.decisions) <= LEDGER_CAP:
            return
        referenced = {txn for rec in self.replicas.values()
                      for txn in rec.tentative}
        for txn in list(self.decisions):
            if len(self.decisions) <= LEDGER_CAP:
                break
            if txn in self._acks or txn in referenced:
                continue   # head-tracked / still resolving: never evict
            self.decisions.pop(txn, None)
            self.chains.pop(txn, None)

    # ------------------------------------------------------------------ #
    # promotion                                                          #
    # ------------------------------------------------------------------ #
    def head_of(self, txn: str) -> Optional[str]:
        """Coordinator address recorded on any buffered tentative of
        ``txn``, or ``None`` if no replica here holds one."""
        with self.lock:
            for rec in self.replicas.values():
                t = rec.tentative.get(txn)
                if t is not None:
                    return t[3]
        return None

    def _query_head(self, head: str, txn: str) -> str:
        """Ask a tentative's coordinator for the transaction's fate.
        An unreachable coordinator answers ``unreachable`` — under §11 it
        may be mid-restart holding a durable ``commit``, so only callers
        protected by epoch fencing (promotion: a returning rival's
        contradicting fold is discarded when it defers to the successor
        chain) may doom on it immediately; resurrection must poll it out
        first (no rival chain exists to fence the disagreement away)."""
        try:
            return self.core._peer(head).call("txn_status", txn=txn)
        except Exception:  # noqa: BLE001 - dead (or restarting) coordinator
            return "unreachable"

    def promote(self, names: List[str]) -> Dict[str, List[str]]:
        """Attempt to take over as primary for ``names``.

        Returns ``{"promoted": [...], "busy": [...]}``; names in neither
        list are unknown here (the caller tries the next follower). A name
        is *busy* while some tentative's coordinator is alive but
        undecided — the caller retries: a live coordinator's chained
        commit is synchronous, so the window is bounded.
        """
        promoted: List[str] = []
        busy: List[str] = []
        for name in names:
            lm = getattr(self.core, "leases", None)
            moved = lm is not None and name in lm.moved
            if self.core.has_binding(name) and not moved:
                promoted.append(name)    # already primary here: idempotent
                continue
            with self.lock:
                rec = self.replicas.get(name)
                if rec is None:
                    continue
                if rec.promoted:
                    promoted.append(name)
                    continue
                if rec.recovering:
                    # A replayed image may be missing commits that landed
                    # while we were dead (§11): promoting it would serve
                    # stale state — refuse retryably until the rejoin
                    # catch-up replaces the record.
                    busy.append(name)
                    continue
                pending_txns = [
                    (txn, t) for txn, t in rec.tentative.items()
                    if txn not in self.decisions]
            wait = False
            for txn, t in pending_txns:
                status = self._query_head(t[3], txn)
                if status == "pending":
                    wait = True
                    break
                with self.lock:
                    # first-writer-wins: a racing repl_decision beats us
                    first = txn not in self.decisions
                    d = self.decisions.setdefault(
                        txn, "commit" if status == "commit" else "abort")
                    self._wal_decision(txn, d, first)
            if wait:
                busy.append(name)
                continue
            with self.lock:
                for txn in list(rec.tentative):
                    d = self.decisions.get(txn)
                    t = rec.tentative.pop(txn)
                    if d == "commit":
                        self._apply(rec, t[0], t[1], t[2])
                self._activate(name, rec)
            promoted.append(name)
        return {"promoted": promoted, "busy": busy}

    def _activate(self, name: str, rec: ReplicaRecord) -> None:
        """Become primary: bind the replica state into the local registry
        under a fresh header and continue the chain at ``epoch + 1``."""
        obj = pickle.loads(rec.payload)
        self.core.bind_local(name, obj)
        me = self.core.address
        tail = rec.order[rec.order.index(me) + 1:] if me in rec.order else []
        epoch = rec.applied[0] + 1
        self.followers[name] = tail
        self.epochs[name] = epoch
        rec.promoted = True
        if self._wal is not None:
            self._wal.bind(name, rec.payload, tail, epoch)
        leases = getattr(self.core, "leases", None)
        if leases is not None:
            # Ownership is lease-based (§10): the promotion IS a lease
            # grant at the new epoch — renewal over `tail` starts now.
            leases.grant_local(name, epoch)
        log.info("promoted to primary of %r (epoch %d, %d followers)",
                 name, epoch, len(tail))
        if tail:
            for f in tail:
                self._notify(f, "repl_init", count=False, name=name,
                             primary=me, order=tail, epoch=epoch,
                             payload=rec.payload, seq=0)

    # ------------------------------------------------------------------ #
    # ownership migration (§10)                                          #
    # ------------------------------------------------------------------ #
    def adopt(self, name: str, followers: List[str], epoch: int,
              payload: bytes) -> None:
        """Become primary of ``name`` by *handoff* (migrate_in): take over
        the chain at the shipped epoch, re-seed the followers, and mark any
        local replica record promoted so the old primary's stale one-ways
        are ignored."""
        followers = [f for f in followers if f != self.core.address]
        with self.lock:
            self.followers[name] = list(followers)
            self.epochs[name] = epoch
            rec = self.replicas.get(name)
            if rec is not None:
                rec.promoted = True
        if self._wal is not None:
            self._wal.bind(name, payload, list(followers), epoch)
        for f in followers:
            self._notify(f, "repl_init", count=False, name=name,
                         primary=self.core.address, order=list(followers),
                         epoch=epoch, payload=payload, seq=0)

    def drop_primary(self, name: str) -> None:
        """Old primary after a successful handoff: stop replicating."""
        with self.lock:
            self.followers.pop(name, None)

    # ------------------------------------------------------------------ #
    # restart + chain rejoin (§11)                                       #
    # ------------------------------------------------------------------ #
    def rejoin_accept(self, name: str, addr: str,
                      payload: bytes) -> Dict[str, Any]:
        """Primary side of a restarted node's chain rejoin: grow the
        chain back by appending ``addr`` as the tail follower and hand it
        the quiesced committed snapshot (anti-entropy catch-up, snapshot
        form — the chain's native replication unit is the full state, so
        one snapshot IS the delta). The caller (``_op_repl_rejoin``) has
        already drained the object, so ``payload`` is the whole truth:
        no in-flight versions, no pending tentatives. The surviving
        followers learn the grown order via ``repl_chain`` one-ways."""
        me = self.core.address
        with self.lock:
            fl = list(self.followers.get(name, ()))
            if addr != me and addr not in fl:
                fl.append(addr)
            self.followers[name] = fl
            epoch = self.epochs.get(name, 0)
        if self._wal is not None:
            self._wal.membership(name, list(fl), list(fl))
        for f in fl:
            if f != addr:
                self._notify(f, "repl_chain", count=False, name=name,
                             order=list(fl), epoch=epoch)
        return {"name": name, "primary": me, "order": list(fl),
                "epoch": epoch, "seq": 0, "payload": payload}

    def repl_chain(self, name: str, order: List[str], epoch: int) -> None:
        """Chain-membership update (a restarted node rejoined as tail):
        adopt the grown order so a future promotion replicates to — and a
        future rejoin probes — the full healed chain."""
        with self.lock:
            rec = self.replicas.get(name)
            if rec is None or rec.promoted or epoch < rec.epoch:
                return
            rec.order = list(order)
        if self._wal is not None:
            self._wal.membership(name, list(order), [])

    # ------------------------------------------------------------------ #
    # client recovery                                                    #
    # ------------------------------------------------------------------ #
    def txn_decision(self, txn: str) -> Tuple[str, List[dict]]:
        """A recovering client asks a follower of the dead coordinator for
        the transaction's fate. No recorded decision means the coordinator
        died before making it recoverable — doom to abort, first-writer-
        wins (atomic either way: the decision broadcast precedes every
        effect of the decision, so a doomed transaction committed
        nowhere). A *retired* commit (fully acked + GC'd before the
        client's reply arrived — e.g. the coordinator crashed between the
        decision drive and the reply send) answers ``commit`` from the
        retired memo: its chain already drove to completion everywhere, so
        no re-drive is needed."""
        with self.lock:
            if txn not in self.decisions and txn in self._retired_commits:
                return "commit", []
            first = txn not in self.decisions
            d = self.decisions.setdefault(txn, "abort")
            self._wal_decision(txn, d, first)
            if d == "abort":
                self._resolve_tentatives_abort(txn)
                return d, []
            self._resolve_tentatives_commit(txn)
            return d, list(self.chains.get(txn, ()))
