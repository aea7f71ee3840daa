"""Write-ahead ledger + crash-restart recovery (DESIGN.md §11).

Every node appends its durable facts here *before* acknowledging them:
replication tentatives and finals keyed by ``(epoch, seq)``, commit
decisions, lease epochs, chain membership, and redirect tombstones. A
restarting node replays the ledger (truncating a torn tail at the first
bad checksum), rebuilds its pre-crash roles, and rejoins its chains —
see :meth:`Wal.recover` for the replay state machine and
``NodeCore.rejoin_chains`` for the networked half.

Frame format (little-endian)::

    <u32 length> <u32 crc32-of-payload> <payload = pickle(record dict)>

Appends are cheap (one buffered write); durability points — commit
finals, decisions, membership changes — call :meth:`Wal.append` with
``sync=True``, which flushes *every* frame written since the last sync
in one batch (``fsync``-batched group commit). The two counters
``n_appends`` / ``n_syncs`` feed the benchmark metrics
``wal_appends_per_txn`` / ``fsync_batches_per_txn``.

Storage is pluggable: :class:`FileStorage` is a real append-only file
(TCP nodes, opt-in via ``--wal-dir``); :class:`VirtualDisk` is the
deterministic in-memory device simnet hands a node — it survives a
simulated restart and models an *ordered* device on crash: a seeded
prefix of the unsynced writes lands, the next frame may land torn, the
rest is lost.
"""
from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Wal", "FileStorage", "VirtualDisk", "Recovered", "replay",
           "DELTA_MAGIC", "encode_delta", "fold_payload"]

_HDR = struct.Struct("<II")

#: Prefix marking a replication payload as a §12 commute *delta* — a
#: pickled entry list to fold into the committed snapshot — rather than a
#: full state snapshot that replaces it. No pickle protocol starts with a
#: NUL byte, so the prefix test can never misfire on a snapshot payload.
DELTA_MAGIC = b"\x00\xc6\x12"


def encode_delta(entries) -> bytes:
    """Wrap a commute-group member's buffered ``(method, args, kwargs)``
    entries as a replication payload (tentative delta, DESIGN.md §12)."""
    return DELTA_MAGIC + pickle.dumps(
        list(entries), protocol=pickle.HIGHEST_PROTOCOL)


def fold_payload(base: bytes, payload: bytes) -> bytes:
    """Resolve a replication payload against the committed snapshot
    ``base``: a snapshot payload replaces it, a commute delta folds into
    it (replay the entries against the unpickled state — the §12 contract
    is that entries of one method class commute, so fold order across
    group members is free)."""
    if not payload.startswith(DELTA_MAGIC):
        return payload
    obj = pickle.loads(base)
    for method, args, kwargs in pickle.loads(payload[len(DELTA_MAGIC):]):
        getattr(obj, method)(*args, **(kwargs or {}))
    return pickle.dumps(obj)


def _frame(record: Dict[str, Any]) -> bytes:
    payload = pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def replay(data: bytes) -> Tuple[List[Dict[str, Any]], int]:
    """Decode ``data`` into records, stopping at the first torn frame.

    Returns ``(records, good)`` where ``good`` is the byte length of the
    intact prefix — everything past it (a partial header, a short
    payload, or a checksum mismatch: the torn tail of a crash mid-write)
    is truncated by the caller before appending resumes.
    """
    records: List[Dict[str, Any]] = []
    off = 0
    n = len(data)
    while off + _HDR.size <= n:
        length, crc = _HDR.unpack_from(data, off)
        start, end = off + _HDR.size, off + _HDR.size + length
        if end > n:
            break                       # short payload: torn tail
        payload = data[start:end]
        if zlib.crc32(payload) != crc:
            break                       # corrupt frame: torn tail
        try:
            records.append(pickle.loads(payload))
        except Exception:  # noqa: BLE001 - undecodable frame: treat as torn
            break
        off = end
    return records, off


# --------------------------------------------------------------------- #
# storage backends                                                      #
# --------------------------------------------------------------------- #
class FileStorage:
    """A real append-only ledger file.

    Writes go straight to the kernel (unbuffered handle), so a SIGKILL
    loses at most what the *device* would lose; ``sync`` is a real
    ``fsync``. ``truncate`` discards a torn tail found at replay.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab", buffering=0)

    def read_all(self) -> bytes:
        with open(self.path, "rb") as f:
            return f.read()

    def truncate(self, good: int) -> None:
        self._f.close()
        with open(self.path, "r+b") as f:
            f.truncate(good)
        self._f = open(self.path, "ab", buffering=0)

    def append(self, data: bytes) -> None:
        self._f.write(data)

    def sync(self) -> None:
        os.fsync(self._f.fileno())

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class VirtualDisk:
    """simnet's deterministic in-memory ledger device.

    ``data`` is the durable (synced) image; ``pending`` holds frames
    written but not yet synced. :meth:`crash` applies ordered-device
    semantics with the simulation's seeded RNG: a prefix of ``pending``
    survives, the next frame may survive *torn* (a random strict prefix
    of its bytes), the rest vanishes. ``halt`` models the device going
    away mid-append (the ``node-mid-wal-append`` injection): once set,
    appends and syncs are no-ops until the node restarts.
    """

    def __init__(self) -> None:
        self.data = bytearray()
        self.pending: List[bytes] = []
        self.halt = False
        #: injection hook (simnet ``node-mid-wal-append``): called after
        #: each frame is written, while the writer is still on-CPU.
        self.on_append = None

    def read_all(self) -> bytes:
        return bytes(self.data)

    def truncate(self, good: int) -> None:
        del self.data[good:]

    def append(self, data: bytes) -> None:
        if self.halt:
            return
        self.pending.append(data)
        if self.on_append is not None:
            self.on_append(self)

    def sync(self) -> None:
        if self.halt:
            return
        for chunk in self.pending:
            self.data += chunk
        self.pending.clear()

    def close(self) -> None:
        pass

    def tear_tail(self, rng) -> None:
        """Corrupt the most recent unsynced frame to a strict prefix
        (the ``node-mid-wal-append`` injection: the append itself is the
        crash point, so the frame can never be whole)."""
        if self.pending:
            last = self.pending[-1]
            self.pending[-1] = last[:rng.randrange(0, len(last))]

    def crash(self, rng) -> None:
        """Crash-time settlement of unsynced writes (ordered device).
        Leaves the device halted — a poisoned handler unwinding after the
        node's death must not leak post-mortem frames into the image the
        restart replays; the restart re-opens it (``SimNet._disk``)."""
        if self.pending:
            k = rng.randint(0, len(self.pending))  # frames [0:k) land whole
            for chunk in self.pending[:k]:
                self.data += chunk
            if k < len(self.pending):
                torn = self.pending[k]
                cut = rng.randrange(0, len(torn)) if torn else 0
                if cut:
                    self.data += torn[:cut]        # frame k lands torn
            self.pending.clear()
        self.halt = True


# --------------------------------------------------------------------- #
# recovery state machine                                                #
# --------------------------------------------------------------------- #
class Recovered:
    """What a replayed ledger says this node *was* (DESIGN.md §11).

    - ``objects``: name -> the last known role + committed snapshot::

        {"role": "primary" | "follower",
         "payload": pickled committed state, "epoch": int, "seq": int,
         "primary": address-or-None, "order": [addr, ...],
         "followers": [addr, ...]}

    - ``decisions``: txn -> "commit" / "abort" (the decision ledger).
    - ``pending``: (txn, name) -> (epoch, seq, payload, head) —
      tentatives with **no** recorded final/drop/decision: undecided at
      crash time, to be resolved against the live chain (or doomed).
    - ``tombstones``: name -> (target, epoch, followers) — redirect
      tombstones to rehydrate so stale client bindings keep redirecting.
    - ``leases``: name -> last granted lease epoch.
    """

    def __init__(self) -> None:
        self.objects: Dict[str, Dict[str, Any]] = {}
        self.decisions: Dict[str, str] = {}
        self.pending: Dict[Tuple[str, str], Tuple[int, int, bytes, Optional[str]]] = {}
        self.tombstones: Dict[str, Tuple[str, int, List[str]]] = {}
        self.leases: Dict[str, int] = {}


class Wal:
    """The per-node write-ahead ledger over a storage backend."""

    def __init__(self, storage) -> None:
        self.storage = storage
        self.n_appends = 0
        self.n_syncs = 0
        self._unsynced = 0
        self.records, good = replay(storage.read_all())
        self.truncated = len(storage.read_all()) - good
        if self.truncated:
            storage.truncate(good)

    # -- appending ------------------------------------------------------
    def append(self, record: Dict[str, Any], sync: bool = False) -> None:
        self.storage.append(_frame(record))
        self.n_appends += 1
        self._unsynced += 1
        if sync:
            self.storage.sync()
            self.n_syncs += 1
            self._unsynced = 0

    # Typed writers: one per durable fact. Appends are buffered; the
    # facts that must not be lost once acknowledged (finals, decisions,
    # membership, leases, tombstones) sync — each sync lands the whole
    # unsynced batch (group commit), so a commit costs at most one
    # fsync however many tentatives preceded it.
    def bind(self, name: str, payload: bytes, followers: List[str],
             epoch: int) -> None:
        self.append({"kind": "bind", "name": name, "payload": payload,
                     "followers": list(followers), "epoch": epoch},
                    sync=True)

    def tentative(self, txn: str, name: str, epoch: int, seq: int,
                  payload: bytes, head: Optional[str]) -> None:
        self.append({"kind": "tentative", "txn": txn, "name": name,
                     "epoch": epoch, "seq": seq, "payload": payload,
                     "head": head})

    def final(self, txn: str, name: str, epoch: int, seq: int) -> None:
        self.append({"kind": "final", "txn": txn, "name": name,
                     "epoch": epoch, "seq": seq}, sync=True)

    def drop(self, txn: str, name: str) -> None:
        self.append({"kind": "drop", "txn": txn, "name": name})

    def decision(self, txn: str, decision: str) -> None:
        self.append({"kind": "decision", "txn": txn, "decision": decision},
                    sync=True)

    def init(self, name: str, primary: str, order: List[str], epoch: int,
             seq: int, payload: bytes) -> None:
        self.append({"kind": "init", "name": name, "primary": primary,
                     "order": list(order), "epoch": epoch, "seq": seq,
                     "payload": payload}, sync=True)

    def membership(self, name: str, order: List[str],
                   followers: List[str]) -> None:
        self.append({"kind": "membership", "name": name,
                     "order": list(order), "followers": list(followers)},
                    sync=True)

    def lease(self, name: str, epoch: int) -> None:
        self.append({"kind": "lease", "name": name, "epoch": epoch},
                    sync=True)

    def tombstone(self, name: str, target: str, epoch: int,
                  followers: List[str]) -> None:
        self.append({"kind": "tombstone", "name": name, "target": target,
                     "epoch": epoch, "followers": list(followers)},
                    sync=True)

    # -- replay ---------------------------------------------------------
    def recover(self) -> Recovered:
        """Fold the replayed records into a :class:`Recovered` image.

        Ordering rules: ``bind``/``init`` reset an object's role and
        committed snapshot; a ``final`` (or a later ``decision: commit``)
        promotes its matching tentative into the committed snapshot iff
        its ``(epoch, seq)`` advances it; tombstones supersede roles
        (the object moved away); epoch monotonicity everywhere.
        """
        rec = Recovered()
        for r in self.records:
            kind = r["kind"]
            if kind == "bind":
                rec.objects[r["name"]] = {
                    "role": "primary", "payload": r["payload"],
                    "epoch": r["epoch"], "seq": 0, "primary": None,
                    "order": [], "followers": list(r["followers"])}
                rec.tombstones.pop(r["name"], None)
            elif kind == "init":
                rec.objects[r["name"]] = {
                    "role": "follower", "payload": r["payload"],
                    "epoch": r["epoch"], "seq": r["seq"],
                    "primary": r["primary"], "order": list(r["order"]),
                    "followers": []}
            elif kind == "tentative":
                rec.pending[(r["txn"], r["name"])] = (
                    r["epoch"], r["seq"], r["payload"], r.get("head"))
            elif kind == "final":
                rec.decisions.setdefault(r["txn"], "commit")
                self._apply_pending(rec, r["txn"], r["name"])
            elif kind == "drop":
                rec.pending.pop((r["txn"], r["name"]), None)
            elif kind == "decision":
                rec.decisions.setdefault(r["txn"], r["decision"])
            elif kind == "membership":
                o = rec.objects.get(r["name"])
                if o is not None:
                    o["order"] = list(r["order"])
                    o["followers"] = list(r["followers"])
            elif kind == "lease":
                rec.leases[r["name"]] = r["epoch"]
            elif kind == "tombstone":
                rec.objects.pop(r["name"], None)
                rec.tombstones[r["name"]] = (
                    r["target"], r["epoch"], list(r["followers"]))
        # Decisions recorded after the tentative settle it at replay end:
        for (txn, name), _t in list(rec.pending.items()):
            d = rec.decisions.get(txn)
            if d == "commit":
                self._apply_pending(rec, txn, name)
            elif d == "abort":
                rec.pending.pop((txn, name), None)
        return rec

    @staticmethod
    def _apply_pending(rec: Recovered, txn: str, name: str) -> None:
        t = rec.pending.pop((txn, name), None)
        o = rec.objects.get(name)
        if t is None or o is None:
            return
        epoch, seq, payload, _head = t
        if (epoch, seq) >= (o["epoch"], o["seq"]):
            # fold_payload: a §12 commute delta folds into the replayed
            # snapshot instead of replacing it (same rule as the live
            # follower's apply — replay must converge to the same state).
            o["payload"] = fold_payload(o["payload"], payload)
            o["epoch"], o["seq"] = epoch, seq

    def close(self) -> None:
        self.storage.close()
