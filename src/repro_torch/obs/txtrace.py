"""Causal transaction tracing: per-thread ring buffers of binary spans.

Model (DESIGN.md §9):

* A :class:`Tracer` is one *site* — one track in the merged trace: a
  node (``node:<name>``) or a client (``client:<id>``). Each site has
  its own clock callable, which is how the two clock domains coexist:
  TCP/in-process sites read ``time.monotonic``; simnet sites read the
  virtual clock, so a simulated run's trace is a pure function of the
  seed and replays byte-identically.
* Within a tracer, each *thread* owns a private ring buffer and appends
  40-byte packed event records to it without taking any lock (the only
  lock is one-time ring registration). Rings overwrite oldest-first
  when full; the drop count is visible in ``snapshot`` metadata.
* An event is ``(ts, dur, kind, txn, detail, incarnation, pv,
  severity)`` with the three string fields interned process-wide. The
  correlation key ``(txn_uid, incarnation, pv)`` is what lets the
  export stitch one transaction's spans across client, coordinator,
  chain nodes and replica followers into a single causal flow.

The module flag ``enabled`` is THE gate: instrumentation sites check it
before doing anything else, so the disabled path costs one module
attribute read per site (the <1% overhead budget of the transport bench).
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional

#: The global on/off switch. Checked (not imported!) at every
#: instrumentation site: ``if txtrace.enabled: ...``. Seeded from the
#: environment so spawned node-server subprocesses inherit the setting.
enabled: bool = os.environ.get("REPRO_TRACE", "") not in ("", "0")

# ts, dur (seconds, site clock domain), kind, txn, detail (interned
# string ids), incarnation, pv, severity — 40 bytes per event.
_EVENT = struct.Struct("<ddIIIiiI")
EVENT_SIZE = _EVENT.size

#: severity levels for instant events (satellite: structured
#: severity-tagged events replacing ad-hoc stderr lines).
INFO, WARN, ERROR = 0, 1, 2
_SEV_NAMES = ("info", "warn", "error")

# -- process-wide string interning -------------------------------------------
_intern_lock = threading.Lock()
_interned: Dict[str, int] = {"": 0}
_strings: List[str] = [""]


def _intern(s: str) -> int:
    v = _interned.get(s)
    if v is not None:
        return v
    with _intern_lock:
        v = _interned.get(s)
        if v is None:
            v = len(_strings)
            _strings.append(s)
            _interned[s] = v
        return v


class _Ring:
    """One thread's event ring: a preallocated bytearray, overwritten
    oldest-first. Appends are lock-free — only the owning thread writes."""

    __slots__ = ("buf", "cap", "n", "rid")

    def __init__(self, cap: int, rid: int):
        self.buf = bytearray(cap * EVENT_SIZE)
        self.cap = cap
        self.n = 0          # events ever written (wrap = n % cap)
        self.rid = rid

    def events(self) -> List[tuple]:
        """Decode in emission order (oldest surviving first)."""
        out: List[tuple] = []
        n, cap = self.n, self.cap
        first = max(0, n - cap)
        for i in range(first, n):
            off = (i % cap) * EVENT_SIZE
            out.append(_EVENT.unpack_from(self.buf, off) + (i,))
        return out


class Tracer:
    """One site's event sink (see module doc)."""

    def __init__(self, site: str, clock: Callable[[], float] = time.monotonic,
                 capacity: int = 65536):
        self.site = site
        self.clock = clock
        self.capacity = capacity
        self._tl = threading.local()
        self._rings: List[_Ring] = []
        self._lock = threading.Lock()

    # -- emission (hot path; call only under ``if txtrace.enabled``) ---------
    def _ring(self) -> _Ring:
        r = getattr(self._tl, "ring", None)
        if r is None:
            with self._lock:
                r = _Ring(self.capacity, len(self._rings))
                self._rings.append(r)
            self._tl.ring = r
        return r

    def now(self) -> float:
        return self.clock()

    def emit(self, kind: str, t0: float, dur: float = 0.0, *, txn: str = "",
             inc: int = 0, pv: int = -1, detail: str = "",
             sev: int = INFO) -> None:
        r = self._ring()
        off = (r.n % r.cap) * EVENT_SIZE
        _EVENT.pack_into(r.buf, off, t0, dur, _intern(kind), _intern(txn),
                         _intern(detail), inc, pv, sev)
        r.n += 1

    def span(self, kind: str, t0: float, **kw: Any) -> None:
        """Record a span that started at ``t0`` and ends now."""
        self.emit(kind, t0, self.clock() - t0, **kw)

    def instant(self, kind: str, **kw: Any) -> None:
        self.emit(kind, self.clock(), 0.0, **kw)

    # -- draining ------------------------------------------------------------
    def events(self) -> List[dict]:
        """Decode every ring into dict events (stable per-ring order)."""
        with self._lock:
            rings = list(self._rings)
        out: List[dict] = []
        for r in rings:
            for ts, dur, kind, txn, detail, inc, pv, sev, idx in r.events():
                out.append({
                    "site": self.site, "ring": r.rid, "idx": idx,
                    "ts": ts, "dur": dur, "kind": _strings[kind],
                    "txn": _strings[txn], "detail": _strings[detail],
                    "inc": inc, "pv": pv, "sev": _SEV_NAMES[sev],
                })
        return out

    def dropped(self) -> int:
        with self._lock:
            return sum(max(0, r.n - r.cap) for r in self._rings)

    def reset(self) -> None:
        with self._lock:
            self._rings.clear()
        self._tl = threading.local()


# -- site registry -----------------------------------------------------------
_reg_lock = threading.Lock()
_tracers: Dict[str, Tracer] = {}


def tracer(site: str, clock: Optional[Callable[[], float]] = None,
           capacity: int = 65536) -> Tracer:
    """Get (or create) the tracer for ``site``. Passing ``clock`` rebinds
    the site's clock — a fresh simnet run reuses node names but must read
    the NEW run's virtual clock."""
    t = _tracers.get(site)
    if t is None:
        with _reg_lock:
            t = _tracers.get(site)
            if t is None:
                t = Tracer(site, clock or time.monotonic, capacity)
                _tracers[site] = t
    if clock is not None:
        t.clock = clock
    return t


def all_tracers() -> List[Tracer]:
    with _reg_lock:
        return list(_tracers.values())


def reset() -> None:
    """Drop all recorded events (sites and interned strings persist —
    exported traces carry strings, never ids, so replay stays exact)."""
    with _reg_lock:
        for t in _tracers.values():
            t.reset()


# -- per-thread current tracer (client-side spans) ---------------------------
_cur = threading.local()


def set_thread_tracer(t: Optional[Tracer]) -> None:
    """Bind this thread's client-side spans to ``t`` (simnet binds each
    virtual client's actor thread to its own site + virtual clock)."""
    _cur.t = t


def thread_tracer() -> Optional[Tracer]:
    """This thread's bound tracer, or ``None`` (no fallback)."""
    return getattr(_cur, "t", None)


def current() -> Tracer:
    """This thread's tracer, defaulting to the process-wide client site."""
    t = getattr(_cur, "t", None)
    if t is not None:
        return t
    return tracer("client:proc")


def enable() -> None:
    global enabled
    enabled = True


def disable() -> None:
    global enabled
    enabled = False
