"""Metrics registry: counters + HDR-style histograms per site.

Recording is gated by the same ``txtrace.enabled`` flag as span
emission, so the disabled hot path stays one attribute read. Histograms
use HDR-style log-linear buckets (power-of-two exponent, 16 linear
sub-buckets) over integer microseconds: bounded memory, ~6% relative
quantile error, deterministic under the simnet virtual clock.

Key series (DESIGN.md §9):

* ``gate_wait_us`` — blocked time on the access condition (``lv``);
* ``term_wait_us`` — blocked time on the commit condition (``ltv``);
* ``handoff_us`` — *version-handoff latency*: the object's release at
  transaction *i* → the first access-condition completion of
  transaction *i+1*. This is the direct measure of how much pipeline
  parallelism early release actually buys (the paper's headline claim).
* ``rpc_us`` — client-observed round-trip time per RPC.

Snapshots ship inside the existing ``stats`` RPC reply (no new message
types), and ``install_sigusr2`` dumps every registry to stderr on
SIGUSR2 for live processes.
"""
from __future__ import annotations

import json
import signal
import sys
import threading
from typing import Dict, List, Optional

_SUB_BITS = 4                 # 16 linear sub-buckets per power of two
_SUB = 1 << _SUB_BITS


def _bucket(v: int) -> int:
    """Log-linear bucket index for non-negative integer ``v``."""
    if v < _SUB:
        return v
    exp = v.bit_length() - _SUB_BITS - 1
    return ((exp + 1) << _SUB_BITS) | ((v >> exp) & (_SUB - 1))


def _bucket_value(idx: int) -> int:
    """Lower bound of bucket ``idx`` (the reported quantile value)."""
    if idx < _SUB:
        return idx
    exp = (idx >> _SUB_BITS) - 1
    return (_SUB | (idx & (_SUB - 1))) << exp


class Counter:
    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0

    def inc(self, k: int = 1) -> None:
        self.n += k


class Histogram:
    """HDR-style log-linear histogram over integer microseconds."""

    __slots__ = ("buckets", "count", "total", "max")

    def __init__(self) -> None:
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0
        self.max = 0

    def record(self, us: float) -> None:
        v = int(us)
        if v < 0:
            v = 0
        b = self.buckets
        idx = _bucket(v)
        b[idx] = b.get(idx, 0) + 1
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v

    def percentile(self, p: float) -> int:
        if not self.count:
            return 0
        target = p * self.count
        seen = 0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if seen >= target:
                return _bucket_value(idx)
        return self.max

    def snapshot(self) -> dict:
        return {"count": self.count,
                "mean_us": round(self.total / self.count, 1)
                if self.count else 0.0,
                "p50_us": self.percentile(0.50),
                "p90_us": self.percentile(0.90),
                "p99_us": self.percentile(0.99),
                "max_us": self.max}


class Registry:
    """One site's metric namespace. Creation locks; recording does not
    (counter/histogram updates are single-field mutations on the hot
    path — per-event exactness matters only for the obs counters, which
    tolerate the benign Python-level race; the bench-gated wire counters
    live in Transport and are per-thread exact, see transport.py)."""

    def __init__(self, site: str):
        self.site = site
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def histogram(self, name: str) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, Histogram())
        return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            hists = dict(self._hists)
        return {"site": self.site,
                "counters": {k: c.n for k, c in sorted(counters.items())},
                "histograms": {k: h.snapshot()
                               for k, h in sorted(hists.items())}}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._hists.clear()


# -- site registry -----------------------------------------------------------
_reg_lock = threading.Lock()
_registries: Dict[str, Registry] = {}


def registry(site: str) -> Registry:
    r = _registries.get(site)
    if r is None:
        with _reg_lock:
            r = _registries.get(site)
            if r is None:
                r = Registry(site)
                _registries[site] = r
    return r


def all_registries() -> List[Registry]:
    with _reg_lock:
        return list(_registries.values())


def reset() -> None:
    with _reg_lock:
        for r in _registries.values():
            r.reset()


def merged_percentile(name: str, p: float,
                      sites: Optional[List[str]] = None) -> int:
    """Quantile over ``name`` pooled across sites (bench rollups)."""
    pool = Histogram()
    for r in all_registries():
        if sites is not None and r.site not in sites:
            continue
        h = r._hists.get(name)
        if h is None:
            continue
        for idx, n in h.buckets.items():
            pool.buckets[idx] = pool.buckets.get(idx, 0) + n
        pool.count += h.count
        pool.total += h.total
        pool.max = max(pool.max, h.max)
    return pool.percentile(p)


def dump(stream=None) -> None:
    stream = stream or sys.stderr
    doc = [r.snapshot() for r in all_registries()]
    json.dump(doc, stream, indent=2, sort_keys=True)
    stream.write("\n")
    stream.flush()


def install_sigusr2() -> None:
    """Dump every registry to stderr on SIGUSR2 (live node servers)."""
    if not hasattr(signal, "SIGUSR2"):  # pragma: no cover - non-POSIX
        return
    signal.signal(signal.SIGUSR2, lambda _sig, _frm: dump())
