"""Host spans of the port's serving, training and model paths, on txtrace.

The three copied modules of this package trace the OptSVA-CF core; this one
lets the model path emit into the same rings and registries, and lays them
over a ``torch.profiler`` trace of the card.

* :func:`span` (a context manager) and :func:`begin` / :func:`end` (for
  sites where a ``with`` does not fit) record one span of ``kind`` on the
  site its prefix names (:data:`SITES`: ``host:serve``, ``host:train``,
  ``host:model``), through ``txtrace.tracer(site)``. With
  ``txtrace.enabled`` false they cost one attribute read and record
  nothing; a per-layer site (the MoE layer) tests ``txtrace.enabled``
  itself, as the core does. With it on, and a profiler collecting, each
  span also opens a ``record_function`` range of its name (its detail as
  the range's argument), so the program's own ranges sit in the device
  trace on the profiler's clock.
* One clock: when tracing turns on (``REPRO_TRACE`` at import, :func:`enable`,
  or the first span), one ``(time.monotonic_ns(), time.time_ns())`` anchor
  is taken. txtrace's sites read ``time.monotonic``; kineto stamps events in
  Unix-epoch nanoseconds; :func:`to_epoch_ns` maps the first onto the
  second. :func:`write_merged` writes one Perfetto file: the profiler's
  trace, plus every txtrace site (the core's transaction spans too, which
  have no range of their own) as a process of its own, shifted into the
  profiler's epoch (its ``baseTimeNanoseconds``).
* :func:`idle_by_span` splits each idle gap of the device over the mirrored
  ranges the host was in along the gap's whole length, the innermost range
  first, and returns milliseconds by span name.

What is always on lives beside the spans, in the callers: the Server's
``timing`` floats and the Trainer's ``metrics.registry("train")``
histograms. Nothing here imports torch until a profiler is started or its
events are read.
"""
from __future__ import annotations

import contextlib
import heapq
import json
import sys
import time
from typing import Dict, Iterable, List, Optional, Tuple

from . import export, txtrace

#: the site of a span, by the prefix of its kind (before the first ".")
SITES = {"serve": "host:serve", "train": "host:train", "moe": "host:model",
         "kernels": "host:model"}
#: what :func:`idle_by_span` credits idle time to where no span was open
OUTSIDE = "(no span)"

_anchor: Optional[Tuple[int, int]] = None
#: names of the profiler ranges opened by spans in this process
mirrored: set = set()


def anchor() -> Tuple[int, int]:
    """The ``(time.monotonic_ns(), time.time_ns())`` pair taken when tracing
    turned on (taken now if it was not)."""
    global _anchor
    if _anchor is None:
        _anchor = (time.monotonic_ns(), time.time_ns())
    return _anchor


def enable() -> None:
    """Turn tracing on (``txtrace.enable``) and take the clock's anchor."""
    txtrace.enable()
    anchor()


if txtrace.enabled:
    anchor()


def to_epoch_ns(ts: float) -> int:
    """A txtrace timestamp (``time.monotonic`` seconds) in Unix-epoch ns."""
    mono, wall = anchor()
    return int(round(ts * 1e9)) - mono + wall


def _site(kind: str) -> str:
    return SITES.get(kind.split(".", 1)[0], "host:model")


def _mirror(kind: str, detail: str):
    """A ``record_function`` range of ``kind``, entered, when a profiler is
    collecting; else None."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rf = prof.record_function(kind, detail or None)
    rf.__enter__()
    mirrored.add(kind)
    return rf


class _Open:
    """An open span: :func:`end` (or leaving its ``with``) records it."""

    __slots__ = ("tracer", "kind", "detail", "t0", "rf")

    def __enter__(self) -> "_Open":
        return self

    def __exit__(self, *exc) -> bool:
        end(self)
        return False


_NULL = contextlib.nullcontext()


def begin(kind: str, detail: str = "") -> Optional[_Open]:
    """Open a span (None with tracing off); close it with :func:`end`."""
    if not txtrace.enabled:
        return None
    if _anchor is None:
        anchor()
    s = _Open()
    s.tracer = txtrace.tracer(_site(kind))
    s.kind, s.detail = kind, detail
    s.t0 = s.tracer.now()
    s.rf = _mirror(kind, detail)
    return s


def end(s: Optional[_Open]) -> None:
    if s is None:
        return
    s.tracer.span(s.kind, s.t0, detail=s.detail)
    if s.rf is not None:
        s.rf.__exit__(None, None, None)


def then(s: Optional[_Open], kind: str) -> Optional[_Open]:
    """End ``s`` and begin ``kind`` with its detail: the next step of a
    sequence of spans."""
    end(s)
    return begin(kind, s.detail if s is not None else "")


def span(kind: str, detail: str = ""):
    """``with span(kind, detail): ...``; nothing is recorded with tracing
    off."""
    if not txtrace.enabled:
        return _NULL
    return begin(kind, detail)


def emit(kind: str, t0: float, t1: Optional[float] = None,
         detail: str = "") -> None:
    """Record a span that began at ``t0`` (txtrace's clock) and ends at
    ``t1`` or now, with no range of its own: for a span that outlives the
    call that opens it (a request in the queue). Call only under
    ``txtrace.enabled``."""
    tr = txtrace.tracer(_site(kind))
    tr.emit(kind, t0, (tr.now() if t1 is None else t1) - t0, detail=detail)


# --------------------------------------------------------------------------- #
# The profiler's trace                                                        #
# --------------------------------------------------------------------------- #
def write_merged(profiler, path: str) -> int:
    """Write ``profiler``'s trace (a stopped ``torch.profiler.profile``) to
    ``path`` with every txtrace site laid over it on the profiler's clock;
    returns the number of txtrace events added."""
    profiler.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    # kineto writes ts in us since baseTimeNanoseconds (absent: the epoch)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = export.merged_events()
    for e in events:
        e["ts"] = (to_epoch_ns(e["ts"]) - base) / 1e9
    ours = export.chrome_trace(events)["traceEvents"]
    pids = [ev["pid"] for ev in doc["traceEvents"]
            if isinstance(ev.get("pid"), int)]
    first = max(pids, default=0) + 1
    for ev in ours:
        ev["pid"] += first
    doc["traceEvents"].extend(ours)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(events)


def start_profiler():
    """A started ``torch.profiler.profile`` over the host and, where there
    is a card, the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else []))
    prof.start()
    return prof


def finish_profiler(prof, path: str) -> str:
    """Stop ``prof`` (the card's work done first), write the merged trace
    to ``path``; returns two lines that say so and give the device's idle
    ms by span."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    n = write_merged(prof, path)
    idle = idle_by_span(prof)
    return (f"[trace] {path}: the profiler's trace and {n} txtrace events\n"
            "[trace] device idle ms by span: " + (", ".join(
                f"{k} {v:.3f}" for k, v in idle.items()) or "no device work"))


Event = Tuple[str, int, int, bool]     # name, start ns, end ns, on the device


def profiler_events(profiler) -> List[Event]:
    """The kineto events of a stopped ``torch.profiler.profile``, in
    Unix-epoch nanoseconds: the host's, and the device's work (its kernels,
    copies and sets). A host range's mirror on the device's timeline is left
    out: it bears the name of a host event, which no kernel or copy does
    (kineto's activity types tell them apart too, but not every torch has
    them)."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    events = list(profiler.profiler.kineto_results.events())
    host = {e.name() for e in events if e.device_type() == cpu}
    out: List[Event] = []
    for e in events:
        on_device = e.device_type() != cpu
        if on_device and e.name() in host:
            continue
        out.append((e.name(), e.start_ns(), e.end_ns(), on_device))
    return out


def idle_by_span(source, names: Optional[Iterable[str]] = None
                 ) -> Dict[str, float]:
    """Milliseconds the device sat idle, by the span the host was in.

    ``source``: a stopped ``torch.profiler.profile``, or a list of
    :data:`Event` tuples. The trace runs from its first event to its last;
    every stretch of it that no device event covers is split along its
    whole length over the host ranges named ``names`` (default: every range
    a span mirrored, :data:`mirrored`), each instant credited to the
    innermost range open then (the latest begun; of two begun together,
    the shorter), and to :data:`OUTSIDE` where none is. Empty where the
    device ran nothing."""
    events = (profiler_events(source) if hasattr(source, "profiler")
              else list(source))
    wanted = set(mirrored if names is None else names)
    device = sorted((s, t) for _, s, t, dev in events if dev)
    if not device:
        return {}
    ranges = [(s, t, n) for n, s, t, dev in events
              if not dev and n in wanted and t > s]
    w0 = min(s for _, s, _, _ in events)
    w1 = max(t for _, _, t, _ in events)
    out: Dict[str, float] = {}
    segs = _innermost(ranges)
    i = 0
    for a, b in _gaps(device, w0, w1):
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        covered = 0
        j = i
        while j < len(segs) and segs[j][0] < b:
            s, t, name = segs[j]
            d = min(t, b) - max(s, a)
            if d > 0:
                out[name] = out.get(name, 0.0) + d / 1e6
                covered += d
            j += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _gaps(busy: List[Tuple[int, int]], w0: int, w1: int
          ) -> List[Tuple[int, int]]:
    """The stretches of [w0, w1] that the sorted intervals ``busy`` leave
    uncovered."""
    out, at = [], w0
    for s, t in busy:
        if s > at:
            out.append((at, s))
        at = max(at, t)
    if w1 > at:
        out.append((at, w1))
    return out


def _innermost(ranges: List[Tuple[int, int, str]]
               ) -> List[Tuple[int, int, str]]:
    """Time covered by ``ranges`` as sorted disjoint pieces, each labelled
    with the innermost range open over it."""
    bounds = sorted({t for s, e, _ in ranges for t in (s, e)})
    by_start = sorted(ranges)
    heap: List[Tuple[int, int, str]] = []      # (-start, end, name)
    out: List[Tuple[int, int, str]] = []
    k = 0
    for p, q in zip(bounds, bounds[1:]):
        while k < len(by_start) and by_start[k][0] <= p:
            s, e, n = by_start[k]
            heapq.heappush(heap, (-s, e, n))
            k += 1
        while heap and heap[0][1] <= p:
            heapq.heappop(heap)
        if heap:
            name = heap[0][2]
            if out and out[-1][2] == name and out[-1][1] == p:
                out[-1] = (out[-1][0], q, name)
            else:
                out.append((p, q, name))
    return out
