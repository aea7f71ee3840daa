"""The traced run's instruments, all of them the benchmark's own.

:class:`Ranges` wraps attributes of the port's modules so that each call
runs inside a ``torch.profiler.record_function`` range named after the
entry, and records the call's shapes while a stretch is on (the way
``chip_smoke.py::moe_spans`` wraps the MoE steps). :class:`Stretch` runs the
profiler over a short stretch of the window, marked by a range of its own,
and reduces the trace to numbers: the device's busy time (the union of its
kernels' and copies' intervals, ``chip_smoke.py::profile_calls``'
arithmetic), the device time inside each named range (a kernel counts for
the ranges on its launching thread's stack), the operations that took the
most device time, and the idle gaps named by the innermost range the host
was in when each began.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

STRETCH = "portbench.stretch"
NO_RANGE = "host outside the ranges"
MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


def _marker() -> None:
    """A near-empty kernel that brackets a call's work on the stream."""
    torch.cuda._sleep(0)


class Ranges:
    """Install with ``with Ranges(): ...``; ``add(obj, attr, name, note,
    bracket)`` before entering. ``name`` is a string or a function of the
    call's arguments; ``note(args, kwargs, out)`` returns what to record of
    a call made while ``recording`` (after its range has closed).

    A kernel launched from outside PyTorch's operators (the port's kernels,
    through ctypes) is not tied to the range it was launched in by the
    profiler, so a ``bracket`` entry's device time is read otherwise: while
    recording, each call is enclosed by two marker kernels on the stream,
    and its device time is that of the work between them (the entries so
    marked never nest, and run one at a time)."""

    def __init__(self):
        self._wraps: List[Tuple] = []
        self._saved: List[Tuple[object, str, object]] = []
        self.recording = False
        self.calls: Dict[str, List] = {}
        self.marks: List[str] = []
        self._lock = threading.Lock()

    def add(self, obj, attr: str, name, note: Optional[Callable] = None,
            bracket: bool = False):
        self._wraps.append((obj, attr, name, note, bracket))
        return self

    def names(self) -> List[str]:
        out = []
        for _, attr, name, _, _ in self._wraps:
            out.extend(name.names if callable(name) else [name])
        return out

    def _wrap(self, fn, name, note, bracket):
        from torch.profiler import record_function

        def call(*args, **kwargs):
            label = name(*args, **kwargs) if callable(name) else name
            marked = bracket and self.recording and torch.cuda.is_available()
            with record_function(label):
                if marked:
                    with self._lock:
                        self.marks.append(label)
                    _marker()
                out = fn(*args, **kwargs)
                if marked:
                    _marker()
            if self.recording and note is not None:
                rec = note(args, kwargs, out)
                with self._lock:
                    self.calls.setdefault(label, []).append(rec)
            return out
        return call

    def __enter__(self):
        for obj, attr, name, note, bracket in self._wraps:
            # a module's function or an instance's own attribute is put
            # back on exit; a method found on the class is deleted again
            self._saved.append((obj, attr, vars(obj).get(attr)))
            setattr(obj, attr, self._wrap(getattr(obj, attr), name, note,
                                          bracket))
        return self

    def __exit__(self, *exc):
        for obj, attr, fn in reversed(self._saved):
            if fn is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, fn)
        self._saved.clear()


class Stretch:
    """The profiler over one stretch: :meth:`start` and :meth:`stop` are
    called on one thread, in order, with no range of :class:`Ranges` open
    across either. Each returns the host seconds it took, which a caller
    whose own clock ran across it leaves out."""

    def __init__(self, ranges: Ranges):
        self.ranges = ranges
        self.prof = None
        self._mark = None
        self.result: Optional[Dict] = None

    @staticmethod
    def activities():
        from torch.profiler import ProfilerActivity
        # without a card (the CPU tests) the trace holds host ranges only
        return [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])

    @classmethod
    def warm(cls) -> None:
        """Start and stop the profiler once, so that its first start's cost
        (CUPTI's set-up) falls in set-up."""
        from torch.profiler import profile
        with profile(activities=cls.activities()):
            torch.ones(1).add_(1)
            sync()

    def start(self) -> float:
        from torch.profiler import profile, record_function
        t0 = time.perf_counter()
        self.prof = profile(activities=self.activities())
        self.prof.start()
        self._mark = record_function(STRETCH)
        self._mark.__enter__()
        self.ranges.recording = True
        return time.perf_counter() - t0

    def stop(self) -> float:
        t0 = time.perf_counter()
        sync()
        self.ranges.recording = False
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self.result = reduce(self.prof.events(), self.ranges.names(),
                             self.ranges.marks)
        self.prof = None
        return time.perf_counter() - t0


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _union(spans: List[Tuple[float, float]]) -> Tuple[float, List]:
    """(covered length, the gaps between covered runs) of intervals."""
    busy, end, gaps = 0.0, None, []
    for s, e in sorted(spans):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _bracketed(device: List, marks: List[str]) -> Optional[Dict]:
    """Device time of each marked call: the work between its two markers,
    summed by range; None where the markers in the trace do not pair with
    the calls recorded (nothing is then read)."""
    ordered = sorted(device)
    at = [i for i, (_, _, name) in enumerate(ordered) if MARKER in name]
    if len(at) != 2 * len(marks):
        return None
    out: Dict[str, float] = {}
    for label, a, b in zip(marks, at[0::2], at[1::2]):
        out[label] = out.get(label, 0.0) + sum(
            t - s for s, t, _ in ordered[a + 1:b])
    return out


def reduce(events, range_names: List[str], marks: List[str] = ()) -> Dict:
    """Numbers of one stretch from ``prof.events()``; times in seconds."""
    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    mark = [e for e in events if e.name == STRETCH and e.device_type == cpu]
    if not mark:
        raise RuntimeError("the stretch's range is not in the trace")
    w0, w1 = mark[0].time_range.start, mark[0].time_range.end
    wanted = set(range_names)
    device, host, by_range = [], [], {}
    for e in events:
        if e.device_type == cuda:
            if e.name in wanted or e.name == STRETCH:
                continue        # a range's device-side mirror, not work
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                device.append((s, t, e.name))
        elif e.name in wanted:
            host.append((e.time_range.start, e.time_range.end, e.name))
            r = by_range.setdefault(e.name, [0.0, 0, 0.0])
            r[0] += e.device_time_total
            r[1] += 1
            r[2] += e.time_range.end - e.time_range.start
    if marks:
        bracketed = _bracketed(device, list(marks))
        for label in set(marks):
            by_range.setdefault(label, [0.0, 0, 0.0])
            by_range[label][0] = (bracketed or {}).get(label, 0.0)
        device = [d for d in device if MARKER not in d[2]]
    busy, gaps = _union([(s, t) for s, t, _ in device])
    if device:
        first = min(s for s, _, _ in device)
        last = max(t for _, t, _ in device)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    ops: Dict[str, float] = {}
    for s, t, name in device:
        ops[name] = ops.get(name, 0.0) + (t - s)
    idle: Dict[str, float] = {}
    for s, t in gaps:
        if t <= s:
            continue
        inside = [h for h in host if h[0] <= s < h[1]]
        label = max(inside, key=lambda h: h[0])[2] if inside else NO_RANGE
        idle[label] = idle.get(label, 0.0) + (t - s)
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": busy * us,
        "range_device_s": {k: v[0] * us for k, v in by_range.items()},
        "range_calls": {k: v[1] for k, v in by_range.items()},
        "range_host_s": {k: v[2] * us for k, v in by_range.items()},
        "device_ops": sorted(([k, v * us] for k, v in ops.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v * us] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:10],
    }
