"""Copy and log buffers for the complex-object model (paper §2.6).

* :class:`CopyBuffer` — a snapshot of the entire object state. Creating one
  requires the access condition (it views state); it then serves local reads
  after release, and the checkpoint variant (``st``) restores state on abort.

* :class:`LogBuffer` — records method invocations without touching the
  object's state, which is what lets *pure writes* execute with **no prior
  synchronization**. Applying the log replays the recorded calls against the
  real object ("if a method was not previously executed, it is executed on
  the original object at the time the log is being applied", §2.6).

Snapshot protocol (DESIGN.md §1.4): ``copy.deepcopy`` of the whole object on
every checkpoint/read-buffer is the dominant per-operation cost for small
objects. An object class may therefore implement

* ``__tx_snapshot__() -> obj`` — return an independent object exposing the
  same methods, capturing the current state (O(1)/shallow where the state
  is immutable or a flat cell);
* ``__tx_restore__() -> obj`` — called on a *snapshot*, return a fresh live
  object carrying the snapshot's state (defaults to ``__tx_snapshot__`` —
  for most classes "snapshot of a snapshot" is exactly a restore).

``copy.deepcopy`` remains the fallback, so arbitrary objects keep working.
Restores swap a *new* object into the holder either way, preserving the
invalid-instance semantics (a doomed transaction still holding the stale
reference keeps reading the instance it observed).

Both buffer types live on the object's home node (CF model: side effects of
replay must occur where the object lives). In this in-process realization
that is automatic; the ``home_node`` tag is kept for the distributed
simulation and assertions.
"""
from __future__ import annotations

import copy
from typing import Any, List, Optional, Tuple


def snapshot_state(obj: Any) -> Any:
    """Snapshot ``obj`` via ``__tx_snapshot__`` or deepcopy fallback."""
    fn = getattr(obj, "__tx_snapshot__", None)
    if fn is not None:
        return fn()
    return copy.deepcopy(obj)


def restore_state(snap: Any) -> Any:
    """Materialize a fresh live object from a snapshot."""
    fn = getattr(snap, "__tx_restore__", None)
    if fn is None:
        fn = getattr(snap, "__tx_snapshot__", None)
    if fn is not None:
        return fn()
    return copy.deepcopy(snap)


class CopyBuffer:
    """Full-state snapshot of a shared object."""

    __slots__ = ("state", "instance", "home_node")

    def __init__(self, obj: Any, instance: int, home_node: Optional[object] = None):
        self.state = snapshot_state(obj)
        self.instance = instance          # instance epoch observed at snapshot time
        self.home_node = home_node

    def call(self, method: str, args: tuple, kwargs: dict) -> Any:
        """Execute ``method`` against the buffered copy (local read path)."""
        return getattr(self.state, method)(*args, **kwargs)

    def restore_into(self, target_holder: "StateHolder") -> None:
        """Abort path: replace the live object state with the snapshot."""
        target_holder.obj = restore_state(self.state)


class LogBuffer:
    """Method-invocation log for unsynchronized pure writes."""

    __slots__ = ("entries", "home_node")

    def __init__(self, home_node: Optional[object] = None):
        self.entries: List[Tuple[str, tuple, dict]] = []
        self.home_node = home_node

    def __len__(self) -> int:
        return len(self.entries)

    def record(self, method: str, args: tuple, kwargs: dict) -> None:
        """Log a write call. Pure writes return no value, so recording is
        sufficient — the effects materialize at apply time."""
        self.entries.append((method, args, kwargs))

    def apply_to(self, obj: Any) -> None:
        """Replay the log against the real object, then clear it."""
        for method, args, kwargs in self.entries:
            getattr(obj, method)(*args, **kwargs)
        self.entries.clear()


class StateHolder:
    """Mutable cell holding the live state of a shared object.

    Restores swap the referenced object rather than mutating in place so a
    doomed transaction still holding the stale reference keeps reading the
    invalid instance it observed (matching the paper's "invalid instance"
    semantics) instead of silently seeing restored state.
    """

    __slots__ = ("obj",)

    def __init__(self, obj: Any):
        self.obj = obj
