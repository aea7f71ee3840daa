"""Public API surface of the OptSVA-CF core (paper Figs. 7-9).

Users annotate shared-object methods with an access mode, publish the
object in a :class:`~repro.core.registry.Registry`, and run transactions
through :class:`~repro.core.transaction.Transaction`.
"""
from __future__ import annotations

import enum
import math
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

INF = math.inf

_WARNED: set = set()


def warn_deprecated(key: str, msg: str) -> None:
    """Emit ``msg`` as a DeprecationWarning exactly once per ``key`` per
    process (the API-migration contract: legacy forms keep working but
    say so exactly once)."""
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(msg, DeprecationWarning, stacklevel=3)


class Mode(enum.Enum):
    """Operation classification of the complex-object model (paper §2.5)."""

    READ = "read"      # may view state / return value; never modifies state
    WRITE = "write"    # may modify state; never views it
    UPDATE = "update"  # may both view and modify state


def access(mode: Mode, commutes: Optional[str] = None) -> Callable:
    """Method decorator declaring the access mode of a shared-object method.

    Mirrors the ``@Access(Mode.READ)`` annotation of Atomic RMI 2 (Fig. 7)::

        class Account:
            @access(Mode.READ)
            def balance(self): ...

    ``commutes`` names a *commuting method class* (DESIGN.md §12): every
    method sharing the same class label commutes with every other (including
    itself), so invocations restricted to one class may skip version-gated
    dispensing and merge as deltas at the home node. Only ``Mode.WRITE``
    methods may commute — a commuting operation must never view state, or
    the merge order would be observable.
    """

    def deco(fn: Callable) -> Callable:
        fn.__access_mode__ = mode
        if commutes is not None:
            if mode is not Mode.WRITE:
                raise TypeError(
                    f"commutes={commutes!r} requires Mode.WRITE: a commuting "
                    f"method must be write-only (got {mode})")
            fn.__access_commutes__ = commutes
        return fn

    return deco


#: Per-class cache of {method name: (Mode, commute class | None)}, built
#: once on first access instead of re-resolving ``getattr(type(obj), name)``
#: in the hot dispatch path. Unannotated methods are simply absent.
_CLASS_ACCESS_MAPS: Dict[type, Dict[str, tuple]] = {}


def class_access_map(cls: type) -> Dict[str, tuple]:
    """The cached ``{name: (mode, commute_class)}`` map of ``cls``."""
    m = _CLASS_ACCESS_MAPS.get(cls)
    if m is None:
        m = {}
        for name in dir(cls):
            fn = getattr(cls, name, None)
            mode = getattr(fn, "__access_mode__", None)
            if mode is not None:
                m[name] = (mode, getattr(fn, "__access_commutes__", None))
        _CLASS_ACCESS_MAPS[cls] = m
    return m


def method_mode(obj: Any, name: str) -> Mode:
    """Resolve the declared access mode of ``obj.name``.

    Raises ``TypeError`` for unannotated methods: in the CF model every
    remotely callable operation must be classified (paper §2.5).
    """
    ent = class_access_map(type(obj)).get(name)
    if ent is None:
        if getattr(type(obj), name, None) is None:
            raise AttributeError(
                f"{type(obj).__name__} has no method {name!r}")
        raise TypeError(
            f"method {type(obj).__name__}.{name} lacks an @access(Mode.*) annotation"
        )
    return ent[0]


def method_commutes(obj: Any, name: str) -> Optional[str]:
    """The commute-class label of ``obj.name``, or ``None``."""
    ent = class_access_map(type(obj)).get(name)
    return ent[1] if ent is not None else None


def commute_classes(obj: Any) -> Dict[str, str]:
    """All declared ``{method name: commute class}`` entries of ``obj``."""
    return {n: c for n, (m, c) in class_access_map(type(obj)).items()
            if c is not None}


@dataclass
class Suprema:
    """A-priori upper bounds on per-object access counts (paper §2.2).

    ``inf`` means "unknown"; the algorithm stays correct but releases the
    object only at commit/abort instead of early.

    ``commutes`` marks a *commute-restricted* declaration (DESIGN.md §12):
    the transaction promises to touch the object only through methods of
    the named commuting class. Such accesses are write-only (``writes``
    bounds them) and may skip version-gated dispensing entirely.
    """

    reads: float = INF
    writes: float = INF
    updates: float = INF
    commutes: Optional[str] = None

    @property
    def total(self) -> float:
        return self.reads + self.writes + self.updates

    @property
    def read_only(self) -> bool:
        """True iff the transaction may only ever read this object."""
        return self.writes == 0 and self.updates == 0

    def validate(self) -> None:
        for v, n in ((self.reads, "reads"), (self.writes, "writes"), (self.updates, "updates")):
            if v != INF and (v < 0 or int(v) != v):
                raise ValueError(f"supremum {n} must be a non-negative integer or inf, got {v}")


class TransactionError(RuntimeError):
    """Base class for transactional control-flow errors."""


class AbortError(TransactionError):
    """The transaction aborted (manually, by cascade, or forced)."""

    def __init__(self, msg: str, *, forced: bool = False):
        super().__init__(msg)
        self.forced = forced


class SupremumViolation(AbortError):
    """An object was accessed more times than its declared supremum (paper §2.2)."""

    def __init__(self, msg: str):
        super().__init__(msg, forced=True)


class RetrySignal(TransactionError):
    """Raised by ``Transaction.retry()``; caught by ``start`` to re-run the atomic block."""


class RemoteObjectFailure(TransactionError):
    """Crash-stop remote object failure (paper §3.4)."""


class InstanceInvalidated(TransactionError):
    """A home node reports that an observed object instance was invalidated.

    Raised by the network transport when a server-side session operation
    finds the object's instance epoch has moved past the one the session
    observed (a cascading abort restored older state, §2.3). The client
    transaction maps this onto its forced-abort path — the in-process
    transport discovers the same condition via ``_validity_check`` instead.
    """


class IllegalState(TransactionError):
    """API misuse (e.g. operating on a finished transaction)."""


@dataclass
class OpStats:
    """Per-transaction operation statistics (used by benchmarks and tests)."""

    reads: int = 0
    writes: int = 0
    updates: int = 0
    waits: int = 0
    aborts: int = 0
    retries: int = 0
    extra: Dict[str, Any] = field(default_factory=dict)

    @property
    def ops(self) -> int:
        return self.reads + self.writes + self.updates
