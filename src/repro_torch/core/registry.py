"""Nodes, the object registry, and shared-object containers (paper §3, Fig. 6).

A :class:`Node` stands in for one network host/JVM: it *homes* shared
objects, owns the node's single executor thread (§3.3), and can simulate
network latency for calls arriving from other nodes. A :class:`Registry`
is the RMI-registry analogue: it binds names to shared objects and lets
clients ``locate`` them.

Every operation on a :class:`SharedObject` executes on its home node (CF
model) — here, in-process, the "home node" is an accounting entity that the
fault-tolerance layer and the latency simulation key off.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

from .api import (IllegalState, Mode, RemoteObjectFailure, commute_classes,
                  method_commutes, method_mode, warn_deprecated)
from .buffers import StateHolder
from .executor import Executor
from .versioning import VersionHeader


class Node:
    """One simulated host: homes objects, runs one executor thread."""

    def __init__(self, name: str, *, network_delay: float = 0.0,
                 executor_workers: int = 1):
        self.name = name
        self.network_delay = network_delay
        self.executor = Executor(name=f"exec-{name}", workers=executor_workers)
        self.alive = True
        self.registry: Optional["Registry"] = None   # set by Registry.add_node

    def bind(self, name: str, obj: Any, *, followers: tuple = (),
             wal: Any = None, lease: Any = None) -> "SharedObject":
        """Publish ``obj`` under ``name`` on this node — the unified
        keyword-only publish signature (DESIGN.md §12), same shape as
        ``RemoteNode.bind``. The in-process node has no replication or
        durability plane, so only the defaults are accepted."""
        if self.registry is None:
            raise IllegalState(
                f"node {self.name!r} is not attached to a registry")
        return self.registry.bind(name, obj, node=self, followers=followers,
                                  wal=wal, lease=lease)

    def simulate_network(self, from_node: Optional["Node"]) -> None:
        """Sleep for the configured one-way latency on cross-node calls."""
        if self.network_delay > 0.0 and from_node is not self:
            time.sleep(self.network_delay)

    def crash(self) -> None:
        """Crash-stop the node: all homed objects become unreachable."""
        self.alive = False

    def shutdown(self) -> None:
        self.executor.shutdown()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Node({self.name})"


class SharedObject:
    """A shared object homed on a node, with its versioning header.

    ``holder.obj`` is the live state; all transactional bookkeeping
    (version counters, instance epoch) lives in ``header``.
    """

    def __init__(self, name: str, obj: Any, node: Node):
        self.name = name
        self.holder = StateHolder(obj)
        self.node = node
        self.header = VersionHeader(owner_node=node)
        self.failed = False
        # operation log fence for fault tolerance: last time a transaction
        # holding this object talked to it (paper §3.4).
        self.last_contact: float = time.monotonic()
        self.holding_txn: Optional[object] = None
        self._contact_lock = threading.Lock()

    # -- direct (non-transactional) execution --------------------------------
    def raw_call(self, method: str, args: tuple = (),
                 kwargs: Optional[dict] = None,
                 from_node: Optional[Node] = None) -> Any:
        """Execute a method on the live state at the home node."""
        self.check_reachable()
        self.node.simulate_network(from_node)
        return getattr(self.holder.obj, method)(*args, **(kwargs or {}))

    def mode_of(self, method: str) -> Mode:
        return method_mode(self.holder.obj, method)

    def commute_of(self, method: str) -> Optional[str]:
        """Declared commute-class label of ``method``, or None (§12)."""
        return method_commutes(self.holder.obj, method)

    def commute_classes(self) -> Dict[str, str]:
        """All ``{method: commute class}`` declarations of this object."""
        return commute_classes(self.holder.obj)

    def check_reachable(self) -> None:
        if self.failed or not self.node.alive:
            raise RemoteObjectFailure(f"remote object {self.name!r} is unreachable")

    def fail(self) -> None:
        """Crash-stop this object (paper §3.4: removed from the system).

        Wakes nobody: reachability is checked on the operation path, not in
        any wait condition, and the monitor's self-rollback (not this flag)
        is what eventually advances the counters blocked waiters need."""
        self.failed = True

    # -- fault-tolerance heartbeat -------------------------------------------
    def touch(self, txn: object) -> None:
        with self._contact_lock:
            self.last_contact = time.monotonic()
            self.holding_txn = txn

    def clear_holder(self, txn: object) -> None:
        with self._contact_lock:
            if self.holding_txn is txn:
                self.holding_txn = None

    # -- transport boundary ---------------------------------------------------
    def make_access(self, txn: object, sup: Any) -> Any:
        """Build the per-transaction access record for this object.

        The in-process transport returns a plain
        :class:`~repro.core.transaction.ObjectAccess`; remote proxies
        (``repro.net.remote.RemoteSharedObject``) override this to return an
        access record whose state operations are RPCs to the home node.
        """
        from .transaction import CommuteAccess, ObjectAccess
        if getattr(sup, "commutes", None) is not None:
            return CommuteAccess(txn, self, sup)
        return ObjectAccess(txn, self, sup)

    def __repr__(self) -> str:  # pragma: no cover
        return f"SharedObject({self.name}@{self.node.name}, {self.header!r})"


class Registry:
    """Name → shared object directory (the RMI-registry analogue)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._connect_lock = threading.Lock()   # serializes connect() I/O
        self._objects: Dict[str, SharedObject] = {}
        self._nodes: Dict[str, Node] = {}

    def add_node(self, name: str, **kw) -> Node:
        with self._lock:
            if name in self._nodes:
                raise ValueError(f"node {name!r} already exists")
            node = Node(name, **kw)
            node.registry = self
            self._nodes[name] = node
            return node

    def node(self, name: str) -> Node:
        with self._lock:
            return self._nodes[name]

    @property
    def nodes(self) -> Iterable[Node]:
        with self._lock:
            return list(self._nodes.values())

    def bind(self, name: str, obj: Any, *args: Any,
             node: Optional[Node] = None, followers: tuple = (),
             wal: Any = None, lease: Any = None) -> SharedObject:
        """Publish ``obj`` under ``name`` on ``node``.

        The unified publish signature (DESIGN.md §12): keyword-only
        ``followers=()``, ``wal=None``, ``lease=None`` mirror the node
        servers' ``bind`` — the in-process registry has no replication or
        durability plane, so it accepts only their defaults. The legacy
        positional ``bind(name, obj, node)`` form still works but warns
        once; pass ``node=`` instead."""
        if args:
            warn_deprecated(
                "Registry.bind:positional",
                "Registry.bind(name, obj, node) with positional node is "
                "deprecated; use bind(name, obj, node=...) — the unified "
                "keyword-only publish signature")
            node = args[0]
        if node is None:
            raise TypeError("Registry.bind requires node=")
        if followers or wal is not None or lease is not None:
            raise ValueError(
                "followers/wal/lease are node-server publish options; the "
                "in-process registry supports only their defaults")
        with self._lock:
            if name in self._objects:
                raise ValueError(f"object {name!r} already bound")
            shared = SharedObject(name, obj, node)
            self._objects[name] = shared
            return shared

    def locate(self, name: str) -> SharedObject:
        with self._lock:
            try:
                return self._objects[name]
            except KeyError:
                raise KeyError(f"no object bound under {name!r}") from None

    def unbind(self, name: str) -> None:
        with self._lock:
            self._objects.pop(name, None)

    def all_objects(self) -> Dict[str, SharedObject]:
        with self._lock:
            return dict(self._objects)

    # -- registry federation (DESIGN.md §3.1) ---------------------------------
    def connect(self, address: str, **client_kw) -> "Node":
        """Merge a remote node server's bindings into this registry.

        ``address`` is ``"host:port"``. Creates (or reuses) a
        ``repro.net.remote.RemoteNode`` for the server and a
        ``RemoteSharedObject`` proxy for every binding the server reports;
        ``locate`` then hands out remote proxies exactly like local shared
        objects, so transactions span transports transparently. Returns the
        remote node. Re-connecting the same address refreshes the binding
        set (new remote bindings since the last call are merged in).
        """
        from repro_torch.net.remote import RemoteNode  # lazy: net imports core
        # Network I/O happens outside the registry lock (a hung server must
        # not stall bind/locate); concurrent connects serialize on their own.
        with self._connect_lock:
            with self._lock:
                node = self._nodes.get(address)
            if node is None:
                node = RemoteNode(address, **client_kw)
            elif not (node.alive and getattr(node.client, "alive", True)):
                # same address, reborn process (§11 restart): re-dial the
                # cached handle instead of leaving it crash-stopped forever
                node.reconnect()
            bindings = node.fetch_bindings()
            with self._lock:
                self._nodes.setdefault(address, node)
                for shared in bindings:
                    self._objects.setdefault(shared.name, shared)
            node.registry = self   # future node.bind()s register here too
            return node

    def register_remote(self, shared: SharedObject) -> None:
        """Merge one remote binding (used by ``RemoteNode.bind``)."""
        with self._lock:
            self._objects.setdefault(shared.name, shared)

    def shutdown(self) -> None:
        for node in self.nodes:
            node.shutdown()
