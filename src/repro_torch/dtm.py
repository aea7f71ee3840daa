"""``repro.dtm`` — the one-stop public API of the transactional memory.

The canonical surface of the OptSVA-CF reproduction (DESIGN.md §12): one
import gives everything an application needs across all three transports
(in-process, TCP, deterministic simulation)::

    from repro_torch.dtm import (access, Mode, Suprema, Transaction, Registry,
                           connect, bind, spawn_server)
    from repro_torch.net.demo import HotAccount   # wire-bound classes must be
                                            # importable (pickled by ref)

    server = spawn_server("node0")                  # one process per node
    reg = connect(server.address)                   # client-side registry
    node, = reg.nodes
    bind(node, "hot", HotAccount(0))

    t = Transaction(reg)
    acct = t.commutes(reg.locate("hot"))            # commute-restricted
    t.start(lambda _t: acct.deposit(10))            # merges as a delta

Everything here is a re-export or a thin veneer over ``repro.core`` and
``repro.net``; the implementation modules remain importable (legacy public
paths keep working — deprecated forms warn exactly once and point here).
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.core import (AbortError, Mode, Registry, RemoteObjectFailure,
                        Suprema, Transaction, TransactionError, access)
from repro_torch.net.spawn import spawn_server

__all__ = [
    "access", "Mode", "Suprema", "Transaction", "Registry",
    "connect", "bind", "spawn_server",
    # the error surface applications handle
    "AbortError", "TransactionError", "RemoteObjectFailure",
]


def connect(*addresses: str, registry: Optional[Registry] = None,
            **client_kw: Any) -> Registry:
    """Build (or extend) a client-side :class:`Registry` connected to node
    servers.

    Each ``address`` is ``"host:port"`` (TCP) or a transport-specific
    address such as ``"sim://node0"``. Returns the registry; the connected
    nodes are reachable through ``registry.nodes`` and their bindings
    through ``registry.locate``.
    """
    reg = registry if registry is not None else Registry()
    for address in addresses:
        reg.connect(address, **client_kw)
    return reg


def bind(node: Any, name: str, obj: Any, *, followers: tuple = (),
         wal: Any = None, lease: Any = None) -> Any:
    """Publish ``obj`` under ``name`` on ``node`` — the unified publish
    signature (DESIGN.md §12).

    ``node`` may be an in-process :class:`~repro.core.registry.Node`, a
    connected :class:`~repro.net.remote.RemoteNode`, or a simulation node
    proxy — all expose the same keyword-only ``bind``. ``followers``
    (replica chain), ``wal`` (durability) and ``lease`` (ownership) are
    node-server publish options; the in-process registry accepts only
    their defaults.
    """
    return node.bind(name, obj, followers=followers, wal=wal, lease=lease)
