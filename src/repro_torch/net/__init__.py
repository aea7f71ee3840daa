"""``repro.net`` — a real wire for OptSVA-CF (DESIGN.md §3.1).

Atomic RMI 2 runs transactions against objects *homed* on remote JVMs over
Java RMI; this package is the reproduction's analogue: registry nodes become
real OS processes reachable over TCP, and the control-flow (CF) model's
delegation becomes literal — §2.7 read-only buffering, §2.8.4 last-write log
application, checkpointing, and abort restores all execute *on the home
node*; only versions, instance epochs, and method return values cross the
wire. Object state never moves for a buffered write.

Modules:

* :mod:`repro.net.wire`   — length-prefixed binary framing + the tagged
  message codec (requests, one-way messages, replies with piggybacked
  notes, server pushes);
* :mod:`repro.net.client` — multiplexed pipelined RPC client
  (``call_async`` futures, fire-and-forget ``notify``, deferred one-way
  errors, pushed task notes) with liveness riding the same link;
* :mod:`repro.net.server` — the node server process: hosts
  ``SharedObject``/``VersionHeader``/``Executor`` plus per-transaction
  *sessions* (whose access records subclass ``ObjectAccess``) and the §3.4
  :class:`~repro.core.faults.TransactionMonitor`; concurrent per-connection
  dispatch with reply tagging and completion pushes;
* :mod:`repro.net.remote` — ``RemoteNode``/``RemoteSharedObject``/
  ``RemoteObjectAccess`` duck-typing the in-process surface so
  ``Transaction``, ``TransactionMonitor``, and ``txstore`` run unchanged
  over either transport;
* :mod:`repro.net.spawn`  — subprocess helpers used by benchmarks, tests,
  and the distributed quickstart;
* :mod:`repro.net.transport` — the narrow client-side ``Transport``
  interface both wires implement (plus the shared deferred-error /
  task-note bookkeeping);
* :mod:`repro.net.simnet` — the deterministic simulation transport
  (DESIGN.md §7): every node in one process under a virtual clock, a
  seeded scheduler owning delivery order/latency/faults, byte-replayable
  schedule traces.

Trust model: frames carry pickles, so a node server must only be exposed to
trusted peers (localhost or a private cluster network) — exactly the
deployment model of Java RMI serialization in the source system.
"""
from repro_torch.core.api import warn_deprecated

from .client import NodeClient
from .remote import RemoteNode, RemoteObjectAccess, RemoteSharedObject
from .server import NodeCore, NodeServer
from .simnet import SimNet, SimNode, SimTransport, build_simnet
from .spawn import ServerHandle
from .transport import CLIENT_ID, Transport
from .wire import ConnectionClosed, WireError


def __getattr__(name: str):
    # Legacy public import path (pre-§12 API): kept working, warns once,
    # points at the canonical surface.
    if name == "spawn_server":
        warn_deprecated(
            "import:repro_torch.net.spawn_server",
            "importing spawn_server from repro_torch.net is deprecated; use "
            "repro_torch.dtm.spawn_server (the unified public API surface)")
        from .spawn import spawn_server
        return spawn_server
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "CLIENT_ID", "NodeClient", "RemoteNode", "RemoteObjectAccess",
    "RemoteSharedObject", "NodeCore", "NodeServer", "ServerHandle",
    "SimNet", "SimNode", "SimTransport", "Transport", "build_simnet",
    "spawn_server", "ConnectionClosed", "WireError",
]
