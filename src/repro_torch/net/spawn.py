"""Subprocess helpers: launch real node-server processes (DESIGN.md §3.1).

Used by ``benchmarks/eigenbench.py --transport=tcp``, the distributed
quickstart, and the transport tests: spawns ``python -m repro.net.server``
with an OS-assigned port, parses the ``LISTENING host:port`` announcement,
and hands back a :class:`ServerHandle` that can stop the process cleanly
(shutdown RPC first, SIGTERM/kill as fallback).

This module is TCP-only on purpose: a "node" of the deterministic
simulation transport is an in-process :class:`~repro.net.simnet.SimNode`
(no subprocess to spawn) — build those with
:func:`repro.net.simnet.build_simnet` instead. Both end up behind the
same client-side :class:`~repro.net.transport.Transport` interface.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Optional, Sequence

from .client import NodeClient

_SRC_DIR = str(Path(__file__).resolve().parents[2])   # .../src


class ServerHandle:
    """A running node-server subprocess."""

    def __init__(self, proc: subprocess.Popen, address: str, name: str):
        self.proc = proc
        self.address = address
        self.name = name
        self._client: Optional[NodeClient] = None

    @property
    def client(self) -> NodeClient:
        if self._client is None:
            self._client = NodeClient(self.address)
        return self._client

    def stop(self, grace: float = 3.0) -> None:
        if self.proc.poll() is None:
            try:
                self.client.call("shutdown")
            except Exception:  # noqa: BLE001 - already dead is fine
                pass
            try:
                self.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                self.proc.terminate()
                try:
                    self.proc.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
        if self._client is not None:
            self._client.close()

    def kill(self) -> None:
        """Crash-stop the server process (for §3.4 failure testing)."""
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def __enter__(self) -> "ServerHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def spawn_server(name: str = "node0", *, host: str = "127.0.0.1",
                 port: int = 0,
                 monitor_timeout: float = 2.0, monitor_poll: float = 0.05,
                 workers: int = 1, extra_paths: Sequence[str] = (),
                 wal_dir: Optional[str] = None,
                 startup_timeout: float = 20.0) -> ServerHandle:
    """Spawn one node-server process and wait for its announcement.

    ``extra_paths`` are appended to the server's ``sys.path`` so that
    classes of objects bound over the wire (pickled by reference) can be
    imported on the home node.

    ``port=0`` (the default) lets the OS pick; a fixed port plus a
    ``wal_dir`` is the §11 restart recipe — SIGKILL the process, spawn it
    again under the same name/port/wal_dir, and it replays its ledger and
    rejoins its chains under the old identity.
    """
    cmd: List[str] = [
        sys.executable, "-u", "-m", "repro_torch.net.server",
        "--name", name, "--host", host, "--port", str(port), "--announce",
        "--monitor-timeout", str(monitor_timeout),
        "--monitor-poll", str(monitor_poll),
        "--workers", str(workers),
    ]
    if wal_dir is not None:
        cmd += ["--wal-dir", str(wal_dir)]
    for p in extra_paths:
        cmd += ["--path", str(p)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC_DIR, *map(str, extra_paths),
         *filter(None, [env.get("PYTHONPATH")])])
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, env=env, text=True)
    # readline() blocks, so the deadline is enforced from a reader thread —
    # a child that hangs before announcing must not stall the parent.
    found: dict = {}

    def _reader() -> None:
        for line in proc.stdout:
            if line.startswith("LISTENING "):
                found["address"] = line.split(None, 1)[1].strip()
                return

    t = threading.Thread(target=_reader, daemon=True)
    t.start()
    t.join(startup_timeout)
    if "address" not in found:
        proc.kill()
        proc.wait()
        if proc.returncode not in (None, -9):
            raise RuntimeError(
                f"node server {name!r} died during startup "
                f"(rc={proc.returncode})")
        raise TimeoutError(f"node server {name!r} never announced")
    return ServerHandle(proc, found["address"], name)


def spawn_cluster(n: int, **kw) -> List[ServerHandle]:
    """Spawn ``n`` node servers (``node0`` ... ``node{n-1}``)."""
    handles: List[ServerHandle] = []
    try:
        for i in range(n):
            handles.append(spawn_server(f"node{i}", **kw))
    except BaseException:
        for h in handles:
            h.stop()
        raise
    return handles
