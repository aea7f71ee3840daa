"""repro.obs — structured tracing + metrics for the OptSVA-CF stack.

Three pieces (DESIGN.md §9):

* :mod:`repro.obs.txtrace` — per-thread ring buffers of binary span
  events covering the full transaction lifecycle, correlated cross-node
  by ``(txn_uid, incarnation, pv)``;
* :mod:`repro.obs.metrics` — counters + HDR-style histograms (gate wait,
  version wait, version-handoff latency), exposed via the ``stats`` RPC
  and a SIGUSR2 dump;
* :mod:`repro.obs.export` — merges per-site rings into Chrome-trace /
  Perfetto JSON (one track per node, one flow per transaction).

Everything is gated on the single module flag ``txtrace.enabled``
(default off, or the ``REPRO_TRACE`` environment variable): every
instrumentation site in the hot path is ``if txtrace.enabled: ...`` —
one attribute read when tracing is off, no allocation, no locks, no
messages. Enabling tracing never adds protocol messages either (rings
are in-process; export pulls them explicitly), so the simnet exact
message-plan gate holds with tracing on or off.
"""
from . import txtrace, metrics, export  # noqa: F401

__all__ = ["txtrace", "metrics", "export"]
