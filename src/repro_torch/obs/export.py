"""Merge per-site trace rings into Chrome-trace / Perfetto JSON.

One *process* per site (node or client), one *thread* per ring, one
*flow* per transaction: the flow's steps visit, in causal order, the
first span each site recorded for that transaction — so a bank transfer
under ``--transport sim`` renders as client → home node → chain node →
follower arrows in the Perfetto UI (load the file at ui.perfetto.dev).

Determinism: events are sorted by ``(ts, site, ring, idx)`` — under
simnet all timestamps come from the one virtual clock and site/ring ids
are a pure function of the seed, so the merged JSON is byte-identical
across replays of the same seed. Transaction uids and client sites are
normalized by first appearance (``T1, T2, ...`` / ``client1, ...``),
mirroring simnet's ``_txn_label`` scheme, because raw uids embed the
OS pid.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from . import txtrace


def merged_events(tracers: Optional[Iterable[txtrace.Tracer]] = None,
                  extra_events: Optional[List[dict]] = None) -> List[dict]:
    """Collect, sort and normalize events from ``tracers`` (default: all
    registered sites) plus ``extra_events`` (e.g. rings pulled from TCP
    node-server processes via the ``trace_dump`` op)."""
    evs: List[dict] = []
    for t in (txtrace.all_tracers() if tracers is None else tracers):
        evs.extend(t.events())
    if extra_events:
        evs.extend(dict(e) for e in extra_events)
    evs.sort(key=lambda e: (e["ts"], e["site"], e["ring"], e["idx"]))

    txn_map: Dict[str, str] = {}
    site_map: Dict[str, str] = {}
    for e in evs:
        raw = e["txn"]
        if raw:
            # Key on the "#<id>[r<inc>]" tail: client-side spans emit the
            # bare tail while server-side spans carry the full wire uid
            # ("<client_id>#<id>..."); both must map to one flow. The
            # tail is unique per run (Transaction.id is process-global).
            key = raw.rsplit("#", 1)[-1]
            lbl = txn_map.get(key)
            if lbl is None:
                lbl = f"T{len(txn_map) + 1}"
                txn_map[key] = lbl
            e["txn"] = lbl
        site = e["site"]
        norm = site_map.get(site)
        if norm is None:
            if site.startswith("client:"):
                n = sum(1 for s in site_map.values()
                        if s.startswith("client"))
                norm = f"client{n + 1}"
            else:
                norm = site.split(":", 1)[-1]
            site_map[site] = norm
        e["site"] = norm
    return evs


def chrome_trace(events: List[dict]) -> dict:
    """Build a Chrome-trace document (Perfetto-loadable) from normalized
    events. Slices carry the correlation key in ``args``; instants keep
    their severity tag."""
    pids: Dict[str, int] = {}
    out: List[dict] = []
    for e in events:
        if e["site"] not in pids:
            pid = len(pids) + 1
            pids[e["site"]] = pid
            out.append({"ph": "M", "pid": pid, "tid": 0,
                        "name": "process_name",
                        "args": {"name": e["site"]}})
    for e in events:
        pid = pids[e["site"]]
        ts = int(round(e["ts"] * 1e6))
        args = {"txn": e["txn"], "inc": e["inc"], "pv": e["pv"],
                "detail": e["detail"], "sev": e["sev"]}
        if e["dur"] > 0.0:
            out.append({"ph": "X", "pid": pid, "tid": e["ring"],
                        "ts": ts, "dur": int(round(e["dur"] * 1e6)),
                        "name": e["kind"], "cat": "txn", "args": args})
        else:
            out.append({"ph": "i", "s": "t", "pid": pid, "tid": e["ring"],
                        "ts": ts, "name": e["kind"], "cat": "txn",
                        "args": args})

    # One flow per transaction: its steps visit the FIRST span recorded
    # per site, in time order (client -> home node -> chain -> follower).
    flows: Dict[str, List[dict]] = {}
    for e in events:
        if not e["txn"] or e["dur"] <= 0.0:
            continue
        sites_seen = flows.setdefault(e["txn"], [])
        if not any(s["site"] == e["site"] for s in sites_seen):
            sites_seen.append(e)
    for txn, chain in sorted(flows.items()):
        if len(chain) < 2:
            continue
        fid = int(txn[1:]) if txn[1:].isdigit() else abs(hash(txn)) % 10 ** 6
        for i, e in enumerate(chain):
            out.append({"ph": "s" if i == 0 else "t", "id": fid,
                        "pid": pids[e["site"]], "tid": e["ring"],
                        "ts": int(round(e["ts"] * 1e6)),
                        "name": "txn-flow", "cat": "txn",
                        "args": {"txn": txn}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_trace(path: str,
                tracers: Optional[Iterable[txtrace.Tracer]] = None,
                extra_events: Optional[List[dict]] = None) -> int:
    """Write the merged Perfetto JSON to ``path``; returns the event
    count. The serialization is canonical (sorted keys, no whitespace)
    so identical event streams produce identical bytes."""
    events = merged_events(tracers, extra_events)
    doc = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")
    return len(events)
