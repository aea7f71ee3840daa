"""One run of one cell: the checks around a driver and the result line.

The run refuses to measure without the cards its cell asks for; it never
falls back to the CPU. After the window it refuses to print a result if
the process holds JAX or the JAX package (compared by the top-level name
of every module, as a whole word: the port's own name begins with the JAX
package's). ``--trace 0`` reports the cell's end-to-end metrics, ``--trace
1`` its per-layer metrics (each from its reader in ``metrics/``) with the
device's busy seconds and the breakdown of the profiled stretch.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from /proc (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def metrics_of(cell, record: Dict, trace: bool) -> Dict:
    from .manifest import metric_reader
    out = {}
    if not trace:
        for m in cell.end_to_end:
            value = record["end_to_end"].get(m["name"])
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = metric_reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compared(cell, numbers: Dict) -> Dict:
    limits = cell.cell["check"]["limits"]
    return {name: {"value": numbers.get(name), "limit": limits[name]}
            for name in limits}


def is_correct(check: Dict, table: Dict) -> bool:
    return check["failed"] == 0 and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in table.values())


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda") -> Dict:
    """Drive one run and return the result line's object. ``t_start``: the
    process's first instant the caller could read (set-up counts from the
    process's start where /proc gives it)."""
    import torch

    driver = importlib.import_module(f"portbench.drivers.{cell.cell['kind']}")
    record = driver.run(cell, seed, seconds, trace, device)
    age = process_age_s()
    now = time.perf_counter()
    setup_s = (record["t_window"] - t_start
               + (age - (now - t_start) if age is not None else 0.0))
    record["end_to_end"]["setup_s"] = setup_s
    table = compared(cell, record["check"]["numbers"])
    on_card = device == "cuda"
    result = {
        "correct": is_correct(record["check"], table),
        "attempted": record["check"]["attempted"],
        "failed": record["check"]["failed"],
        "metrics": metrics_of(cell, record, trace),
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": int(record.get("memory_peak_bytes", 0)),
            "power_limit": power_limit() if on_card else "none",
        },
    }
    if trace and record.get("stretch"):
        st = record["stretch"]
        result["device"]["busy_s"] = st["busy_s"]
        result["device"]["window_s"] = st["window_s"]
        result["breakdown"] = {"device_ops": st["device_ops"],
                               "idle_gaps": st["idle_gaps"]}
    result["compared"] = table
    return result


def main(args, t_start: float) -> int:
    import torch

    from .manifest import load_cell, load_manifest

    cell = load_cell(args.workload, load_manifest())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {found} after the window: no "
              "result", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"compared {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
