"""The port's fake-mesh dry run (``repro_torch.launch.dryrun``) on the
production meshes, each cell in a process of its own, as the reference's
``tests/test_distribution.py`` runs its own. A file of its own: the
multi-pod cell spends minutes in DTensor's redistribute planner on torch
2.13 (ROADMAP.md, section 3)."""
import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_cell_runs_on_the_fake_production_mesh(mesh):
    """whisper-tiny x train_4k on 256 and 512 fake ranks, in a process of
    its own (the fake group is process-wide), with the reference's default
    settings: ZeRO-3 and the per-layer gather put collectives inside the
    layers."""
    code = f"""
import json
from repro_torch.launch.dryrun import run_cell
from repro_torch.runtime.steps import StepSettings
res = run_cell("whisper-tiny", "train_4k", "{mesh}",
               settings=StepSettings(), verbose=False)
print(json.dumps({{"chips": res["chips"], "flops": res["roofline"]["hlo_flops"],
                   "coll": res["hlocost"]["collective_bytes"],
                   "in_layer": res["hlocost"]["in_loop_bytes"],
                   "peak": res["memory"]["peak_bytes"],
                   "args": res["memory"]["argument_bytes"],
                   "frac": res["roofline"]["roofline_fraction"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code],
                         env={**os.environ, "PYTHONPATH": SRC},
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    data = json.loads(out.stdout.strip().splitlines()[-1])
    assert data["chips"] == (512 if mesh == "multi" else 256)
    assert data["flops"] > 0 and data["coll"] > 0 and data["in_layer"] > 0
    assert data["peak"] > data["args"] > 0 and 0 < data["frac"] < 1
