"""The import rule: nothing the benchmark runs loads JAX or the JAX package,
compared by the top-level name of each module as a whole word (the port's
name begins with the JAX package's)."""
import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import harness
from portbench.manifest import HERE, ROOT

FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.models.backbone", "reproduce", "jaxtyping",
      "torch"], []),
    (["repro.models"], ["repro"]),
    (["jax._src.core", "numpy"], ["jax"]),
    (["jaxlib", "flax.linen"], ["flax", "jaxlib"]),
])
def test_forbidden_by_whole_top_level_name(names, found):
    assert harness.forbidden_modules(names) == found


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_of_the_harness_imports_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_a_run_loads_neither_jax_nor_repro(tmp_path):
    """A tiny CPU run in a fresh interpreter, then its sys.modules."""
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from portbench.tests import tiny\n"
        "from portbench import harness\n"
        "for name in ('qwen3-4b.train-2k', 'mixtral-8x22b.serve-long'):\n"
        "    r = tiny.run(tiny.cell(name), trace=True, seconds=0.05)\n"
        "    assert r['correct'], r\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    # one CPU thread: the run is tiny, and the suite's other workers share
    # the machine
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.runtime.serve_loop" in mods
    assert harness.forbidden_modules(mods) == []


def test_run_without_a_card_exits_without_a_result(tmp_path):
    """run.py with no CUDA device: a non-zero exit and no result line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "mixtral-8x22b.serve-long", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    if out.returncode == 0:
        pytest.fail("a result without a card: " + out.stdout[-500:])
    assert not out.stdout.strip()
