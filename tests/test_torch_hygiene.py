"""The port stands alone: no module of src/repro_torch/ and no line of
its scripts (chip_smoke.py, scan_phases.py) imports JAX or anything of
the JAX package, or names a module of it as the ``-m`` target of a
subprocess, and the entry points run on the card unless the CPU is asked
for."""
import ast
import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SCRIPTS = [ROOT / name for name in ("chip_smoke.py", "scan_phases.py")]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


_DASH_M = re.compile(r"(?:^|\s)-m\s+([\w.]+)")


def _module_targets(tree: ast.AST):
    """(line, module) of every ``-m`` target a string constant names: an
    element after a ``"-m"`` element of a list or tuple (an argv), or the
    word after ``-m`` inside one string (a shell command). Docstrings are
    prose and are not read."""
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, (ast.List, ast.Tuple)):
            elts = node.elts
            for a, b in zip(elts, elts[1:]):
                if (isinstance(a, ast.Constant) and a.value == "-m"
                        and isinstance(b, ast.Constant)
                        and isinstance(b.value, str)):
                    yield b.lineno, b.value
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs):
            for name in _DASH_M.findall(node.value):
                yield node.lineno, name


@pytest.mark.parametrize("path", PORT_FILES + SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"
    tree = ast.parse(path.read_text(), str(path))
    bad = [(line, name) for line, name in _module_targets(tree)
           if _forbidden(name)]
    assert not bad, f"{path.name} runs reference modules with -m: {bad}"


def test_the_scan_sees_the_port():
    assert len(PORT_FILES) >= 10
    assert _forbidden("repro.models") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.models")


def test_the_scan_sees_a_module_target():
    """The reference's spawn argv and a shell command are flagged; the
    port's argv and a docstring's example are not."""
    code = ('"""python -m repro.net.server in prose"""\n'
            'cmd = [sys.executable, "-u", "-m", "repro.net.server"]\n'
            'sh = "cd x && python -m repro.launch.serve --arch a"\n'
            'ok = (sys.executable, "-m", "repro_torch.net.server")\n')
    found = sorted(_module_targets(ast.parse(code)))
    assert found == [(2, "repro.net.server"), (3, "repro.launch.serve"),
                     (4, "repro_torch.net.server")]
    assert [n for _, n in found if _forbidden(n)] == [
        "repro.net.server", "repro.launch.serve"]
    src = (ROOT / "src" / "repro" / "net" / "spawn.py").read_text()
    assert [n for _, n in _module_targets(ast.parse(src))] == [
        "repro.net.server"]


def test_backbone_without_a_device_raises_where_there_is_no_card():
    from repro_torch.models import Backbone, get_config, reduced
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Backbone(reduced(get_config("qwen3-4b")))
    Backbone(reduced(get_config("qwen3-4b")), device="cpu")


def test_serve_launcher_defaults_to_the_card(monkeypatch):
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "qwen3-4b",
                                     "--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main()


def test_train_launcher_defaults_to_the_card(monkeypatch, tmp_path):
    from repro_torch.launch import train
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    monkeypatch.setattr("sys.argv", ["train", "--arch", "qwen3-4b",
                                     "--reduced", "--steps", "1",
                                     "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main()
