"""The port stands alone: no module of src/repro_torch/ and no line of
chip_smoke.py imports JAX or anything of the JAX package, and the entry
points run on the card unless the CPU is asked for."""
import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))


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


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_sees_the_port():
    assert len(PORT_FILES) >= 10
    assert _forbidden("repro.models") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch.models")


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
