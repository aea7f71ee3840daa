"""Helpers for the tests that hold ``repro_torch``'s copied OptSVA-CF
modules against ``repro``: a reference script or test module loaded with
its imports pointed at the port, and the mapping that lets traces of the
two packages be compared."""
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _is_import(line: str) -> bool:
    return line.strip().startswith(("import ", "from "))


def port_of(relpath: str, renames: dict = None) -> types.ModuleType:
    """The module at ``ROOT / relpath`` with every import line's first
    ``repro.`` read as ``repro_torch.`` and each key of ``renames`` read as
    its value (a name the port words otherwise, such as a logger's): the
    same code, run on the port. Loaded once per process, under the name
    ``port_of:<relpath>``."""
    name = f"port_of:{relpath}"
    if name in sys.modules:
        return sys.modules[name]
    path = ROOT / relpath
    text = path.read_text()
    for old, new in (renames or {}).items():
        assert old in text, (relpath, old)
        text = text.replace(old, new)
    lines = [l.replace("repro.", "repro_torch.", 1) if _is_import(l) else l
             for l in text.splitlines()]
    mod = types.ModuleType(name)
    mod.__file__ = str(path)
    sys.modules[name] = mod
    exec(compile("\n".join(lines) + "\n", str(path), "exec"), mod.__dict__)
    return mod


def as_reference(text: str) -> str:
    """A trace of the port with its class paths read as the reference's."""
    return text.replace("repro_torch.", "repro.")
