"""Versioned sharded checkpoint store.

Layout::

    <dir>/step_<N>/manifest.json       # leaf paths, shapes, dtypes, version
    <dir>/step_<N>/<leaf-hash>.npy     # one array per pytree leaf
    <dir>/LATEST                       # atomic pointer (rename-committed)

Writes are crash-safe: the step directory is written under a temp name and
atomically renamed, then LATEST is updated by rename — a torn write can
never be observed, mirroring the "no object observed mid-transaction"
guarantee the control plane gives in-process. Save runs inside an
*irrevocable read-only* OptSVA-CF transaction when coordinated through
``repro_torch.txstore`` (file I/O must never be re-executed; paper §2.4).

The port of ``repro.checkpoint.store``, with the same files: leaves in
``jax.tree_util`` order (dict keys sorted), each named by the sha1 of its
"/"-joined key path, the same manifest. A bf16 leaf is written as the JAX
package writes an ml_dtypes bfloat16 array, whose ``.npy`` header says
``'<V2'`` and whose manifest dtype says ``"bfloat16"``; it is read back as
those bits. Leaves may be tensors (on any device) or numpy arrays; restore
returns tensors on the device asked for.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch.shardings import tree_distribute

Params = Any


def _leaves_with_path(tree: Params, path: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of nested dicts in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in _leaves_with_path(tree[key], path + (key,))]
    return [(path, tree)]


def _leaf_key(path: Tuple[str, ...]) -> str:
    return "/".join(path)


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(array to write, manifest dtype string) of one leaf; a DTensor's
    full value."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    # the bytes np.save writes for an ml_dtypes bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def _load_tensor(path: Path, meta: Dict[str, Any], device) -> torch.Tensor:
    arr = np.load(path)
    if list(arr.shape) != meta["shape"]:
        raise ValueError(f"{path}: shape {list(arr.shape)}, manifest says "
                         f"{meta['shape']}")
    arr = np.array(arr, order="C")  # a copy, 0-d arrays kept 0-d
    if meta["dtype"] == "bfloat16":  # stored as 2-byte voids: the bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(arr).to(device)


def _unflatten(template: Params, values: Dict[str, Any],
               path: Tuple[str, ...] = ()) -> Params:
    if isinstance(template, dict):
        return {key: _unflatten(template[key], values, path + (key,))
                for key in template}
    return values[_leaf_key(path)]


class CheckpointStore:
    def __init__(self, directory: str):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ #
    def save(self, tree: Params, step: int) -> str:
        leaves = _leaves_with_path(tree)
        tmp = Path(tempfile.mkdtemp(dir=self.dir, prefix=f".tmp_step_{step}_"))
        manifest: Dict[str, Any] = {"step": step, "leaves": {}}
        try:
            for path, leaf in leaves:
                key = _leaf_key(path)
                fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
                arr, dtype = _host_array(leaf)
                _save_npy(tmp / fname, arr, dtype)
                manifest["leaves"][key] = {
                    "file": fname, "shape": list(arr.shape), "dtype": dtype}
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic commit
            self._set_latest(step)
            return str(final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _set_latest(self, step: int) -> None:
        ptr = self.dir / "LATEST"
        tmp = self.dir / ".LATEST.tmp"
        tmp.write_text(str(step))
        os.rename(tmp, ptr)                            # atomic pointer swap

    # ------------------------------------------------------------------ #
    def latest_step(self) -> Optional[int]:
        ptr = self.dir / "LATEST"
        if not ptr.exists():
            return None
        step = int(ptr.read_text().strip())
        if not (self.dir / f"step_{step}" / "manifest.json").exists():
            return None  # torn directory (crash between renames): ignore
        return step

    def restore(self, template: Params, step: Optional[int] = None, *,
                device: Union[str, torch.device] = "cpu",
                shardings: Optional[Params] = None) -> Tuple[Params, int]:
        """Load into the template's tree structure (its leaves are not read:
        meta tensors will do), as tensors on ``device``; with ``shardings``
        (a tree like the template's of ``launch.shardings.NamedSharding``:
        an elastic restore onto a mesh) each full tensor is then placed on
        its mesh, every rank loading the same file."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint available")
        d = self.dir / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        values = {}
        for path, _ in _leaves_with_path(template):
            key = _leaf_key(path)
            meta = manifest["leaves"][key]
            values[key] = _load_tensor(d / meta["file"], meta, device)
        tree = _unflatten(template, values)
        if shardings is not None:
            tree = tree_distribute(tree, shardings)
        return tree, step

    def gc(self, keep: int = 3) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        for s in steps[:-keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)


class AsyncCheckpointer:
    """Background checkpoint writer fed by transactional snapshots.

    ``submit`` is called with an already-consistent snapshot (taken by the
    txstore's irrevocable read-only transaction); the file I/O happens on
    this thread so the trainer never blocks on disk.
    """

    def __init__(self, store: CheckpointStore,
                 on_done: Optional[Callable[[int, str], None]] = None):
        self.store = store
        self.on_done = on_done
        self._lock = threading.Lock()
        self._pending: Optional[Tuple[Params, int]] = None
        self._busy = False                 # a save is in flight on the thread
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._idle = threading.Condition(self._lock)
        self.saved: List[int] = []
        self.errors: List[str] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="async-ckpt")
        self._thread.start()

    def submit(self, tree: Params, step: int) -> None:
        with self._lock:
            self._pending = (tree, step)   # newest wins; older snap dropped
        self._wake.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            with self._lock:
                job, self._pending = self._pending, None
                self._busy = job is not None
            if job is None:
                continue
            tree, step = job
            try:
                path = self.store.save(tree, step)
                self.saved.append(step)
                if self.on_done:
                    self.on_done(step, path)
            except BaseException as e:  # noqa: BLE001
                self.errors.append(repr(e))
            finally:
                with self._lock:
                    self._busy = False
                    self._idle.notify_all()

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every submitted snapshot is fully on disk — i.e. no
        job is pending AND no save is in flight (a drain that returns while
        the last save is mid-write lets callers observe the previous
        LATEST pointer)."""
        self._wake.set()
        with self._lock:
            self._idle.wait_for(
                lambda: self._pending is None and not self._busy,
                timeout=timeout)

    def stop(self) -> None:
        self.drain()
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10.0)
