"""Move parameter and cache trees between numpy and the port.

The JAX package's trees (nested dicts; ``jax.tree_util.tree_map(np.asarray,
tree)`` turns them into numpy) and the port's have identical keys, shapes
and layouts, so each direction is a copy with no transpose. This is how the
parity tests graft one JAX init into both packages: ``jax.random`` and
``torch.Generator`` never agree.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _to_tensor(a, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits as torch's
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16; fp32 holds it exactly
        t = t.float()
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any], *, device,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dicts of arrays -> the same tree of tensors on ``device``;
    floating leaves are cast to ``dtype`` when one is given."""
    return {k: params_from_numpy(v, device=device, dtype=dtype)
            if isinstance(v, dict) else _to_tensor(v, device, dtype)
            for k, v in tree.items()}


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree of tensors -> the same tree of numpy arrays (bf16
    leaves as fp32)."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else _to_numpy(v)
            for k, v in tree.items()}


def cache_from_numpy(tree: Dict[str, Any], *, device,
                     dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """A decode cache: as :func:`params_from_numpy`, with the scalar
    ``pos`` as a Python int, as the port keeps it."""
    out = params_from_numpy({k: v for k, v in tree.items() if k != "pos"},
                            device=device, dtype=dtype)
    out["pos"] = int(tree["pos"])
    return out


def cache_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A decode cache -> numpy, with ``pos`` as an int32 scalar array, as the
    JAX package keeps it."""
    out = params_to_numpy({k: v for k, v in tree.items() if k != "pos"})
    out["pos"] = np.asarray(tree["pos"], np.int32)
    return out
