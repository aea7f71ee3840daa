"""Per-device cost of a step, counted as it runs (the port of
``repro.launch.hlocost``, which reads XLA's partitioned HLO text).

:class:`CostCounter` is a ``TorchDispatchMode`` entered around one step on
the dry run's fake mesh (``launch.dryrun``), where every tensor is ``meta``:

* **FLOPs** — the matmul family's, by ``torch.utils.flop_counter``'s
  formulas, plus the hand-written kernels' operations, which their shape
  functions charge (``kernels.ops.SINKS``). Elementwise FLOPs are ignored,
  as in the reference. The count is per device: a DTensor op is handed on
  to DTensor (the mode returns NotImplemented for it) and only the local
  ops it runs on the rank's shards are counted; the ops that DTensor's
  sharding propagation runs on fake tensors of the global shapes are not.
  (``FlopCounterMode`` around DTensor code counts both.)
* **Bytes** — each aten op's operands and outputs, views and allocations
  left out: eager, unfused traffic. It is an upper bound of the step's
  memory traffic, not the reference's fusion-aware count.
* **Collective bytes** — the output bytes of every ``c10d_functional``
  collective that a DTensor redistribute issues, by kind (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``). ``in_loop_*`` count
  those issued inside a layer (the backbone's ``layer_scope``, entered
  through :meth:`CostCounter.in_layer`), forward or backward: the
  early-release signature, which the reference finds in the scan body. A
  backward collective is inside a layer when the autograd node that issues
  it was made inside one.
* **Memory** — the bytes of the local storages made under the counter and
  still alive, and their peak. An op's output on an input's storage (an
  in-place op, a donated argument written) allocates nothing.

``CostTotals`` keeps the reference's fields and ``to_json`` keys, so the
results read the same.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import ops

COLLECTIVE_NAMES = {"all_reduce": "all-reduce",
                    "all_gather_into_tensor": "all-gather",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all",
                    "shard_dim_alltoall": "all-to-all"}
# ops that move no bytes of their own
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "lift_fresh",
               "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd"}


@dataclass
class CostTotals:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_count: float = 0.0
    coll_by_op: Dict[str, float] = field(default_factory=dict)
    coll_by_op_count: Dict[str, float] = field(default_factory=dict)
    in_loop_bytes: float = 0.0
    in_loop_count: float = 0.0
    unknown_custom_calls: List[str] = field(default_factory=list)
    kernel_flops: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collective_count": self.collective_count,
            "coll_by_op": self.coll_by_op,
            "coll_by_op_count": self.coll_by_op_count,
            "in_loop_bytes": self.in_loop_bytes,
            "in_loop_count": self.in_loop_count,
            "unknown_custom_calls": sorted(set(self.unknown_custom_calls)),
            "kernel_flops": self.kernel_flops,
        }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and live memory of the
    code run under it (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}        # storage id -> bytes
        self._depth = 0
        # per thread, the autograd sequence numbers made inside a layer
        self._ranges: Dict[int, List[Tuple[int, int]]] = {}

    # ---- the kernels' shape functions charge here ------------------------
    def _charge(self, name: str, flops: float, nbytes: float) -> None:
        self.totals.flops += flops
        self.totals.bytes += nbytes
        kf = self.totals.kernel_flops
        kf[name] = kf.get(name, 0.0) + flops

    def __enter__(self):
        ops.SINKS.append(self._charge)
        return super().__enter__()

    def __exit__(self, *exc):
        ops.SINKS.remove(self._charge)
        return super().__exit__(*exc)

    # ---- layers ------------------------------------------------------------
    @staticmethod
    def _sequence_nr() -> int:
        """The autograd sequence number the next node of this thread
        takes (made by a throwaway node, outside the mode)."""
        with torch._C._DisableTorchDispatch(), torch.enable_grad():
            probe = torch.zeros((), requires_grad=True).mul(1)
        return probe.grad_fn._sequence_nr() + 1

    @contextlib.contextmanager
    def in_layer(self):
        """The backbone's ``layer_scope``: the collectives issued inside,
        and in the backward of the nodes made inside, are in the layer."""
        lo = self._sequence_nr()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self._ranges.setdefault(threading.get_ident(), []).append(
                (lo, self._sequence_nr()))

    def _inside_layer(self) -> bool:
        if self._depth > 0:
            return True
        node = torch._C._current_autograd_node()
        if node is None:
            return False
        seq = node._sequence_nr()
        return any(lo <= seq < hi for ranges in self._ranges.values()
                   for lo, hi in ranges)

    # ---- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._seen.pop(key, 0)

    # ---- the ops -----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            # DTensor runs it on the local shards, which come back here
            return NotImplemented
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if any(isinstance(a, FakeTensor) for a in flat + outs):
            return out      # DTensor's sharding propagation, global shapes
        ins = [t for t in flat if isinstance(t, torch.Tensor)]
        name = func._overloadpacket.__name__
        ns = func.namespace
        tot = self.totals
        if ns in ("_c10d_functional", "c10d_functional", "_dtensor"):
            kind = COLLECTIVE_NAMES.get(name)
            if kind is not None:
                nbytes = float(sum(_nbytes(t) for t in outs))
                tot.collective_bytes += nbytes
                tot.collective_count += 1
                tot.coll_by_op[kind] = tot.coll_by_op.get(kind, 0.0) + nbytes
                tot.coll_by_op_count[kind] = tot.coll_by_op_count.get(
                    kind, 0.0) + 1
                if self._inside_layer():
                    tot.in_loop_bytes += nbytes
                    tot.in_loop_count += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            tot.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and name not in _NO_TRAFFIC:
            tot.bytes += float(sum(_nbytes(t) for t in ins + outs))
        if not func.is_view:
            held = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                if id(t.untyped_storage()) not in held:
                    self._track(t)
        return out
