"""Wrapper of the Hopper RG-LRU backward kernel, K2b (``csrc/rglru_bwd.cu``).

The reference writes no kernel for the RG-LRU's gradient: it takes
``jax.grad`` through ``src/repro/kernels/ref.py::rglru_scan_ref``. The port's
gradient is this kernel, reached from
:class:`repro_torch.models.rglru.RGLRUScan`. It runs chunk-parallel on
chunks of ``CHUNK`` steps: each chunk's map of the reverse recurrence (its
quarters of ``SUB`` steps composed), a carry over the chunks, a rescan of
every chunk at once, and da_log's sum in a fixed order. Its plain version is
:func:`repro_torch.kernels.ref.rglru_scan_bwd_plain`;
:func:`repro_torch.kernels.ref.rglru_scan_bwd_chunked_plain` repeats the
scheme; :mod:`repro_torch.kernels.ops` picks between kernel and plain version
by the tensors' device. The dispatch ledger counts a call once,
``rglru_bwd`` (:mod:`repro_torch.kernels.build`): four launches inside, the
chunk maps, the carry over the chunks, the rescan, and da_log's sum over the
batch rows and chunks.
"""
from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import Tuple

import torch

from . import build, rglru

# steps per chunk and per quarter of the maps pass: L and SUB of
# csrc/rglru_bwd.cu, which the wrapper checks when it binds the kernel
CHUNK = 32
SUB = 8

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# x, r, i, a_log, h0, y, dy, dh_T, dx, dr, di, da_log, dh0, maps, part; B,
# T, W, dtype, alog_dtype, vector; stream
_ARGS = [_ptr] * 15 + [_i32] * 6 + [_ptr]
_check_steps = partial(build.check_steps, "rglru_scan_bwd_steps",
                       (CHUNK, SUB))


def check_inputs(x: torch.Tensor, a_log: torch.Tensor, gate_r: torch.Tensor,
                 gate_i: torch.Tensor, h0: torch.Tensor, y: torch.Tensor,
                 dy: torch.Tensor, dh_T: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take: the forward's
    inputs as :func:`repro_torch.kernels.rglru.check_inputs` takes them, y
    and dy fp32 of x's shape, dh_T fp32 of h0's."""
    rglru.check_inputs(x, a_log, gate_r, gate_i, h0, None)
    for name, t, shape in (("y", y, x.shape), ("dy", dy, x.shape),
                           ("dh_T", dh_T, h0.shape)):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"float32 {tuple(shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on x's device")


def rglru_scan_bwd(x: torch.Tensor, a_log: torch.Tensor, gate_r: torch.Tensor,
                   gate_i: torch.Tensor, h0: torch.Tensor, y: torch.Tensor,
                   dy: torch.Tensor, dh_T: torch.Tensor
                   ) -> Tuple[torch.Tensor, ...]:
    """Launch K2b on CUDA tensors: (dx, da_log, dgate_r, dgate_i, dh0), each
    in its input's dtype. y is the forward's h sequence, dy and dh_T the
    cotangents of y and h_T."""
    check_inputs(x, a_log, gate_r, gate_i, h0, y, dy, dh_T)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan_bwd runs on CUDA tensors, not {x.device}")
    B, T, W = x.shape
    dx, dr, di = (torch.empty_like(t) for t in (x, gate_r, gate_i))
    da_log, dh0 = torch.empty_like(a_log), torch.empty_like(h0)
    n = math.ceil(T / CHUNK)
    # each chunk's map (P, then Q; the carry in is written over P) and its
    # sum of r a da
    maps = torch.empty((2, B, n, W), dtype=torch.float32, device=x.device)
    part = torch.empty((B, n, W), dtype=torch.float32, device=x.device)
    vector = (W * x.element_size() % 16 == 0
              and all(t.data_ptr() % 16 == 0
                      for t in (x, gate_r, gate_i, h0, y, dy)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dtypes = rglru._DTYPES
    with torch.cuda.device(x.device):
        rc = build.entry("rglru_scan_bwd", _ARGS, _check_steps)(
            x.data_ptr(), gate_r.data_ptr(), gate_i.data_ptr(),
            a_log.data_ptr(), h0.data_ptr(), y.data_ptr(), dy.data_ptr(),
            dh_T.data_ptr(), dx.data_ptr(), dr.data_ptr(), di.data_ptr(),
            da_log.data_ptr(), dh0.data_ptr(), maps.data_ptr(),
            part.data_ptr(), B, T, W, dtypes[x.dtype], dtypes[a_log.dtype],
            int(vector), stream)
    build.check_launch("rglru_bwd", rc)
    return dx, da_log, dr, di, dh0
