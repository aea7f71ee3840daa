"""Wrapper of the Hopper WKV backward kernel, K3b (``csrc/wkv6_bwd.cu``).

The reference writes no kernel for the WKV's gradient: it takes ``jax.grad``
through ``src/repro/kernels/ref.py::rwkv6_scan_ref``. The port's gradient is
this kernel, reached from :class:`repro_torch.models.rwkv6.WKVScan`. It runs
chunk-parallel on the chunks of ``CHUNK`` steps of K3's chunked body: the
state before each chunk (K3's chunk summaries and carry) and the cotangent
after each (the same two passes on r and dy, last chunk first) on the tensor
cores, each in a scratch buffer of ``[B, H, ceil(T / CHUNK), 64, 64]`` fp32;
then every chunk's reverse walk at once (the states recomputed forward from
the chunk's, never by dividing by a decay). Its
plain version is :func:`repro_torch.kernels.ref.rwkv6_scan_bwd_plain`;
:func:`repro_torch.kernels.ref.rwkv6_scan_bwd_chunked_plain` repeats the
scheme; :mod:`repro_torch.kernels.ops` picks between kernel and plain version
by the tensors' device. The dispatch ledger counts a call once,
``wkv6_bwd`` (:mod:`repro_torch.kernels.build`): six launches inside, the
chunk states (K3's summary and carry), the chunk cotangents (their summary
and the reverse carry), the chunks' reverse walk, and du's sum over the
batch rows and chunks.
"""
from __future__ import annotations

import ctypes
import math
from functools import partial
from typing import Optional, Tuple

import torch

from . import build, rwkv6

# steps per chunk and per sub-chunk: L and SUB of csrc/wkv6_bwd.cu (K3's
# chunk, rwkv6.CHUNK and rwkv6.SUB), which the wrapper checks when it binds
# the kernel
CHUNK = 64
SUB = 16

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
# r, k, v, w, u, state, dy, ds_T, dr, dk, dv, dw, du, ds0, starts, ends,
# decay, du_part; B, T, H, hd, dtype, u_dtype, vec; stream
_ARGS = [_ptr] * 18 + [_i32] * 7 + [_ptr]
_check_steps = partial(build.check_steps, "wkv6_scan_bwd_steps",
                       (CHUNK, SUB))


def check_inputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 dy: torch.Tensor, ds_T: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take: the forward's
    inputs as :func:`repro_torch.kernels.rwkv6.check_inputs` takes them, dy
    fp32 of r's shape, ds_T fp32 of the state's."""
    rwkv6.check_inputs(r, k, v, w, u, state, None)
    for name, t, shape in (("dy", dy, r.shape), ("ds_T", ds_T, state.shape)):
        if t.shape != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"float32 {tuple(shape)}")
        if t.device != r.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, on r's device")


def scratch(B: int, T: int, H: int, hd: int, device) -> dict:
    """The kernel's scratch buffers for r [B,T,H,hd]: ``starts`` (the state
    before each chunk) and ``ends`` (the cotangent after each), each
    [B, H, ceil(T / CHUNK), 64, 64] fp32, ``decay`` [B, H, ceil(T / CHUNK),
    64] and ``du_part`` [B, H, ceil(T / CHUNK), hd]."""
    n, m = math.ceil(T / CHUNK), rwkv6.MAX_HEAD_DIM
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=device)
    return {"starts": empty(B, H, n, m, m), "ends": empty(B, H, n, m, m),
            "decay": empty(B, H, n, m), "du_part": empty(B, H, n, hd)}


def wkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                  dy: torch.Tensor, ds_T: torch.Tensor, *,
                  scratch_out: Optional[dict] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """Launch K3b on CUDA tensors: (dr, dk, dv, dw, du, ds0), each in its
    input's dtype. dy and ds_T are the cotangents of y and S_T. The scratch
    comes from :func:`scratch`; ``scratch_out`` takes a dict of those
    buffers to use instead (a test reads the chunk states back)."""
    check_inputs(r, k, v, w, u, state, dy, ds_T)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_scan_bwd runs on CUDA tensors, not {r.device}")
    B, T, H, hd = r.shape
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du, ds0 = torch.empty_like(u), torch.empty_like(state)
    sc = scratch(B, T, H, hd, r.device) if scratch_out is None else scratch_out
    stream = torch.cuda.current_stream(r.device).cuda_stream
    dtypes = rwkv6._DTYPES
    vec = hd % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in (r, k, v, w, dy))
    with torch.cuda.device(r.device):
        rc = build.entry("wkv6_scan_bwd", _ARGS, _check_steps)(
            *(t.data_ptr() for t in (r, k, v, w, u, state, dy, ds_T, dr, dk,
                                     dv, dw, du, ds0, sc["starts"],
                                     sc["ends"], sc["decay"], sc["du_part"])),
            B, T, H, hd, dtypes[r.dtype], dtypes[u.dtype], int(vec), stream)
    build.check_launch("wkv6_bwd", rc)
    return dr, dk, dv, dw, du, ds0
