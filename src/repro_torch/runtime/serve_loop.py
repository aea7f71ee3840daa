"""Serving runtime: synchronised batched decode with slot-based admission.

The port of ``repro.runtime.serve_loop``: a fixed number of decode *slots*
share one decode step; a finished sequence frees its slot and a queued
request is admitted by a batch-1 prefill merged into that slot of the cache.

Its semantics are the reference's, kept exactly, limitation included:
``cache["pos"]`` is one position shared by all slots, and :func:`_merge_slot`
takes ``pos`` and ``kpos`` from the newly admitted request, so an admission
while other slots are mid-flight resets the position and the valid-key mask
of every slot (ROADMAP.md records this). Requests of equal prompt length
admitted together are served exactly.

Each step reads the argmaxed tokens to the host once (one ``.tolist()``).
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.backbone import Backbone


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    out: List[int] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)


class Server:
    def __init__(self, bb: Backbone, params, *, slots: int = 4,
                 ctx: int = 256):
        self.bb = bb
        self.params = params
        self.slots = slots
        self.ctx = ctx
        self._queue: "queue.Queue[Request]" = queue.Queue()
        self.stats = {"steps": 0, "tokens": 0, "admitted": 0}
        # host seconds in prefill and decode; each ends in a read of tokens
        # to the host, so the device work is inside them
        self.timing = {"prefill_s": 0.0, "decode_s": 0.0}

    def submit(self, req: Request) -> None:
        self._queue.put(req)

    # ------------------------------------------------------------------ #
    def run(self, max_steps: int = 10_000) -> None:
        """Drive the batch loop until the queue drains (synchronous API)."""
        bb, dev = self.bb, self.bb.device
        vocab = bb.cfg.vocab
        active: List[Optional[Request]] = [None] * self.slots
        cache = None
        next_tok = torch.zeros((self.slots, 1), dtype=torch.int32, device=dev)

        def admit() -> None:
            nonlocal cache
            for i in range(self.slots):
                if active[i] is not None:
                    continue
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                # per-request prefill in a batch-1 slice, then merge caches
                t0 = time.perf_counter()
                tokens = torch.as_tensor(req.prompt[None, :], device=dev)
                logits, c1 = bb.prefill(self.params, {"tokens": tokens},
                                        self.ctx)
                tok = int(torch.argmax(logits[0, -1, :vocab]))
                self.timing["prefill_s"] += time.perf_counter() - t0
                req.out.append(tok)
                if cache is None:
                    cache = bb.init_cache(self.slots, self.ctx)
                _merge_slot(cache, c1, i)
                next_tok[i, 0] = tok
                active[i] = req
                self.stats["admitted"] += 1

        for _ in range(max_steps):
            admit()
            if all(a is None for a in active):
                if self._queue.empty():
                    return
                continue
            t0 = time.perf_counter()
            logits, cache = bb.decode_step(self.params, cache, next_tok)
            toks = torch.argmax(logits[:, -1, :vocab], dim=-1)
            host_toks = toks.tolist()
            self.timing["decode_s"] += time.perf_counter() - t0
            self.stats["steps"] += 1
            for i, req in enumerate(active):
                if req is None:
                    continue
                req.out.append(host_toks[i])
                self.stats["tokens"] += 1
                if len(req.out) >= req.max_new:
                    req.done.set()
                    active[i] = None
            next_tok = toks[:, None].to(torch.int32)


def _merge_slot(cache, one, i: int):
    """Copy the batch-1 cache ``one`` into slot ``i`` of the batched cache,
    in place. Leaves that are not batch-major (``pos``, ``kpos``) are taken
    from ``one`` whole, as the reference takes them."""
    for key, dst in cache.items():
        src = one[key]
        if isinstance(dst, dict):
            _merge_slot(dst, src, i)
        elif (isinstance(dst, torch.Tensor) and dst.ndim >= 2
              and dst.ndim == src.ndim and src.shape[0] == dst.shape[0]
              and dst.shape[2:] == src.shape[2:] and src.shape[1] == 1
              and dst.shape[1] > 1):
            dst[:, i] = src[:, 0]
        else:
            cache[key] = src  # scalars (pos) and shared leaves (kpos)
    return cache
