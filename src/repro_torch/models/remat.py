"""Selective recomputation: the reference's ``remat_policy="dots"``.

``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` saves the
output of every ``dot_general`` without batch dimensions that the backward
reads, and recomputes everything else. In the port a product with a 2-D
weight (``x @ W``, whatever the rank of ``x``) reaches ``aten.mm`` (or
``addmm``); a product with batch dimensions (attention's, the MoE experts'
``torch.bmm``, the RG-LRU gates' ``einsum``) reaches ``aten.bmm``.
:func:`context` is the ``context_fn`` of ``torch.utils.checkpoint`` that
does the same through selective activation checkpointing (SAC): the forward
caches the output of each such ``mm`` and the recompute takes it from the
cache, running every other op again.

One rule keeps SAC's cache to the reference's saved set: a layer's last
product, whose output only the residual add that ends the layer reads (the
FFN's down projection in the last sublayer), is not saved. No backward reads
it, and with early stop the recompute stops before it, so a cached copy
would only be held until the backward. The backbone runs its last sublayer
under :func:`last_sublayer`, the FFN its down projection under
:func:`residual_product`; a product under both is recomputed.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

POLICIES = ("full", "dots")

_SAVED = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_LOCAL = threading.local()


@contextlib.contextmanager
def _flag(name: str):
    before = getattr(_LOCAL, name, False)
    setattr(_LOCAL, name, True)
    try:
        yield
    finally:
        setattr(_LOCAL, name, before)


def last_sublayer():
    """The last sublayer of a checkpointed layer runs under this."""
    return _flag("last")


def residual_product():
    """A sublayer's output product, which only its residual add reads."""
    return _flag("out")


def _dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if op in _SAVED and not (getattr(_LOCAL, "last", False)
                             and getattr(_LOCAL, "out", False)):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def context():
    """``checkpoint(..., context_fn=context)``: SAC under the "dots"
    rule."""
    return create_selective_checkpoint_contexts(_dots)
