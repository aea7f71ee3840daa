"""Faults planted in the port under a run, to show that the check fails
them: each is a context manager that patches the program (never the
benchmark) and undoes the patch on exit. ``portbench/readings.py`` reads
them on the card at a cell's own size; ``tests/test_portbench_faults.py``
sees each one turn ``correct`` false on the CPU.

Training: ``state_unchanged`` (the step computes the loss but writes no
update), ``half_batch`` (the step sees the first half of the rows, its mean
taken over them), ``labels_shifted`` (the batch's first row's labels one
token off where the pipeline produces them). Serving:
``decode_state_unchanged`` (a decode step writes nothing into the cache:
its position and ring stay), ``token_altered`` (one decode step's first
slot gets another token).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def _train_step_fault(wrap):
    from repro_torch.runtime import train_loop

    def make(make_train_step):
        def patched(*args, **kwargs):
            return wrap(make_train_step(*args, **kwargs), *args)
        return patched
    return _patched(train_loop, "make_train_step", make)


def state_unchanged():
    from repro_torch.optim import adamw
    from repro_torch.runtime import steps

    def wrap(step, bb, *rest):
        def broken(state, batch):
            loss, grads = steps.value_and_grad(bb, state["params"], batch)
            return state, {"loss": loss,
                           "grad_norm": adamw.global_norm(grads)}
        return broken
    return _train_step_fault(wrap)


def half_batch():
    def wrap(step, *rest):
        def broken(state, batch):
            half = {k: v[: len(v) // 2] for k, v in batch.items()}
            return step(state, half)
        return broken
    return _train_step_fault(wrap)


def labels_shifted():
    def wrap(step, *rest):
        def broken(state, batch):
            labels = np.array(batch["labels"], copy=True)
            labels[0] = np.roll(labels[0], 1)
            return step(state, dict(batch, labels=labels))
        return broken
    return _train_step_fault(wrap)


def decode_state_unchanged():
    from repro_torch.models.backbone import Backbone

    def make(decode_step):
        def broken(self, params, cache, tokens):
            scratch = _copy(cache)
            logits, _ = decode_step(self, params, scratch, tokens)
            return logits, cache
        return broken
    return _patched(Backbone, "decode_step", make)


def token_altered(at_call: int = 3):
    from repro_torch.models.backbone import Backbone
    calls = [0]

    def make(decode_step):
        def broken(self, params, cache, tokens):
            logits, cache = decode_step(self, params, cache, tokens)
            calls[0] += 1
            if calls[0] == at_call:
                logits = logits.clone()
                vocab = self.cfg.vocab
                best = int(torch.argmax(logits[0, -1, :vocab]))
                logits[0, -1, (best + 1) % vocab] = logits[0, -1, best] + 1
            return logits, cache
        return broken
    return _patched(Backbone, "decode_step", make)


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch,
         "labels_shifted": labels_shifted}
SERVE = {"decode_state_unchanged": decode_state_unchanged,
         "token_altered": token_altered}
