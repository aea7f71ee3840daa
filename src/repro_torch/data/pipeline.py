"""Deterministic sharded token pipeline.

Synthetic LM data with a Zipf-ish unigram distribution plus induced bigram
structure (so a model can actually reduce loss), generated as a pure
function of ``(seed, step)`` — the pipeline is *stateless*, which makes
checkpoint/restart and elastic rescaling exact: the data cursor in the
transactional store is just the step counter, and any reshaped cluster can
regenerate precisely the batches it owes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    enc_seq: int = 0          # >0 for enc-dec models (whisper stub frames)
    enc_dim: int = 0


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step]))


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Pure function of (config, step) -> one global batch."""
    rng = _batch_rng(cfg, step)
    B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab
    # Zipf-ish unigram draw, then overwrite with structure: even positions
    # seed a bigram chain t[i+1] = (a*t[i] + c) % V so loss can fall.
    ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
    tokens = np.minimum(ranks, V - 1).astype(np.int32)
    a, c = 31, 17
    chain = (a * tokens[:, :-1] + c) % V
    mask = (np.arange(S) % 2 == 1)
    tokens[:, 1:][:, mask] = chain[:, mask].astype(np.int32)
    batch = {"tokens": tokens[:, :S],
             "labels": tokens[:, 1:S + 1]}
    if cfg.enc_seq:
        batch["enc_frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.enc_dim), dtype=np.float32)
    return batch


class Pipeline:
    """Iterator facade with an explicit, restorable cursor."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(self.cfg, self.step)
        self.step += 1
        return batch

    def restore(self, step: int) -> None:
        self.step = step
