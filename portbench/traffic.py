"""The one traffic generator: it reads a mix's parameters from
``portbench/traffic/<mix>.json`` and makes the cell's inputs from the seed.

Serving traffic is a closed loop of waves: every request of a wave has the
wave's prompt length (the port's ``Server`` keeps one position for all
slots), and a wave is sent when the one before it has finished. Lengths are
drawn by strata: a distribution's ``n`` quantiles at ``(j + 0.5) / n``. A
wave's output lengths are the ``wave_size`` strata of the output
distribution, dealt to its requests in an order drawn from the seed; the
prompt lengths run through the ``strata`` strata of the prompt
distribution, a fresh order drawn from the seed for each pass, and the
serving window ends with a whole pass. So every seed gives the same sizes
in another order, and the amount of work in a window does not hang on the
seed; the token ids are uniform draws.

Training traffic is the port's synthetic language-model data; the program
makes its own batches (``repro_torch.data.pipeline``), and
:func:`train_batch` is this benchmark's frozen copy of ``make_batch``,
which the reference reads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List

import numpy as np


def strata(dist: Dict, n: int) -> List[int]:
    """The ``n`` quantiles at (j + 0.5) / n of ``dist`` ({"dist": "uniform"
    | "loguniform", "low", "high"}), rounded to whole numbers."""
    lo, hi = float(dist["low"]), float(dist["high"])
    out = []
    for j in range(n):
        u = (j + 0.5) / n
        if dist["dist"] == "uniform":
            x = lo + u * (hi - lo)
        elif dist["dist"] == "loguniform":
            x = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            raise ValueError(f"unknown distribution {dist['dist']!r}")
        out.append(int(round(x)))
    return out


@dataclass
class Wave:
    prompt_len: int
    prompts: np.ndarray          # [wave_size, prompt_len] int32
    max_new: List[int]           # tokens to serve, the prefill's included
    pass_end: bool = False       # the last wave of a pass over the strata


def prompt_lengths(mix: Dict) -> List[int]:
    return strata(mix["prompt_len"], mix["prompt_len"]["strata"])


def waves(mix: Dict, seed: int, vocab: int) -> Iterator[Wave]:
    """The waves of a serving mix, without end."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    lengths = prompt_lengths(mix)
    outs = strata(mix["output_len"], mix["wave_size"])
    while True:
        order = rng.permutation(len(lengths))
        for n, i in enumerate(order):
            L = lengths[i]
            prompts = rng.integers(0, vocab, (mix["wave_size"], L),
                                   dtype=np.int32)
            yield Wave(L, prompts, [outs[j] for j in
                                    rng.permutation(len(outs))],
                       pass_end=n == len(order) - 1)


def check_serve_mix(mix: Dict) -> None:
    """A mix the Server can serve exactly: every request of a wave in a
    slot at once, prompt and output inside the context."""
    if mix["wave_size"] > mix["slots"]:
        raise ValueError("a wave must fit the slots: the Server admits "
                         "while other slots are mid-flight otherwise, and "
                         "its shared position then serves them wrongly")
    longest = max(prompt_lengths(mix)) + max(
        strata(mix["output_len"], mix["wave_size"]))
    if longest > mix["ctx"]:
        raise ValueError(f"prompt and output of {longest} tokens past ctx "
                         f"{mix['ctx']}")


# --------------------------------------------------------------------------- #
# Training                                                                     #
# --------------------------------------------------------------------------- #
def train_batch(vocab: int, seq_len: int, global_batch: int, seed: int,
                step: int) -> Dict[str, np.ndarray]:
    """A frozen copy of ``repro_torch.data.pipeline.make_batch`` (without
    the encoder frames): a Zipf-ish unigram draw with an induced bigram
    chain, a pure function of (seed, step)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    B, S, V = global_batch, seq_len, vocab
    ranks = rng.zipf(1.3, size=(B, S + 1)).astype(np.int64)
    tokens = np.minimum(ranks, V - 1).astype(np.int32)
    a, c = 31, 17
    chain = (a * tokens[:, :-1] + c) % V
    mask = (np.arange(S) % 2 == 1)
    tokens[:, 1:][:, mask] = chain[:, mask].astype(np.int32)
    return {"tokens": tokens[:, :S], "labels": tokens[:, 1:S + 1]}
