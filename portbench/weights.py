"""Weights made by the benchmark, on the device, from ``--seed``.

The shapes are the ones the port declares (``Backbone.init(device="meta")``)
and the tree is the port's; the values are the benchmark's own, one
``torch.Generator`` call per leaf (a group's layers are one stacked leaf),
in the type the cell holds them in. Each leaf has a generator of its own,
seeded from (seed, the leaf's index), so that any leaf can be made again
alone: the reference and the training check remake the initial weights
leaf by leaf instead of keeping a copy.

Scales: a vector of a layer (a norm's scale, used as ``1 + scale``) 0.1; a
matrix ``[..., fan_in, fan_out]`` ``fan_in ** -0.5``; the embedding table
``d_model ** -0.5``, so that a tied head's logits have a spread near 1.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def flatten(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) of nested dicts in key order, paths joined by "/"."""
    for key, sub in tree.items():
        path = f"{prefix}{key}"
        if isinstance(sub, dict):
            yield from flatten(sub, path + "/")
        else:
            yield path, sub


def leaf_shapes(meta_tree) -> Dict[str, Tuple[int, ...]]:
    return {path: tuple(leaf.shape) for path, leaf in flatten(meta_tree)}


def _std(path: str, shape: Tuple[int, ...], d_model: int) -> float:
    if path == "embed/tok":
        return d_model ** -0.5
    stacked = path.startswith("g")      # g{i}/s{j}/<leaf>: [layers, ...]
    per_layer = shape[1:] if stacked else shape
    if len(per_layer) <= 1:
        return 0.1
    return shape[-2] ** -0.5


def _generator(seed: int, index: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & ((1 << 63) - 1))
    return gen


def make_leaf(path: str, index: int, shape, seed: int, dtype, device,
              d_model: int) -> torch.Tensor:
    gen = _generator(seed, index, device)
    x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return x.mul_(_std(path, shape, d_model))


def make(meta_tree, seed: int, dtype, device, d_model: int):
    """A tree of ``meta_tree``'s structure and shapes, made from ``seed``."""
    def build(tree, prefix, counter):
        out = {}
        for key, sub in tree.items():
            path = f"{prefix}{key}"
            if isinstance(sub, dict):
                out[key] = build(sub, path + "/", counter)
            else:
                out[key] = make_leaf(path, counter[0], tuple(sub.shape), seed,
                                     dtype, device, d_model)
                counter[0] += 1
        return out
    return build(meta_tree, "", [0])


def remake(meta_tree, seed: int, dtype, device, d_model: int
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) of :func:`make`'s tree one at a time, each made again."""
    for index, (path, leaf) in enumerate(flatten(meta_tree)):
        yield path, make_leaf(path, index, tuple(leaf.shape), seed, dtype,
                              device, d_model)


def get(tree, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree
