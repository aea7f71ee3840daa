"""The yardstick's arithmetic against hand-computed values."""
import math

import pytest
import torch

from portbench import calls, counts, weights
from portbench.manifest import load_cell, load_manifest, port_config


@pytest.mark.parametrize("sq,skv,window", [
    (7, 7, None), (7, 7, 3), (1, 9, None), (1, 9, 4), (5, 12, None),
    (5, 12, 6), (40, 40, 32), (4, 4, 100)])
def test_causal_pairs_by_brute_force(sq, skv, window):
    want = 0
    for i in range(sq):
        pos = skv - sq + i
        want += sum(1 for j in range(skv)
                    if pos - j >= 0 and (window is None or pos - j < window))
    assert counts.causal_pairs(sq, skv, window) == want


def test_attention_counts_by_hand():
    # qwen3-4b's training attention: [4, 2048], 32 / 8 heads of 128, bf16
    pairs = 2048 * 2049 // 2
    assert counts.attention_flops(4, 32, 128, pairs) == 4 * 128 * 32 * 4 * \
        pairs
    assert counts.attention_bytes(batch=4, sq=2048, heads=32, kv_heads=8,
                                  hd=128, live_keys=2048, elem=2) == (
        2 * 4 * 2048 * 32 * 128 * 2 + 2 * 4 * 2048 * 8 * 128 * 2
        + 4 * (2048 + 2048))
    f = counts.attention_flops(4, 32, 128, pairs)
    assert counts.least_seconds(f, 0) == pytest.approx(f / 989e12)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_least_time_of_a_recorded_decode_call():
    # a ring of 6 slots, positions 10..15 after a wrap, one empty slot
    kpos = torch.tensor([12, 13, 14, 15, 10, -1], dtype=torch.int32)
    rec = {"kind": "fwd", "q": (2, 1, 4, 16), "k": (2, 6, 2, 16), "elem": 2,
           "causal": True, "window": 4,
           "qpos": torch.tensor([15], dtype=torch.int32), "kpos": kpos}
    pairs, live = 4, 4          # keys 12..15 within the window of 4
    want = counts.least_seconds(
        4 * 16 * 4 * 2 * pairs,
        2 * (2 * 1 * 4 * 16 * 2) + 2 * (2 * live * 2 * 16 * 2) + 4 * (1 + live))
    assert calls.attention_least_s(rec) == pytest.approx(want)


def test_qwen3_train_step_model_flops():
    """6.2e13 a step: 6 x 8,192 tokens x (807 M layer parameters + the
    389 M tied head), plus causal attention over 8 layers x 3."""
    cell = load_cell("qwen3-4b.train-2k", load_manifest())
    from repro_torch.models import Backbone
    bb = Backbone(port_config(cell.config), device="cpu")
    shapes = weights.leaf_shapes(bb.init(device="meta"))
    active = counts.active_params(shapes, 0, 0)
    per_layer = (2560 * 4096 + 2 * 2560 * 1024 + 4096 * 2560 + 2 * 128
                 + 3 * 2560 * 9728 + 2 * 2560)
    assert active == 8 * per_layer + 2560          # + the final norm
    flops = counts.model_flops(
        active, 2560, 151_936, tokens=8192, head_tokens=8192,
        attn_pairs=4 * 8 * (2048 * 2049 // 2), heads=32, hd=128, train=True)
    hand = (6 * 8192 * (active + 2560 * 151_936)
            + 3 * 4 * 128 * 32 * 4 * 8 * 2048 * 2049 / 2)
    assert flops == pytest.approx(hand)
    assert 6.1e13 < flops < 6.3e13


def test_mixtral_active_params_count_two_of_eight_experts():
    cell = load_cell("mixtral-8x22b.serve-long", load_manifest())
    from repro_torch.models import Backbone
    bb = Backbone(port_config(cell.config), device="cpu")
    shapes = weights.leaf_shapes(bb.init(device="meta"))
    active = counts.active_params(shapes, 2, 8)
    attn = 6144 * 6144 * 2 + 2 * 6144 * 1024
    experts = 2 * 3 * 6144 * 16384
    assert active == 6 * (attn + experts + 6144 * 8 + 2 * 6144) + 6144
    assert math.isclose(active / 1e9, 4.15, rel_tol=0.01)
