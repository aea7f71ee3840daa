"""The generator: waves of one prompt length, the same sizes for every seed
in another order, the same draws for the same seed; the frozen copy of the
port's training data."""
import itertools

import numpy as np
import pytest

from portbench import manifest, traffic
from portbench.manifest import HERE

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))


def _mix(name):
    return manifest._json("traffic", name)


SERVE_MIXES = [m for m in MIXES if _mix(m)["kind"] == "serve"]


def test_strata_are_quantiles():
    assert traffic.strata({"dist": "uniform", "low": 0, "high": 10}, 5) == \
        [1, 3, 5, 7, 9]
    lo = traffic.strata({"dist": "loguniform", "low": 16, "high": 64}, 2)
    assert lo == [round(16 * 4 ** 0.25), round(16 * 4 ** 0.75)]


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_waves_hold_one_prompt_length(name):
    mix = _mix(name)
    traffic.check_serve_mix(mix)
    for w in itertools.islice(traffic.waves(mix, 7, 1000), 12):
        assert w.prompts.shape == (mix["wave_size"], w.prompt_len)
        assert w.prompts.dtype == np.int32
        assert len(w.max_new) == mix["wave_size"]
        assert w.prompts.min() >= 0 and w.prompts.max() < 1000


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_same_seed_same_draws_other_seed_same_sizes(name):
    mix = _mix(name)
    n = mix["prompt_len"]["strata"]
    seed = 2 ** 31 + 99
    a = list(itertools.islice(traffic.waves(mix, seed, 500), 2 * n))
    b = list(itertools.islice(traffic.waves(mix, seed, 500), 2 * n))
    c = list(itertools.islice(traffic.waves(mix, seed + 1, 500), 2 * n))
    for x, y in zip(a, b):
        assert x.prompt_len == y.prompt_len and x.max_new == y.max_new
        assert np.array_equal(x.prompts, y.prompts)
    # each pass over the strata holds every prompt length once, and every
    # wave the same output lengths, whatever the seed
    for ws in (a, c):
        for k in range(2):
            lens = sorted(w.prompt_len for w in ws[k * n:(k + 1) * n])
            assert lens == sorted(traffic.prompt_lengths(mix))
        for w in ws:
            assert sorted(w.max_new) == sorted(traffic.strata(
                mix["output_len"], mix["wave_size"]))
    assert [w.prompt_len for w in a] != [w.prompt_len for w in c] or \
        [w.max_new for w in a] != [w.max_new for w in c]


def test_mix_that_cannot_be_served_exactly_is_refused():
    mix = dict(_mix(SERVE_MIXES[0]))
    with pytest.raises(ValueError, match="slots"):
        traffic.check_serve_mix(dict(mix, wave_size=mix["slots"] + 1))
    with pytest.raises(ValueError, match="ctx"):
        traffic.check_serve_mix(dict(mix, ctx=64))


@pytest.mark.parametrize("seed,step", [(0, 0), (2 ** 31 + 5, 3)])
def test_train_batch_is_the_ports_make_batch(seed, step):
    from repro_torch.data.pipeline import DataConfig, make_batch
    want = make_batch(DataConfig(vocab=151_936, seq_len=64, global_batch=3,
                                 seed=seed), step)
    got = traffic.train_batch(151_936, 64, 3, seed, step)
    assert set(got) == set(want)
    for k in got:
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_each_pass_ends_on_its_last_wave(name):
    mix = _mix(name)
    n = mix["prompt_len"]["strata"]
    ws = list(itertools.islice(traffic.waves(mix, 2 ** 33 + 1, 100), 3 * n))
    assert [w.pass_end for w in ws] == ([False] * (n - 1) + [True]) * 3


def test_serving_window_ends_with_a_whole_pass():
    """A zero-second window serves every wave of the first pass, and
    without ``whole_passes`` one wave."""
    from portbench.drivers import serve
    from portbench.tests import tiny
    cell = tiny.cell("mixtral-8x22b.serve-long")
    cell.mix = dict(cell.mix, prompt_len={"dist": "uniform", "low": 24,
                                          "high": 40, "strata": 2})
    for whole, waves in ((True, 2), (False, 1)):
        ctx = serve.setup(cell, tiny.SEED, "cpu")
        record = serve.window(ctx, 0.0, False, whole_passes=whole)
        assert len(record["served"]) == waves * cell.mix["wave_size"]
        assert len({p for p, _ in record["served"]}) == waves
