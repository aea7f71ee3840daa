"""The readers of the per-layer metrics that the program measures itself:
the Server's ``timing`` (``server_first_gap_ms``, ``server_decode_host_ms``)
and the Trainer's ``registry("train")`` histograms (``trainer_gap_ms``,
``trainer_data_ms``, ``txstore_commit_ms``), on hand-made records, and in
the traced line of a tiny run of each cell."""
import pytest

from portbench.manifest import load_manifest, metric_reader
from portbench.tests import tiny

SERVE = ("server_first_gap_ms", "server_decode_host_ms")
TRAIN = ("trainer_gap_ms", "trainer_data_ms", "txstore_commit_ms")
HISTS = dict(zip(TRAIN, ("gap_us", "data_us", "commit_us")))


@pytest.fixture
def train_registry():
    from repro_torch.obs import metrics
    reg = metrics.registry("train")
    reg.reset()
    yield reg
    reg.reset()


def _serve_record(**timing):
    return {"kind": "serve", "stats": {"steps": 4, "tokens": 9,
                                       "admitted": 3},
            "served": [(40, 5), (40, 1), (40, 3)],
            "timing": {"prefill_s": 0.3, "decode_s": 0.2, **timing}}


def test_first_gap_is_the_mean_over_requests_with_a_second_token():
    read = metric_reader("server_first_gap_ms")
    # two of the three served requests have a second token
    assert read(_serve_record(first_gap_s=0.5, decode_read_s=0.05)) == \
        pytest.approx(250.0)
    assert read(_serve_record()) is None            # a Server without it
    rec = _serve_record(first_gap_s=0.0)
    rec["served"] = [(40, 1)]
    assert read(rec) is None


def test_decode_host_is_the_step_less_its_read():
    read = metric_reader("server_decode_host_ms")
    assert read(_serve_record(decode_read_s=0.12, first_gap_s=0.0)) == \
        pytest.approx((0.2 - 0.12) / 4 * 1e3)
    assert read(_serve_record()) is None
    rec = _serve_record(decode_read_s=0.0)
    rec["stats"]["steps"] = 0
    assert read(rec) is None


@pytest.mark.parametrize("name", TRAIN)
def test_trainer_metric_is_the_median_of_its_histogram(name, train_registry):
    read = metric_reader(name)
    assert read({"kind": "train"}) is None           # nothing recorded
    h = train_registry.histogram(HISTS[name])
    for us in (900, 4000, 4100, 4200, 90_000):
        h.record(us)
    # the log-linear bucket of the median, 4096-4351 us, by its lower bound
    assert read({"kind": "train"}) == 4.096
    assert read({"kind": "serve"}) is None


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_reader_of_the_other_kind_of_cell_reads_none(name, train_registry):
    train_registry.histogram("gap_us").record(10)
    other = {"kind": "train"} if name in SERVE else _serve_record(
        first_gap_s=1.0, decode_read_s=0.1)
    assert metric_reader(name)(other) is None


def test_manifest_lists_each_in_its_one_cell():
    layer = {m["name"]: m for m in load_manifest()["per_layer"]}
    for name in SERVE:
        assert layer[name]["workloads"] == ["mixtral-8x22b.serve-long"]
        assert layer[name]["source"] == "program_span"
    for name in TRAIN:
        assert layer[name]["workloads"] == ["qwen3-4b.train-2k"]
        assert layer[name]["moves"] == "train_tokens_per_s"


@pytest.mark.parametrize("cell,names", [
    ("mixtral-8x22b.serve-long", SERVE), ("qwen3-4b.train-2k", TRAIN)])
def test_a_tiny_traced_run_reports_them(cell, names, train_registry):
    line = tiny.run(tiny.cell(cell), trace=True)
    assert line["correct"], line
    for name in names:
        assert line["metrics"][name]["value"] > 0, name
    if cell == "qwen3-4b.train-2k":
        # a step a Trainer.run call: setup's check steps and the window's
        n = line["attempted"] + tiny.cell(cell).mix["check_steps"]
        assert train_registry.histogram("gap_us").count == n
