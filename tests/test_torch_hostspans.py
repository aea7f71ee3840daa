"""The port's own spans and always-on accounts (repro_torch.obs.hostspans):
the Server's, the Trainer's and the MoE layer's, on txtrace's rings and
registries; their ranges in a torch.profiler trace on the profiler's clock;
the device's idle time split over them. CPU tests but for the two marked
``gpu``, which need the card."""
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.data.pipeline import DataConfig
from repro_torch.models import Backbone, LayerGroup, ModelConfig, ffn
from repro_torch.models import get_config, reduced
from repro_torch.obs import hostspans, metrics, txtrace
from repro_torch.optim import adamw
from repro_torch.runtime.serve_loop import Request, Server
from repro_torch.runtime.steps import StepSettings
from repro_torch.runtime.train_loop import Trainer, TrainerConfig

MS = 1_000_000          # ns


@pytest.fixture
def tracing(monkeypatch):
    """txtrace on, its rings empty; off again afterwards."""
    txtrace.reset()
    monkeypatch.setattr(txtrace, "enabled", True)
    yield
    txtrace.reset()


@pytest.fixture
def quiet(monkeypatch):
    txtrace.reset()
    monkeypatch.setattr(txtrace, "enabled", False)
    yield


def _events(kind=None):
    evs = [e for t in txtrace.all_tracers() for e in t.events()]
    return [e for e in evs if kind is None or e["kind"] == kind]


def _serve(n=5, slots=2, arch="qwen3-4b"):
    bb = Backbone(reduced(get_config(arch)), compute_dtype=torch.float32,
                  device="cpu")
    srv = Server(bb, bb.init(0), slots=slots, ctx=64)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, 8, dtype=np.int32),
                    max_new=4 + i % 3) for i in range(n)]
    for r in reqs:
        srv.submit(r)
    srv.run(max_steps=200)
    return srv, reqs


def _trainer(tmp_path, steps=3):
    cfg = ModelConfig(name="spans", family="dense",
                      groups=(LayerGroup(("attn",), 2),), d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
    bb = Backbone(cfg, compute_dtype=torch.float32, device="cpu")
    tr = Trainer(bb, adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=steps),
                 DataConfig(vocab=256, seq_len=16, global_batch=2),
                 TrainerConfig(total_steps=steps, ckpt_every=100,
                               log_every=100, ckpt_dir=str(tmp_path)),
                 StepSettings(zero3=False, gather_weights=False, remat=False))
    return tr


def _train(tmp_path, steps=3):
    tr = _trainer(tmp_path, steps)
    try:
        tr.run(tr.init_or_restore())
    finally:
        tr.shutdown()
    return tr


def _ours(names):
    return [n for n in names
            if n.split(".", 1)[0] in hostspans.SITES]


# --------------------------------------------------------------------------- #
# Tracing off: nothing recorded but the always-on accounts                    #
# --------------------------------------------------------------------------- #
def test_server_with_tracing_off_records_no_span_and_keeps_its_timing(quiet):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv, reqs = _serve()
    assert _events() == []
    assert _ours({e.name for e in prof.events()}) == []
    tm = srv.timing
    assert set(tm) == {"prefill_s", "decode_s", "decode_read_s",
                       "first_gap_s"}
    assert all(isinstance(v, float) for v in tm.values())
    assert 0.0 <= tm["decode_read_s"] <= tm["decode_s"]
    assert tm["first_gap_s"] > 0.0
    assert srv.stats == {"steps": srv.stats["steps"],
                         "tokens": sum(len(r.out) - 1 for r in reqs),
                         "admitted": len(reqs)}


def test_first_gap_is_each_requests_wait_for_its_second_token(quiet,
                                                               monkeypatch):
    """On a clock that ticks one second a read, ``first_gap_s`` is the
    sum over requests of the ticks from a request's first token read to its
    second."""
    import types

    import repro_torch.runtime.serve_loop as sl
    ticks = iter(range(10_000))
    monkeypatch.setattr(sl, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks)), monotonic=sl.time.monotonic))
    srv, reqs = _serve(n=3, slots=3)
    # clock reads: each prefill 2 (its start, its first token's read), each
    # decode step 3 (its start, before the read, after it). The requests
    # are admitted at 0-1, 2-3 and 4-5; the first decode step reads at 6-8:
    # gaps 8 - 1, 8 - 3 and 8 - 5
    assert srv.timing == {"prefill_s": 3.0,
                          "decode_s": 2.0 * srv.stats["steps"],
                          "decode_read_s": 1.0 * srv.stats["steps"],
                          "first_gap_s": 7.0 + 5.0 + 3.0}


def test_trainer_records_three_histograms_a_step(quiet, tmp_path):
    reg = metrics.registry("train")
    reg.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr = _train(tmp_path, steps=3)
    assert _events() == []
    assert _ours({e.name for e in prof.events()}) == []
    hists = reg.snapshot()["histograms"]
    assert sorted(hists) == ["commit_us", "data_us", "gap_us"]
    assert all(h["count"] == 3 for h in hists.values())
    assert all(h["p50_us"] > 0 for h in hists.values())
    assert len(tr.metrics_log) == 3


def test_trainer_gap_covers_what_lies_outside_step_and_reads(quiet, tmp_path,
                                                            monkeypatch):
    """On a clock that ticks T a read: each step's gap is its ticks outside
    the step and its reads, the first step's with the run's set-up, the last
    one's with the drain."""
    import types

    import repro_torch.runtime.train_loop as tl
    T = 2.0 ** -10                  # s: exact in binary, about 977 us
    ticks = iter(range(10_000))
    monkeypatch.setattr(tl, "time", types.SimpleNamespace(
        monotonic=lambda: next(ticks) * T))
    reg = metrics.registry("train")
    reg.reset()
    _train(tmp_path, steps=3)
    # reads: one at entry; a step's t_data, t0, dt's, t_read, t_commit,
    # t_end and the end's (7: the step and its reads span t0 -> t_read, 2
    # ticks); one after the drain. Gaps 7 - 2 = 5 ticks, the last 5 + 1
    us = T * 1e6
    gap, data, commit = (reg.histogram(n) for n in
                         ("gap_us", "data_us", "commit_us"))
    assert gap.count == data.count == commit.count == 3
    assert gap.total == 2 * int(5 * us) + int(6 * us)
    assert gap.max == int(6 * us)
    assert data.total == commit.total == 3 * int(us)


# --------------------------------------------------------------------------- #
# Tracing on                                                                   #
# --------------------------------------------------------------------------- #
def test_server_spans_one_queue_and_prefill_a_request_one_step_a_step(
        tracing):
    srv, reqs = _serve()
    assert len(_events("serve.queue")) == len(reqs)
    assert len(_events("serve.prefill")) == len(reqs)
    assert len(_events("serve.first_token_read")) == len(reqs)
    assert len(_events("serve.merge")) == len(reqs)
    assert len(_events("serve.decode_step")) == srv.stats["steps"]
    assert len(_events("serve.decode_read")) == srv.stats["steps"]
    assert {e["site"] for e in _events() if e["kind"].startswith("serve.")} \
        == {"host:serve"}
    assert {e["detail"] for e in _events("serve.prefill")} == {"8"}
    # each read lies inside its step
    for step, read in zip(_events("serve.decode_step"),
                          _events("serve.decode_read")):
        assert step["ts"] <= read["ts"]
        assert read["ts"] + read["dur"] <= step["ts"] + step["dur"]


def test_server_token_lists_are_the_same_traced_or_not(monkeypatch):
    txtrace.reset()
    monkeypatch.setattr(txtrace, "enabled", False)
    plain, plain_reqs = _serve()
    monkeypatch.setattr(txtrace, "enabled", True)
    traced, traced_reqs = _serve()
    txtrace.reset()
    assert [r.out for r in traced_reqs] == [r.out for r in plain_reqs]
    assert traced.stats == plain.stats


def test_moe_layer_records_four_spans_a_call(tracing, monkeypatch):
    cfg = reduced(get_config("mixtral-8x22b"))
    bb = Backbone(cfg, compute_dtype=torch.float32, device="cpu")
    layer = {k: v[0] for k, v in bb.init(0)["g0"]["s0"].items()
             if k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.randn(2, 5, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    y, aux = ffn.moe_mlp(layer, x, cfg)
    evs = sorted(_events(), key=lambda e: e["ts"])
    assert [e["kind"] for e in evs] == ["moe.route", "moe.dispatch",
                                        "moe.experts", "moe.combine"]
    for a, b in zip(evs, evs[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    C = ffn.moe_capacity(10, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    assert {e["detail"] for e in evs} == {f"T=10 EC={cfg.n_experts * C}"}
    assert {e["site"] for e in evs} == {"host:model"}
    monkeypatch.setattr(txtrace, "enabled", False)
    y0, aux0 = ffn.moe_mlp(layer, x, cfg)
    assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_served_moe_layers_record_four_spans_a_layer_call(tracing):
    srv, reqs = _serve(n=2, arch="mixtral-8x22b")
    layers = reduced(get_config("mixtral-8x22b")).n_layers
    calls = layers * (len(reqs) + srv.stats["steps"])
    for kind in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        assert len(_events(kind)) == calls


def test_trainer_spans_and_the_commits_transactions_inside(tracing,
                                                          tmp_path):
    _train(tmp_path, steps=3)
    for kind in ("train.data", "train.step", "train.read", "train.log",
                 "train.commit"):
        assert len(_events(kind)) == 3, kind
    assert len(_events("train.run_setup")) == len(_events("train.drain")) == 1
    commits = _events("train.commit")
    txns = [e for e in _events("txn") if e["detail"] == "commit"]
    # init_or_restore commits the cursor; each step commits once more
    assert len(txns) == 4
    for c in commits:
        inside = [t for t in _events() if t["site"] != "host:train"
                  and c["ts"] <= t["ts"]
                  and t["ts"] + t["dur"] <= c["ts"] + c["dur"]]
        assert {"txn", "commit", "lw_apply"} <= {t["kind"] for t in inside}


# --------------------------------------------------------------------------- #
# One clock                                                                    #
# --------------------------------------------------------------------------- #
def test_mirrored_ranges_start_with_their_spans_on_one_clock(tracing,
                                                           tmp_path):
    hostspans.anchor()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv, reqs = _serve(n=3)
        _train(tmp_path, steps=2)
    kin = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in hostspans.mirrored:
            kin.setdefault(e.name(), []).append(e.start_ns())
    assert {"serve.prefill", "serve.decode_step", "train.commit",
            "train.step"} <= set(kin)
    for kind, starts in kin.items():
        spans = sorted(hostspans.to_epoch_ns(e["ts"]) for e in _events(kind))
        assert len(spans) == len(starts), kind
        for a, b in zip(sorted(starts), spans):
            assert abs(a - b) < 1 * MS, (kind, a, b)


def test_merged_file_lays_the_sites_over_the_profilers_trace(tracing,
                                                           tmp_path):
    hostspans.anchor()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(tmp_path, steps=2)
    path = tmp_path / "merged.json"
    n = hostspans.write_merged(prof, str(path))
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    assert n == len(_events())
    names = {e["pid"]: e["args"]["name"] for e in evs
             if e.get("name") == "process_name"}
    assert {"train", "client1"} <= set(names.values())
    ours = {p for p, name in names.items() if name in ("train", "client1")}
    assert not ours & {e["pid"] for e in evs
                       if e.get("cat") == "user_annotation"}
    ranges = sorted(e["ts"] for e in evs if e.get("name") == "train.commit"
                    and e["pid"] not in ours)
    spans = sorted(e["ts"] for e in evs if e.get("name") == "train.commit"
                   and e["pid"] in ours)
    assert len(ranges) == len(spans) == 2
    for a, b in zip(ranges, spans):
        assert abs(a - b) < 1000          # us
    # the store's transactions sit inside the commits on the same clock
    commits = [e for e in evs if e.get("name") == "train.commit"
               and e["pid"] in ours]
    txns = [e for e in evs if e.get("name") == "txn" and e["pid"] in ours]
    for c in commits:
        assert any(c["ts"] <= t["ts"] <= c["ts"] + c["dur"] for t in txns)


def test_a_range_closed_after_the_profiler_stopped_is_harmless(tracing):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    s = hostspans.begin("serve.decode_step")
    prof.stop()
    hostspans.end(s)
    assert len(_events("serve.decode_step")) == 1


# --------------------------------------------------------------------------- #
# idle_by_span                                                                 #
# --------------------------------------------------------------------------- #
def test_idle_split_over_the_innermost_span_along_each_gap():
    # host: A 0-100 with B 20-60 inside it, an op outside any span at
    # 100-120; device busy 0-10, 50-70, 90-95. Idle: 10-50 (A 10, B 30),
    # 70-90 (A 20), 95-120 (A 5, none 20)
    events = [("A", 0, 100 * MS, False), ("B", 20 * MS, 60 * MS, False),
              ("aten::op", 100 * MS, 120 * MS, False),
              ("k1", 0, 10 * MS, True), ("k2", 50 * MS, 70 * MS, True),
              ("k3", 90 * MS, 95 * MS, True)]
    got = hostspans.idle_by_span(events, names={"A", "B"})
    assert got == {"A": 35.0, "B": 30.0, hostspans.OUTSIDE: 20.0}
    assert list(got) == ["A", "B", hostspans.OUTSIDE]


def test_idle_split_ties_and_overlapping_kernels():
    # C and D begin together, D shorter: D is the inner one while open;
    # kernels overlap each other; the gap before the first kernel counts
    events = [("C", 0, 40 * MS, False), ("D", 0, 10 * MS, False),
              ("k1", 5 * MS, 20 * MS, True), ("k2", 15 * MS, 25 * MS, True),
              ("k3", 30 * MS, 40 * MS, True)]
    got = hostspans.idle_by_span(events, names={"C", "D"})
    assert got == {"D": 5.0, "C": 5.0}
    # no device work: nothing to split
    assert hostspans.idle_by_span([("C", 0, MS, False)], names={"C"}) == {}
    # an unnamed range is not a span
    got = hostspans.idle_by_span(events, names={"C"})
    assert got == {"C": 10.0}


def test_idle_split_of_a_cpu_profile_reads_its_ranges(tracing):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with hostspans.span("train.log"):
            torch.ones(4).add_(1)
    assert "train.log" in hostspans.mirrored
    events = hostspans.profiler_events(prof)
    assert any(name == "train.log" and not dev for name, _, _, dev in events)
    assert not any(dev for _, _, _, dev in events)
    assert hostspans.idle_by_span(prof) == {}


# --------------------------------------------------------------------------- #
# On the card                                                                  #
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_idle_split_on_the_card_credits_the_span_the_host_waited_in(
        cuda, tracing):
    import time
    x = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x.add_(1)
        torch.cuda.synchronize()
        with hostspans.span("train.log"):
            time.sleep(0.02)        # the card idle, the host in train.log
        x.add_(1)
        torch.cuda.synchronize()
    events = hostspans.profiler_events(prof)
    assert any(dev for _, _, _, dev in events)
    assert not any(dev and name == "train.log" for name, _, _, dev in events)
    idle = hostspans.idle_by_span(prof)
    assert 19.0 <= idle["train.log"] <= 25.0, idle


@pytest.mark.gpu
def test_kernel_library_load_is_a_span(cuda, tracing, monkeypatch):
    from repro_torch.kernels import build
    build.load()
    monkeypatch.setattr(build, "_lib", None)
    txtrace.reset()
    build.load()
    (ev,) = _events("kernels.load")
    assert ev["detail"] == "loaded" and ev["site"] == "host:model"
