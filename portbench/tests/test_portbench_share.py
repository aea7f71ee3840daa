"""The cell of a model held as one device's share of its experts
(``qwen3-moe-235b-ep2.serve-long``: the ``serve_share`` driver,
``reference/moe_share.py``, ``readings_share.py`` and
``moe_gemm_roofline.serve``) at tiny widths on the CPU: the reference's
shares sum to the uncut layer, the port's Backbone with the share agrees
with the reference through prefill and decode, serve_share's check reads
``correct`` true unbroken and false under each serving fault and against
the fp8 control, and the metric's arithmetic by hand. Limits: fp32 on the
CPU agrees to round-off (1e-4, as the Mixtral test has it)."""
import copy

import numpy as np
import pytest
import torch

from portbench import counts, faults, manifest, weights
from portbench.drivers import serve_share
from portbench.manifest import port_config
from portbench.reference import model as ref
from portbench.reference import moe_share
from portbench.tests import tiny

CELL = "qwen3-moe-235b-ep2.serve-long"


def config(conf, drops=False):
    """Small widths, 8 experts top-2 of which the second half is held;
    drop-free at capacity factor E / K, or with ``drops`` at 1.0 (a
    prompt's assignments drop)."""
    c = copy.deepcopy(conf)
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, intermediate_size=32, moe_intermediate_size=32,
             vocab_size=512, num_hidden_layers=2, num_experts=8,
             num_local_experts=8, num_experts_per_tok=2,
             experts_held=[4, 8], capacity_factor=1.0 if drops else 4.0,
             dtypes={"weights": "float32", "compute": "float32"})
    return c


def cell(name=CELL, limits=None):
    """The manifest's cell, small (``<cell>+drops`` with drops), served as
    ``tiny.cell`` serves a small serving cell: one wave of 4 requests, all
    of them checked."""
    base, _, variant = name.partition("+")
    c = manifest.load_cell(base, manifest.load_manifest())
    c.config = config(c.config, drops=variant == "drops")
    c.mix = dict(c.mix, slots=4, ctx=96, wave_size=4,
                 prompt_len={"dist": "uniform", "low": 40, "high": 40,
                             "strata": 1},
                 output_len={"dist": "loguniform", "low": 4, "high": 12},
                 trace_decode_steps=2)
    c.cell = dict(c.cell, check={"requests": 4, "limits": limits or {
        "widest_gap": 1e-3}})
    return c


def _layer_leaves(conf, seed, E):
    gen = torch.Generator().manual_seed(seed)
    D, Fe = conf["hidden_size"], conf["intermediate_size"]
    return {"router": torch.randn(D, conf["num_local_experts"],
                                  generator=gen) * 2.0,
            "w_gate": torch.randn(E, D, Fe, generator=gen) * D ** -0.5,
            "w_up": torch.randn(E, D, Fe, generator=gen) * D ** -0.5,
            "w_down": torch.randn(E, Fe, D, generator=gen) * Fe ** -0.5}


@pytest.mark.parametrize("drops", [False, True], ids=["drop_free", "drops"])
def test_reference_shares_sum_to_the_uncut_layer(drops):
    """moe_share.moe over experts [0, 3) and [3, 8) sums to
    reference.model.moe over all 8, prompt drops and all."""
    conf = config(manifest.load_cell(CELL, manifest.load_manifest()).config,
                  drops)
    p = _layer_leaves(conf, 1, 8)
    h = torch.randn(48, conf["hidden_size"],
                    generator=torch.Generator().manual_seed(2))
    whole = ref.moe(h, p, conf, 40, ref.FP32)
    parts = []
    for first, end in ((0, 3), (3, 8)):
        share = dict(p, **{k: p[k][first:end]
                           for k in ("w_gate", "w_up", "w_down")})
        parts.append(moe_share.moe(h, share, dict(conf, experts_held=[
            first, end]), 40, ref.FP32))
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5,
                               atol=1e-5)
    assert all(float(part.abs().max()) > 0 for part in parts)
    gates, idx = ref.route(h, p["router"], 2)
    cap = ref.capacity(40, 8, 2, conf["capacity_factor"])
    assert ref.kept(idx, 8, 40, cap).all() != drops
    with pytest.raises(ValueError, match="does not lie"):
        moe_share.held(dict(conf, experts_held=[4, 9]))


@pytest.mark.parametrize("drops", [False, True], ids=["drop_free", "drops"])
def test_served_logits_match_the_ports_share_through_prefill_and_decode(
        drops):
    """The port's Backbone holding experts [4, 8) (fp32, one request):
    the prefill's last logits and 6 decode steps through the cache equal
    the share reference's full forward pass over the same tokens."""
    from repro_torch.models import Backbone
    conf = cell(CELL + ("+drops" if drops else "")).config
    cfg = port_config(conf)
    bb = Backbone(cfg, compute_dtype=torch.float32, param_dtype=torch.float32,
                  device="cpu", held_experts=(4, 4))
    meta = bb.init(device="meta")
    assert meta["g0"]["s0"]["w_gate"].shape[:2] == (2, 4)
    assert meta["g0"]["s0"]["router"].shape == (2, 64, 8)
    params = weights.make(meta, 5, torch.float32, "cpu", cfg.d_model)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, 40), dtype=torch.int32)
    logits, cache = bb.prefill(params, {"tokens": prompt[None]}, 96)
    got, toks = [logits[0, -1, :cfg.vocab]], []
    for _ in range(6):
        toks.append(int(torch.argmax(got[-1])))
        logits, cache = bb.decode_step(
            params, cache, torch.tensor([[toks[-1]]], dtype=torch.int32))
        got.append(logits[0, -1, :cfg.vocab])
    seq = torch.cat([prompt, torch.tensor(toks, dtype=torch.int32)])
    want = moe_share.served_logits(conf, params, [seq], [len(prompt)])[0]
    assert want.shape == (7, cfg.vocab)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("drops", [False, True], ids=["drop_free", "drops"])
def test_served_logits_of_many_sequences_are_each_ones_own(drops):
    """The reference computes a layer's held experts over all the
    sequences at once; each sequence's logits equal those of it alone
    (prompts of other lengths beside it, drops by its own prompt)."""
    conf = cell(CELL + ("+drops" if drops else "")).config
    cfg = port_config(conf)
    from repro_torch.models import Backbone
    meta = Backbone(cfg, compute_dtype=torch.float32, device="cpu",
                    held_experts=(4, 4)).init(device="meta")
    params = weights.make(meta, 7, torch.float32, "cpu", cfg.d_model)
    rng = np.random.default_rng(1)
    seqs = [torch.as_tensor(rng.integers(0, cfg.vocab, n), dtype=torch.int32)
            for n in (30, 45, 38)]
    plens = [24, 40, 33]
    many = moe_share.served_logits(conf, params, seqs, plens)
    for seq, plen, got in zip(seqs, plens, many):
        alone = moe_share.served_logits(conf, params, [seq], [plen])[0]
        assert got.shape == (len(seq) - plen + 1, cfg.vocab)
        torch.testing.assert_close(got, alone, rtol=1e-5, atol=1e-5)


def test_the_cells_check_reads_a_whole_wave_and_its_widest_gap():
    """The committed check samples a whole wave of requests, so that a
    reading's one wave is checked whole (a fault in one slot is seen), and
    holds the widest gap, which one altered token moves, besides the
    mean."""
    c = manifest.load_cell(CELL, manifest.load_manifest())
    assert c.cell["check"]["requests"] >= c.mix["wave_size"]
    assert set(c.cell["check"]["limits"]) == {"mean_gap", "widest_gap"}


def test_unbroken_is_correct_and_counts_the_stretchs_calls():
    """A tiny run reads correct, traced or not. A traced window counts,
    one host read after it, each grouped MoE call of the stretch (the
    first wave's last prefill and 2 decode steps, 2 layers each): the
    prefill's rows are its held assignments; the counter is off after."""
    from repro_torch.models import ffn
    c = cell()
    for trace in (False, True):
        r = tiny.run(c, trace=trace)
        assert r["correct"], r["compared"]
        assert r["failed"] == 0 and r["attempted"] == 4
    ctx = serve_share.setup(c, tiny.SEED, "cpu")
    record = serve_share.window(ctx, 0.0, True, whole_passes=False)
    rows = record["expert_rows"]
    assert (rows["d_model"], rows["d_ff"], rows["elem"]) == (64, 32, 4)
    assert len(rows["calls"]) == 2 * (1 + 2)
    for n, busy in rows["calls"]:
        assert 0 < busy <= 4 and busy <= n
    assert rows["calls"][0][0] <= 40 * 2
    assert not ffn.expert_rows.on and ffn.expert_rows.take() == []
    assert "prefill" not in vars(ctx["bb"])
    assert record["kind"] == "serve" and record["stretch"]


def test_a_traced_window_whose_markers_do_not_pair_is_served_again(
        monkeypatch):
    """serve_share.window reads through tracing._bracketed: a window in
    whose trace the markers do not pair is served again, up to
    TRACED_WINDOWS in all, and the record of the first that pairs is
    kept; the harness's function is put back after."""
    from portbench import tracing
    paired = [(0.0, 1.0, tracing.MARKER), (1.0, 3.0, "work"),
              (3.0, 4.0, tracing.MARKER)]
    traces = iter([[], [(0.0, 1.0, tracing.MARKER)], paired, paired])
    served = []

    def fake_window(ctx, seconds, trace, whole_passes=True):
        read = tracing._bracketed(next(traces), ["moe_mlp"])
        served.append(read)
        return {"kind": "serve", "stretch": read}
    monkeypatch.setattr(serve_share.serve, "window", fake_window)
    original = tracing._bracketed
    ctx = serve_share.setup(cell(), tiny.SEED, "cpu")
    record = serve_share.window(ctx, 0.0, True)
    assert served == [None, None, {"moe_mlp": 2.0}]
    assert record["stretch"] == {"moe_mlp": 2.0} and "expert_rows" in record
    assert tracing._bracketed is original
    traces = iter([[]] * 4)
    served.clear()
    serve_share.window(ctx, 0.0, True)
    assert served == [None] * serve_share.TRACED_WINDOWS
    traces = iter([[]] * 4)
    served.clear()
    serve_share.window(ctx, 0.0, False)
    assert served == [None]


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_fault_is_not_correct(fault):
    with faults.SERVE[fault]():
        r = tiny.run(cell())
    assert not r["correct"], r["compared"]


def test_readings_judge_control_and_faults_not_correct():
    """readings_share's one seed at the tiny cell: the port reads correct,
    the fp8 control and each serving fault not."""
    from portbench import readings_share
    out = readings_share.share_seed(cell(), tiny.SEED, True, "cpu")
    assert out["correct"] == {"program": True, "control": False,
                              **{name: False for name in faults.SERVE}}, out


def test_moe_gemm_roofline_by_hand():
    """One prefill call of 6,000 rows over 64 experts at D 4096, Fe 1536,
    bf16: its bytes bound it (2.42 GB of weights and 0.14 GB of rows,
    0.7616 ms at 3.35 TB/s, against 0.2290 ms of operations); one decode
    call of 2,048 rows, 60 experts. Their least time over the kernels'
    device time (both template instances, nothing else), in %."""
    read = manifest.metric_reader("moe_gemm_roofline.serve")
    D, Fe = 4096, 1536
    calls = [(6000, 64), (2048, 60)]
    flops0 = 6 * 6000 * D * Fe
    bytes0 = 2 * (3 * 64 * D * Fe + 2 * 6000 * (D + Fe))
    bytes1 = 2 * (3 * 60 * D * Fe + 2 * 2048 * (D + Fe))
    assert bytes0 / counts.PEAK_BYTES > flops0 / counts.PEAK_FLOPS_BF16
    assert bytes0 / counts.PEAK_BYTES == pytest.approx(0.7616e-3, rel=1e-3)
    least = (bytes0 + bytes1) / counts.PEAK_BYTES
    record = {"kind": "serve",
              "expert_rows": {"calls": calls, "d_model": D, "d_ff": Fe,
                              "elem": 2},
              "stretch": {"device_ops": [
                  ["void (anonymous namespace)::moe_gemm_kernel<true>(...)",
                   1.0e-3],
                  ["flash_decode_kernel", 5.0],
                  ["void (anonymous namespace)::moe_gemm_kernel<false>(...)",
                   0.6e-3]]}}
    assert read(record) == pytest.approx(least / 1.6e-3 * 100)
    assert read(dict(record, stretch={"device_ops": []})) is None
    assert read(dict(record, expert_rows={"calls": []})) is None
    assert read(dict(record, kind="train")) is None
    assert read({"kind": "serve", "stretch": record["stretch"]}) is None
