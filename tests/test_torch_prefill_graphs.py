"""The Backbone's replayed prefill (``Backbone(prefill_graphs=True)``) on the
CPU: it stays eager off the card, it replays only where nothing reads the
eager step's calls, and it captures each shape once, again after the
parameters change, and hands out a cache tree of its own around the graph's
leaves. The capture itself runs on the card only
(``tests/test_torch_gpu.py::test_prefill_graphs_replay_the_eager_prefill``)."""
import numpy as np
import pytest
import torch

from repro_torch.models import Backbone, ffn, get_config, reduced
from repro_torch.obs import txtrace
from repro_torch.runtime.serve_loop import Request, Server


def _backbone(graphs: bool) -> Backbone:
    cfg = reduced(get_config("qwen3-moe-235b-a22b"), n_experts=8)
    return Backbone(cfg, compute_dtype=torch.float32, remat=False,
                    device="cpu", held_experts=(4, 4),
                    prefill_graphs=graphs)


def _tokens(cfg, S: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (1, S), dtype=np.int32))


def _leaves(tree):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield k, v


def test_prefill_graphs_stay_eager_on_the_cpu():
    """Off the card the flag changes nothing: the same logits and cache,
    bit for bit, the same served tokens, and nothing captured."""
    eager, graphed = _backbone(False), _backbone(True)
    params = eager.init(3)
    toks = _tokens(eager.cfg, 19, 4)
    want, wcache = eager.prefill(params, {"tokens": toks}, 48)
    got, gcache = graphed.prefill(params, {"tokens": toks}, 48)
    assert torch.equal(got, want)
    for (kw, w), (kg, g) in zip(_leaves(wcache), _leaves(gcache)):
        assert kw == kg
        assert (torch.equal(g, w) if isinstance(w, torch.Tensor)
                else g == w), kw
    assert graphed._graphs == {}
    served = []
    for bb in (eager, graphed):
        srv = Server(bb, params, slots=2, ctx=48)
        reqs = [Request(rid=i, prompt=toks[0].numpy(), max_new=4)
                for i in range(2)]
        for r in reqs:
            srv.submit(r)
        srv.run()
        served.append([list(r.out) for r in reqs])
    assert served[0] == served[1]


def _on_the_card(bb: Backbone) -> Backbone:
    """The decision of :meth:`Backbone._replays_prefill` as on the card."""
    bb.device = torch.device("cuda")
    return bb


@pytest.mark.parametrize("case", ["replays", "not_asked", "profiler",
                                  "host_spans", "row_counter",
                                  "other_inputs"])
def test_replays_prefill_only_where_nothing_reads_the_calls(case,
                                                            monkeypatch):
    """On the card a replay is taken when asked for and with tokens alone;
    never while the profiler, the host spans or the MoE layer's row counter
    are on, since a replay enters none of the calls they read."""
    bb = _on_the_card(_backbone(case != "not_asked"))
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    if case == "other_inputs":
        batch["enc_frames"] = torch.zeros(1)
    if case == "host_spans":
        monkeypatch.setattr(txtrace, "enabled", True)
    if case == "row_counter":
        monkeypatch.setattr(ffn.expert_rows, "on", True)
    if case == "profiler":
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            taken = bb._replays_prefill(batch)
    else:
        taken = bb._replays_prefill(batch)
    assert taken == (case == "replays")


class _Graph:
    """A stand-in for a captured graph: a replay writes the eager prefill
    of the static tokens into the entry's own tensors."""

    def __init__(self, bb, params, entry, ctx):
        self.bb, self.params, self.entry, self.ctx = bb, params, entry, ctx
        self.replays = 0

    def replay(self):
        self.replays += 1
        logits, cache = self.bb._prefill(
            self.params, {"tokens": self.entry["tokens"]}, self.ctx)
        self.entry["logits"].copy_(logits)
        for (_, dst), (_, src) in zip(_leaves(self.entry["cache"]),
                                      _leaves(cache)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)


def test_graph_prefill_captures_a_shape_once_and_again_for_new_params(
        monkeypatch):
    """The first call of a (shape, ctx) captures; later ones copy the
    tokens into the graph's own and replay it; other parameters drop every
    graph first. Each call returns a cache tree of its own whose tensors
    are the graph's, with the eager prefill's numbers."""
    bb = _backbone(True)
    params = bb.init(5)
    captured = []

    def capture(p, tokens, ctx):
        logits, cache = bb._prefill(p, {"tokens": tokens}, ctx)
        entry = {"tokens": tokens.clone(), "logits": logits.clone(),
                 "cache": cache}
        entry["graph"] = _Graph(bb, p, entry, ctx)
        captured.append(((tuple(tokens.shape), ctx), p))
        return entry
    monkeypatch.setattr(bb, "_capture_prefill", capture)
    a, b = _tokens(bb.cfg, 11, 6), _tokens(bb.cfg, 11, 7)
    outs = [bb._graph_prefill(params, t, 40) for t in (a, b)]
    assert len(captured) == 1 and len(bb._graphs) == 1
    entry = next(iter(bb._graphs.values()))
    assert entry["graph"].replays == 2 and torch.equal(entry["tokens"], b)
    (l1, c1), (l2, c2) = outs
    assert l1 is l2 and c1 is not c2 and c1["g0"] is not c2["g0"]
    assert c1["g0"]["s0"]["k"] is entry["cache"]["g0"]["s0"]["k"]
    want, wcache = bb._prefill(params, {"tokens": b}, 40)
    assert torch.equal(l2, want)
    assert torch.equal(c2["g0"]["s0"]["k"], wcache["g0"]["s0"]["k"])
    bb._graph_prefill(params, _tokens(bb.cfg, 13, 8), 40)
    assert len(captured) == 2 and len(bb._graphs) == 2
    other = bb.init(9)
    bb._graph_prefill(other, a, 40)
    assert len(captured) == 3 and len(bb._graphs) == 1
    assert captured[-1][1] is other
    bb.drop_prefill_graphs()
    assert bb._graphs == {} and bb._graph_params is None
