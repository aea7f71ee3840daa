"""The plain reference against the port's plain path at a reduced size: the
test may import both; the reference imports neither the port nor JAX."""
import ast

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.drivers import serve, train
from portbench.manifest import HERE, port_config
from portbench.reference import model as ref
from portbench.reference import train as ref_train
from portbench.tests import tiny


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_port_nor_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("name", ["mixtral-8x22b.serve-long",
                                  "mixtral-8x22b.serve-long+drops"])
def test_served_logits_match_the_ports_prefill_and_decode(name):
    """The reference's logits at the prompt's last position and after
    equal the port's prefill and decode steps (fp32, one request): as
    shipped, no window and no drops; ``+drops`` has its window wrap and
    its prefill drop assignments."""
    from repro_torch.models import Backbone
    cell = tiny.cell(name)
    conf = cell.config
    cfg = port_config(conf)
    bb = Backbone(cfg, compute_dtype=torch.float32,
                  param_dtype=torch.float32, device="cpu")
    params = weights.make(bb.init(device="meta"), 5, torch.float32, "cpu",
                          cfg.d_model)
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
    want = ref.served_logits(conf, params, [seq], [len(prompt)])[0]
    assert want.shape == (7, cfg.vocab)
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(40, cfg.d_model, generator=gen)
    gates, idx = ref.route(h, torch.randn(cfg.d_model, cfg.n_experts,
                                          generator=gen), cfg.top_k)
    cap = ref.capacity(40, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    # as shipped an expert holds every token; with drops the rule runs
    assert ref.kept(idx, cfg.n_experts, 40, cap).all() == (
        not name.endswith("+drops"))
    assert (cfg.attn_window is None) == (not name.endswith("+drops"))


def test_reference_training_matches_the_port():
    """Losses, first gradients and changes of the reference's AdamW steps
    equal the port's Trainer's in fp32 (the harness's check, tiny)."""
    cell = tiny.cell("qwen3-4b.train-2k")
    ctx = train.build(cell, 3, "cpu")
    train.first_steps(ctx)
    side = train.program_side(ctx)
    train.free(ctx)
    numbers = train.compare(ctx, train.reference(ctx), side)
    assert all(v < 1e-5 for v in numbers.values()), numbers


def test_lr_schedule_is_the_ports():
    from repro_torch.optim import adamw
    opt = tiny.cell("qwen3-4b.train-2k").mix["optimizer"]
    cfg = adamw.AdamWConfig(**opt)
    for step in (1, 2, 3, 500, 1000, 1200):
        want = float(adamw.cosine_lr(cfg, torch.tensor(step)))
        assert ref_train.lr_at(opt, step) == pytest.approx(want, rel=1e-6)


def test_fp8_control_moves_the_logits_more_than_bf16():
    """The control's precision is below the cell's: at a tiny size the fp8
    reference lies farther from fp32 than the same weights rounded to
    bf16 do."""
    from repro_torch.models import Backbone
    conf = tiny.cell("qwen3-4b.train-2k").config
    meta = Backbone(port_config(conf), device="cpu").init(device="meta")
    params = weights.make(meta, 9, torch.float32, "cpu", conf["hidden_size"])
    rounded = _map(lambda t: t.bfloat16().float(), params)
    seq = torch.as_tensor(np.random.default_rng(1).integers(0, 512, 48))
    truth = ref.served_logits(conf, params, [seq], [40])[0]
    low = ref.served_logits(conf, params, [seq], [40], ref.Precision("fp8"))[0]
    bf16 = ref.served_logits(conf, rounded, [seq], [40])[0]
    assert (low - truth).abs().max() > 3 * (bf16 - truth).abs().max()


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def test_sample_holds_the_longest_request():
    class R:
        def __init__(self, n, p):
            self.out, self.prompt = [0] * n, [0] * p
    reqs = [R(n, 8) for n in (3, 9, 4, 9, 2, 5)]
    picked = serve.sample(reqs, 3, seed=2 ** 32 + 1)
    assert picked[0] is reqs[1] and len(set(map(id, picked))) == 3
    assert serve.sample(reqs, 3, seed=2 ** 32 + 1) == picked
