"""The port's Server against the JAX package's, on the CPU in fp32: the same
grafted parameters and the requests of tests/test_system.py's continuous
batching test must give identical token lists (both argmaxes take the first
maximum)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Backbone as JBackbone
from repro.models import get_config as jget_config
from repro.models import reduced as jreduced
from repro.runtime.serve_loop import Request as JRequest
from repro.runtime.serve_loop import Server as JServer
from repro_torch import bridge
from repro_torch.models import Backbone, get_config, reduced
from repro_torch.runtime.serve_loop import Request, Server, _merge_slot


@pytest.fixture(scope="module")
def served():
    jbb = JBackbone(jreduced(jget_config("qwen3-4b")),
                    compute_dtype=jnp.float32, remat=False)
    jparams = jbb.init(jax.random.PRNGKey(0))
    tbb = Backbone(reduced(get_config("qwen3-4b")),
                   compute_dtype=torch.float32, device="cpu")
    tparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")

    def requests(cls):
        rng = np.random.default_rng(0)
        return [cls(rid=i, prompt=rng.integers(0, 512, 8, dtype=np.int32),
                    max_new=5) for i in range(5)]

    out = {}
    for name, srv, cls in (("jax", JServer(jbb, jparams, slots=2, ctx=64),
                            JRequest),
                           ("torch", Server(tbb, tparams, slots=2, ctx=64),
                            Request)):
        reqs = requests(cls)
        for r in reqs:
            srv.submit(r)
        srv.run(max_steps=200)
        out[name] = (srv, reqs)
    return out, tbb, tparams


def test_server_token_lists_match_jax(served):
    out, _, _ = served
    (jsrv, jreqs), (tsrv, treqs) = out["jax"], out["torch"]
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert tsrv.stats == jsrv.stats
    assert all(r.done.is_set() for r in treqs)


def test_server_first_token_is_direct_prefill(served):
    out, tbb, tparams = served
    _, treqs = out["torch"]
    logits, _ = tbb.prefill(tparams, {"tokens": torch.from_numpy(
        treqs[0].prompt[None, :])}, 64)
    assert treqs[0].out[0] == int(torch.argmax(logits[0, -1, :tbb.cfg.vocab]))


def test_merge_slot_takes_pos_and_kpos_from_the_admitted_request():
    """The reference's semantics, kept: batch-major leaves merge into slot i;
    pos and kpos come whole from the new request."""
    cache = {"pos": 7, "g0": {"s0": {"k": torch.zeros(2, 3, 4, 1, 2),
                                     "kpos": torch.full((2, 4), 5)}}}
    one = {"pos": 2, "g0": {"s0": {"k": torch.ones(2, 1, 4, 1, 2),
                                   "kpos": torch.tensor([[0, 1, -1, -1]] * 2)}}}
    _merge_slot(cache, one, 1)
    assert cache["pos"] == 2
    assert cache["g0"]["s0"]["kpos"] is one["g0"]["s0"]["kpos"]
    k = cache["g0"]["s0"]["k"]
    assert k[:, 1].eq(1).all() and k[:, 0].eq(0).all() and k[:, 2].eq(0).all()
