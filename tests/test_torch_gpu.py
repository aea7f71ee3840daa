"""The Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (decided in the
``cuda`` fixture, never at import). It imports torch and the port only, so
it runs on a machine without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances, as |got - want| <= atol + rtol * |want|: fp32 atol = rtol = 5e-5
(the kernel and the plain version sum in another order); bf16 atol 1e-4,
rtol 2**-6 (both round an fp32 result to bf16 once, so they differ by at
most one bf16 ulp, 2**-7 of |want|; the limit allows two).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import Backbone, LayerGroup, get_config, reduced

pytestmark = pytest.mark.gpu

# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap): the shapes of
# tests/test_kernels.py's FLASH_CASES, plus head dims of every kernel width
SHAPES = [
    (1, 64, 64, 4, 4, 32, True, None, None),
    (2, 96, 96, 4, 2, 32, True, None, None),
    (2, 64, 64, 8, 1, 16, True, None, None),
    (1, 80, 80, 4, 2, 32, True, 16, None),
    (1, 64, 64, 4, 2, 32, True, None, 30.0),
    (1, 64, 64, 4, 2, 32, False, None, None),
    (1, 72, 72, 4, 2, 24, True, 32, 50.0),
    (2, 130, 130, 8, 2, 64, True, None, None),
    (1, 200, 200, 32, 8, 128, True, None, None),
    (1, 65, 65, 4, 1, 256, True, None, None),
]
DTYPES = {"fp32": (torch.float32, (5e-5, 5e-5)),
          "bf16": (torch.bfloat16, (1e-4, 2.0 ** -6))}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain(cuda, shape, dtype):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap = shape
    dt, (atol, rtol) = DTYPES[dtype]
    q = _randn((B, Sq, Hq, hd), dt, cuda, 0)
    k = _randn((B, Skv, Hkv, hd), dt, cuda, 1)
    v = _randn((B, Skv, Hkv, hd), dt, cuda, 2)
    qp = torch.arange(Sq, dtype=torch.int32, device=cuda)
    kp = torch.arange(Skv, dtype=torch.int32, device=cuda)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_positions=qp,
              kv_positions=kp)
    got = fa.flash_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.attention_plain(q, k, v, **kw)
    assert got.dtype == dt and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_kernel_decode_against_a_wrapped_ring(cuda, dtype):
    dt, (atol, rtol) = DTYPES[dtype]
    B, C, Hq, Hkv, hd = 3, 200, 32, 8, 128
    kpos = np.full((C,), -1, np.int32)
    for p in range(150, 331):           # wrapped at 200, 19 empty slots
        kpos[p % C] = p
    q = _randn((B, 1, Hq, hd), dt, cuda, 3)
    k = _randn((B, C, Hkv, hd), dt, cuda, 4)
    v = _randn((B, C, Hkv, hd), dt, cuda, 5)
    for window, cap in ((None, None), (64, 20.0)):
        kw = dict(causal=True, window=window, logit_cap=cap,
                  q_positions=torch.tensor([330], dtype=torch.int32,
                                           device=cuda),
                  kv_positions=torch.from_numpy(kpos).to(cuda))
        got = fa.flash_fwd(q, k, v, **kw)
        torch.testing.assert_close(got.float(),
                                   ref.attention_plain(q, k, v, **kw).float(),
                                   atol=atol, rtol=rtol)


def test_fully_masked_rows_are_zero(cuda):
    """The Pallas kernel's choice, kept: a row with no valid key is 0."""
    q = _randn((1, 4, 2, 32), torch.float32, cuda, 6)
    k = _randn((1, 8, 1, 32), torch.float32, cuda, 7)
    out = fa.flash_fwd(q, k, k, causal=True,
                       q_positions=torch.tensor([0, 1, 2, 3], dtype=torch.int32,
                                                device=cuda),
                       kv_positions=torch.tensor([-1, -1, 2, 3, -1, 5, 6, 7],
                                                 dtype=torch.int32,
                                                 device=cuda))
    assert out[:, :2].abs().max().item() == 0.0
    assert out[:, 2:].abs().max().item() > 0.0


def test_wrapper_counts_launches_and_rejects_what_it_cannot_take(cuda):
    q = _randn((1, 8, 4, 32), torch.bfloat16, cuda, 8)
    k = _randn((1, 8, 2, 32), torch.bfloat16, cuda, 9)
    before = fa.launches
    ops.flash_attention(q, k, k)
    ops.flash_attention(q, k, k)
    assert fa.launches == before + 2
    with pytest.raises(ValueError):
        ops.flash_attention(q.half(), k.half(), k.half())
    assert fa.launches == before + 2


def test_model_decode_matches_prefill_on_the_card(cuda):
    cfg = reduced(get_config("qwen3-4b"), groups=(LayerGroup(("attn",), 3),))
    bb = Backbone(cfg, compute_dtype=torch.float32, device=cuda)
    params = bb.init(0)
    toks = torch.from_numpy(np.random.default_rng(10).integers(
        0, cfg.vocab, (2, 18), dtype=np.int32)).to(cuda)
    _, cache = bb.prefill(params, {"tokens": toks[:, :17]}, 40)
    got, _ = bb.decode_step(params, cache, toks[:, 17:])
    want, _ = bb.prefill(params, {"tokens": toks}, 40)
    torch.testing.assert_close(got, want, atol=2e-3, rtol=2e-3)
