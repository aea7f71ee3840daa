"""The port's attention (K1's plain version and dispatch) against the JAX
package's on the CPU. Inputs are made with numpy from a seed and handed to
both. The CUDA kernel itself is held against the plain version on the card
in tests/test_torch_gpu.py and chip_smoke.py.

Tolerances: fp32 3e-5 (as tests/test_kernels.py: the two sum the softmax in
another order); bf16 2e-2 (both round an fp32 result to bf16 once, so they
differ by at most one bf16 ulp of an output below 4).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models.attention import attention_reference, flash_attention_jnp
from repro_torch.kernels import build, ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ref as tref
from repro_torch.obs import metrics
from test_kernels import FLASH_CASES


def _inputs(shapes, dtype, seed=0):
    """The same arrays for both packages: (jax list, torch list)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return ([jnp.asarray(a).astype(dtype) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _tol(dtype):
    return 2e-2 if dtype == jnp.bfloat16 else 3e-5


@pytest.mark.parametrize("case", FLASH_CASES)
def test_plain_attention_matches_pallas_interpret(case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)], dtype)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  logit_cap=cap, block_q=32, block_k=32,
                                  interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              logit_cap=cap)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_ref_matches_jax_ref(case):
    B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(B, Sq, Hq, hd), (B, Skv, Hkv, hd), (B, Skv, Hkv, hd)], dtype, 1)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                    logit_cap=cap, q_offset=3)
    got = tref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   logit_cap=cap, q_offset=3)
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype),
                               rtol=_tol(dtype))


def test_decode_offset_matches_pallas_interpret():
    """Single query at position q_offset against a longer KV."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, 1, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)], jnp.float32)
    want = flash_attention_pallas(jq, jk, jv, causal=True, q_offset=39,
                                  block_q=8, block_k=16, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=39)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


def _ring_positions(C, first, last):
    """kv positions of a ring of C slots holding positions first..last at
    slots p % C; the other slots are empty (-1)."""
    kpos = np.full((C,), -1, np.int32)
    for p in range(first, last + 1):
        kpos[p % C] = p
    return kpos


RING_CASES = [
    # (Sq, C, first, last, window, cap)
    (1, 40, 25, 57, None, None),     # wrapped, 7 empty slots
    (1, 40, 0, 12, None, None),      # not yet wrapped, mostly empty
    (3, 40, 30, 60, 16, None),       # three queries, window
    (1, 48, 20, 70, None, 30.0),     # wrapped, full, softcap
]


@pytest.mark.parametrize("case", RING_CASES)
@pytest.mark.parametrize("reference", ["attention_reference",
                                       "flash_attention_jnp"])
def test_ring_positions_match_jax(case, reference):
    Sq, C, first, last, window, cap = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, Sq, 8, 32), (2, C, 2, 32), (2, C, 2, 32)], jnp.float32, 2)
    kpos = _ring_positions(C, first, last)
    qpos = np.arange(last - Sq + 1, last + 1, dtype=np.int32)
    fn = {"attention_reference": attention_reference,
          "flash_attention_jnp": flash_attention_jnp}[reference]
    want = fn(jq, jk, jv, causal=True, window=window, logit_cap=cap,
              q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos))
    got = ops.attention(tq, tk, tv, causal=True, window=window, logit_cap=cap,
                        q_positions=torch.from_numpy(qpos),
                        kv_positions=torch.from_numpy(kpos))
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5, rtol=3e-5)


# (Sq, C, first, last, window, cap, n_splits): the split mirror of the
# decode kernel against the unsplit plain version; chunks of ceil(C / n)
SPLIT_CASES = [
    (1, 40, 25, 57, None, None, 1),
    (1, 40, 25, 57, None, None, 3),
    (1, 40, 25, 57, None, None, 8),
    (1, 40, 0, 12, None, None, 3),   # chunks 2 and 3 hold no valid key
    (1, 40, 0, 12, None, None, 8),   # six of eight chunks empty
    (1, 64, 10, 90, 16, None, 8),    # the window leaves most chunks empty
    (1, 48, 20, 70, None, 30.0, 3),  # softcap
    (1, 48, 20, 70, 24, 30.0, 8),    # window and softcap
    (3, 40, 30, 60, 16, None, 3),    # three queries, window
    (1, 10, 0, 9, None, None, 8),    # more splits than keys: last ones empty
]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_plain_matches_plain(case):
    Sq, C, first, last, window, cap, n = case
    _, (tq, tk, tv) = _inputs([(2, Sq, 8, 32), (2, C, 2, 32), (2, C, 2, 32)],
                              jnp.float32, 3)
    kw = dict(causal=True, window=window, logit_cap=cap,
              q_positions=torch.arange(last - Sq + 1, last + 1,
                                       dtype=torch.int32),
              kv_positions=torch.from_numpy(_ring_positions(C, first, last)))
    got = tref.attention_split_plain(tq, tk, tv, n_splits=n, **kw)
    want = tref.attention_plain(tq, tk, tv, **kw)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_splits", [1, 3, 8])
@pytest.mark.parametrize("case", RING_CASES)
def test_split_plain_matches_jax_ring(case, n_splits):
    """The two passes against the JAX package's attention_reference."""
    Sq, C, first, last, window, cap = case
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        [(2, Sq, 8, 32), (2, C, 2, 32), (2, C, 2, 32)], jnp.float32, 2)
    kpos = _ring_positions(C, first, last)
    qpos = np.arange(last - Sq + 1, last + 1, dtype=np.int32)
    want = attention_reference(jq, jk, jv, causal=True, window=window,
                               logit_cap=cap, q_positions=jnp.asarray(qpos),
                               kv_positions=jnp.asarray(kpos))
    got = tref.attention_split_plain(
        tq, tk, tv, causal=True, window=window, logit_cap=cap,
        q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kpos),
        n_splits=n_splits)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_split_plain_rows_without_a_valid_key_are_zero():
    """As the kernels give it; attention_plain gives the mean of V there."""
    _, (tq, tk, tv) = _inputs([(1, 1, 2, 16), (1, 8, 1, 16), (1, 8, 1, 16)],
                              jnp.float32, 4)
    kp = torch.tensor([-1, -1, 5, 6, -1, 9, 7, 8], dtype=torch.int32)
    for qpos, empty in ((4, True), (6, False)):
        out = tref.attention_split_plain(
            tq, tk, tv, q_positions=torch.tensor([qpos], dtype=torch.int32),
            kv_positions=kp, n_splits=3)
        assert (out.abs().max().item() == 0.0) == empty


@pytest.mark.parametrize("shape", [
    (8, 1, 16, 2048), (8, 8, 4, 1024), (1, 1, 16, 2048), (3, 8, 4, 200),
    (1, 8, 4, 10), (2, 1, 32, 256), (1, 2, 2, 70000), (128, 8, 4, 1024)],
    ids=str)
def test_split_plan_fills_the_card_in_whole_tiles(shape):
    B, Hkv, G, Skv = shape
    n, keys = tfd.split_plan(B, Hkv, G, Skv)
    assert keys % tfd.SPLIT_TILE == 0 and keys >= tfd.SPLIT_TILE
    assert n * keys >= Skv and (n - 1) * keys < max(Skv, 1)  # none empty
    ctas = B * Hkv * -(-G // tfd.ROWS_PER_CTA)
    # one tile a split, or enough splits for a CTA on every SM ...
    assert keys == tfd.SPLIT_TILE or n * ctas >= tfd.SMS
    # ... and no more than about two waves of them
    assert n == 1 or n * ctas < 2 * tfd.CTAS_PER_SM * tfd.SMS


def test_split_plan_at_the_serving_shapes():
    # recurrentgemma-9b decode: 8 slots, MQA 16/1, the 2048-slot local ring
    assert tfd.split_plan(8, 1, 16, 2048) == (32, 64)
    # qwen3-4b decode: 8 slots, GQA 32/8, the 1024-slot ring
    assert tfd.split_plan(8, 8, 4, 1024) == (4, 256)


def test_cpu_tensors_take_the_plain_version():
    q = torch.randn(1, 4, 4, 16)
    k = torch.randn(1, 4, 2, 16)
    ledger = metrics.registry("dispatch")
    before = ledger.snapshot()
    out = ops.flash_attention(q, k, k)
    assert ledger.snapshot() == before
    torch.testing.assert_close(out, tref.flash_attention_ref(q, k, k),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_fwd(q, k, k, q_positions=torch.arange(4, dtype=torch.int32),
                      kv_positions=torch.arange(4, dtype=torch.int32))


def test_cpu_decode_takes_the_plain_version():
    """One query position on the CPU: attention_plain, no kernel launched."""
    q, k = torch.randn(2, 1, 4, 16), torch.randn(2, 6, 2, 16)
    kw = dict(q_positions=torch.tensor([5], dtype=torch.int32),
              kv_positions=torch.arange(6, dtype=torch.int32), window=4)
    ledger = metrics.registry("dispatch")
    before = ledger.snapshot()
    out = ops.attention(q, k, k, **kw)
    assert ledger.snapshot() == before
    torch.testing.assert_close(out, tref.attention_plain(q, k, k, **kw),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfd.flash_decode(q, k, k, **kw)
    with pytest.raises(ValueError, match="one query position"):
        tfd.flash_decode(torch.randn(2, 2, 4, 16), k, k, window=4,
                         q_positions=torch.tensor([4, 5], dtype=torch.int32),
                         kv_positions=kw["kv_positions"])


def _bad_inputs():
    q, k = torch.zeros(1, 4, 4, 16), torch.zeros(1, 6, 2, 16)
    qp, kp = torch.arange(4, dtype=torch.int32), torch.arange(6, dtype=torch.int32)
    ok = dict(q=q, k=k, v=k, q_positions=qp, kv_positions=kp, window=None,
              logit_cap=None)
    return {
        "fp16": dict(ok, q=q.half(), k=k.half(), v=k.half()),
        "mixed dtypes": dict(ok, v=k.bfloat16()),
        "hd not a multiple of 8": dict(ok, q=torch.zeros(1, 4, 4, 12),
                                       k=torch.zeros(1, 6, 2, 12),
                                       v=torch.zeros(1, 6, 2, 12)),
        "hd above 256": dict(ok, q=torch.zeros(1, 4, 4, 264),
                             k=torch.zeros(1, 6, 2, 264),
                             v=torch.zeros(1, 6, 2, 264)),
        "Hq not a multiple of Hkv": dict(ok, k=torch.zeros(1, 6, 3, 16),
                                         v=torch.zeros(1, 6, 3, 16)),
        "non-contiguous q": dict(ok, q=torch.zeros(1, 4, 16, 4).transpose(2, 3)),
        "q off a 16-byte boundary": dict(ok, q=torch.zeros(257)[1:].view(1, 4, 4, 16)),
        "int64 positions": dict(ok, q_positions=qp.long()),
        "wrong position length": dict(ok, kv_positions=kp[:5]),
        "window 0": dict(ok, window=0),
        "cap 0": dict(ok, logit_cap=0.0),
    }


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_kernel_wrapper_rejects(name):
    args = _bad_inputs()[name]
    with pytest.raises(ValueError):
        tfa.check_inputs(args["q"], args["k"], args["v"], args["q_positions"],
                         args["kv_positions"], args["window"],
                         args["logit_cap"])


# (dtype, head dim, logit cap, body): bf16 at hd 128 without a cap takes the
# sm90 body (TMA and wgmma), any other bf16 call the mma body, fp32 the simt
# body
BODY_CASES = [
    (torch.bfloat16, 128, None, "sm90"),
    (torch.bfloat16, 128, 50.0, "mma"),
    (torch.bfloat16, 256, None, "mma"),
    (torch.bfloat16, 256, 50.0, "mma"),
    (torch.bfloat16, 64, None, "mma"),
    (torch.bfloat16, 32, None, "mma"),
    (torch.bfloat16, 136, None, "mma"),
    (torch.float32, 128, None, "simt"),
    (torch.float32, 64, None, "simt"),
    (torch.float32, 256, 50.0, "simt"),
]


@pytest.mark.parametrize("dtype, hd, cap, want", BODY_CASES, ids=str)
def test_flash_fwd_body_rule(dtype, hd, cap, want):
    assert tfa.body(dtype, hd, cap) == want
    # the cases take every body the dispatch ledger counts, flash_fwd.<body>
    assert {case[-1] for case in BODY_CASES} == {"sm90", "mma", "simt"}


# the architectures whose bf16 forward calls of K1 take the sm90 body (hd
# 128, no cap); gemma2 (hd 256, cap 50), recurrentgemma (hd 256) and
# whisper-tiny (hd 64) keep the mma body; rwkv6 runs no attention
SM90_ARCHS = ["qwen3-4b", "qwen2-7b", "phi4-mini-3.8b", "chameleon-34b",
              "mixtral-8x22b", "qwen3-moe-235b-a22b"]
MMA_ARCHS = ["gemma2-2b", "recurrentgemma-9b", "whisper-tiny"]


@pytest.mark.parametrize("arch", SM90_ARCHS + MMA_ARCHS)
def test_flash_fwd_body_of_each_architecture(arch):
    from repro_torch.models import get_config

    cfg = get_config(arch)
    want = "sm90" if arch in SM90_ARCHS else "mma"
    assert tfa.body(torch.bfloat16, cfg.hd, cfg.attn_logit_softcap) == want
    assert tfa.body(torch.float32, cfg.hd, cfg.attn_logit_softcap) == "simt"


def test_build_targets_hopper_from_the_repo_sources():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "-shared" in build.LINK_FLAGS and "-shared" not in build.NVCC_FLAGS
    names = [src.name for src in build.SOURCES]
    assert names == sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert {"flash_fwd.cu", "flash_decode.cu", "rglru_scan.cu",
            "wkv6_scan.cu"} <= set(names)
    assert all(src.parent == build.CSRC for src in build.SOURCES)
    path = build.library_path()
    assert path.parent == build.BUILD_DIR and path == build.library_path()
    assert path.name.startswith(build.LIB_NAME + "-")
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """flash_common.cuh is compiled into two sources, not on its own: a
    change to it must still give the library another name."""
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    assert (tmp_path / "flash_common.cuh").exists()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path()
    (tmp_path / "flash_common.cuh").write_text("// changed\n")
    assert build.library_path() != before
    assert "flash_common.cuh" not in [s.name for s in build.SOURCES]
