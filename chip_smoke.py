#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; each one that fails raises, and the process exits non-zero:

1. The card: nvidia-smi's name and power limit, torch's device name. TF32
   is switched off, so fp32 matrix products are full fp32. The caching
   allocator takes expandable segments (training fragments it otherwise).
2. Build the kernels with nvcc from the checkout's sources, one nvcc per
   source, all started together; print the seconds and ``-Xptxas -v``;
   count the HMMA (tensor-core) instructions of K1b's dk/dv and dq kernels
   and of K3b's matrix kernels (its chunk states and chunk cotangents)
   in the library (cuobjdump -sass), none of which may lack them.
3. Hold each kernel against its plain PyTorch version on the card, in fp32
   and bf16 inputs, and time each (CUDA events, after warm-up, inputs
   rotated through copies larger than the L2 cache) beside the plain
   version, a library call where one computes the same function (never
   called by the port) and the bound computed from the inputs:
   K1 as flash_fwd (more than one query position) at tests/test_kernels.py's
   FLASH_CASES shapes and the prefill of every served arch and attention
   kind, and as flash_decode (one query position, split over the keys) at
   their ring decodes (see serve_attention_cases), a wrapped ring with empty
   slots, a half-empty ring and a ring where every split but one is empty,
   and whisper-tiny's calls (whisper_attention_cases: the encoder's
   non-causal [8, 1500], the decoder's prefill, cross prefill 32 x 1500,
   the ring decode and the cross decode over 1500 frames); at the
   benchmark cells' calls (SM90_CASES: qwen3-moe's prefill strata, mixtral's
   1500, qwen3-4b's training forward with its LSE) K1's sm90 body beside the
   mma body it replaced on the same call, SDPA and the bound;
   K2 (rglru_scan) at RGLRU_CASES shapes, a ragged
   chunked shape and recurrentgemma's prefill and decode; K3 (wkv6_scan) at
   RWKV_CASES shapes, a ragged chunked shape, rwkv6-3b's prefill and decode;
   each scan case through both bodies (sequential and chunked, the plan's
   choice and the other), against the sequential plain version; state
   chaining for both scans; the scans' backwards K2b (rglru_bwd) and K3b
   (wkv6_bwd) at a ragged shape and at the training shapes of phase 6,
   against their plain versions, two runs bit for bit, each of their
   launches timed at the training shapes (torch.profiler): K2b's maps,
   carry, rescan and da_log sum, K3b's chunk states, chunk cotangents,
   walk (dv inside it) and du sum. The MoE layer's grouped expert kernel
   (moe_gemm: gate-up, then down) at mixtral's prefill strata 945 / 1500 /
   2381 and a 256-slot decode, and at qwen3-moe's 512-token prefill and
   8-slot decode (MOE_GEMM_CASES), each launch against its plain version,
   timed beside the capacity path's bmm products on the same tokens and
   beside torch._grouped_mm on the same rows; the no-grad MoE layer run
   under set_sync_debug_mode("error") and its device launches a call
   against the capacity path's (MOE_PATH_CASES).
4. Each served arch at full width and reduced depth (see MODEL_CHECKS: 2
   layers, recurrentgemma-9b one (rec, rec, local) group and gemma2-2b one
   (local, attn) group, each with prompts past its window): in fp32, decode
   matches a longer prefill; in bf16, the kernel path matches the all-plain
   path with the same weights. The MoE archs (phase_moe_model): decode
   against a longer prefill in fp32 and bf16 at a drop-free capacity
   factor, rows with a flipped route counted and left out (none in fp32);
   at the config's own factor the bf16 kernel path against the plain path
   pinned to its routes, each layer's dropped assignments and the routes
   the unpinned plain path picks otherwise printed. whisper-tiny at full
   depth (4 enc + 4 dec), each sequence over its own 1500 frames.
5. Serve each model (see SERVES: the nine archs, chameleon-34b at 32 of
   its 48 layers and the MoE archs at 6, the others at full depth; bf16
   weights and compute,
   weights from a seeded torch.Generator) through ``Server``, two
   synchronised waves of 16 requests. The port's dispatch ledger is reset
   just before the run and read just after: each kernel must have launched
   exactly (its layers) x (its calls) times: flash_fwd once a request
   (prefill), each on the arch's body (K1_SM90_ARCHS: sm90 at hd 128, mma
   otherwise), flash_decode once a decode step, the MoE expert kernel twice
   a MoE layer call, every such call on the grouped path, the scans once
   each, the
   prefills through the scans' chunked bodies and the decode steps through
   their sequential bodies (the ledger counts each body), no
   backward. The first tokens must equal a direct prefill's; a
   torch.profiler trace shows where a prefill's and a decode step's time
   goes, for the MoE archs by step of the MoE layer (router, positions,
   dispatch scatter, expert GEMMs, combine, aux loss). Each model is freed
   before the next. Then moe_mlp_ep over a one-rank NCCL group equals
   moe_mlp bit for bit, forward and gradients, on one full-width layer of
   each MoE arch, and the two halves of tp 2 through _local_moe (each a
   held range on M1, no gradient) sum to moe_mlp within 2^-6 of its
   largest |y| (phase_ep). whisper-tiny (phase_serve_whisper) is served
   as the reference serves it, through Backbone.prefill and decode_step
   (its Server takes no frames): two waves of 8 requests with their own
   frames, the counts set to 0 before each wave, flash_fwd exactly 12 a
   prefill and flash_decode 8 a decode step, and the encoder's pass one
   ``layer_views.unbind`` a prefill.
6. Training. K1 with its LSE against the plain LSE; K1b (flash_bwd: delta,
   dkdv, dq, and reduce where its plan splits the dk/dv grid) against
   flash_bwd_plain in fp32 and bf16 (causal, GQA 32/8, 28/4 and 24/8, MQA
   16/1, softcap 50, window 2048 at hd 256, gemma2-2b's 8/4 at hd 256 with
   window 4096 and softcap 50, empty kv slots, whisper-tiny's encoder,
   cross (Sq != Skv) and decoder shapes), two runs bit for bit, timed
   beside the plain version, SDPA forward + backward and the bound. Then
   qwen3-4b at full width, depth 8 (see TRAIN): one microbatch of [1, 512]
   through loss_fn and the backward on the kernel path and on the plain path
   from the same fp32 parameters (bf16 compute, remat on), the loss and
   every leaf's gradient compared, with exact launch counts; then the
   ``Trainer`` of launch/train.py takes 6 steps of 4 x 2048 tokens, each
   committed through the transactional store, with exact launch counts
   (flash_fwd and each kernel of flash_bwd once a layer and step, and
   ``layer_views.unbind`` once a group and step), finite
   and falling loss, step ms, tokens/s, peak memory and a profiled step's
   idle share. The same gradient check for gemma2-2b at depth 2 (one
   (local, attn) group) past its window, and for recurrentgemma-9b (one
   (rec, rec, local) group) and rwkv6-3b (8 layers in fp32 compute and 2 in
   bf16; at 8 layers its two bf16 paths against the fp32 plain path, see
   bf16_witness), which then take 6
   ``Trainer`` steps each with remat on (see OTHER_TRAIN): exact launches
   of rglru_scan (twice a rec layer and step) and rglru_bwd, wkv6_scan and
   wkv6_bwd, K1 and K1b in recurrentgemma's local layer, a falling loss,
   step ms, tokens/s, peak memory, a profiled step. The MoE archs' gradient
   check at one layer (see MOE_TRAIN), fp32 and bf16 compute, remat's
   recomputed routes equal to the forward's, the route flips counted, the
   bf16 plain path pinned to the kernel path's routes; then each MoE arch's
   ``Trainer`` at full width and one layer, 6 steps with remat (mixtral
   [1, 4200], qwen3-moe [1, 512]; K1 with its LSE twice and each K1b pass
   once a step), a falling loss, its peak beside the card's name and power
   limit. Every ``Trainer`` step, and the profiled step after it, donates
   its state (the reference jits its step with donate_argnums=(0,)): each
   cell's peak is printed beside its peak when the step was functional
   (FUNCTIONAL_PEAK_GB). whisper-tiny at full
   depth: the gradient check at [2, 448] tokens over 1500 frames in fp32
   and bf16 compute, then 6 ``Trainer`` steps of 16 x 448 tokens and 16 x
   1500 frames, remat off (flash_fwd and each K1b pass 12 a step: 4
   encoder, 4 self, 4 cross), a falling loss. Then a crash at
   step 13 of the reduced qwen3-4b and its restart from the step-8
   checkpoint match an uninterrupted run. Finally the donating step
   against the functional step at the reduced qwen3-4b, 3 steps, bit for
   bit (donate_check).
7. Distribution (phase_dist): qwen3-4b as phase 6 trains it (8 layers,
   [4, 2048]), 3 donating steps on plain tensors and 3 from the same seed on a
   (data 1, model 1) DeviceMesh over a one-rank NCCL group, the state under
   ZeRO-3 shardings with the per-layer gather: the losses and every
   parameter bit for bit, K1 with its LSE and each K1b pass once a layer
   and step (the path "qwen3-4b dist train" of the kernels line), step ms
   and a profiled step of each. Then, in a subprocess that sees no card,
   the fake-mesh dry run (launch/dryrun.py) of whisper-tiny x train_4k on
   256 and 512 ranks and qwen3-4b x train_4k on 256, and the cost counter
   over the step above on a fake (1, 1) mesh: its FLOPs beside
   model_flops and the measured step. Then the reference's remat_policy
   (phase_remat, see REMAT): qwen3-4b at phase 6's cell with remat off,
   "full" and "dots", rwkv6-3b at its cell with "full" and "dots", each
   from the same seed: the first batch's gradients bit for bit against the
   first configuration's, equal losses over 3 donating steps, peak
   memory, device (CUDA events) and host ms a step, a profiled step, exact
   launches (K1 and the scans' forwards twice a layer and step under
   either policy: "dots" saves products, not kernels' outputs; the group's
   layer views once a group and step, outside the recompute); and the
   dry run of qwen3-4b x train_4k x single under both policies ("dots"
   counts "full"'s FLOPs less the saved products' forward FLOPs).
8. The OptSVA-CF wire (phase_net): two node servers spawned with
   repro_torch.dtm.spawn_server and reached with dtm.connect; the
   transport-equivalence schedule in-process, over TCP and under simnet
   with equal traces; qwen3-4b's parameters at full width and 2 layers
   (fp32, initialised on the card, 2.36 GB) bound as StateCells on node 0,
   published by a write transaction and read back by an irrevocable
   read-only one, bit for bit, with the commit and snapshot seconds and
   GB/s; neither server among the card's compute apps. No kernel runs.
9. Print the kernels line (eight kernels: flash_fwd, flash_decode,
   rglru_scan, wkv6_scan, flash_bwd, rglru_bwd, wkv6_bwd, moe_gemm), the
   card line and the result line.

It exits 2 without a CUDA device, and fails where the repo's sources are
absent.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

# Expandable segments, set before torch first allocates on the card:
# training's large tensors of many sizes (vocab logits of 2.6-5.2 GB, a
# 4.2 GB fp32 embedding with its AdamW state) otherwise fragment the caching
# allocator until recurrentgemma-9b's training runs out of memory with a
# quarter of the card reserved but unallocated.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F

SEED = 0
DEVICE = "cuda"
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM, dense
PEAK_BYTES = 3.35e12                                         # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20
# kernel vs plain, (atol, rtol): |got - want| <= atol + rtol * |want|. fp32
# sums in another order. In bf16 both round an fp32 result that differs by
# about 1e-6 to bf16 once, so they differ by at most one bf16 ulp of |want|
# (2**-7 of it); the limit allows two, over a floor far above fp32's error.
TOL = {torch.float32: (5e-5, 5e-5), torch.bfloat16: (1e-4, 2.0 ** -6)}
# The bf16 attention bodies run P V on the tensor cores with P rounded to
# bf16 (the plain version and the fp32 Pallas kernel keep it fp32): each
# probability moves by at most 2**-8 of itself, so an output moves by at
# most 2**-8 of the probability-weighted mean of |v|, which the plain side
# computes as attention_plain(q, k, |v|). The bf16 limit adds that term.
P_ROUND = 2.0 ** -8
# The scans return fp32 whatever their input type, and both sides see the
# same input values, so bf16 inputs keep the fp32 limit (atol = rtol), the
# JAX tests' limits for the two kernels: 1e-5 for K2 (the sequential body
# does the plain version's operations in its order, only expf, log1pf and
# sqrtf round differently; the chunked body composes the same a_t, b_t into
# chunk maps and a carry, which regroups the chain's products and sums by a
# few fp32 ulps), 2e-4 for K3 (the sequential body sums y's 64 products in
# another order; the chunked body runs its products in 3xTF32 and its
# decays as exp of sums of log w).
SCAN_TOL = {"rglru_scan": 1e-5, "wkv6_scan": 2e-4}
MODEL_FP32_TOL = 2e-3      # decode vs longer prefill (tests/test_models.py)
MODEL_BF16_TOL = 0.125     # kernel vs plain path: a few bf16 ulps of a logit
# K1's LSE against attention_lse_plain: fp32 on both sides from the same
# inputs, so the fp32 limit (atol = rtol) in both dtypes, on rows with a
# valid key. K1b against flash_bwd_plain: both take the same out, lse and
# dout and sum in fp32, so TOL holds for each of dq, dk and dv; K1b's bf16
# body also rounds p and ds to bf16 before the products that take them (as
# K1 rounds P), each by at most 2**-8 of itself, so its bf16 limit adds
# ref.flash_bwd_rounding_plain: 2**-8 of |p|ᵀ|dout| (dv), |ds|ᵀ|q| (dk) and
# |ds||k| (dq).
LSE_TOL = 5e-5
# The training model's kernel path against its plain path (bf16 compute):
# K1's tensor-core body rounds P to bf16, which moves activations by bf16
# ulps through 8 layers and back. The loss within 2**-6 of itself, each
# leaf's gradient within 2**-4 of its norm (normwise: a leaf's entries are
# sums of many terms of both signs).
TRAIN_LOSS_RTOL = 2.0 ** -6
TRAIN_GRAD_RTOL = 2.0 ** -4
# rwkv6-3b's check at its 8 training layers runs in fp32 compute: the loss
# within 1e-5 of itself, each leaf within 2**-10 of its norm (the two paths
# sum in other orders). In bf16 compute the two paths' gradients are far
# apart at 8 layers at random init, so its bf16 check runs at 2 layers
# (TRAIN_GRAD_RTOL), and bf16_witness holds both bf16 paths at 8 layers
# against the fp32 plain path: the kernel path's worst leaf may stand no
# further from it than WITNESS_RATIO times the plain path's, and each
# path's loss within TRAIN_LOSS_RTOL of the reference's.
TRAIN_FP32_LOSS_RTOL = 1e-5
TRAIN_FP32_GRAD_RTOL = 2.0 ** -10
WITNESS_RATIO = 1.5
TRAIN_RESTART_RTOL = 1e-4  # the embedding's backward uses atomics on the card
TRAIN = dict(depth=8, batch=4, seq=2048, steps=6, grad_seq=512)
# The other models' training at full width (phase 6), bf16 compute, fp32
# parameters and AdamW state: gemma2-2b's gradient check at depth 2, past its
# 4096-token window; recurrentgemma-9b one (rec, rec, local) group, 2 x 2560
# tokens (its 2048 window masks); rwkv6-3b 8 layers, 4 x 2048 tokens. Remat
# on for the recurrent models, so each scan's forward runs twice a layer
# and step.
OTHER_TRAIN = {
    "gemma2-2b": dict(groups=((("local", "attn"), 1),), grad_seq=4200),
    "recurrentgemma-9b": dict(groups=((("rec", "rec", "local"), 1),), batch=2,
                              seq=2560, steps=6, grad_seq=512, remat=True),
    "rwkv6-3b": dict(groups=((("rwkv",), 8),), batch=4, seq=2048, steps=6,
                     grad_seq=256, remat=True, grad_dtype=torch.float32,
                     bf16_groups=((("rwkv",), 2),)),
}
# The MoE archs' gradient checks (phase 6), one layer, in fp32 and bf16
# compute: mixtral past its 4096-token window. Each arch's Trainer then
# takes 6 steps at full width and one layer, bf16 compute, fp32 parameters
# and AdamW state, remat on: mixtral [1, 4200], 2.907 B parameters, 46.5 GB
# of state and gradients; qwen3-moe [1, 512], 3.732 B, 59.7 GB. Both fit
# the card because the step donates its state: a functional step's second
# params, m and v would add 34.9 and 44.8 GB (PERF.md, section 4).
MOE_TRAIN = {
    "mixtral-8x22b": dict(groups=((("local",), 1),), grad_seq=4200,
                          trainer=dict(batch=1, seq=4200, steps=6,
                                       remat=True)),
    "qwen3-moe-235b-a22b": dict(groups=((("attn",), 1),), grad_seq=512,
                                trainer=dict(batch=1, seq=512, steps=6,
                                             remat=True)),
}
# The peak of each Trainer cell, GB, measured on an H100 80GB HBM3 at 700 W
# when its step was functional (it held a second params, m and v while the
# update ran; PERF.md, section 4); printed beside the donating step's peak.
FUNCTIONAL_PEAK_GB = {"qwen3-4b": 54.4, "recurrentgemma-9b": 48.34,
                      "rwkv6-3b": 29.58, "whisper-tiny": 10.48,
                      "qwen3-4b dist train": 68.78}
# K2b and K3b against their plain versions: both compute in fp32 from the
# same inputs, so each gradient is held within SCAN_BWD_TOL of itself plus
# SCAN_BWD_TOL of its tensor's largest entry (an entry is a sum of terms up
# to that size): 1e-5 for K2b (the plain version's operations, regrouped
# into chunk maps and a carry; expf, log1pf, sqrtf and the sigmoid round
# otherwise), 2e-4 for K3b (its chunk states and cotangents from 3xTF32
# products and carries, its sums of 64 products in another order). A bf16
# gradient is rounded to bf16 once by both, which adds two bf16 ulps of
# itself.
SCAN_BWD_TOL = {"rglru_bwd": 1e-5, "wkv6_bwd": 2e-4}
BF16_GRAD_RTOL = 2.0 ** -6
# whisper-tiny at full width and full depth (4 enc + 4 dec layers, MHA 6/6
# at hd 64), served and trained through Backbone (the reference's Server
# takes no frames): serving in two waves of `slots` requests, each request
# with its own enc_seq frames, a prompt_len-token prompt and max_new new
# tokens at ctx 448, Whisper's text context (n_text_ctx, Radford et al.
# 2022); each wave one batched prefill, then max_new - 1 decode steps.
# Training: the Trainer at batch x seq tokens (and frames), remat off; the
# gradient check at [grad_batch, grad_seq].
WHISPER = dict(slots=8, ctx=448, requests=16, prompt_len=32, max_new=64,
               batch=16, seq=448, steps=6, grad_batch=2, grad_seq=448)
# K1b cases: (name, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, empty kv
# slots)
BWD_CASES = [
    ("gqa_32_8", 1, 512, 512, 32, 8, 128, True, None, None, False),
    ("softcap_50", 1, 200, 200, 32, 8, 128, True, None, 50.0, False),
    ("window_2048_hd256", 1, 2100, 2100, 16, 1, 256, True, 2048, None, False),
    ("mqa_16_1_empty_slots", 2, 300, 300, 16, 1, 128, True, None, None, True),
    # odd groups: a 16-row fragment straddles query positions
    ("gqa_28_4_qwen2", 1, 320, 320, 28, 4, 128, True, None, None, False),
    ("gqa_24_8_phi4", 2, 256, 256, 24, 8, 128, True, None, None, True),
    # gemma2-2b: 8/4 at hd 256, window 4096 and softcap 50, past the window
    ("gemma2_window_softcap", 1, 4200, 4200, 8, 4, 256, True, 4096, 50.0,
     False),
    ("qwen3_train", TRAIN["batch"], TRAIN["seq"], TRAIN["seq"], 32, 8, 128,
     True, None, None, False),
    # mixtral-8x22b's local layers: 48/8 (G 6), window 4096, past it
    ("mixtral_window", 1, 4200, 4200, 48, 8, 128, True, 4096, None, False),
    # whisper-tiny's training step: the encoder over 1500 frames, not
    # causal (a ragged last key tile); cross-attention from the 448 text
    # positions to the frames (Sq != Skv); the decoder's causal
    # self-attention
    ("whisper_encoder", WHISPER["batch"], 1500, 1500, 6, 6, 64, False, None,
     None, False),
    ("whisper_cross", WHISPER["batch"], WHISPER["seq"], 1500, 6, 6, 64,
     False, None, None, False),
    ("whisper_decoder", WHISPER["batch"], WHISPER["seq"], WHISPER["seq"], 6,
     6, 64, True, None, None, False),
]

# (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap) of FLASH_CASES
FLASH_SHAPES = [
    (1, 64, 64, 4, 4, 32, True, None, None),
    (2, 96, 96, 4, 2, 32, True, None, None),
    (2, 64, 64, 8, 1, 16, True, None, None),
    (1, 80, 80, 4, 2, 32, True, 16, None),
    (1, 64, 64, 4, 2, 32, True, None, 30.0),
    (1, 64, 64, 4, 2, 32, False, None, None),
    (1, 72, 72, 4, 2, 24, True, 32, 50.0),
    (2, 64, 64, 4, 2, 32, True, None, None),
]
# Serving runs: two synchronised waves of `requests / slots` requests each.
# recurrentgemma's and gemma2's prompts are longer than their 2048- and
# 4096-token windows, so their local rings wrap in prefill and in decode.
# chameleon-34b serves 32 of its 48 layers: 0.69 B parameters a layer, so 48
# layers and the embeddings are 68.6 GB in bf16, which leaves no room on an
# 80 GB card for the init's fp32 draw of a stacked leaf, the cache and the
# activations; 32 layers are 46.4 GB (PERF.md, section 4).
SERVES = {
    "qwen3-4b": dict(slots=8, ctx=1024, requests=16, prompt_len=512, max_new=32),
    "recurrentgemma-9b": dict(slots=8, ctx=4096, requests=16, prompt_len=2560,
                              max_new=32),
    "rwkv6-3b": dict(slots=8, ctx=1024, requests=16, prompt_len=512, max_new=32),
    "gemma2-2b": dict(slots=8, ctx=4608, requests=16, prompt_len=4200,
                      max_new=32),
    "qwen2-7b": dict(slots=8, ctx=1024, requests=16, prompt_len=512, max_new=32),
    "phi4-mini-3.8b": dict(slots=8, ctx=1024, requests=16, prompt_len=512,
                           max_new=32),
    "chameleon-34b": dict(slots=8, ctx=1024, requests=16, prompt_len=512,
                          max_new=32, depth=32),
    # the MoE archs at 6 layers: a layer holds 2.42 B expert parameters
    # (4.8 GB in bf16), and the init draws a stacked expert leaf in fp32
    # (6 x 8 x 6144 x 16384 x 4 bytes = 19.3 GB) before it casts (PERF.md,
    # section 4). mixtral's prompts pass its 4096-token window.
    "mixtral-8x22b": dict(slots=8, ctx=4608, requests=16, prompt_len=4200,
                          max_new=32, depth=6),
    "qwen3-moe-235b-a22b": dict(slots=8, ctx=1024, requests=16,
                                prompt_len=512, max_new=32, depth=6),
}
SERVE = SERVES["qwen3-4b"]
RG = SERVES["recurrentgemma-9b"]
RW = SERVES["rwkv6-3b"]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def free_memory() -> None:
    """Give a finished phase's tensors back to the card: reference cycles
    (the trainer's, autograd's) hold tensors until Python's cyclic collector
    runs, and a later phase's peak memory would count them."""
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------------------- #
# Phase 3: the kernel against its plain version                               #
# --------------------------------------------------------------------------- #
def _valid(qp, kp, causal, window):
    dpos = qp[:, None].long() - kp[None, :].long()
    ok = (kp[None, :] >= 0).expand(dpos.shape)
    if causal:
        ok = ok & (dpos >= 0)
    if window is not None:
        ok = ok & (dpos < window)
    return ok


def attention_bound(q, k, qp, kp, causal, window, extra_bytes=0):
    """(ms, 'bytes' | 'operations'): the least time for this call's work.
    Operations: 4*hd per valid (query, key) pair per query head. Bytes: q and
    out, K and V of the keys some query sees, the positions and
    ``extra_bytes`` (the LSE where it is written)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    ok = _valid(qp, kp, causal, window)
    pairs = int(ok.sum())
    live = int(ok.any(0).sum())
    flops = 4.0 * hd * Hq * B * pairs
    nbytes = (q.element_size() * (2 * q.numel() + 2 * B * live * Hkv * hd)
              + 4 * (Sq + kp.numel()) + extra_bytes)
    t_ops, t_bytes = flops / PEAK_FLOPS[q.dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def rotating(fn, inputs):
    """A call of ``fn`` that takes the next set of ``inputs`` each time."""
    i = [0]

    def call():
        i[0] = (i[0] + 1) % len(inputs)
        return fn(*inputs[i[0]])
    return call


def n_buffers(nbytes: int) -> int:
    """Sets of inputs to rotate through so that they exceed the L2 twice."""
    return max(1, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


def kernel_case(name, kernel, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap,
                dtype, qpos=None, kpos=None):
    """K1 as ``kernel`` (flash_fwd or flash_decode) against attention_plain."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ref

    fn = {"flash_fwd": fa.flash_fwd, "flash_decode": fd.flash_decode}[kernel]

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    in_bytes = (B * Sq * Hq + 2 * B * Skv * Hkv) * hd * (4 if dtype == torch.float32 else 2)
    nbuf = n_buffers(in_bytes)
    bufs = [tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((B, Sq, Hq, hd), (B, Skv, Hkv, hd),
                                (B, Skv, Hkv, hd)))
            for _ in range(nbuf)]
    qp = (torch.arange(Sq, dtype=torch.int32) if qpos is None
          else torch.as_tensor(qpos, dtype=torch.int32)).to(dev)
    kp = (torch.arange(Skv, dtype=torch.int32) if kpos is None
          else torch.as_tensor(kpos, dtype=torch.int32)).to(dev)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_positions=qp,
              kv_positions=kp)
    q, k, v = bufs[0]
    got = fn(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.attention_plain(q, k, v, **kw).float()
    err = (got.float() - want).abs()
    atol, rtol = TOL[dtype]
    limit = atol + rtol * want.abs()
    if dtype == torch.bfloat16:
        limit += P_ROUND * ref.attention_plain(q.float(), k.float(),
                                               v.float().abs(), **kw)
    max_err = float(err.max())
    if not bool((err <= limit).all()):
        raise AssertionError(f"{name} {kernel} {dtype}: kernel disagrees with "
                             f"the plain version, max abs err {max_err} (atol "
                             f"{atol}, rtol {rtol}, P rounding "
                             f"{P_ROUND if dtype == torch.bfloat16 else 0})")
    del want, limit, err

    ms = time_ms(rotating(lambda a, b, c: fn(a, b, c, **kw), bufs))
    plain_ms = time_ms(rotating(
        lambda a, b, c: ref.attention_plain(a, b, c, **kw), bufs), iters=5)
    library_ms = None
    if cap is None:  # SDPA has no softcap
        # [B,H,S,hd] views with KV repeated to Hq heads, made before timing
        G = Hq // Hkv
        lib_bufs = [(a.transpose(1, 2), b.repeat_interleave(G, 2).transpose(1, 2),
                     c.repeat_interleave(G, 2).transpose(1, 2))
                    for a, b, c in bufs]
        aligned = qpos is None and kpos is None and window is None and causal
        ok = _valid(qp, kp, causal, window)
        # a call that is not causal and sees every key needs no mask
        mask = None if aligned or (not causal and bool(ok.all())) else ok
        library_ms = time_ms(rotating(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, attn_mask=mask, is_causal=aligned), lib_bufs))
        del lib_bufs
    bound_ms, bound_by = attention_bound(q, k, qp, kp, causal, window)
    row = dict(kernel=kernel, case=name,
               dtype=str(dtype).replace("torch.", ""),
               shape=[B, Sq, Skv, Hq, Hkv, hd], causal=causal, window=window,
               logit_cap=cap, max_abs_err=max_err, atol=atol, rtol=rtol, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    log(f"[kernel] {kernel} {name:>22} {row['dtype']:>8} err {max_err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


def _ring(C, first, last):
    """kv positions of a C-slot ring holding first..last at slots p % C."""
    ring = np.full((C,), -1, np.int32)
    for p in range(first, last + 1):
        ring[p % C] = p
    return ring


# short names of the served archs in the kernel rows
TAGS = {"qwen3-4b": "qwen3", "recurrentgemma-9b": "rgemma", "rwkv6-3b": "rwkv6",
        "gemma2-2b": "gemma2", "qwen2-7b": "qwen2", "phi4-mini-3.8b": "phi4",
        "chameleon-34b": "chameleon", "mixtral-8x22b": "mixtral",
        "qwen3-moe-235b-a22b": "qwen3moe"}


# K1's forward body for an arch's calls, as the runs must show it
# (kernels/flash_attention.body decides from dtype, head dim and cap): bf16
# at hd 128 without a cap on the sm90 body (csrc/flash_fwd_sm90.cu);
# gemma2 (hd 256, cap 50), recurrentgemma (hd 256) and whisper-tiny (hd 64)
# on the mma body; fp32 on the simt body
K1_SM90_ARCHS = ("qwen3-4b", "qwen2-7b", "phi4-mini-3.8b", "chameleon-34b",
                 "mixtral-8x22b", "qwen3-moe-235b-a22b")


def k1_body(arch, dtype):
    if dtype != torch.bfloat16:
        return "simt"
    return "sm90" if arch in K1_SM90_ARCHS else "mma"


def mma_body(q, k, v, kw, return_lse=False):
    """flash_fwd.cu's mma.sync body on a bf16 call, through the library's
    entry point (the wrapper sends bf16 at hd 128 to the sm90 body): the
    yardstick of the sm90 body's lines. The port never calls it so."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    B, Sq, Hq, hd = q.shape
    _, Skv, Hkv, _ = k.shape
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hkv, Hq // Hkv, Sq), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    rc = build.entry("flash_fwd", fa.FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kw["q_positions"].data_ptr(),
        kw["kv_positions"].data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Skv, Hq, Hkv, hd, 1,
        int(kw["causal"]), kw["window"] or 0, 0.0, float(hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch("flash_fwd.mma", rc)
    return (out, lse) if return_lse else out


# K1 at the benchmark cells' calls, bf16 at hd 128, causal: (name, B, S, Hq,
# Hkv, with LSE): qwen3-moe's prefill strata, mixtral's middle one, qwen3-4b's
# training forward
SM90_CASES = [
    ("qwen3moe_945", 1, 945, 64, 4, False),
    ("qwen3moe_1500", 1, 1500, 64, 4, False),
    ("qwen3moe_2381", 1, 2381, 64, 4, False),
    ("mixtral_1500", 1, 1500, 48, 8, False),
    ("qwen3_train_lse", 4, 2048, 32, 8, True),
]


def sm90_case(name, B, S, Hq, Hkv, lse):
    """K1's sm90 body at one cell's call: against attention_plain (and
    attention_lse_plain with the LSE), timed (CUDA events, inputs rotated
    past the L2) beside the mma body it replaced on the same call, SDPA with
    KV repeated (never called by the port) and the bound."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    G, hd = Hq // Hkv, 128
    nbuf = n_buffers((B * S * Hq + 2 * B * S * Hkv) * hd * 2)
    bufs = [tuple(torch.randn(shape, generator=gen, device=dev).bfloat16()
                  for shape in ((B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
            for _ in range(nbuf)]
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=None, logit_cap=None, q_positions=pos,
              kv_positions=pos)
    q, k, v = bufs[0]
    before = ledger().get("flash_fwd.sm90", 0)
    got = fa.flash_fwd(q, k, v, return_lse=lse, **kw)
    torch.cuda.synchronize()
    if ledger().get("flash_fwd.sm90", 0) != before + 1:
        raise AssertionError(f"{name}: flash_fwd did not take the sm90 body")
    out, got_lse = got if lse else (got, None)
    want = ref.attention_plain(q, k, v, **kw).float()
    atol, rtol = TOL[torch.bfloat16]
    limit = atol + rtol * want.abs() + P_ROUND * ref.attention_plain(
        q.float(), k.float(), v.float().abs(), **kw)
    err = (out.float() - want).abs()
    if not bool((err <= limit).all()):
        raise AssertionError(f"{name}: the sm90 body disagrees with the plain "
                             f"version, max abs err {float(err.max())}")
    lse_err = None
    if lse:
        _, want_lse = ref.attention_lse_plain(q, k, v, **kw)
        lse_err = float((got_lse - want_lse).abs().max())
        if lse_err > LSE_TOL:
            raise AssertionError(f"{name}: LSE err {lse_err}")
    max_err = float(err.max())
    del want, limit, err
    ms = time_ms(rotating(lambda a, b, c: fa.flash_fwd(
        a, b, c, return_lse=lse, **kw), bufs))
    mma_ms = time_ms(rotating(lambda a, b, c: mma_body(a, b, c, kw, lse), bufs))
    lib_bufs = [(a.transpose(1, 2), b.repeat_interleave(G, 2).transpose(1, 2),
                 c.repeat_interleave(G, 2).transpose(1, 2)) for a, b, c in bufs]
    library_ms = time_ms(rotating(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True), lib_bufs))
    del lib_bufs
    bound_ms, bound_by = attention_bound(q, k, pos, pos, True, None,
                                         extra_bytes=4 * B * Hq * S if lse else 0)
    row = dict(kernel="flash_fwd", case=f"{name}_sm90", dtype="bfloat16",
               body="sm90", shape=[B, S, S, Hq, Hkv, hd], causal=True,
               window=None, logit_cap=None, max_abs_err=max_err,
               lse_err=lse_err, ms=ms, mma_ms=mma_ms, plain_ms=None,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    log(f"[kernel] flash_fwd sm90 {name:>16} err {max_err:.3e}"
        + (f" lse err {lse_err:.3e}" if lse else "")
        + f" sm90 {ms:.4f} ms mma {mma_ms:.4f} ms ({mma_ms / ms:.2f}x) library "
        f"{library_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}): "
        f"{100 * bound_ms / ms:.1f}% of the bound, mma "
        f"{100 * bound_ms / mma_ms:.1f}%")
    return row


def serve_attention_cases():
    """K1's calls as phase 5 makes them, for each served arch and each of its
    attention kinds (gemma2-2b's local and global layers): the prefill of one
    request, flash_fwd at [1, prompt_len]; the last decode step of a wave,
    flash_decode over all slots against the layer's ring (ctx slots, or the
    window's for a local layer, as Backbone.cache_len sizes it) holding the
    positions that step sees. Each case is the arguments of kernel_case after
    the dtype, with its q and kv positions."""
    from repro_torch.models import get_config

    cases = []
    for arch, spec in SERVES.items():
        cfg = get_config(arch)
        kinds = [k for k in ("local", "attn") if k in cfg.layer_kinds()]
        P, ctx = spec["prompt_len"], spec["ctx"]
        last = P + spec["max_new"] - 2
        for kind in kinds:
            tag = TAGS[arch] + ("" if len(kinds) == 1 else
                                "_global" if kind == "attn" else "_local")
            window = cfg.attn_window if kind == "local" else None
            C = min(window or ctx, ctx)
            heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
            cap = cfg.attn_logit_softcap
            cases.append((f"{tag}_prefill", "flash_fwd", 1, P, P, *heads, True,
                          window, cap, None, None))
            cases.append((f"{tag}_decode", "flash_decode", spec["slots"], 1, C,
                          *heads, True, window, cap, [last],
                          _ring(C, max(0, last - C + 1), last)))
    return cases


def whisper_attention_cases():
    """K1's calls in whisper-tiny's serving run (phase 5), each the
    arguments of kernel_case after the dtype: a wave's batched prefill runs
    flash_fwd over the encoder ([slots, 1500] x [slots, 1500], not causal),
    the decoder's self-attention ([slots, prompt_len], causal) and the cross
    attention (prompt_len queries against the 1500 frames, not causal); its
    last decode step runs flash_decode against the self-attention ring
    (ctx slots holding positions 0..last) and across to the 1500 frames."""
    from repro_torch.models import get_config

    cfg = get_config("whisper-tiny")
    B, P, Se = WHISPER["slots"], WHISPER["prompt_len"], cfg.enc_seq
    heads = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    last = P + WHISPER["max_new"] - 2
    return [
        ("whisper_encoder", "flash_fwd", B, Se, Se, *heads, False, None, None,
         None, None),
        ("whisper_self_prefill", "flash_fwd", B, P, P, *heads, True, None,
         None, None, None),
        ("whisper_cross_prefill", "flash_fwd", B, P, Se, *heads, False, None,
         None, None, None),
        ("whisper_self_decode", "flash_decode", B, 1, WHISPER["ctx"], *heads,
         True, None, None, [last], _ring(WHISPER["ctx"], 0, last)),
        ("whisper_cross_decode", "flash_decode", B, 1, Se, *heads, False, None,
         None, [last], None),
    ]


def phase_flash():
    """K1 at FLASH_CASES shapes, at every served arch's prefill and ring
    decode (serve_attention_cases), and at three rings the serving run does
    not reach: qwen3-4b's wrapped with empty slots, one where every split but
    the first is empty, and recurrentgemma-9b's half full."""
    qw = dict(Hq=32, Hkv=8, hd=128)
    C, first, last = SERVE["ctx"], 600, 1500   # wrapped at 1024, 123 empty
    ring = _ring(C, first, last)
    served = serve_attention_cases() + whisper_attention_cases()
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for i, (B, Sq, Skv, Hq, Hkv, hd, causal, window, cap) in enumerate(
                FLASH_SHAPES):
            rows.append(kernel_case(f"flash_case_{i}", "flash_fwd", B, Sq, Skv,
                                    Hq, Hkv, hd, causal, window, cap, dtype))
        for (name, kernel, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, qpos,
             kpos) in served:
            rows.append(kernel_case(name, kernel, B, Sq, Skv, Hq, Hkv, hd,
                                    causal, window, cap, dtype, qpos=qpos,
                                    kpos=kpos))
        rows.append(kernel_case("qwen3_decode_wrapped", "flash_decode",
                                SERVE["slots"], 1, C, qw["Hq"], qw["Hkv"],
                                qw["hd"], True, None, None, dtype, qpos=[last],
                                kpos=ring))
        # positions 0..200 only: every split but the first is empty
        rows.append(kernel_case("qwen3_decode_one_split", "flash_decode",
                                SERVE["slots"], 1, C, qw["Hq"], qw["Hkv"],
                                qw["hd"], True, None, None, dtype, qpos=[200],
                                kpos=_ring(C, 0, 200)))
        rows.append(kernel_case("rgemma_decode_half_ring", "flash_decode",
                                RG["slots"], 1, 2048, 16, 1, 256, True, 2048,
                                None, dtype, qpos=[1023],
                                kpos=_ring(2048, 0, 1023)))
    rows += [sm90_case(*case) for case in SM90_CASES]
    return rows


def scan_case(kernel, name, dtype, make, run, plain, nbytes, flops, body,
              planned):
    """Hold one body of a scan kernel against the sequential plain version
    on ``make(seed)``'s inputs and time both; the bound is the larger of
    ``nbytes`` over the memory rate and ``flops`` of fp32 over the fp32
    rate. ``planned`` is the body the plan picks at this shape."""
    atol = rtol = SCAN_TOL[kernel]
    args = make(0)
    got = run(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    max_err = 0.0
    for g, w in zip(got, want):
        err = (g - w).abs()
        max_err = max(max_err, float(err.max()))
        if g.dtype != torch.float32 or not bool(
                (err <= atol + rtol * w.abs()).all()):
            raise AssertionError(f"{kernel} {name} {dtype} {body}: kernel disagrees "
                                 f"with the plain version, max abs err "
                                 f"{max_err} (atol = rtol = {atol})")
    bufs = [args] + [make(s) for s in range(1, n_buffers(nbytes))]
    ms = time_ms(rotating(run, bufs))
    plain_ms = time_ms(rotating(plain, bufs), iters=3, warmup=1)
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = dict(kernel=kernel, case=name, dtype=str(dtype).replace("torch.", ""),
               body=body, planned=body == planned,
               shape=list(args[0].shape), max_abs_err=max_err, atol=atol,
               rtol=rtol, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by)
    mark = "" if body == planned else " (not the plan's)"
    log(f"[kernel] {kernel} {name:>15} {row['dtype']:>8} {body}{mark} "
        f"err {max_err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library none "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


def _gen(seed):
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(SEED + 1000 + seed)
    return gen


BODIES = ("sequential", "chunked")


def phase_rglru():
    """K2 at RGLRU_CASES shapes, a ragged chunked shape (T and W not whole
    chunks and vectors) and recurrentgemma's prefill and decode, through both
    bodies: random gates in (0, 1), random a_log, nonzero h0; then state
    chaining at the prefill shape."""
    from repro_torch.kernels import ref, rglru

    shapes = [("rglru_case_0", 1, 32, 64), ("rglru_case_1", 2, 50, 96),
              ("rglru_case_2", 2, 64, 128), ("rglru_case_3", 1, 33, 48),
              ("rglru_ragged", 2, 131, 100),
              ("rgemma_prefill", 1, RG["prompt_len"], 4096),
              ("rgemma_decode", RG["slots"], 1, 4096)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, W in shapes:
            def make(seed, B=B, T=T, W=W):
                g = _gen(seed)
                rnd = lambda *s: torch.randn(s, generator=g, device=DEVICE)
                return (rnd(B, T, W).to(dtype), rnd(W).to(dtype),
                        torch.sigmoid(rnd(B, T, W)).to(dtype),
                        torch.sigmoid(rnd(B, T, W)).to(dtype), rnd(B, W))
            es = torch.finfo(dtype).bits // 8
            nbytes = es * (3 * B * T * W + W) + 4 * (B * T * W + 2 * B * W)
            for body in BODIES:
                rows.append(scan_case(
                    "rglru_scan", name, dtype, make,
                    lambda *a, body=body: rglru.rglru_scan(*a, body=body),
                    ref.rglru_scan_plain, nbytes, 9 * B * T * W, body,
                    rglru.plan(B, T, W, dtype).body))
    # two half-length calls that hand the state on equal one full call
    g = _gen(98)
    T, W = RG["prompt_len"], 4096
    x, gr, gi = (torch.randn(1, T, W, generator=g, device=DEVICE)
                 .to(torch.bfloat16) for _ in range(3))
    gr, gi = torch.sigmoid(gr), torch.sigmoid(gi)
    a_log, h0 = (torch.randn(*s, generator=g, device=DEVICE) for s in ((W,), (1, W)))
    y_full, h_full = rglru.rglru_scan(x, a_log, gr, gi, h0)
    half = T // 2
    parts = [t[:, :half].contiguous() for t in (x, gr, gi)]
    y1, h1 = rglru.rglru_scan(parts[0], a_log, parts[1], parts[2], h0)
    parts = [t[:, half:].contiguous() for t in (x, gr, gi)]
    y2, h2 = rglru.rglru_scan(parts[0], a_log, parts[1], parts[2], h1)
    _check_chaining("rglru_scan", half, torch.cat([y1, y2], 1), y_full, h2,
                    h_full)
    return rows


def _check_chaining(kernel, half, y_two, y_full, s_two, s_full):
    tol = SCAN_TOL[kernel]
    err = max(float((y_two - y_full).abs().max()),
              float((s_two - s_full).abs().max()))
    log(f"[kernel] {kernel} state chaining: 2 x {half} steps vs {2 * half}, "
        f"max abs err {err:.3e}")
    torch.testing.assert_close(y_two, y_full, atol=tol, rtol=tol)
    torch.testing.assert_close(s_two, s_full, atol=tol, rtol=tol)


def phase_wkv():
    """K3 at RWKV_CASES shapes, a ragged chunked shape (hd 24, T not whole
    chunks) and rwkv6's prefill and decode, through both bodies: random u, w
    in (0, 1) in fp32 as the model passes it, a nonzero state; then state
    chaining at the prefill shape."""
    from repro_torch.kernels import ref, rwkv6

    shapes = [("wkv_case_0", 1, 32, 2, 16), ("wkv_case_1", 2, 50, 4, 32),
              ("wkv_case_2", 2, 64, 1, 8), ("wkv_case_3", 1, 33, 2, 16),
              ("wkv_ragged", 2, 131, 3, 24),
              ("rwkv6_prefill", 1, RW["prompt_len"], 40, 64),
              ("rwkv6_decode", RW["slots"], 1, 40, 64)]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, B, T, H, hd in shapes:
            def make(seed, B=B, T=T, H=H, hd=hd):
                g = _gen(seed)
                rnd = lambda *s: torch.randn(s, generator=g, device=DEVICE)
                return (rnd(B, T, H, hd).to(dtype), rnd(B, T, H, hd).to(dtype),
                        rnd(B, T, H, hd).to(dtype),
                        torch.sigmoid(rnd(B, T, H, hd)), rnd(H, hd).to(dtype),
                        rnd(B, H, hd, hd))
            es = torch.finfo(dtype).bits // 8
            n = B * T * H * hd
            nbytes = es * (3 * n + H * hd) + 4 * (2 * n + 2 * B * H * hd * hd)
            # the u-term factors out of y (see wkv6_scan.cu): 2 operations
            # per state element for S^T r, 3 for w S + k v^T, 5 per element
            # of r for u, k, r and v
            for body in BODIES:
                rows.append(scan_case(
                    "wkv6_scan", name, dtype, make,
                    lambda *a, body=body: rwkv6.wkv6_scan(*a, body=body),
                    ref.rwkv6_scan_plain, nbytes, (5 * hd + 5) * n, body,
                    rwkv6.plan(B, T, H, hd).body))
    # two half-length calls that hand the state on equal one full call
    g = _gen(99)
    r, k, v, w = (torch.randn(1, RW["prompt_len"], 40, 64, generator=g,
                              device=DEVICE) for _ in range(4))
    w, u = torch.sigmoid(w), torch.randn(40, 64, generator=g, device=DEVICE)
    s0 = torch.randn(1, 40, 64, 64, generator=g, device=DEVICE)
    half = RW["prompt_len"] // 2
    y_full, s_full = rwkv6.wkv6_scan(r, k, v, w, u, s0)
    parts = [t[:, :half].contiguous() for t in (r, k, v, w)]
    y1, s1 = rwkv6.wkv6_scan(*parts, u, s0)
    parts = [t[:, half:].contiguous() for t in (r, k, v, w)]
    y2, s2 = rwkv6.wkv6_scan(*parts, u, s1)
    _check_chaining("wkv6_scan", half, torch.cat([y1, y2], 1), y_full, s2,
                    s_full)
    return rows


# the launches of each scan backward by pass, as the profiler names them
BWD_PASSES = {
    "rglru_bwd": {"maps": ("rglru_bwd_maps_kernel",),
                  "carry": ("rglru_bwd_carry_kernel",),
                  "rescan": ("rglru_bwd_rescan_kernel",),
                  "sum": ("rglru_bwd_alog_kernel",)},
    "wkv6_bwd": {"states": ("wkv_summary_kernel", "wkv_carry_kernel"),
                 "cotangents": ("wkv_bwd_cot_kernel", "wkv_bwd_carry_kernel"),
                 "walk": ("wkv_bwd_walk_kernel",),
                 "du": ("wkv_bwd_du_kernel",)},
}


def scan_bwd_case(kernel, name, dtype, make, run, plain, nbytes, flops,
                  timed_passes=False):
    """Hold a scan's backward kernel against its plain version on
    ``make(0)``'s inputs within SCAN_BWD_TOL, a rerun bit for bit, and time
    both (the timed shapes' inputs exceed the L2 cache: no rotation); the
    bound is the larger of ``nbytes`` over the memory rate and ``flops`` of
    fp32 over the fp32 rate. ``timed_passes``: each launch's device time
    from torch.profiler too, summed by pass (BWD_PASSES)."""
    tol = SCAN_BWD_TOL[kernel]
    args = make(0)
    got = run(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    max_err = 0.0
    for n, (g, w) in enumerate(zip(got, want)):
        wf = w.float()
        err = (g.float() - wf).abs()
        limit = tol * (wf.abs() + wf.abs().max())
        if g.dtype == torch.bfloat16:
            limit = limit + BF16_GRAD_RTOL * wf.abs()
        max_err = max(max_err, float(err.max()))
        if g.dtype != w.dtype or not bool((err <= limit).all()):
            raise AssertionError(f"{kernel} {name} {dtype}: output {n} "
                                 f"disagrees with the plain version, max abs "
                                 f"err {float(err.max())} (tol {tol} of itself "
                                 f"and of the largest entry)")
    again = run(*args)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{kernel} {name}: two runs differ")
    del got, want, again
    ms = time_ms(lambda: run(*args), iters=10)
    plain_ms = time_ms(lambda: plain(*args), iters=1, warmup=1)
    dname = str(dtype).replace("torch.", "")
    passes = None
    if timed_passes:
        launch = kernel_ms(lambda: run(*args), calls=5)
        passes = {p: sum(ms_ for k, ms_ in launch.items()
                         if k.split("<")[0] in names)
                  for p, names in BWD_PASSES[kernel].items()}
        missing = set().union(*BWD_PASSES[kernel].values()) - {
            k.split("<")[0] for k in launch}
        if missing:
            raise AssertionError(f"{kernel} {name}: no device time for "
                                 f"{sorted(missing)} in the trace")
        log(f"[kernel] {kernel} {name:>16} {dname:>8} passes "
            + " ".join(f"{p} {t:.4f} ms" for p, t in passes.items())
            + f" (sum {sum(passes.values()):.4f} ms)")
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = dict(kernel=kernel, case=name, dtype=dname,
               shape=list(args[0].shape), max_abs_err=max_err, atol=tol,
               rtol=tol, ms=ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=bound_ms, bound_by=bound_by, passes_ms=passes)
    log(f"[kernel] {kernel} {name:>16} {row['dtype']:>8} err {max_err:.3e} "
        f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library none "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return row


def phase_scan_bwd():
    """K2b (rglru_bwd) and K3b (wkv6_bwd) against their plain versions at a
    ragged shape and at the training shapes of phase 6, in fp32 and bf16
    inputs: random inputs and gates, nonzero initial states and final-state
    cotangents; y of K2b's inputs from K2, as the autograd Function saves
    it."""
    from repro_torch.kernels import ref, rglru, rglru_bwd, rwkv6_bwd

    rg, rw = OTHER_TRAIN["recurrentgemma-9b"], OTHER_TRAIN["rwkv6-3b"]
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        for name, B, T, W in (("rglru_bwd_ragged", 2, 131, 100),
                              ("rgemma_train", rg["batch"], rg["seq"], 4096)):
            def make(seed, B=B, T=T, W=W):
                g = _gen(500 + seed)
                rnd = lambda *s: torch.randn(s, generator=g, device=DEVICE)
                x, al = rnd(B, T, W).to(dtype), rnd(W).to(dtype)
                gr, gi = (torch.sigmoid(rnd(B, T, W)).to(dtype)
                          for _ in range(2))
                h0 = rnd(B, W)
                y, _ = rglru.rglru_scan(x, al, gr, gi, h0)
                return x, al, gr, gi, h0, y, rnd(B, T, W), rnd(B, W)
            n = B * T * W
            # x, r, i read and dx, dr, di written; y, dy read; a_log and
            # da_log; h0, dh_T, dh0. About 20 operations an element.
            nbytes = es * (6 * n + 2 * W) + 4 * (2 * n + 3 * B * W)
            rows.append(scan_bwd_case("rglru_bwd", name, dtype, make,
                                      rglru_bwd.rglru_scan_bwd,
                                      ref.rglru_scan_bwd_plain, nbytes, 20 * n,
                                      timed_passes=name == "rgemma_train"))
        for name, B, T, H, hd in (("wkv_bwd_ragged", 2, 131, 3, 24),
                                  ("rwkv6_train", rw["batch"], rw["seq"], 40,
                                   64)):
            def make(seed, B=B, T=T, H=H, hd=hd):
                g = _gen(600 + seed)
                rnd = lambda *s: torch.randn(s, generator=g, device=DEVICE)
                r, k, v = (rnd(B, T, H, hd).to(dtype) for _ in range(3))
                w = torch.sigmoid(rnd(B, T, H, hd))
                return (r, k, v, w, rnd(H, hd).to(dtype), rnd(B, H, hd, hd),
                        rnd(B, T, H, hd), rnd(B, H, hd, hd))
            n = B * T * H * hd
            # r, k, v read and dr, dk, dv written; w, dy read and dw
            # written; u and du; s0, dS_T, ds0. 14 operations per state
            # element and step (see wkv6_bwd.cu): 14 hd per element of r.
            nbytes = es * (6 * n + 2 * H * hd) + 4 * (3 * n + 3 * B * H * hd * hd)
            rows.append(scan_bwd_case("wkv6_bwd", name, dtype, make,
                                      rwkv6_bwd.wkv6_scan_bwd,
                                      ref.rwkv6_scan_bwd_plain, nbytes,
                                      14 * hd * n,
                                      timed_passes=name == "rwkv6_train"))
    free_memory()
    return rows


# --------------------------------------------------------------------------- #
# Phase 4: each model at full width, reduced depth                             #
# --------------------------------------------------------------------------- #
# arch -> (layer groups, fp32 prefill length, bf16 prompt length, ctx)
MODEL_CHECKS = {
    "qwen3-4b": (((("attn",), 2),), 64, SERVE["prompt_len"], SERVE["ctx"]),
    "recurrentgemma-9b": (((("rec", "rec", "local"), 1),), 2100, 2100,
                          RG["ctx"]),
    "rwkv6-3b": (((("rwkv",), 2),), 64, RW["prompt_len"], RW["ctx"]),
    # one (local, attn) group, both prompts past the 4096-token window
    "gemma2-2b": (((("local", "attn"), 1),), SERVES["gemma2-2b"]["prompt_len"],
                  SERVES["gemma2-2b"]["prompt_len"], SERVES["gemma2-2b"]["ctx"]),
    "qwen2-7b": (((("attn",), 2),), 64, SERVES["qwen2-7b"]["prompt_len"],
                 SERVES["qwen2-7b"]["ctx"]),
    "phi4-mini-3.8b": (((("attn",), 2),), 64,
                       SERVES["phi4-mini-3.8b"]["prompt_len"],
                       SERVES["phi4-mini-3.8b"]["ctx"]),
    "chameleon-34b": (((("attn",), 2),), 64,
                      SERVES["chameleon-34b"]["prompt_len"],
                      SERVES["chameleon-34b"]["ctx"]),
    # the MoE archs: see phase_moe_model
    "mixtral-8x22b": (((("local",), 2),), SERVES["mixtral-8x22b"]["prompt_len"],
                      SERVES["mixtral-8x22b"]["prompt_len"],
                      SERVES["mixtral-8x22b"]["ctx"]),
    "qwen3-moe-235b-a22b": (((("attn",), 2),), 512,
                            SERVES["qwen3-moe-235b-a22b"]["prompt_len"],
                            SERVES["qwen3-moe-235b-a22b"]["ctx"]),
    # full depth, over 1500 frames a sequence; the bf16 prompt ends 4
    # decode steps short of the 448-token text context
    "whisper-tiny": (((("enc",), 4), (("dec",), 4)), 64, WHISPER["ctx"] - 4,
                     WHISPER["ctx"]),
}


def phase_model(arch):
    from repro_torch.models import Backbone, LayerGroup, get_config

    groups, n32, n16, ctx = MODEL_CHECKS[arch]
    cfg = dataclasses.replace(get_config(arch), groups=tuple(
        LayerGroup(pattern, repeat) for pattern, repeat in groups))
    if cfg.ffn_kind == "moe":
        return phase_moe_model(arch, cfg, n32, n16, ctx)
    depth = f"{cfg.n_layers} layers {'+'.join(cfg.layer_kinds())}"
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, n32 + 1),
                                         dtype=np.int32)).to(DEVICE)
    # an encoder-decoder model's frames (the stub frontend's), one set a row
    frames = (torch.from_numpy(rng.standard_normal(
        (2, cfg.enc_seq, cfg.d_model), dtype=np.float32)).to(DEVICE)
        if cfg.is_enc_dec else None)

    def batch(t):
        return ({"tokens": t} if frames is None else
                {"tokens": t, "enc_frames": frames[:t.shape[0]]})

    bb = Backbone(cfg, compute_dtype=torch.float32, param_dtype=torch.float32,
                  device=DEVICE)
    params = bb.init(SEED + 1)
    _, cache = bb.prefill(params, batch(toks[:, :n32]), ctx)
    got, _ = bb.decode_step(params, cache, toks[:, n32:])
    want, _ = bb.prefill(params, batch(toks), ctx)
    if got.shape != (2, 1, bb.Vp) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{arch} fp32 decode logits {tuple(got.shape)} "
                             "not finite")
    fp32_err = float((got - want).abs().max())
    log(f"[model] {arch} full width, {depth}, fp32: decode after {n32} vs "
        f"prefill of {n32 + 1}, max abs err {fp32_err:.3e} "
        f"(tol {MODEL_FP32_TOL})")
    if fp32_err > MODEL_FP32_TOL:
        raise AssertionError(f"{arch}: fp32 decode disagrees with the longer "
                             "prefill")
    del bb, params, cache, got, want

    kern = Backbone(cfg, compute_dtype=torch.bfloat16,
                    param_dtype=torch.bfloat16, device=DEVICE)
    plain = Backbone(cfg, compute_dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, kernel_impl="plain",
                     device=DEVICE)
    params = kern.init(SEED + 2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n16 + 4),
                                           dtype=np.int32)).to(DEVICE)
    errs = []
    lk, ck = kern.prefill(params, batch(prompt[:, :n16]), ctx)
    lp, cp = plain.prefill(params, batch(prompt[:, :n16]), ctx)
    errs.append(float((lk.float() - lp.float()).abs().max()))
    for i in range(4):
        t = prompt[:, n16 + i:n16 + i + 1]
        lk, ck = kern.decode_step(params, ck, t)
        lp, cp = plain.decode_step(params, cp, t)
        errs.append(float((lk.float() - lp.float()).abs().max()))
    log(f"[model] {arch} full width, {depth}, bf16 (allow_bf16_reduced_"
        f"precision_reduction="
        f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}"
        f"): kernels vs plain versions, max abs logit err prefill of {n16} "
        f"{errs[0]:.3e}, decode {max(errs[1:]):.3e} (tol {MODEL_BF16_TOL})")
    if max(errs) > MODEL_BF16_TOL:
        raise AssertionError(f"{arch}: bf16 kernel path disagrees with the "
                             "plain path")
    del kern, plain, params, ck, cp
    free_memory()
    return {"fp32_decode_vs_prefill_err": fp32_err,
            "bf16_kernel_vs_plain_err": max(errs)}


class Routes:
    """Records the experts each call of the MoE layer picks (the indices of
    ``repro_torch.models.ffn.top_k``, [T, K] a call), in call order, while
    installed over ``ffn.top_k``. With ``pin``, another run's record, each
    call takes that run's indices instead, with the gate values from its
    own probabilities: two paths then run the same routes, and what is
    left between them is the kernels' rounding."""

    def __init__(self, pin=None):
        self.calls, self.pin = [], pin

    def __enter__(self):
        from repro_torch.models import ffn
        self._top_k = top_k = ffn.top_k

        def recording(probs, k):
            vals, idx = top_k(probs, k)
            if self.pin is not None:
                idx = self.pin[len(self.calls)]
                vals = torch.gather(probs, -1, idx)
            self.calls.append(idx.detach())
            return vals, idx
        ffn.top_k = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ffn
        ffn.top_k = self._top_k


def dropped(cfg, idx):
    """Assignments of one MoE call (experts ``idx`` [T, K]) past their
    expert's capacity."""
    from repro_torch.models import ffn
    C = ffn.moe_capacity(idx.shape[0], cfg.n_experts, cfg.top_k,
                         cfg.capacity_factor)
    return int((ffn.slot_positions(idx.reshape(-1), cfg.n_experts) >= C).sum())


def phase_moe_model(arch, cfg, n32, n16, ctx):
    """The MoE archs at full width, 2 layers. Decode against a longer
    prefill in fp32 (2 rows) and bf16 (4 rows) at the drop-free capacity
    factor E / K (then C >= T: a token gives an expert one assignment at
    most), the reference's convention (reduced() takes 8 so that smoke
    tests compare decode against prefill exactly); a row is compared where
    its routes agree in every layer (a flipped route is another function),
    and fp32 may flip none. Then the config's own factor (1.25), bf16: the
    kernel path against the plain path pinned to its routes (Routes), with
    each layer's dropped assignments and the routes the unpinned plain path
    picks otherwise."""
    from repro_torch.models import Backbone

    rng = np.random.default_rng(SEED)
    n_moe = cfg.n_layers
    free_cf = cfg.n_experts / cfg.top_k
    drop_free = dataclasses.replace(cfg, capacity_factor=free_cf)
    depth = f"{cfg.n_layers} layers {'+'.join(cfg.layer_kinds())}"
    out = {"drop_free_capacity_factor": free_cf}
    for dtype, B, n, tol in ((torch.float32, 2, n32, MODEL_FP32_TOL),
                             (torch.bfloat16, 4, n16, MODEL_BF16_TOL)):
        bb = Backbone(drop_free, compute_dtype=dtype, param_dtype=dtype,
                      device=DEVICE)
        params = bb.init(SEED + 1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, n + 1),
                                             dtype=np.int32)).to(DEVICE)
        _, cache = bb.prefill(params, {"tokens": toks[:, :n]}, ctx)
        with Routes() as rd:
            got, _ = bb.decode_step(params, cache, toks[:, n:])
        with Routes() as rp:
            want, _ = bb.prefill(params, {"tokens": toks}, ctx)
        if got.shape != (B, 1, bb.Vp) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{arch} decode logits not finite")
        same = torch.ones(B, dtype=torch.bool, device=DEVICE)
        for d, p in zip(rd.calls, rp.calls):
            same &= (d == p.view(B, n + 1, -1)[:, -1]).all(-1)
        drops = sum(dropped(drop_free, c) for c in rd.calls + rp.calls)
        err = (got - want).float().abs().amax((1, 2))
        flipped = int((~same).sum())
        name = str(dtype)[6:]
        worst = float(err[same].max()) if bool(same.any()) else math.inf
        log(f"[model] {arch} full width, {depth}, {name}, capacity factor "
            f"{free_cf} (drop-free: {drops} dropped): decode after {n} vs "
            f"prefill of {n + 1}, {B} rows, {flipped} with a flipped route, "
            f"max abs err of the others {worst:.3e} (tol {tol})")
        if drops or worst > tol or (dtype == torch.float32 and flipped):
            raise AssertionError(f"{arch} {name}: decode disagrees with the "
                                 "longer prefill")
        out[f"{name}_decode_vs_prefill_err"] = worst
        out[f"{name}_flipped_rows"] = flipped
        del bb, params, cache, got, want
        free_memory()

    kern = Backbone(cfg, compute_dtype=torch.bfloat16,
                    param_dtype=torch.bfloat16, device=DEVICE)
    plain = Backbone(cfg, compute_dtype=torch.bfloat16,
                     param_dtype=torch.bfloat16, kernel_impl="plain",
                     device=DEVICE)
    params = kern.init(SEED + 2)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, n16 + 4),
                                           dtype=np.int32)).to(DEVICE)

    def drive(bb):
        logits, cache = bb.prefill(params, {"tokens": prompt[:, :n16]}, ctx)
        outs = [logits]
        for i in range(4):
            logits, cache = bb.decode_step(params, cache,
                                           prompt[:, n16 + i:n16 + i + 1])
            outs.append(logits)
        return outs

    with Routes() as rk:
        lk = drive(kern)
    with Routes() as rf:
        lf = drive(plain)
    with Routes(pin=rk.calls):
        lp = drive(plain)
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(lk, lp)]
    free_errs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(lk, lf)]
    layers = []
    for layer in range(n_moe):
        calls = range(layer, len(rk.calls), n_moe)
        layers.append({
            "dropped_prefill": dropped(cfg, rk.calls[layer]),
            "assignments_prefill": rk.calls[layer].numel(),
            "dropped_decode": sum(dropped(cfg, rk.calls[c]) for c in calls
                                  if c >= n_moe),
            "routes_differing": sum(int((rk.calls[c] != rf.calls[c]).sum())
                                    for c in calls)})
    log(f"[model] {arch} full width, {depth}, bf16, capacity factor "
        f"{cfg.capacity_factor}: kernels vs plain versions (pinned to the "
        f"kernel path's routes), max abs logit err prefill of {n16} "
        f"{errs[0]:.3e}, decode {max(errs[1:]):.3e} (tol {MODEL_BF16_TOL}); "
        f"unpinned {max(free_errs):.3e}; by layer: " + "; ".join(
            f"{i}: {l['dropped_prefill']} of {l['assignments_prefill']} "
            f"assignments dropped in prefill, {l['dropped_decode']} in decode,"
            f" {l['routes_differing']} (token, k) routes differ unpinned"
            for i, l in enumerate(layers)))
    if max(errs) > MODEL_BF16_TOL:
        raise AssertionError(f"{arch}: bf16 kernel path disagrees with the "
                             "plain path")
    del kern, plain, params
    free_memory()
    out.update(bf16_kernel_vs_plain_err=max(errs),
               bf16_kernel_vs_plain_unpinned_err=max(free_errs),
               layers=layers)
    return out


# --------------------------------------------------------------------------- #
# Phase 5: serve each model at full depth                                      #
# --------------------------------------------------------------------------- #
def dispatch():
    """The port's dispatch ledger, ``metrics.registry("dispatch")``: one
    count a launch of a C entry point, keyed ``<kernel>.<body or pass>`` or
    ``<kernel>``, one a moe_mlp call, ``moe_mlp.<path>``, and one a group's
    layer views in a training forward, ``layer_views.unbind``."""
    from repro_torch.obs import metrics
    return metrics.registry("dispatch")


def ledger():
    """The ledger's counts since its last reset (a key that never moved is
    absent)."""
    return dispatch().snapshot()["counters"]


def with_totals(counts):
    """Ledger ``counts`` with each kernel's launches beside its keys, as the
    count lines print them: ``<kernel>``, the sum of its keys, for K1b its
    calls (one dq launch each); the MoE layer's calls and the layer views
    have none."""
    out = dict(counts)
    for key, n in counts.items():
        kernel, _, part = key.partition(".")
        if part and kernel not in ("moe_mlp", "layer_views") and (
                kernel != "flash_bwd" or part == "dq"):
            out[kernel] = out.get(kernel, 0) + n
    return dict(sorted(out.items()))


def phase_serve(arch):
    from repro_torch.models import Backbone, LayerGroup, get_config
    from repro_torch.runtime.serve_loop import Request, Server

    spec = SERVES[arch]
    cfg = get_config(arch)
    if "depth" in spec:
        cfg = dataclasses.replace(cfg, groups=(
            LayerGroup(cfg.groups[0].pattern, spec["depth"]),))
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                  device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = bb.init(SEED)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e9:.3f} B params in bf16 "
        f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), init "
        f"{time.perf_counter() - t0:.2f} s, peak {init_peak / 1e9:.2f} GB")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (spec["requests"], spec["prompt_len"]),
                           dtype=np.int32)

    warm = Server(bb, params, slots=spec["slots"], ctx=spec["ctx"])
    warm.submit(Request(rid=-1, prompt=prompts[0], max_new=2))
    warm.run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    srv = Server(bb, params, slots=spec["slots"], ctx=spec["ctx"])
    reqs = [Request(rid=i, prompt=prompts[i], max_new=spec["max_new"])
            for i in range(spec["requests"])]
    for r in reqs:
        srv.submit(r)
    dispatch().reset()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ledger()
    peak = torch.cuda.max_memory_allocated()

    steps = srv.stats["steps"]
    waves = spec["requests"] // spec["slots"]
    if not all(r.done.is_set() and len(r.out) == spec["max_new"] for r in reqs):
        raise AssertionError("not every request finished with max_new tokens")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.out):
        raise AssertionError("a token outside the vocabulary")
    if steps != waves * (spec["max_new"] - 1):
        raise AssertionError(f"{steps} decode steps, want "
                             f"{waves * (spec['max_new'] - 1)}")
    kinds = cfg.layer_kinds()
    n_attn = sum(k in ("attn", "local") for k in kinds)
    n_rec, n_rwkv = kinds.count("rec"), kinds.count("rwkv")
    n_moe = len(kinds) if cfg.ffn_kind == "moe" else 0
    # kernel -> (layers that run it, how many calls each)
    req, both = spec["requests"], spec["requests"] + steps
    expect = {"flash_fwd": (n_attn, f"{req} requests"),
              "flash_decode": (n_attn, f"{steps} decode steps"),
              "rglru_scan": (n_rec, f"({req} + {steps})"),
              "wkv6_scan": (n_rwkv, f"({req} + {steps})"),
              "moe_gemm": (2 * n_moe, f"({req} + {steps})")}
    # every prefill on K1's body for the arch and through the scans'
    # chunked bodies, every decode step through their sequential ones; no
    # backward; serving takes no gradient: every MoE layer call on the
    # grouped path
    _check_counts(f"{arch} on the main path", counts, {
        f"flash_fwd.{k1_body(arch, torch.bfloat16)}": n_attn * req,
        "flash_decode": n_attn * steps,
        "rglru_scan.chunked": n_rec * req,
        "rglru_scan.sequential": n_rec * steps,
        "wkv6_scan.chunked": n_rwkv * req,
        "wkv6_scan.sequential": n_rwkv * steps,
        "moe_gemm.gate_up": n_moe * both, "moe_gemm.down": n_moe * both,
        "moe_mlp.grouped": n_moe * both})
    # the first token of a request is the argmax of a direct prefill
    for r in reqs[:2]:
        logits, _ = bb.prefill(params, {"tokens": torch.from_numpy(
            r.prompt[None, :]).to(DEVICE)}, spec["ctx"])
        if logits.shape != (1, 1, bb.Vp) or not bool(torch.isfinite(logits).all()):
            raise AssertionError("prefill logits not finite")
        if r.out[0] != int(torch.argmax(logits[0, -1, :cfg.vocab])):
            raise AssertionError("served first token != direct prefill argmax")
    tokens = sum(len(r.out) for r in reqs)
    out = {
        "arch": arch, "requests": len(reqs), "prompt_len": spec["prompt_len"],
        "decode_steps": steps, "launches": counts,
        "prefill_ms_per_request": srv.timing["prefill_s"] / len(reqs) * 1e3,
        "decode_ms_per_step": srv.timing["decode_s"] / steps * 1e3,
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "max_memory_allocated_gb": peak / 1e9,
        "init_max_memory_allocated_gb": init_peak / 1e9,
    }
    totals = with_totals(counts)
    line = ", ".join(
        f"{name} {totals[name]} = {n} x {why}"
        + (f" ({counts.get(name + '.chunked', 0)} chunked, "
           f"{counts.get(name + '.sequential', 0)} sequential)"
           if name in ("rglru_scan", "wkv6_scan") else "")
        + (f" (all {k1_body(arch, torch.bfloat16)})" if name == "flash_fwd"
           else "")
        for name, (n, why) in expect.items() if n)
    log(f"[serve] {arch}: {len(reqs)} requests of {spec['prompt_len']} tokens, "
        f"{steps} decode steps, {tokens} tokens in {wall:.3f} s "
        f"({out['tokens_per_s']:.1f} tok/s); prefill "
        f"{out['prefill_ms_per_request']:.2f} ms/request, decode "
        f"{out['decode_ms_per_step']:.2f} ms/step; launches {line}; peak "
        f"memory {out['max_memory_allocated_gb']:.2f} GB")
    log("[serve] " + json.dumps(out))
    out["trace"] = phase_trace(bb, params, prompts, spec)
    del srv, warm, bb, params
    free_memory()
    return out


def phase_serve_whisper():
    """whisper-tiny at full width and full depth, bf16 weights and compute,
    served as the reference serves it (Backbone.prefill, then decode_step:
    its Server takes no frames): two waves of WHISPER["slots"] requests,
    each request with its own frames from a seeded numpy generator. A wave
    is one batched prefill and max_new - 1 greedy decode steps, each ending
    in a read of its tokens. The counts are set to 0 just before each wave
    and read just after: flash_fwd 12 a prefill (4 encoder, 4 decoder
    self-attention, 4 cross), flash_decode 8 a decode step (4 + 4), the
    encoder's layer views once a prefill, nothing else. Each request's
    first token must be the top logit, within MODEL_BF16_TOL, of a batch-1
    prefill of its own prompt and frames (the
    wave's rows land in their slots); then a torch.profiler trace of a
    wave's prefill and of a decode step."""
    from repro_torch.models import Backbone, get_config

    spec = WHISPER
    cfg = get_config("whisper-tiny")
    B, ctx, steps = spec["slots"], spec["ctx"], spec["max_new"] - 1
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                  device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    params = bb.init(SEED)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers "
        f"{'+'.join(cfg.layer_kinds())}, d_model {cfg.d_model}, "
        f"{cfg.param_count() / 1e6:.1f} M params in bf16, init peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    rng = np.random.default_rng(SEED)
    prompts = rng.integers(0, cfg.vocab, (spec["requests"], spec["prompt_len"]),
                           dtype=np.int32)
    frames = rng.standard_normal((spec["requests"], cfg.enc_seq, cfg.d_model),
                                 dtype=np.float32)

    def wave(i):
        """(tokens [B, max_new] on the host, prefill s, decode s)."""
        sl = slice(i * B, (i + 1) * B)
        batch = {"tokens": torch.from_numpy(prompts[sl]).to(DEVICE),
                 "enc_frames": torch.from_numpy(frames[sl]).to(DEVICE)}
        t0 = time.perf_counter()
        logits, cache = bb.prefill(params, batch, ctx)
        tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
        out = [tok.tolist()]
        t1 = time.perf_counter()
        for _ in range(steps):
            logits, cache = bb.decode_step(params, cache, tok[:, None].int())
            tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)
            out.append(tok.tolist())
        t2 = time.perf_counter()
        return np.array(out).T, t1 - t0, t2 - t1

    wave(0)  # warm-up: the kernels' first launches, the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    waves = spec["requests"] // B
    launches, tokens, prefill_s, decode_s = {}, [], 0.0, 0.0
    t0 = time.perf_counter()
    for i in range(waves):
        dispatch().reset()
        toks, tp, td = wave(i)
        counts = ledger()
        _check_counts(f"whisper-tiny serving wave {i}", counts, {
            f"flash_fwd.{k1_body('whisper-tiny', torch.bfloat16)}": 3 * 4,
            "flash_decode": 2 * 4 * steps,
            "layer_views.unbind": sum("enc" in g.pattern
                                      for g in cfg.groups)})
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        tokens.append(toks)
        prefill_s += tp
        decode_s += td
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    tokens = np.concatenate(tokens)
    if tokens.shape != (spec["requests"], spec["max_new"]) or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"whisper-tiny: served tokens {tokens.shape}, or "
                             "a token outside the vocabulary")
    gaps = []
    for r in (0, B - 1, B):
        logits, _ = bb.prefill(params, {
            "tokens": torch.from_numpy(prompts[r:r + 1]).to(DEVICE),
            "enc_frames": torch.from_numpy(frames[r:r + 1]).to(DEVICE)}, ctx)
        row = logits[0, -1, :cfg.vocab].float()
        if not bool(torch.isfinite(row).all()):
            raise AssertionError("whisper-tiny: prefill logits not finite")
        gaps.append(float(row.max() - row[int(tokens[r, 0])]))
    if max(gaps) > MODEL_BF16_TOL:
        raise AssertionError(f"whisper-tiny: a served first token is not the "
                             f"top of its own batch-1 prefill: gaps {gaps}")
    n_tok = int(tokens.size)
    out = {
        "arch": cfg.name, "requests": spec["requests"],
        "prompt_len": spec["prompt_len"], "frames": cfg.enc_seq,
        "decode_steps": waves * steps, "launches": launches,
        "prefill_ms_per_wave": prefill_s / waves * 1e3,
        "decode_ms_per_step": decode_s / (waves * steps) * 1e3,
        "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
        "first_token_logit_gaps": gaps,
        "max_memory_allocated_gb": peak / 1e9,
    }
    log(f"[serve] whisper-tiny: {waves} waves of {B} requests ({cfg.enc_seq} "
        f"frames, {spec['prompt_len']}-token prompts), {waves * steps} decode "
        f"steps, {n_tok} tokens in {wall:.3f} s ({out['tokens_per_s']:.1f} "
        f"tok/s); prefill {out['prefill_ms_per_wave']:.2f} ms/wave, decode "
        f"{out['decode_ms_per_step']:.2f} ms/step; launches flash_fwd "
        f"{with_totals(launches)['flash_fwd']} = 12 x {waves} prefills, "
        f"flash_decode {launches['flash_decode']} = 8 x {waves * steps} "
        f"decode steps; "
        f"first-token logit gaps {gaps}; peak memory {peak / 1e9:.3f} GB")
    log("[serve] " + json.dumps(out))
    batch = {"tokens": torch.from_numpy(prompts[:B]).to(DEVICE),
             "enc_frames": torch.from_numpy(frames[:B]).to(DEVICE)}
    _, cache = bb.prefill(params, batch, ctx)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=DEVICE)
    bb.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    out["trace"] = {
        "prefill": profile_calls("whisper-tiny prefill (one wave)",
                                 lambda: bb.prefill(params, batch, ctx)),
        "decode": profile_calls("whisper-tiny decode",
                                lambda: bb.decode_step(params, cache, tok))}
    del bb, params, cache
    free_memory()
    return out


def profile_calls(label, fn, calls=3):
    """torch.profiler over ``calls`` calls of ``fn``: host ms and device busy
    ms per call, the device idle share and the top kernels. Device busy
    time is the union of the CUDA activity intervals; the idle share is
    1 - busy / host wall time. Only the profiler's failure to start is
    caught: the calls and their errors stay outside any handler."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:  # the profiler could not attach to the card
        return f"not measured ({e})"
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    prof.stop()
    spans, by_name, parts = [], {}, {}
    for e in prof.events():
        if e.name.startswith("moe.") and e.device_type == \
                torch.autograd.DeviceType.CPU:   # moe_spans' ranges
            parts[e.name[4:]] = parts.get(e.name[4:], 0.0) + e.device_time_total
        # the ranges' GPU-side spans cover the gaps between their kernels
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                e.name.startswith("moe."):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    if not spans:
        return "not measured (no device activity in the trace)"
    busy, end = 0.0, -math.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 8, and the port's own kernels wherever they rank
    shown = ranked[:8] + [kv for kv in ranked[8:] if any(
        k in kv[0] for k in TRACE_NAMES)]
    r = {
        "host_ms_per_call": wall_us / calls / 1e3,
        "device_busy_ms_per_call": busy / calls / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "top_kernels_ms_per_call": {
            k[:80]: [t / calls / 1e3, n // calls] for k, (t, n) in shown},
    }
    log(f"[trace] {label}: host {r['host_ms_per_call']:.3f} "
        f"ms/call, device busy {r['device_busy_ms_per_call']:.3f} ms, idle "
        f"share {r['device_idle_share']:.3f}")
    if parts:
        r["moe_device_ms_per_call"] = {k: t / calls / 1e3
                                       for k, t in sorted(parts.items())}
        steps = sum(t for k, t in r["moe_device_ms_per_call"].items()
                    if k != "layer")
        log(f"[trace]   MoE layers, device ms a call: " + ", ".join(
            f"{k} {t:.4f}" for k, t in r["moe_device_ms_per_call"].items())
            + f" (the layers' other ops "
            f"{r['moe_device_ms_per_call'].get('layer', 0.0) - steps:.4f})")
    for k, (t, n) in r["top_kernels_ms_per_call"].items():
        log(f"[trace]   {t:9.4f} ms  x{n:<5d} {k}")
    return r


# the MoE layer's steps in repro_torch.models.ffn that the traces time: the
# capacity path's and the grouped path's
MOE_STEPS = ("route", "slot_positions", "dispatch", "expert_ffn", "combine",
             "grouped_rows", "dispatch_rows", "grouped_experts",
             "combine_rows", "aux_loss")


class moe_spans:
    """While installed, each MoE layer (``moe.layer``) and each of its steps
    (``moe.route``, ``moe.dispatch``, ...) runs inside a
    ``torch.profiler.record_function`` range, whose device time
    profile_calls sums: the router (route: the fp32 product, softmax and
    top-k), the positions, the dispatch scatter, the expert GEMMs
    (expert_ffn), the combine and the aux loss; on the grouped path the
    rows (grouped_rows), the compact dispatch (dispatch_rows), the grouped
    kernel (grouped_experts) and its combine (combine_rows)."""

    def __enter__(self):
        from repro_torch.models import backbone, ffn
        self._saved = [(ffn, n, getattr(ffn, n)) for n in MOE_STEPS]
        self._saved.append((backbone, "moe_mlp", backbone.moe_mlp))
        for mod, name, fn in self._saved:
            setattr(mod, name, self._ranged(
                "layer" if name == "moe_mlp" else name, fn))
        return self

    @staticmethod
    def _ranged(name, fn):
        from torch.profiler import record_function

        def call(*args, **kw):
            with record_function(f"moe.{name}"):
                return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def phase_trace(bb, params, prompts, spec):
    """Where the time goes: 3 batch-1 prefills and 3 decode steps of all
    slots under the profiler; for an MoE arch, the device ms of its layers'
    steps (moe_spans)."""
    slots, ctx = spec["slots"], spec["ctx"]
    _, cache = bb.prefill(params, {"tokens": torch.from_numpy(
        prompts[:slots]).to(DEVICE)}, ctx)
    tok = torch.zeros((slots, 1), dtype=torch.int32, device=DEVICE)
    one = torch.from_numpy(prompts[:1]).to(DEVICE)
    bb.decode_step(params, cache, tok)
    torch.cuda.synchronize()
    moe = bb.cfg.ffn_kind == "moe"
    out = {}
    for name, fn in (("prefill", lambda: bb.prefill(params, {"tokens": one},
                                                    ctx)),
                     ("decode", lambda: bb.decode_step(params, cache, tok))):
        with moe_spans() if moe else contextlib.nullcontext():
            out[name] = profile_calls(f"{bb.cfg.name} {name}", fn)
        if moe and isinstance(out[name], dict) and not out[name].get(
                "moe_device_ms_per_call", {}).get("layer"):
            raise AssertionError(f"{bb.cfg.name} {name}: no device time for "
                                 "the MoE layers in the trace")
    return out


# --------------------------------------------------------------------------- #
# Phase 6: training qwen3-4b                                                   #
# --------------------------------------------------------------------------- #
def _train_want(bb, batch, seq, runs, fwd):
    """Exact launches of ``runs`` passes of ``bb.loss_fn`` and its backward
    at [batch, seq], with ``fwd`` forwards a layer (2 with remat): K1 (with
    its LSE) once a forward of an attention layer and K1b's passes once a
    backward (the reduce pass only where its plan splits); each scan once a
    forward of its layers, through the body its plan picks, and its
    backward once a pass; the layer views once a group and pass (remat's
    recompute makes none)."""
    from repro_torch.kernels import flash_bwd, rglru, rwkv6
    kinds = bb.cfg.layer_kinds()
    Se = bb.cfg.enc_seq
    # (Sq, Skv) of each attention call of a pass: a dec layer attends to
    # itself and across to the encoder's frames
    calls = ([(seq, seq)] * sum(k in ("attn", "local", "dec") for k in kinds)
             + [(Se, Se)] * kinds.count("enc") + [(seq, Se)] * kinds.count("dec"))
    attn = len(calls) * runs
    rec, rwk = kinds.count("rec") * runs, kinds.count("rwkv") * runs
    split = sum(flash_bwd.plan(batch, sq, skv, bb.H, bb.KV, bb.hd,
                               bb.compute_dtype,
                               sms=flash_bwd.device_sms(DEVICE)).splits > 1
                for sq, skv in calls) * runs
    # training takes gradients: every MoE layer call on the capacity path,
    # the grouped expert kernel never
    moe = len(kinds) * runs if bb.cfg.ffn_kind == "moe" else 0
    rglru_body = rglru.plan(batch, seq, bb.W, bb.compute_dtype).body
    wkv_body = rwkv6.plan(batch, seq, bb.rwkv_H, bb.cfg.rwkv_head_dim).body
    return {f"flash_fwd.{k1_body(bb.cfg.name, bb.compute_dtype)}": attn * fwd,
            "flash_bwd.delta": attn, "flash_bwd.dkdv": attn,
            "flash_bwd.dq": attn, "flash_bwd.reduce": split,
            f"rglru_scan.{rglru_body}": rec * fwd, "rglru_bwd": rec,
            f"wkv6_scan.{wkv_body}": rwk * fwd, "wkv6_bwd": rwk,
            "moe_mlp.capacity": moe * fwd,
            "layer_views.unbind": len(bb.cfg.groups) * runs}


def _check_counts(what, got, want):
    """Raise unless the ledger's counts ``got`` are ``want`` (whose zeros
    the ledger leaves out)."""
    want = {k: n for k, n in want.items() if n}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def lse_case(name, B, S, Hq, Hkv, hd, window, cap, dtype, Skv=None,
             causal=True):
    """K1's LSE (flash_fwd with return_lse) against attention_lse_plain, at
    S queries against ``Skv`` keys (S by default); the out it returns must
    equal the serving call's. Timed beside the plain version, SDPA's
    forward (KV repeated; a window as an explicit boolean mask; none for a
    softcap) and the bound of attention_bound plus the LSE's bytes."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    Skv = S if Skv is None else Skv
    g = _gen(300)
    q = torch.randn((B, S, Hq, hd), generator=g, device=DEVICE).to(dtype)
    k, v = (torch.randn((B, Skv, Hkv, hd), generator=g,
                        device=DEVICE).to(dtype) for _ in range(2))
    pos = torch.arange(S, dtype=torch.int32, device=DEVICE)
    kpos = torch.arange(Skv, dtype=torch.int32, device=DEVICE)
    kw = dict(causal=causal, window=window, logit_cap=cap, q_positions=pos,
              kv_positions=kpos)
    out, lse = fa.flash_fwd(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, fa.flash_fwd(q, k, v, **kw)):
        raise AssertionError(f"{name}: writing the LSE changed out")
    _, want = ref.attention_lse_plain(q, k, v, **kw)
    err = (lse - want).abs()
    max_err = float(err.max())
    if not bool((err <= LSE_TOL + LSE_TOL * want.abs()).all()):
        raise AssertionError(f"{name} {dtype}: K1's LSE disagrees with the "
                             f"plain LSE, max abs err {max_err}")
    del out, lse, want, err
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, return_lse=True, **kw))
    plain_ms = time_ms(lambda: ref.attention_lse_plain(q, k, v, **kw),
                       iters=2, warmup=1)
    library_ms = None
    if cap is None:
        G = Hq // Hkv
        ql, kl, vl = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)))
        mask = None if window is None else _valid(pos, kpos, causal, window)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask,
            is_causal=causal and mask is None))
        del ql, kl, vl, mask
    bound_ms, bound_by = attention_bound(q, k, pos, kpos, causal, window,
                                         extra_bytes=4 * B * Hq * S)
    log(f"[kernel] flash_fwd lse {name:>18} {str(dtype)[6:]:>8} err "
        f"{max_err:.3e} (atol = rtol = {LSE_TOL}) kernel {ms:.4f} ms plain "
        f"{plain_ms:.4f} ms library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"kernel": "flash_fwd", "case": f"{name}_lse",
            "dtype": str(dtype)[6:], "shape": [B, S, Skv, Hq, Hkv, hd],
            "causal": causal, "max_abs_err": max_err, "atol": LSE_TOL,
            "rtol": LSE_TOL,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# K1b cases whose passes are also traced (device ms of each kernel a launch)
BWD_TRACED = ("qwen3_train", "window_2048_hd256")


def bwd_case(name, B, Sq, Skv, Hq, Hkv, hd, causal, window, cap, empty,
             dtype):
    """K1b against flash_bwd_plain on the same out, lse and dout (the bf16
    limit with the rounding term of ref.flash_bwd_rounding_plain), a rerun
    bit for bit; timed beside the plain version, SDPA forward + backward
    with KV repeated (never called by the port: is_causal for causal cases
    without a window, an explicit boolean mask for a window or empty slots,
    neither for a case that is not causal; none for a softcap) and the
    bound: 10 hd operations per valid (query, key) pair and query head over
    the dtype's peak; bytes of q, k, v, out, dout and lse read and dq, dk,
    dv written."""
    from repro_torch.kernels import flash_bwd as fb
    from repro_torch.kernels import ref

    g = _gen(400)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=DEVICE).to(dtype)
    q, dout = rnd(B, Sq, Hq, hd), rnd(B, Sq, Hq, hd)
    k, v = rnd(B, Skv, Hkv, hd), rnd(B, Skv, Hkv, hd)
    qp = torch.arange(Sq, dtype=torch.int32, device=DEVICE)
    kp = torch.arange(Skv, dtype=torch.int32, device=DEVICE)
    if empty:  # every 7th slot empty, key 0 too: query 0 sees no key
        kp[::7] = -1
    kw = dict(causal=causal, window=window, logit_cap=cap, q_positions=qp,
              kv_positions=kp)
    out, lse = ref.attention_lse_plain(q, k, v, **kw)
    plan = fb.plan(B, Sq, Skv, Hq, Hkv, hd, dtype, sms=fb.device_sms(DEVICE))
    before = ledger().get("flash_bwd.reduce", 0)
    got = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    reduced = ledger().get("flash_bwd.reduce", 0) - before
    if reduced != int(plan.splits > 1):
        raise AssertionError(f"flash_bwd {name}: the reduce pass ran "
                             f"{reduced} times with {plan.splits} splits")
    want = ref.flash_bwd_plain(q, k, v, out, lse, dout, **kw)
    extra = (ref.flash_bwd_rounding_plain(q, k, v, out, lse, dout, **kw)
             if dtype == torch.bfloat16 else (0.0,) * 3)
    atol, rtol = TOL[dtype]
    max_err = 0.0
    for part, a, b, e in zip(("dq", "dk", "dv"), got, want, extra):
        err = (a.float() - b.float()).abs()
        max_err = max(max_err, float(err.max()))
        if a.dtype != b.dtype or not bool(
                (err <= atol + rtol * b.float().abs() + e).all()):
            raise AssertionError(f"flash_bwd {name} {dtype} {part}: kernel "
                                 f"disagrees with the plain version, max abs "
                                 f"err {float(err.max())} (atol {atol}, rtol "
                                 f"{rtol}" + (", + the bf16 rounding term)"
                                              if dtype == torch.bfloat16
                                              else ")"))
    again = fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_bwd {name}: two runs differ")
    del want, again, extra
    # every input set of the timed shapes exceeds the L2 (q alone 64 MB at
    # the training shape), so no rotation
    call = lambda: fb.flash_bwd(q, k, v, out, lse, dout, **kw)
    ms = time_ms(call, iters=10)
    plain_ms = time_ms(lambda: ref.flash_bwd_plain(q, k, v, out, lse, dout,
                                                   **kw), iters=2, warmup=1)
    library_ms = None
    if cap is None:
        G = Hq // Hkv
        ql = q.transpose(1, 2).detach().requires_grad_()
        kl, vl = (t.repeat_interleave(G, 2).transpose(1, 2).detach()
                  .requires_grad_() for t in (k, v))
        dl = dout.transpose(1, 2)
        # empty slots and windows as an explicit mask (a query that sees no
        # key gives NaN there: the call is timed, not compared)
        mask = (None if window is None and not empty
                else _valid(qp, kp, causal, window))

        def sdpa():
            ql.grad = kl.grad = vl.grad = None
            F.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                           is_causal=causal and mask is None
                                           ).backward(dl)
        library_ms = time_ms(sdpa, iters=10)
        del ql, kl, vl
    passes = kernel_ms(call) if name in BWD_TRACED else None
    ok = _valid(qp, kp, causal, window)
    pairs = int(ok.sum())
    flops = 10.0 * hd * Hq * B * pairs
    es = q.element_size()
    nbytes = (es * (4 * B * Sq * Hq * hd + 4 * B * Skv * Hkv * hd)
              + 4 * B * Hq * Sq)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    row = dict(kernel="flash_bwd", case=name, dtype=str(dtype)[6:],
               shape=[B, Sq, Skv, Hq, Hkv, hd], causal=causal, window=window,
               logit_cap=cap, empty_slots=empty, splits=plan.splits,
               dkdv_ctas=plan.dkdv_ctas * plan.splits, max_abs_err=max_err,
               atol=atol, rtol=rtol, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               gflop=flops / 1e9, tflops=flops / ms / 1e9, passes=passes)
    log(f"[kernel] flash_bwd {name:>22} {row['dtype']:>8} err {max_err:.3e} "
        f"kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s of the function's "
        f"work) plain {plain_ms:.4f} ms library "
        f"{library_ms if library_ms is None else round(library_ms, 4)} ms "
        f"bound {bound_ms:.4f} ms ({bound_by}, {flops / 1e9:.1f} GFLOP); "
        f"splits {plan.splits}, {row['dkdv_ctas']} dk/dv CTAs"
        + (f"; device ms a launch {passes}" if passes else ""))
    return row


def kernel_ms(fn, calls=6):
    """Device ms per launch of each of the port's kernels that ``fn``
    launches, from torch.profiler's CUDA events over ``calls`` calls after a
    warm-up: each kernel's total time over the launches the trace holds
    (the profiler may miss the first launches after it starts)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in TRACE_NAMES)):
            name = e.name.split("namespace)::")[-1].split("(")[0]
            t, n = by_name.get(name, (0.0, 0))
            by_name[name] = (t + e.time_range.elapsed_us(), n + 1)
    return {k: round(t / n / 1e3, 5) for k, (t, n) in by_name.items()}


# kernels that must hold HMMA instructions, by a part of their name, and how
# many instantiations of each the library holds: K1b's dk/dv and dq kernels
# (2 dtypes x 4 head-dim tilings), K3b's matrix passes (2 dtypes each)
SASS_HMMA = {"flash_bwd_dkdv": 8, "flash_bwd_dq": 8, "wkv_summary_kernel": 2,
             "wkv_bwd_cot_kernel": 2}


def sass_hmma(lib_path):
    """HMMA instructions in each kernel of SASS_HMMA in the built library, by
    cuobjdump -sass: K1b's dk/dv and dq kernels must run on the tensor cores
    (bf16 m16n8k16 and, in the fp32 body, TF32 m16n8k8), and so must K3b's
    chunk states and chunk cotangents (3xTF32 m16n8k8). cuobjdump is the
    one beside the nvcc that built the library; without it the check fails."""
    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(os.path.realpath(build.nvcc())),
                        "cuobjdump")
    if not os.path.exists(tool):
        raise RuntimeError(f"{tool} not found: the HMMA check of K1b and "
                           "K3b cannot run")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if not any(part in name for part in SASS_HMMA):
                name = None
            else:
                counts[name] = {"hmma": 0, "bf16": 0, "tf32": 0}
        elif name is not None and "HMMA" in line:
            c = counts[name]
            c["hmma"] += 1
            c["bf16"] += ".BF16" in line
            c["tf32"] += ".TF32" in line
    for fn, c in sorted(counts.items()):
        log(f"[sass] {fn}: {c['hmma']} HMMA ({c['bf16']} bf16, {c['tf32']} "
            "tf32)")
    found = {part: sum(part in fn for fn in counts) for part in SASS_HMMA}
    if found != SASS_HMMA or any(c["hmma"] == 0 for c in counts.values()):
        raise AssertionError(f"K1b or K3b kernels without HMMA, or not "
                             f"{SASS_HMMA} of them: {found} {counts}")
    return counts


def phase_train_kernels():
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(lse_case("qwen3_prefill", 1, SERVE["prompt_len"], 32, 8,
                             128, None, None, dtype))
        rows.append(lse_case("window_softcap", 2, 300, 8, 2, 64, 64, 30.0,
                             dtype))
        rows.append(lse_case("qwen3_train", TRAIN["batch"], TRAIN["seq"], 32,
                             8, 128, None, None, dtype))
        rows.append(lse_case("whisper_cross", WHISPER["batch"],
                             WHISPER["seq"], 6, 6, 64, None, None, dtype,
                             Skv=1500, causal=False))
        # mixtral-8x22b's Trainer: 48/8 (G 6), window 4096, past it
        t = MOE_TRAIN["mixtral-8x22b"]["trainer"]
        rows.append(lse_case("mixtral_train", t["batch"], t["seq"], 48, 8,
                             128, 4096, None, dtype))
        for case in BWD_CASES:
            rows.append(bwd_case(*case, dtype))
    free_memory()
    return rows


def _config(arch, groups):
    """``arch`` at full width with the layer groups ``groups``."""
    from repro_torch.models import LayerGroup, get_config
    return dataclasses.replace(get_config(arch), groups=tuple(
        LayerGroup(pattern, repeat) for pattern, repeat in groups))


def train_grads_check(arch, cfg, seq, compute_dtype=torch.bfloat16,
                      batch_size=1):
    """One microbatch [batch_size, seq] (with an encoder-decoder model's
    frames) through loss_fn and the backward, kernel path
    against plain path, from the same fp32 parameters, bf16 compute unless
    ``compute_dtype`` says otherwise; remat on, so each forward kernel runs
    twice a layer. An MoE arch's recomputed routes must equal its forward's,
    and the (token, k) routes the plain path picks otherwise are counted.
    fp32 holds the plain path unpinned. In bf16 a flipped route moves the
    gradients of two experts by a token's whole contribution: with N of M
    assignments flipped, a stacked expert leaf's gradient by about
    sqrt(2 N / M) of its norm, which no rounding limit bounds. So bf16 holds
    the plain path pinned to the kernel path's routes (Routes), where the
    dense archs' limits apply, and prints the unpinned path's errors."""
    from repro_torch.models import Backbone
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad

    kern = Backbone(cfg, compute_dtype=compute_dtype,
                    param_dtype=torch.float32, remat=True, device=DEVICE)
    plain = Backbone(cfg, compute_dtype=compute_dtype,
                     param_dtype=torch.float32, remat=True, device=DEVICE,
                     kernel_impl="plain")
    loss_rtol, grad_rtol = ((TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL)
                            if compute_dtype == torch.bfloat16 else
                            (TRAIN_FP32_LOSS_RTOL, TRAIN_FP32_GRAD_RTOL))
    moe = cfg.ffn_kind == "moe"
    torch.cuda.reset_peak_memory_stats()
    params = kern.init(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    toks = rng.integers(0, cfg.vocab, (batch_size, seq + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_enc_dec:
        batch["enc_frames"] = rng.standard_normal(
            (batch_size, cfg.enc_seq, cfg.d_model), dtype=np.float32)
    dispatch().reset()
    with Routes() as rk:
        lk, gk = value_and_grad(kern, params, batch)
    torch.cuda.synchronize()
    counts = ledger()
    _check_counts(f"{arch} loss_fn + backward (remat)", counts,
                  _train_want(kern, batch_size, seq, 1, 2))

    def worst(grads):
        return max(float((a - b).norm() / b.norm())
                   for a, b in zip(tree_leaves(gk), tree_leaves(grads)))
    routes, unpinned = "", None
    with Routes() as rf:
        lp, gp = value_and_grad(plain, params, batch)
    if moe:
        n = cfg.n_layers
        fwd, again = rk.calls[:n], rk.calls[n:][::-1]
        if len(again) != n or not all(torch.equal(a, b)
                                      for a, b in zip(fwd, again)):
            raise AssertionError(f"train {arch}: remat's recomputed routes "
                                 "differ from the forward's")
        flips = sum(int((a != b).sum()) for a, b in zip(fwd, rf.calls[:n]))
        total = sum(c.numel() for c in fwd)
        routes = (f"; {flips} of {total} (token, k) routes differ on the "
                  f"plain path unpinned, "
                  f"{sum(dropped(cfg, c) for c in fwd)} assignments dropped")
        if compute_dtype == torch.bfloat16:
            unpinned = {"flips": flips, "assignments": total,
                        "loss_err": abs(float(lk) - float(lp)),
                        "worst_grad_rel_err": worst(gp),
                        "sqrt_2n_over_m": math.sqrt(2 * flips / total)}
            del gp
            with Routes(pin=rk.calls):
                lp, gp = value_and_grad(plain, params, batch)
            routes += (f"; held with the plain path pinned to the kernel "
                       f"path's routes (unpinned: loss err "
                       f"{unpinned['loss_err']:.3e}, worst leaf "
                       f"{unpinned['worst_grad_rel_err']:.3e} of its norm, "
                       f"sqrt(2 N / M) {unpinned['sqrt_2n_over_m']:.3e})")
    peak = torch.cuda.max_memory_allocated()
    loss_err = abs(float(lk) - float(lp))
    grad_err = worst(gp)
    finite = all(bool(torch.isfinite(a).all()) for a in tree_leaves(gk))
    log(f"[train] {arch} full width, {cfg.n_layers} layers "
        f"{'+'.join(cfg.layer_kinds())}, [{batch_size}, {seq}] "
        f"{str(compute_dtype)[6:]} compute: kernel path vs plain path, loss "
        f"{float(lk):.6f} vs {float(lp):.6f} (err {loss_err:.3e}, tol "
        f"{loss_rtol} x loss), worst leaf gradient err {grad_err:.3e} of its "
        f"norm (tol {grad_rtol}), {len(tree_leaves(gk))} leaves; launches "
        f"{with_totals(counts)}{routes}; peak memory {peak / 1e9:.2f} GB")
    if not finite or not math.isfinite(float(lk)):
        raise AssertionError(f"train {arch}: a gradient or the loss is not "
                             "finite")
    if loss_err > loss_rtol * abs(float(lp)) or grad_err > grad_rtol:
        raise AssertionError(f"train {arch}: the kernel path's loss or "
                             "gradients disagree with the plain path's")
    del kern, plain, params, gk, gp
    free_memory()
    return {"batch": batch_size, "seq": seq,
            "compute_dtype": str(compute_dtype)[6:],
            "loss_kernel": float(lk), "loss_plain": float(lp),
            "loss_err": loss_err, "worst_grad_rel_err": grad_err,
            "launches": counts, "routes": routes, "unpinned": unpinned,
            "max_memory_allocated_gb": peak / 1e9}


def bf16_witness(arch, cfg, seq):
    """The kernel path and the plain path, both in bf16 compute, against the
    plain path in fp32 compute (the reference), from the same fp32
    parameters and one microbatch [1, seq], remat on: each path's loss error
    and worst leaf's gradient error (of the reference leaf's norm). A fault
    of the kernels' bf16 path inside the model would put the kernel path's
    gradients further from the reference than the plain path's; the model's
    own sensitivity to bf16 compute moves both alike."""
    from repro_torch.models import Backbone
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.steps import value_and_grad

    def path(dtype, impl):
        return Backbone(cfg, compute_dtype=dtype, param_dtype=torch.float32,
                        remat=True, device=DEVICE, kernel_impl=impl)

    params = path(torch.float32, "plain").init(SEED + 3)
    toks = np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (1, seq + 1), dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    l_ref, g_ref = value_and_grad(path(torch.float32, "plain"), params, batch)
    g_ref = tree_leaves(g_ref)
    out = {"seq": seq, "loss_fp32_plain": float(l_ref)}
    for impl in ("kernel", "plain"):
        loss, grads = value_and_grad(path(torch.bfloat16, impl), params, batch)
        out[impl] = {
            "loss": float(loss), "loss_err": abs(float(loss) - float(l_ref)),
            "worst_grad_rel_err": max(float((a - b).norm() / b.norm()) for a, b
                                      in zip(tree_leaves(grads), g_ref))}
        del grads
    k, p = out["kernel"], out["plain"]
    log(f"[train] {arch} bf16 witness, {cfg.n_layers} layers, [1, {seq}], vs "
        f"the fp32 plain path (loss {float(l_ref):.6f}): kernel path loss err "
        f"{k['loss_err']:.3e}, worst leaf {k['worst_grad_rel_err']:.3e}; plain "
        f"path loss err {p['loss_err']:.3e}, worst leaf "
        f"{p['worst_grad_rel_err']:.3e} (kernel's within {WITNESS_RATIO} x "
        f"plain's; losses within {TRAIN_LOSS_RTOL} x loss)")
    del g_ref, params
    free_memory()
    loss_tol = TRAIN_LOSS_RTOL * abs(float(l_ref))
    if not (k["worst_grad_rel_err"] <= WITNESS_RATIO * p["worst_grad_rel_err"]
            and max(k["loss_err"], p["loss_err"]) <= loss_tol):
        raise AssertionError(f"train {arch}: in bf16 the kernel path stands "
                             "further from the fp32 reference than the "
                             "plain path")
    return out


def train_run(arch, cfg, batch_size, seq, steps, remat):
    """The Trainer of launch/train.py at full width: ``steps`` steps of
    batch_size x seq tokens, bf16 compute, fp32 params and state, exact
    launch counts, a falling loss; then one profiled step."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import Backbone
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import StepSettings, make_train_step
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    depth, tokens = cfg.n_layers, batch_size * seq
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                  remat=remat, device=DEVICE)
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq,
                          global_batch=batch_size, seed=SEED,
                          enc_seq=cfg.enc_seq, enc_dim=cfg.d_model)
    settings = StepSettings(remat=remat)
    with tempfile.TemporaryDirectory() as d:
        # ckpt_every above the run: the state (tens of GB) is not written
        tr = Trainer(bb, opt_cfg, data_cfg,
                     TrainerConfig(total_steps=steps, ckpt_every=steps + 1,
                                   log_every=1, ckpt_dir=d), settings)
        try:
            free_memory()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            dispatch().reset()
            t0 = time.perf_counter()
            # no reference to the initial state: each step replaces it
            state = tr.run(tr.init_or_restore(SEED))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ledger()
            peak = torch.cuda.max_memory_allocated()
            cursor = tr.store.snapshot(("data_cursor",))["data_cursor"]
            log_ = list(tr.metrics_log)
        finally:
            tr.shutdown()
    _check_counts(f"{arch} Trainer, {steps} steps", counts,
                  _train_want(bb, batch_size, seq, steps, 2 if remat else 1))
    if cursor != steps or len(log_) != steps:
        raise AssertionError(f"train {arch}: {len(log_)} steps logged, cursor "
                             f"{cursor}, want {steps}")
    for m in log_:
        if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
            raise AssertionError(f"train {arch}: step {m['step']} not finite: "
                                 f"{m}")
        log(f"[train] {arch} step {m['step']}: loss {m['loss']:.5f} grad_norm "
            f"{m['grad_norm']:.5f} {m['dt'] * 1e3:.1f} ms "
            f"{tokens / m['dt']:.0f} tokens/s")
    if not log_[-1]["loss"] < log_[0]["loss"]:
        raise AssertionError(f"train {arch}: the loss did not fall: "
                             f"{[m['loss'] for m in log_]}")
    steady = [m["dt"] for m in log_[1:]]
    out = {"layers": depth, "kinds": cfg.layer_kinds(), "batch": batch_size,
           "seq": seq, "remat": remat, "steps": steps,
           "tokens_per_step": tokens, "log": log_, "launches": counts,
           "wall_s": wall, "step_ms_after_first": [t * 1e3 for t in steady],
           "tokens_per_s_after_first": tokens * len(steady) / sum(steady),
           "max_memory_allocated_gb": peak / 1e9,
           "allocated_before_gb": held / 1e9,
           "params": sum(int(t.numel()) for t in
                         adamw.tree_leaves(state["params"]))}
    log(f"[train] {arch} {depth} layers, {out['params'] / 1e9:.3f} B params, "
        f"remat {remat}: {steps} Trainer steps of {batch_size} x {seq} tokens "
        f"in {wall:.3f} s; after the first, "
        f"{out['tokens_per_s_after_first']:.0f} tokens/s; launches "
        f"{with_totals(counts)}; "
        f"peak memory {out['max_memory_allocated_gb']:.2f} GB, the step "
        f"donating its state{functional_peak(arch)} "
        f"({out['allocated_before_gb']:.2f} GB allocated before the run) | "
        f"{card_line()}")
    # one more step of the same function under the profiler: it donates, as
    # the Trainer's does (a functional step would hold a second state)
    step_fn = make_train_step(bb, opt_cfg, settings, donate=True)
    batch = make_batch(data_cfg, steps)
    out["trace"] = profile_calls(
        f"{arch} train step ({depth} layers, {tokens} tokens)",
        lambda: float(step_fn(state, batch)[1]["loss"]), calls=1)
    del state, bb, tr
    free_memory()
    return out


def functional_peak(cell):
    """" (functional step: x GB)" where FUNCTIONAL_PEAK_GB has the cell,
    else ""."""
    if cell not in FUNCTIONAL_PEAK_GB:
        return ""
    return f" (functional step: {FUNCTIONAL_PEAK_GB[cell]} GB)"


def donate_check(steps=3):
    """make_train_step(donate=True) against the functional step at the
    reduced qwen3-4b on the card (bf16 compute on the kernel path, fp32
    parameters and AdamW state), ``steps`` steps from clones of one init:
    every leaf, the loss and grad_norm bit for bit, and every donated leaf
    keeps its storage."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import Backbone, get_config, reduced
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                           make_train_step)

    cfg = reduced(get_config("qwen3-4b"))
    bb = Backbone(cfg, compute_dtype=torch.bfloat16, param_dtype=torch.float32,
                  remat=False, device=DEVICE)
    settings = StepSettings(remat=False)
    opt_cfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=1, total_steps=10)
    data = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=4, seed=SEED)
    functional = make_train_step(bb, opt_cfg, settings)
    donating = make_train_step(bb, opt_cfg, settings, donate=True)
    state = init_train_state(bb, SEED, settings)
    d_state = adamw.tree_map(torch.clone, state)
    ptrs = [t.data_ptr() for t in adamw.tree_leaves(d_state)]
    same_metrics = True
    for i in range(steps):
        batch = make_batch(data, i)
        state, m = functional(state, batch)
        out, dm = donating(d_state, batch)
        same_metrics &= all(torch.equal(m[k], dm[k]) for k in m)
    torch.cuda.synchronize()
    leaves = list(zip(adamw.tree_leaves(state), adamw.tree_leaves(out)))
    same = sum(torch.equal(a, b) for a, b in leaves)
    kept = [t.data_ptr() for t in adamw.tree_leaves(out)] == ptrs
    log(f"[train] donate check, reduced qwen3-4b on the card, {steps} steps of "
        f"4 x 64, bf16 compute: the donating step against the functional "
        f"step: {same} of {len(leaves)} leaves bit for bit, loss and "
        f"grad_norm equal {same_metrics}, donated storages kept {kept}")
    if same != len(leaves) or not same_metrics or not kept:
        raise AssertionError("train: the donating step differs from the "
                             "functional step")
    del state, d_state, out
    free_memory()
    return {"steps": steps, "leaves": len(leaves), "bitwise": True}


def train_restart_check():
    """Crash at step 13 of 24 at the reduced qwen3-4b (fp32), restart from
    the step-8 checkpoint: the losses of steps 8..23 match an uninterrupted
    run's within TRAIN_RESTART_RTOL."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import Backbone, get_config, reduced
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import StepSettings
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig

    cfg = reduced(get_config("qwen3-4b"))

    def trainer(d):
        bb = Backbone(cfg, compute_dtype=torch.float32, remat=False,
                      device=DEVICE)
        return Trainer(bb, adamw.AdamWConfig(lr=2e-3, warmup_steps=4,
                                             total_steps=24),
                       DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4),
                       TrainerConfig(total_steps=24, ckpt_every=8,
                                     ckpt_dir=d, log_every=1000),
                       StepSettings(remat=False))

    def run(d, crash_at=None):
        tr = trainer(d)
        try:
            state = tr.init_or_restore()
            start = tr.start_step
            tr.run(state, crash_at=crash_at)
            return start, {m["step"]: m["loss"] for m in tr.metrics_log}
        finally:
            tr.shutdown()

    with tempfile.TemporaryDirectory() as d:
        _, ref_losses = run(os.path.join(d, "a"))
        try:
            run(os.path.join(d, "b"), crash_at=13)
            raise AssertionError("train: the injected crash did not happen")
        except RuntimeError as e:
            if "injected crash" not in str(e):
                raise
        start, res_losses = run(os.path.join(d, "b"))
    err = max(abs(res_losses[s] - ref_losses[s]) / abs(ref_losses[s])
              for s in range(8, 24))
    log(f"[train] crash-restart, reduced qwen3-4b: resumed at step {start}, "
        f"losses of steps 8..23 vs the uninterrupted run, max rel err "
        f"{err:.3e} (tol {TRAIN_RESTART_RTOL})")
    if start != 8 or sorted(res_losses) != list(range(8, 24)) \
            or err > TRAIN_RESTART_RTOL:
        raise AssertionError("train: the restarted run differs from the "
                             "uninterrupted one")
    return {"resumed_at": start, "max_rel_loss_err": err}


def phase_train():
    """Train qwen3-4b (depth 8), the gemma2-2b gradient check, then
    recurrentgemma-9b and rwkv6-3b, then the MoE archs' gradient checks and
    Trainers, whisper-tiny, the crash restart and the donating step's
    check; each model is freed before the next."""
    out = {}
    cfg = _config("qwen3-4b", ((("attn",), TRAIN["depth"]),))
    out["qwen3-4b"] = {
        "grads": train_grads_check("qwen3-4b", cfg, TRAIN["grad_seq"]),
        "trainer": train_run("qwen3-4b", cfg, TRAIN["batch"], TRAIN["seq"],
                             TRAIN["steps"], remat=False)}
    g = OTHER_TRAIN["gemma2-2b"]
    out["gemma2-2b"] = {"grads": train_grads_check(
        "gemma2-2b", _config("gemma2-2b", g["groups"]), g["grad_seq"])}
    for arch in ("recurrentgemma-9b", "rwkv6-3b"):
        spec = OTHER_TRAIN[arch]
        cfg = _config(arch, spec["groups"])
        out[arch] = {
            "grads": train_grads_check(arch, cfg, spec["grad_seq"],
                                       spec.get("grad_dtype", torch.bfloat16))}
        if "bf16_groups" in spec:
            out[arch]["grads_bf16"] = train_grads_check(
                arch, _config(arch, spec["bf16_groups"]), spec["grad_seq"])
            out[arch]["bf16_witness"] = bf16_witness(arch, cfg,
                                                     spec["grad_seq"])
        out[arch]["trainer"] = train_run(arch, cfg, spec["batch"], spec["seq"],
                                         spec["steps"], spec["remat"])
    for arch, spec in MOE_TRAIN.items():
        cfg = _config(arch, spec["groups"])
        out[arch] = {f"grads_{str(dt)[6:]}": train_grads_check(
            arch, cfg, spec["grad_seq"], dt)
            for dt in (torch.float32, torch.bfloat16)}
        if "trainer" in spec:
            t = spec["trainer"]
            out[arch]["trainer"] = train_run(arch, cfg, t["batch"], t["seq"],
                                             t["steps"], t["remat"])
    # whisper-tiny at full depth: 1500 frames a sequence, remat off
    cfg, w = _config("whisper-tiny", MODEL_CHECKS["whisper-tiny"][0]), WHISPER
    out["whisper-tiny"] = {f"grads_{str(dt)[6:]}": train_grads_check(
        "whisper-tiny", cfg, w["grad_seq"], dt, batch_size=w["grad_batch"])
        for dt in (torch.float32, torch.bfloat16)}
    out["whisper-tiny"]["trainer"] = train_run(
        "whisper-tiny", cfg, w["batch"], w["seq"], w["steps"], remat=False)
    out["restart"] = train_restart_check()
    out["donate"] = donate_check()
    return out


DIST = dict(steps=3, dryrun_timeout=900,
            cells=(("whisper-tiny", "train_4k", "single"),
                   ("whisper-tiny", "train_4k", "multi"),
                   ("qwen3-4b", "train_4k", "single")))


def _dist_steps(state, batches, step_fn, place=lambda b: b):
    """``step_fn`` over ``batches`` from ``state``: (final state, losses,
    host ms a step)."""
    losses, ms = [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, place(batch))
        loss = metrics["loss"]
        loss = float(loss.full_tensor() if hasattr(loss, "full_tensor")
                     else loss)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return state, losses, ms


def phase_dist():
    """The distribution layer. (1) qwen3-4b at phase 6's width and depth
    (TRAIN: 8 layers, [4, 2048], bf16 compute, fp32 parameters and AdamW,
    no remat) trained for DIST["steps"] steps through make_train_step
    (donating, as the Trainer's) on plain tensors, then from the same seed
    (each path its own state) on a (1, 1) mesh over a one-rank
    NCCL group (launch.mesh.make_host_mesh): the state placed by
    param_shardings with ZeRO-3, the per-layer gather on, the batch placed
    by batch_shardings; the losses and every leaf bit for bit, K1 with its
    LSE and each K1b pass launched once a layer and step on the sharded
    path, the step ms and a profiled step of each. (2) The fake-mesh dry
    run of DIST["cells"] (launch.dryrun.run_cell) in a subprocess that sees
    no card, and the same counter over the step of (1) on a fake (1, 1)
    mesh: its FLOPs beside model_flops and the measured step."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import roofline
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh, tp_size
    from repro_torch.models import Backbone, PartitionPlan, ShapeConfig
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                           make_train_step)
    from repro_torch.runtime.train_loop import to_host

    steps, B, S = DIST["steps"], TRAIN["batch"], TRAIN["seq"]
    cfg = _config("qwen3-4b", ((("attn",), TRAIN["depth"]),))
    settings = StepSettings(remat=False)        # zero3 and the gather on
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                          seed=SEED)
    batches = [make_batch(data_cfg, i) for i in range(steps)]
    kw = dict(compute_dtype=torch.bfloat16, param_dtype=torch.float32,
              remat=False, device=DEVICE)
    out = {"steps": steps, "batch": B, "seq": S, "layers": cfg.n_layers}

    # (1a) the plain path: the parameters after the last step kept on the
    # host (4.8 GB) before the profiled step writes into them. Both paths
    # donate their state, as the Trainer does, and each owns the state it
    # made from the seed.
    free_memory()
    plain = Backbone(cfg, PartitionPlan(tp=1), **kw)
    plain_step = make_train_step(plain, opt_cfg, settings, donate=True)
    state, want_losses, plain_ms = _dist_steps(
        init_train_state(plain, SEED), batches, plain_step)
    want = to_host(state["params"])
    out["plain_trace"] = profile_calls(
        "qwen3-4b train step, plain tensors",
        lambda: float(plain_step(state, batches[0])[1]["loss"]), calls=1)
    del state, plain
    free_memory()

    # (1b) the sharded path at world size 1
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        dp = sh.effective_dp(cfg, mesh, B)
        bb = Backbone(cfg, PartitionPlan(tp=tp_size(mesh)),
                      sharder=sh.make_sharder(cfg, mesh, global_batch=B),
                      param_gather=sh.make_param_gatherer(cfg, mesh),
                      mesh=mesh, dp_axes=dp, **kw)
        st_sh = sh.state_shardings(sh.param_shardings(bb, mesh, zero3=True),
                                   mesh)
        bsh = sh.batch_shardings(cfg, ShapeConfig("train", S, B, "train"),
                                 mesh)

        def place(batch):
            return {k: sh.distribute(torch.as_tensor(v, device=DEVICE),
                                     bsh[k]) for k, v in batch.items()}
        step_fn = make_train_step(bb, opt_cfg, settings, donate=True)
        state = sh.tree_distribute(init_train_state(bb, SEED), st_sh)
        torch.cuda.reset_peak_memory_stats()
        dispatch().reset()
        state, got_losses, dist_ms = _dist_steps(state, batches, step_fn,
                                                 place)
        counts = ledger()
        peak = torch.cuda.max_memory_allocated()
        _check_counts("qwen3-4b sharded train steps", counts,
                      _train_want(bb, B, S, steps, fwd=1))
        got = to_host(state["params"])
        leaves = list(zip(adamw.tree_leaves(got), adamw.tree_leaves(want)))
        same = sum(torch.equal(a, b) for a, b in leaves)
        worst = max(float((a - b).abs().max()) for a, b in leaves)
        log(f"[dist] qwen3-4b {cfg.n_layers} layers, {steps} steps of {B} x "
            f"{S} tokens on a (data 1, model 1) mesh over one NCCL rank, "
            f"ZeRO-3 + per-layer gather: losses {got_losses} vs plain "
            f"{want_losses}; {same} of {len(leaves)} leaves bit for bit "
            f"(max abs diff {worst:.3e}); step ms sharded {dist_ms} vs plain "
            f"{plain_ms}; peak {peak / 1e9:.2f} GB, the step donating its "
            f"state{functional_peak('qwen3-4b dist train')}; launches "
            f"{with_totals(counts)} | {card_line()}")
        if got_losses != want_losses or same != len(leaves):
            raise AssertionError("the sharded step at world size 1 differs "
                                 "from the plain step")
        out["dist_trace"] = profile_calls(
            "qwen3-4b train step, (1, 1) mesh", lambda: float(step_fn(
                state, place(batches[0]))[1]["loss"].full_tensor()), calls=1)
        out.update(losses=got_losses, plain_ms=plain_ms, dist_ms=dist_ms,
                   launches=counts, peak_gb=peak / 1e9, bitwise=True)
        del state, got, want, leaves, bb
    finally:
        dist.destroy_process_group()
    free_memory()

    # (2) the dry run, in a process of its own (the fake group and the NCCL
    # group cannot share one), without the card
    code = f"""
import dataclasses, json
from repro_torch.launch import dryrun, mesh
from repro_torch.models import LayerGroup, ShapeConfig, get_config
from repro_torch.runtime.steps import StepSettings
out = {{"cells": [dryrun.run_cell(a, s, m, settings=StepSettings())
                 for a, s, m in {list(DIST["cells"])!r}]}}
mesh.init_fake_world(1)
cfg = dataclasses.replace(get_config("qwen3-4b"),
                          groups=(LayerGroup(("attn",), {cfg.n_layers}),))
out["step"] = dryrun.count_cell(cfg, ShapeConfig("train", {S}, {B}, "train"),
                                mesh.make_host_mesh(), settings=StepSettings(
                                    remat=False))
print(json.dumps(out))
"""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=DIST["dryrun_timeout"],
                         env={**os.environ, "PYTHONPATH": src,
                              "CUDA_VISIBLE_DEVICES": ""})
    if run.returncode != 0:
        raise AssertionError(f"the dry run failed:\n{run.stderr[-3000:]}")
    dry = json.loads(run.stdout.strip().splitlines()[-1])
    log(f"[dryrun] {len(dry['cells'])} cells and the step's count in "
        f"{time.perf_counter() - t0:.1f} s (torch {torch.__version__})")
    for c in dry["cells"]:
        m, h, r = c["memory"], c["hlocost"], c["roofline"]
        log(f"[dryrun] {c['arch']} x {c['shape']} x {c['mesh']}: chips "
            f"{c['chips']}, run {c['run_s']} s, per rank: arguments "
            f"{m['argument_bytes'] / 2**30:.3f} GiB, peak "
            f"{m['peak_bytes'] / 2**30:.3f} GiB, FLOPs {h['flops']:.4e}, "
            f"collective bytes {h['collective_bytes']:.4e} (in a layer "
            f"{h['in_loop_bytes']:.4e}, {h['in_loop_count']:.0f} ops); "
            f"dominant {r['dominant']}, roofline_fraction "
            f"{r['roofline_fraction']:.4f}")
        if not (h["flops"] > 0 and h["collective_bytes"] > 0
                and h["in_loop_bytes"] > 0):
            raise AssertionError(f"dry run {c['arch']} x {c['shape']} x "
                                 f"{c['mesh']}: nothing counted: {h}")
    step = dry["step"]
    step_s = sum(dist_ms[1:]) / len(dist_ms[1:]) / 1e3
    mflops = step["roofline"]["model_flops"]
    line = dict(model_flops=mflops, counted_flops=step["hlocost"]["flops"],
                compute_s=step["roofline"]["compute_s"], step_s=step_s,
                mfu=mflops / (step_s * roofline.PEAK_FLOPS),
                peak_flops=roofline.PEAK_FLOPS,
                counted_peak_bytes=step["memory"]["peak_bytes"],
                measured_peak_bytes=peak)
    log(f"[dist] cost model beside the card, qwen3-4b {cfg.n_layers} layers "
        f"[{B}, {S}] on the (1, 1) mesh: model_flops {mflops:.4e}, counted "
        f"per-device FLOPs {line['counted_flops']:.4e}, compute_s at "
        f"{roofline.PEAK_FLOPS:.3e} FLOP/s {line['compute_s']:.5f} s, "
        f"measured step {step_s:.5f} s, model_flops / (step_s x peak) "
        f"{line['mfu']:.4f}; the donating step's peak counted "
        f"{line['counted_peak_bytes'] / 1e9:.2f} GB, measured "
        f"{peak / 1e9:.2f} GB | {card_line()}")
    out.update(dryrun=dry, cost_line=line)
    return out



# phase_remat: the reference's remat_policy at phase 6's cells, each
# configuration from the same seeded parameters and batches: qwen3-4b
# (TRAIN: 8 layers, [4, 2048]) with remat off, "full" and "dots", rwkv6-3b
# (OTHER_TRAIN: 8 layers, [4, 2048], remat on) with "full" and "dots"; then
# the dry run of REMAT["dryrun"] under both policies.
REMAT = dict(steps=3, cells={"qwen3-4b": ("off", "full", "dots"),
                             "rwkv6-3b": ("full", "dots")},
             dryrun=("qwen3-4b", "train_4k", "single"))


def remat_run(arch, cfg, batch_size, seq, policy, batches):
    """One configuration of phase_remat: the gradient of ``batches[0]``
    (kept on the host), then one donating train step a batch, each timed
    on the host's clock and between CUDA events, the launches of those
    steps exact (K1 twice an attention layer and step under remat, either
    policy), their peak memory; then a profiled step."""
    from repro_torch.models import Backbone
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import (StepSettings, init_train_state,
                                           make_train_step, value_and_grad)
    from repro_torch.runtime.train_loop import to_host

    remat = policy != "off"
    kw = dict(remat=remat, remat_policy=policy if remat else "full")
    bb = Backbone(cfg, compute_dtype=torch.bfloat16,
                  param_dtype=torch.float32, device=DEVICE, **kw)
    steps = len(batches)
    opt_cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=2, total_steps=steps)
    step_fn = make_train_step(bb, opt_cfg, StepSettings(**kw), donate=True)
    free_memory()
    state = init_train_state(bb, SEED)
    loss, grads = value_and_grad(bb, state["params"], batches[0])
    grads = to_host(grads)
    free_memory()
    torch.cuda.reset_peak_memory_stats()
    dispatch().reset()
    losses, host_ms, device_ms = [], [], []
    for batch in batches:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, metrics = step_fn(state, batch)
        end.record()
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        device_ms.append(start.elapsed_time(end))
    counts = ledger()
    peak = torch.cuda.max_memory_allocated()
    _check_counts(f"{arch} remat {policy}, {steps} steps", counts,
                  _train_want(bb, batch_size, seq, steps, 2 if remat else 1))
    out = {"policy": policy, "loss": float(loss), "grads": grads,
           "losses": losses, "host_ms": host_ms, "device_ms": device_ms,
           "peak_gb": peak / 1e9, "launches": counts}
    out["trace"] = profile_calls(
        f"{arch} train step, remat {policy}",
        lambda: float(step_fn(state, batches[0])[1]["loss"]), calls=1)
    del state, bb
    free_memory()
    return out


def remat_dryrun():
    """REMAT["dryrun"] under "full" and "dots" on the fake mesh, in a process
    that sees no card: the saved products' forward FLOPs (2 M K N, each
    rank's shards) and bytes, recorded from the "dots" policy's decisions,
    and "dots"' FLOPs equal to "full"'s less them."""
    arch, shape, mesh_kind = REMAT["dryrun"]
    code = f"""
import json, torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import CheckpointPolicy
from repro_torch.launch import dryrun
from repro_torch.models import remat
from repro_torch.runtime.steps import StepSettings
saved, policy = [], remat._dots
def recording(ctx, op, *args, **kwargs):
    decision = policy(ctx, op, *args, **kwargs)
    if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
        a, b = (args[1], args[2]) if op == torch.ops.aten.addmm.default \\
            else args[:2]
        a, b = [t.to_local() if isinstance(t, DTensor) else t for t in (a, b)]
        saved.append((a.shape[0], a.shape[1], b.shape[1], a.element_size()))
    return decision
remat._dots = recording
out = {{p: dryrun.run_cell({arch!r}, {shape!r}, {mesh_kind!r}, verbose=False,
                           settings=StepSettings(remat_policy=p))
        for p in ("full", "dots")}}
out["saved_flops"] = sum(2 * m * k * n for m, k, n, _ in saved)
out["saved_bytes"] = sum(m * n * e for m, _, n, e in saved)
out["saved_products"] = len(saved)
print(json.dumps(out))
"""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=DIST["dryrun_timeout"],
                         env={**os.environ, "PYTHONPATH": src,
                              "CUDA_VISIBLE_DEVICES": ""})
    if run.returncode != 0:
        raise AssertionError(f"the remat dry run failed:\n{run.stderr[-3000:]}")
    dry = json.loads(run.stdout.strip().splitlines()[-1])
    full, dots = dry["full"], dry["dots"]
    ff, fd = full["hlocost"]["flops"], dots["hlocost"]["flops"]
    pf, pd = full["memory"]["peak_bytes"], dots["memory"]["peak_bytes"]
    log(f"[remat] dry run {arch} x {shape} x {mesh_kind} in "
        f"{time.perf_counter() - t0:.1f} s (torch {torch.__version__}), per "
        f"rank: FLOPs full {ff:.6e}, dots {fd:.6e} (less {ff - fd:.6e}; the "
        f"{dry['saved_products']} saved products' forward FLOPs "
        f"{dry['saved_flops']:.6e}); peak full {pf / 1e9:.3f} GB, dots "
        f"{pd / 1e9:.3f} GB (more {(pd - pf) / 1e9:.3f}; saved bytes "
        f"{dry['saved_bytes'] / 1e9:.3f} GB)")
    if not (ff - fd == dry["saved_flops"] > 0 and pd > pf):
        raise AssertionError("the dry run's dots count is not full's less "
                             "the saved products")
    return {"flops": {"full": ff, "dots": fd}, "peak_bytes": {
        "full": pf, "dots": pd}, "saved_flops": dry["saved_flops"],
        "saved_bytes": dry["saved_bytes"],
        "saved_products": dry["saved_products"]}


def phase_remat():
    """The reference's remat_policy on the card (see REMAT): per cell and
    configuration the losses of REMAT["steps"] donating steps, the
    gradients of the first batch against the first configuration's bit for
    bit (remat recomputes the same values, and "dots" hands the recompute
    the forward's own products), peak memory, device and host ms a step,
    the launches (equal between "full" and "dots"); then the dry run."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim import adamw

    out = {}
    for arch, policies in REMAT["cells"].items():
        if arch == "qwen3-4b":
            cfg = _config(arch, ((("attn",), TRAIN["depth"]),))
            B, S = TRAIN["batch"], TRAIN["seq"]
        else:
            spec = OTHER_TRAIN[arch]
            cfg, B, S = _config(arch, spec["groups"]), spec["batch"], spec["seq"]
        data_cfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                              seed=SEED)
        batches = [make_batch(data_cfg, i) for i in range(REMAT["steps"])]
        runs = [remat_run(arch, cfg, B, S, p, batches) for p in policies]
        want = adamw.tree_leaves(runs[0]["grads"])
        for r in runs:
            got = adamw.tree_leaves(r.pop("grads"))
            same = sum(torch.equal(a, b) for a, b in zip(got, want))
            worst = max(float((a - b).abs().max()) for a, b in zip(got, want))
            r.update(bitwise_leaves=same, leaves=len(want),
                     max_abs_grad_diff=worst)
            busy = r["trace"]["device_busy_ms_per_call"] \
                if isinstance(r["trace"], dict) else r["trace"]
            log(f"[remat] {arch} {cfg.n_layers} layers, {B} x {S} tokens, "
                f"remat {r['policy']}: losses {r['losses']}; first batch's "
                f"gradients {same} of {len(want)} leaves bit for bit against "
                f"remat {runs[0]['policy']} (max abs diff {worst:.3e}); peak "
                f"{r['peak_gb']:.2f} GB; device ms a step {r['device_ms']}, "
                f"host ms {r['host_ms']}, profiled step device busy {busy}; "
                f"launches {with_totals(r['launches'])} | {card_line()}")
            if same != len(want) or r["losses"] != runs[0]["losses"]:
                raise AssertionError(f"{arch} remat {r['policy']}: the "
                                     "gradients or losses differ from remat "
                                     f"{runs[0]['policy']}'s")
        by = {r["policy"]: r for r in runs}
        if by["dots"]["launches"] != by["full"]["launches"]:
            raise AssertionError(f"{arch}: launches under dots "
                                 f"{by['dots']['launches']} differ from full's "
                                 f"{by['full']['launches']}")
        out[arch] = by
    out["dryrun"] = remat_dryrun()
    return out

def phase_ep():
    """moe_mlp_ep over a one-rank NCCL group (an in-memory store, no
    network) against moe_mlp: one full-width MoE layer of each MoE arch,
    bf16 weights at the init's scale, [1, 512] tokens at the config's own
    capacity factor; y, aux and every gradient (of the leaves and of x) bit
    for bit, through the all_reduce and its backward. Then a real share:
    the two ranks of tp 2, each with half the whole experts, through
    _local_moe under no_grad (its held range on M1), summed against
    moe_mlp's y within 2^-6 of its largest |y|, aux equal."""
    import torch.distributed as dist

    from repro_torch.models import ffn, get_config, moe_ep

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    out = {}
    try:
        for arch in MOE_TRAIN:
            cfg = get_config(arch)
            g = _gen(700)
            D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

            def dense(*shape):
                w = torch.randn(shape, generator=g, device=DEVICE)
                return w.mul_(shape[-2] ** -0.5).to(torch.bfloat16)
            leaves = {"router": dense(D, E), "w_gate": dense(E, D, Fe),
                      "w_up": dense(E, D, Fe), "w_down": dense(E, Fe, D)}
            x = torch.randn((1, 512, D), generator=g,
                            device=DEVICE).to(torch.bfloat16)
            ct = torch.randn((1, 512, D), generator=g,
                             device=DEVICE).to(torch.bfloat16)

            def run(fn):
                p = {k: v.detach().requires_grad_() for k, v in leaves.items()}
                xx = x.detach().requires_grad_()
                y, aux = fn(p, xx, cfg)
                (torch.sum((y * ct).float()) + aux).backward()
                return [y.detach(), aux.detach(), xx.grad] + [
                    p[k].grad for k in leaves]
            want = run(ffn.moe_mlp)
            got = run(lambda p, xx, c: moe_ep.moe_mlp_ep(p, xx, c,
                                                         dist.group.WORLD))
            same = [torch.equal(a, b) for a, b in zip(got, want)]
            log(f"[ep] {arch} one full-width layer, [1, 512], bf16, world "
                f"size 1 (NCCL): moe_mlp_ep vs moe_mlp, y, aux, dx and "
                f"{len(leaves)} leaf gradients bit for bit: {all(same)}")
            if not all(same):
                raise AssertionError(f"{arch}: moe_mlp_ep at world size 1 "
                                     f"differs from moe_mlp: {same}")
            # a real share: the two ranks of tp 2 each hold half the whole
            # experts; under no_grad each half runs on M1 over its routed
            # rows (moe_mlp's held range), and the halves sum to the layer
            V, split = moe_ep.virtualization(cfg, 2)
            with torch.no_grad():
                whole, aux = ffn.moe_mlp(leaves, x, cfg)
                parts = [moe_ep._local_moe(
                    x[0], leaves["router"],
                    *(leaves[k][r * V // 2:(r + 1) * V // 2]
                      for k in ("w_gate", "w_up", "w_down")),
                    cfg=cfg, V=V, split=split, tp=2, rank=r)
                    for r in (0, 1)]
            err = float((parts[0][0].float() + parts[1][0].float()
                         - whole[0].float()).abs().max())
            scale = float(whole.float().abs().max())
            ok = (split == 1 and err <= 2.0 ** -6 * scale
                  and all(torch.equal(a, aux) for _, a in parts))
            log(f"[ep] {arch} the two halves of tp 2 through _local_moe "
                f"(held ranges, no_grad, M1) summed vs moe_mlp: max |diff| "
                f"{err:.3e} of max |y| {scale:.3e} (limit 2^-6 of it), aux "
                f"equal: {ok}")
            if not ok:
                raise AssertionError(f"{arch}: the halves of tp 2 differ "
                                     f"from moe_mlp by {err} (max |y| "
                                     f"{scale}, split {split})")
            out[arch] = {"bitwise": True, "halves_max_diff": err,
                         "halves_max_y": scale}
            del leaves, want, got, whole, parts
            free_memory()
    finally:
        dist.destroy_process_group()
    return out


# The grouped expert kernel (csrc/moe_gemm.cu): (case, arch, tokens T, the
# capacity factor of the capacity path it stands beside). mixtral at the
# serving cell's prompt strata (945 / 1500 / 2381, capacity factor 4.0:
# C = T, nothing drops) and a 256-slot decode; qwen3-moe at its config's
# 1.25, a 512-token prefill and an 8-slot decode.
MOE_GEMM_CASES = [
    ("mixtral_prefill_945", "mixtral-8x22b", 945, 4.0),
    ("mixtral_prefill_1500", "mixtral-8x22b", 1500, 4.0),
    ("mixtral_prefill_2381", "mixtral-8x22b", 2381, 4.0),
    ("mixtral_decode_256", "mixtral-8x22b", 256, 4.0),
    ("qwen3moe_prefill_512", "qwen3-moe-235b-a22b", 512, 1.25),
    ("qwen3moe_decode_8", "qwen3-moe-235b-a22b", 8, 1.25),
]
# the cases whose no-grad moe_mlp is run under set_sync_debug_mode("error")
# and whose device launches a call are counted on both paths
MOE_PATH_CASES = ("mixtral_prefill_945", "mixtral_decode_256",
                  "qwen3moe_decode_8")


def device_launches(fn, calls=3):
    """Kernels, copies and fills on the card per call of ``fn``
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events())
    return n / calls


def grouped_mm_yardstick(buf, ends, wg, wu, wd, want):
    """PyTorch's own grouped GEMM (``torch._grouped_mm``, which the port
    never calls) over the same compact rows and each expert's end offset:
    three products (gate, up, down) with SiLU and the product between them
    in bf16, and two, with gate and up in one [E, D, 2 Fe] weight made
    beforehand and not timed. Each version's ms and its largest difference
    from the kernel's output ``want`` [routed rows, D]; the error instead
    where this torch has no such operator for these tensors."""
    import torch.nn.functional as F

    offs = ends.to(torch.int32)
    wgu = torch.cat((wg, wu), dim=-1)

    def three():
        g = torch._grouped_mm(buf, wg, offs=offs)
        u = torch._grouped_mm(buf, wu, offs=offs)
        return torch._grouped_mm(F.silu(g) * u, wd, offs=offs)

    def two():
        g, u = torch._grouped_mm(buf, wgu, offs=offs).chunk(2, dim=-1)
        return torch._grouped_mm(F.silu(g) * u, wd, offs=offs)
    out = {}
    try:
        for name, fn in (("three", three), ("two", two)):
            got = fn()[:want.shape[0]].float()
            out[name] = {"ms": time_ms(fn), "err_vs_kernel":
                         float((got - want.float()).abs().max())}
            del got
    except (AttributeError, RuntimeError) as e:
        out["unavailable"] = f"{type(e).__name__}: {e}"
    del wgu
    return out


def moe_gemm_case(name, arch, T, cf, leaves):
    """One case of the grouped expert kernel at the arch's full widths:
    tokens routed by a router at the init scale, dispatched into the compact
    buffer as the MoE layer's grouped path does; each launch against its
    plain version on the same input (the bf16 limit), both launches timed
    beside the plain version, the capacity path's three bmm products and
    SiLU over its [E, C, D] buffer on the same tokens (the path the kernel
    replaces when no gradient is taken), PyTorch's grouped GEMM on the same
    rows (grouped_mm_yardstick) and the bound: the routed rows'
    operations (2 x 3 D Fe a row) at the bf16 peak, or every byte once (the
    weights of the experts that have rows, the buffer, h written and read,
    the output) at HBM's rate."""
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ffn, get_config

    cfg = dataclasses.replace(get_config(arch), capacity_factor=cf)
    D, E, K, Fe = cfg.d_model, cfg.n_experts, cfg.top_k, cfg.moe_d_ff
    g = _gen(800 + T)
    x = torch.randn((T, D), generator=g, device=DEVICE).to(torch.bfloat16)
    wg, wu, wd, router = (leaves[k] for k in ("w_gate", "w_up", "w_down",
                                               "router"))
    C = ffn.moe_capacity(T, E, K, cf)
    _, _, idx = ffn.route(x, router, K)
    flat = idx.reshape(-1)
    keep, rows, ends = ffn.grouped_rows(flat, E, C)
    buf = ffn.dispatch_rows(x, rows)
    n = int(ends[-1])
    h = mg.moe_gate_up(buf, ends, wg, wu)
    out = mg.moe_down(h, ends, wd)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    errs = {}
    for step, got, want in (
            ("gate_up", h, ref.moe_gate_up_plain(buf, ends, wg, wu)),
            ("down", out, ref.moe_down_plain(h, ends, wd))):
        err = (got[:n].float() - want[:n].float()).abs()
        errs[step] = float(err.max())
        if not bool((err <= atol + rtol * want[:n].float().abs()).all()):
            raise AssertionError(f"moe_gemm {name} {step}: kernel disagrees "
                                 f"with the plain version, max abs err "
                                 f"{errs[step]} (atol {atol}, rtol {rtol})")
        del want, err
    ms = time_ms(lambda: ops.moe_experts(buf, ends, wg, wu, wd))
    gate_up_ms = time_ms(lambda: mg.moe_gate_up(buf, ends, wg, wu))
    down_ms = time_ms(lambda: mg.moe_down(h, ends, wd))
    plain_ms = time_ms(lambda: ref.moe_experts_plain(buf, ends, wg, wu, wd),
                       iters=2, warmup=1)
    safe = torch.where(keep, ffn.slot_positions(flat, E), 0)
    cap_buf = ffn.dispatch(x, keep, flat, safe, (E, C, D))
    library_ms = time_ms(lambda: ffn.expert_ffn(cap_buf, wg, wu, wd))
    del cap_buf
    grouped_mm = grouped_mm_yardstick(buf, ends, wg, wu, wd, out[:n])
    used = int((torch.diff(ends, prepend=ends.new_zeros(1)) > 0).sum())
    flops = 2.0 * 3 * D * Fe * n
    nbytes = 2.0 * (3 * used * D * Fe + buf.numel() + 2 * h.numel()
                    + out.numel())
    t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16], nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    row = dict(kernel="moe_gemm", case=name, dtype="bfloat16",
               shape=[T, K, E, D, Fe], capacity_factor=cf, routed_rows=n,
               capacity_rows=E * C, experts_with_rows=used,
               max_abs_err=max(errs.values()), errs=errs, atol=atol,
               rtol=rtol, ms=ms, gate_up_ms=gate_up_ms, down_ms=down_ms,
               plain_ms=plain_ms, library_ms=library_ms,
               grouped_mm=grouped_mm, bound_ms=bound_ms,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               tflops=flops / ms / 1e9)
    log(f"[kernel] moe_gemm {name:>22} bfloat16 err {row['max_abs_err']:.3e} "
        f"kernel {ms:.4f} ms (gate-up {gate_up_ms:.4f}, down {down_ms:.4f}; "
        f"{row['tflops']:.1f} TFLOP/s over {n} routed rows) plain "
        f"{plain_ms:.4f} ms capacity bmm {library_ms:.4f} ms ({E * C} rows) "
        f"torch._grouped_mm {json.dumps(grouped_mm)} "
        f"bound {bound_ms:.4f} ms ({row['bound_by']})")
    del buf, h, out
    return row


def moe_path_case(name, arch, T, cf, leaves):
    """The no-grad moe_mlp at the arch's full widths on T tokens: once under
    torch.cuda.set_sync_debug_mode("error"), which raises at any op that
    waits for the card; then its device launches a call on the grouped path
    against the capacity path's on the same input (the experts requiring
    grad)."""
    from repro_torch.models import ffn, get_config

    cfg = dataclasses.replace(get_config(arch), capacity_factor=cf)
    x = torch.randn((1, T, cfg.d_model), generator=_gen(900 + T),
                    device=DEVICE).to(torch.bfloat16)
    with torch.no_grad():
        ffn.moe_mlp(leaves, x, cfg)
        torch.cuda.synchronize()
        calls = ledger().get("moe_mlp.grouped", 0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ffn.moe_mlp(leaves, x, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if ledger().get("moe_mlp.grouped", 0) != calls + 1:
            raise AssertionError(f"{name}: the no-grad call did not take the "
                                 "grouped path")
        grouped = device_launches(lambda: ffn.moe_mlp(leaves, x, cfg))
    graded = {k: v.detach().requires_grad_(k != "router")
              for k, v in leaves.items()}
    capacity = device_launches(lambda: ffn.moe_mlp(graded, x, cfg))
    del graded
    log(f"[moe] {name}: the no-grad moe_mlp ran under set_sync_debug_mode"
        f"(\"error\") without a host sync; device launches a call: grouped "
        f"{grouped:g}, capacity {capacity:g}")
    if grouped > capacity:
        raise AssertionError(f"{name}: the grouped path launches {grouped} "
                             f"times a call, the capacity path {capacity}")
    return {"no_host_sync": True, "launches_grouped": grouped,
            "launches_capacity": capacity}


def phase_moe_gemm():
    """The grouped expert kernel at MOE_GEMM_CASES, and the no-grad MoE
    layer's host syncs and launches at MOE_PATH_CASES; one arch's leaves
    (bf16, the init's scale) at a time."""
    from repro_torch.models import get_config

    rows, paths = [], {}
    for arch in dict.fromkeys(a for _, a, _, _ in MOE_GEMM_CASES):
        cfg = get_config(arch)
        g = _gen(780)
        D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff

        def dense(*shape, dtype=torch.bfloat16):
            w = torch.randn(shape, generator=g, device=DEVICE)
            return w.mul_(shape[-2] ** -0.5).to(dtype)
        leaves = {"router": dense(D, E, dtype=torch.float32),
                  "w_gate": dense(E, D, Fe), "w_up": dense(E, D, Fe),
                  "w_down": dense(E, Fe, D)}
        for name, a, T, cf in MOE_GEMM_CASES:
            if a != arch:
                continue
            rows.append(moe_gemm_case(name, arch, T, cf, leaves))
            if name in MOE_PATH_CASES:
                paths[name] = moe_path_case(name, arch, T, cf, leaves)
            free_memory()
        del leaves
        free_memory()
    return rows, paths


# phase_net: qwen3-4b's parameters at full width and NET["depth"] layers,
# homed on a node server in pieces of at most chunk_bytes (the wire's frames
# are capped at 256 MiB, wire.MAX_FRAME); the servers' monitor timeout
# outlasts a transaction that moves 2.4 GB
NET = dict(depth=2, chunk_bytes=128 * 2**20, monitor_timeout=300.0,
           startup_timeout=60.0)


def net_schedule(reg):
    """tests/test_net_equivalence.py's ``_run_schedule`` on the port: nine
    transactions over the accounts A, B and C (read-only, transfer, write
    log, manual abort, supremum violation, mixed, trailing reads, a
    read-only sweep, fused runs). Returns the trace (tag, outcome, value,
    waits) and the final balances."""
    from repro_torch.core import AbortError, SupremumViolation, Transaction
    trace = []

    def record(tag, declare, body):
        t = Transaction(reg)
        proxies = declare(t)
        try:
            out = t.start(lambda tt: body(tt, *proxies))
            trace.append((tag, "commit", out, t.stats.waits))
        except SupremumViolation:
            trace.append((tag, "supremum-abort", None, t.stats.waits))
        except AbortError as e:
            kind = "forced-abort" if e.forced else "manual-abort"
            trace.append((tag, kind, None, t.stats.waits))

    A, B, C = (lambda n=n: reg.locate(n) for n in "ABC")
    record("ro", lambda t: (t.reads(A(), 2),),
           lambda t, a: (a.balance(), a.balance()))

    def transfer(t, a, b):
        a.withdraw(100)
        b.deposit(100)
        return a.balance()
    record("transfer", lambda t: (t.accesses(A(), 1, 0, 1),
                                  t.updates(B(), 1)), transfer)
    record("write-log", lambda t: (t.writes(C(), 1),),
           lambda t, c: c.reset())

    def doomed(t, a, b):
        a.withdraw(10_000)
        b.deposit(10_000)
        if a.balance() < 0:
            t.abort()
    record("doomed", lambda t: (t.accesses(A(), 1, 0, 1),
                                t.updates(B(), 1)), doomed)
    record("violate", lambda t: (t.updates(B(), 1),),
           lambda t, b: (b.deposit(1), b.deposit(1)))

    def final(t, a):
        a.deposit(7)
        return a.balance()
    record("final", lambda t: (t.accesses(A(), 1, 0, 1),), final)

    def trailing(t, a, b):
        a.deposit(3)
        return a.balance(), a.balance(), b.balance()
    record("trailing", lambda t: (t.accesses(A(), 2, 0, 1),
                                  t.reads(B(), 1)), trailing)
    record("ro-sweep", lambda t: (t.reads(A(), 1), t.reads(B(), 1),
                                  t.reads(C(), 1)),
           lambda t, a, b, c: a.balance() + b.balance() + c.balance())

    def fused(t, a, b):
        va = t.invoke_many(a, [("balance", (), {}), ("deposit", (11,), {}),
                               ("balance", (), {})])
        vb = t.invoke_many(b, [("deposit", (1,), {}), ("withdraw", (1,), {}),
                               ("balance", (), {}), ("reset", (), {})])
        return tuple(va), tuple(vb)
    record("fused", lambda t: (t.accesses(A(), 2, 0, 1),
                               t.accesses(B(), 1, 1, 2)), fused)
    return trace, tuple(reg.locate(n).raw_call("balance") for n in "ABC")


def net_schedules(addresses, seed=42):
    """``net_schedule`` in-process, over TCP on the node servers at
    ``addresses`` (A and C on the first, B on the second) and under the
    deterministic simulation; returns {transport: (trace, state)}."""
    from repro_torch import dtm
    from repro_torch.net.demo import Account
    from repro_torch.net.simnet import build_simnet

    def bind_all(nodes):
        for name, node, balance in (("A", nodes[0], 1000), ("B", nodes[1], 500),
                                    ("C", nodes[0], 0)):
            dtm.bind(node, name, Account(balance))

    out = {}
    reg = dtm.Registry()
    bind_all([reg.add_node("n0"), reg.add_node("n1")])
    try:
        out["inproc"] = net_schedule(reg)
    finally:
        reg.shutdown()
    reg = dtm.connect(*addresses)
    try:
        bind_all([next(n for n in reg.nodes if n.address == a)
                  for a in addresses])
        dtm.connect(*addresses, registry=reg)
        out["tcp"] = net_schedule(reg)
    finally:
        reg.shutdown()
    net = build_simnet(seed, 2)
    try:
        setup = net.client_registry("setup")
        bind_all(sorted(setup.nodes, key=lambda n: n.name))
        net.spawn(lambda: out.update(sim=net_schedule(
            net.client_registry("c0"))), "c0")
        net.run()
    finally:
        net.shutdown()
    return out


def net_pieces(params, chunk_bytes):
    """The leaves of ``params`` cut along their first dimension into pieces
    of at most ``chunk_bytes``: [(name, piece)], named by leaf path and
    piece index."""
    from torch.utils import _pytree
    leaves, _ = _pytree.tree_flatten_with_path(params)
    out = []
    for path, leaf in leaves:
        row = leaf[0].numel() * leaf.element_size() if leaf.dim() else 1
        rows = max(1, chunk_bytes // row) if leaf.dim() else 1
        parts = leaf.split(rows) if leaf.dim() else (leaf,)
        out += [(f"{_pytree.keystr(path)}#{i}", p) for i, p in enumerate(parts)]
    return out


def net_round_trip(reg, node, old, new, device):
    """Bind a ``StateCell`` per piece of ``old`` on ``node`` (each cell
    pickles its tensors as host bytes), publish ``new`` with one write
    transaction (``set``'s value is pickled by torch's own reducer, which
    keeps the device, so the client hands over host copies: ``.cpu()``),
    read every cell back with one irrevocable read-only transaction and
    move it to ``device``. Every piece must come back bit for bit, on the
    CPU, at version 1. Returns the seconds and GB/s of each, and the first
    bind's seconds apart (the node server imports torch when it unpickles
    its first tensor)."""
    from repro_torch import dtm
    from repro_torch.core import Transaction
    from repro_torch.txstore.store import StateCell

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    nbytes = sum(p.numel() * p.element_size() for _, p in new)
    sync()
    binds = []
    for name, piece in old:
        t0 = time.perf_counter()
        dtm.bind(node, name, StateCell(piece, 0))
        binds.append(time.perf_counter() - t0)
    bind_s = sum(binds)
    dtm.connect(node.address, registry=reg)
    cells = [reg.locate(name) for name, _ in new]

    sync()
    t0 = time.perf_counter()
    host = [piece.cpu() for _, piece in new]
    t = Transaction(reg)
    writes = [t.writes(c, 1) for c in cells]
    t.start(lambda _t: [w.set(h, 1) for w, h in zip(writes, host)])
    commit_s = time.perf_counter() - t0
    del host

    t0 = time.perf_counter()
    t = Transaction(reg, irrevocable=True)
    reads = [t.reads(c, 2) for c in cells]
    got = {}
    t.start(lambda _t: got.update(
        (i, (r.get(), r.get_version())) for i, r in enumerate(reads)))
    on_host = all(got[i][0].device.type == "cpu" for i in got)
    back = [got[i][0].to(device) for i in range(len(cells))]
    sync()
    snapshot_s = time.perf_counter() - t0
    versions = {got[i][1] for i in got}
    same = [b.dtype == p.dtype and b.shape == p.shape and torch.equal(b, p)
            for b, (_, p) in zip(back, new)]
    if not (on_host and versions == {1} and all(same)):
        raise AssertionError(
            f"net round trip: on the host {on_host}, versions {versions}, "
            f"{sum(same)} of {len(same)} pieces bit for bit")
    gb = nbytes / 1e9
    first = old[0][1].numel() * old[0][1].element_size() / 1e9
    return {"bytes": nbytes, "cells": len(cells), "bind_s": bind_s,
            "bind_gbps": gb / bind_s, "first_bind_s": binds[0],
            "rest_bind_gbps": (gb - first) / max(sum(binds[1:]), 1e-9),
            "commit_s": commit_s,
            "commit_gbps": gb / commit_s, "snapshot_s": snapshot_s,
            "snapshot_gbps": gb / snapshot_s, "bitwise": True}


def net_card_users(pids):
    """Which of ``pids`` use the card: listed by nvidia-smi's compute apps,
    or holding an open /dev/nvidia* file (a CUDA context opens them). In a
    container nvidia-smi may list the host's pids, so the caller also
    holds the number of compute apps to one: this process."""
    listed = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()
    users = {}
    for pid in pids:
        fds = []
        fd_dir = f"/proc/{pid}/fd"
        for fd in os.listdir(fd_dir):
            with contextlib.suppress(OSError):
                if os.readlink(f"{fd_dir}/{fd}").startswith("/dev/nvidia"):
                    fds.append(fd)
        users[pid] = {"nvidia_smi": str(pid) in listed, "dev_fds": len(fds)}
    return listed, users


def phase_net():
    """The OptSVA-CF wire (repro_torch.net, repro_torch.dtm). Two node
    servers spawned with dtm.spawn_server and reached with dtm.connect;
    net_schedule in-process, over TCP and under simnet: outcomes, values and
    final balances equal, the waits equal in-process and under simnet (over
    TCP they depend on when the home node processes the previous
    transaction's release one-ways, so they are printed, not held). Then
    net_round_trip of qwen3-4b's parameters (full width, NET["depth"]
    layers, fp32, initialised on the card, 2.36 GB) on node 0, and neither
    server may use the card."""
    from repro_torch import dtm
    from repro_torch.models import Backbone

    servers = []
    try:
        for i in range(2):
            servers.append(dtm.spawn_server(
                f"node{i}", monitor_timeout=NET["monitor_timeout"],
                startup_timeout=NET["startup_timeout"]))
        addresses = [s.address for s in servers]
        log(f"[net] node servers {addresses} (pids "
            f"{[s.proc.pid for s in servers]})")
        runs = net_schedules(addresses)
        (ti, si), (tt, st), (ts, ss) = (runs[k] for k in ("inproc", "tcp",
                                                          "sim"))
        outcomes = [e[:3] for e in ti]
        ok = (ti == ts and [e[:3] for e in tt] == outcomes
              and si == st == ss == (921, 0, 0))
        log(f"[net] equivalence schedule, {len(ti)} transactions: inproc, "
            f"tcp and sim traces equal: {ok} (waits inproc "
            f"{[e[3] for e in ti]}, sim {[e[3] for e in ts]}, tcp "
            f"{[e[3] for e in tt]}); balances {si}")
        if not ok:
            raise AssertionError(f"net schedules differ: {runs}")

        free_memory()
        cfg = _config("qwen3-4b", ((("attn",), NET["depth"]),))
        bb = Backbone(cfg, param_dtype=torch.float32, device=DEVICE)
        old = net_pieces(bb.init(SEED), NET["chunk_bytes"])
        new = net_pieces(bb.init(SEED + 1), NET["chunk_bytes"])
        reg = dtm.connect(addresses[0])
        try:
            node, = reg.nodes
            rt = net_round_trip(reg, node, old, new, DEVICE)
        finally:
            reg.shutdown()
        n_params = sum(p.numel() for _, p in new)
        log(f"[net] qwen3-4b {cfg.n_layers} layers, {n_params} fp32 "
            f"parameters ({rt['bytes'] / 1e9:.3f} GB) in {rt['cells']} "
            f"StateCells on node 0 over localhost TCP | {card_line()}")
        log(f"[net] bind (the cells' host bytes): {rt['bind_s']:.3f} s, "
            f"{rt['bind_gbps']:.3f} GB/s; the first cell {rt['first_bind_s']:.3f}"
            f" s (the server imports torch), the rest "
            f"{rt['rest_bind_gbps']:.3f} GB/s")
        log(f"[net] commit (write transaction, host copies included): "
            f"{rt['commit_s']:.3f} s, {rt['commit_gbps']:.3f} GB/s")
        log(f"[net] snapshot (irrevocable read-only transaction, moved back "
            f"to cuda): {rt['snapshot_s']:.3f} s, {rt['snapshot_gbps']:.3f} "
            f"GB/s; every piece bit for bit: {rt['bitwise']}")
        del old, new, bb
        free_memory()

        pids = [s.proc.pid for s in servers]
        listed, users = net_card_users(pids)
        on_card = [p for p, u in users.items()
                   if u["nvidia_smi"] or u["dev_fds"]]
        log(f"[net] compute apps on the card {listed} (this process "
            f"{os.getpid()}); node servers {users}: none on the card: "
            f"{not on_card and len(listed) <= 1}")
        if on_card or len(listed) > 1:
            raise AssertionError(f"node servers {on_card} use the card "
                                 f"(compute apps {listed})")
        return {"schedule": {k: v for k, v in runs.items()},
                "round_trip": rt, "compute_apps": listed,
                "servers": users}
    finally:
        for s in servers:
            s.stop()


# The row of each kernel that stands for it in the kernels line, and the TPU
# kernel it replaces (for the backwards, which the reference writes in jnp
# or leaves to jax.grad, the function whose gradient they compute)
HEADLINE = {
    "flash_fwd": ("qwen3_prefill", "src/repro/kernels/flash_attention.py:28"),
    "flash_decode": ("qwen3_decode_wrapped",
                     "src/repro/kernels/flash_attention.py:28"),
    "rglru_scan": ("rgemma_prefill", "src/repro/kernels/rglru_kernel.py:22"),
    "wkv6_scan": ("rwkv6_prefill", "src/repro/kernels/rwkv6_kernel.py:26"),
    "flash_bwd": ("qwen3_train", "src/repro/models/attention.py:163"),
    "rglru_bwd": ("rgemma_train", "src/repro/kernels/ref.py:81"),
    "wkv6_bwd": ("rwkv6_train", "src/repro/kernels/ref.py:52"),
    "moe_gemm": ("mixtral_prefill_1500",
                 "none: the reference's expert einsums go to XLA "
                 "(src/repro/models/ffn.py)"),
}
# the source of each kernel's headline body, and every source of the kernel
SOURCE = {"flash_fwd": "flash_fwd.cu", "flash_decode": "flash_decode.cu",
          "rglru_scan": "rglru_scan.cu", "wkv6_scan": "wkv6_chunk.cu",
          "flash_bwd": "flash_bwd.cu", "rglru_bwd": "rglru_bwd.cu",
          "wkv6_bwd": "wkv6_bwd.cu", "moe_gemm": "moe_gemm.cu"}
SOURCES = {"wkv6_scan": ("wkv6_chunk.cu", "wkv6_scan.cu"),
           "wkv6_bwd": ("wkv6_bwd.cu", "wkv6_chunk.cu", "wkv6_chunk.cuh")}
# the port's kernel names in a profiler trace start with one of these
TRACE_NAMES = ("flash_", "rglru_", "wkv", "moe_gemm")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {kind} | devices {torch.cuda.device_count()} | allow_tf32 False")

    b = build.build()
    log(f"[build] {', '.join(src.name for src in build.SOURCES)}: "
        f"{b['seconds']:.2f} s -> {b['path']}\n{b['log']}")
    sass = sass_hmma(b["path"])
    rows = phase_flash() + phase_rglru() + phase_wkv() + phase_scan_bwd()
    moe_rows, moe_paths = phase_moe_gemm()
    rows += moe_rows
    model = {arch: phase_model(arch) for arch in MODEL_CHECKS}
    serve = {arch: phase_serve(arch) for arch in SERVES}
    serve_whisper = phase_serve_whisper()
    ep = phase_ep()
    rows += phase_train_kernels()
    train = phase_train()
    dist_out = phase_dist()
    remat_out = phase_remat()
    net = phase_net()
    # the main path's runs, each read with the ledger reset just before
    paths = {arch: s["launches"] for arch, s in serve.items()}
    paths["whisper-tiny serve"] = serve_whisper["launches"]
    for arch, t in train.items():
        if "trainer" in t:
            paths[f"{arch} train"] = t["trainer"]["launches"]
    paths["qwen3-4b dist train"] = dist_out["launches"]
    for arch in REMAT["cells"]:
        paths[f"{arch} train, remat dots"] = \
            remat_out[arch]["dots"]["launches"]
    totals = {path: with_totals(counts) for path, counts in paths.items()}

    kernels = []
    for name, (case, replaces) in HEADLINE.items():
        head = next(r for r in rows if r["kernel"] == name and r["case"] == case
                    and r["dtype"] == "bfloat16" and r.get("planned", True))
        by_path = {path: t[name] for path, t in totals.items() if t.get(name)}
        # each body's launches (K1b's passes', the expert kernel's entries')
        bodies = {path: {k.partition(".")[2]: n
                         for k, n in paths[path].items()
                         if k.startswith(f"{name}.")} for path in by_path}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{SOURCE[name]}",
            "sources": [f"src/repro_torch/kernels/csrc/{f}"
                        for f in SOURCES.get(name, (SOURCE[name],))],
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_by_body": {p: b for p, b in bodies.items() if b},
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "at": f"{case} bfloat16 {head['shape']}"
                  + (f" ({head['body']} body)" if "body" in head else ""),
            "cases": [r for r in rows if r["kernel"] == name],
        })
    log("[summary] " + json.dumps({"model": model, "serve": serve,
                                   "serve_whisper": serve_whisper,
                                   "ep": ep, "moe_paths": moe_paths,
                                   "train": train,
                                   "dist": dist_out, "remat": remat_out,
                                   "net": net,
                                   "hmma_sass": sass,
                                   "seconds": time.perf_counter() - t_start}))
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
