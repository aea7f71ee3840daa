// Flash-attention backward for Hopper (sm_90a): K1b.
//
// Replaces src/repro/models/attention.py::_flash_bwd_impl, the jnp custom
// VJP of flash_attention_jnp (the reference has no Pallas backward; its
// "vmem_kernel_flash_bwd" scope treats the loop nest as one kernel). Given
// the forward's inputs, its output and the LSE that flash_fwd.cu writes,
// and dout, it computes, with s, ok and the positions as in flash_fwd.cu:
//
//   delta = rowsum(dout * out)              from the stored out, fp32
//   p     = ok ? exp(s - lse) : 0           recomputed per tile, fp32
//   dv    = p^T dout                        summed over the G heads of a
//   dp    = dout v^T                        kv head (GQA)
//   ds    = p (dp - delta) (1 - t^2) scale  t = tanh(s_raw / cap) with a
//                                           cap, else the factor is 1
//   dq    = ds k,   dk = ds^T q             fp32 sums, written in the
//                                           inputs' dtype
//
// A query row with no valid key has p = 0 everywhere, so it gives and gets
// no gradient whatever its LSE holds (flash_fwd.cu writes -inf there).
//
// Kernels, no atomics on device memory, so two runs give the same bits:
//   flash_bwd_delta_kernel   one warp per (b, query, head): delta.
//   flash_bwd_dkdv_kernel    one CTA per (b, kv head, tile of KN keys[,
//                            split]), warps of 16 keys. K and V stay in
//                            shared memory. The CTA walks the row blocks (RM
//                            rows of query position x the G heads, the row
//                            order of flash_fwd.cu) whose positions can see
//                            its tile, found once as a bitmask
//                            (flash::mark_tiles, rows and keys in swapped
//                            roles). Q, dout, lse and delta of the next live
//                            block stream in by cp.async into the other of
//                            two stages while a block computes; one barrier
//                            a block. Per block a warp forms S^T = K Q^T and
//                            dP^T = V dout^T on the tensor cores, P^T and
//                            dS^T on the accumulator fragments in registers,
//                            and takes those fragments as the A operands of
//                            dV += P^T dout and dK += dS^T Q (the forward's
//                            C -> A reuse: no trip through shared memory).
//                            The GQA sum over the group happens inside the
//                            CTA.
//   flash_bwd_dq_kernel      one CTA per (b, kv head, block of QM rows),
//                            warps of 16 rows. Q and dout stay in shared
//                            memory, K and V tiles stream through two
//                            cp.async stages as above: S = Q K^T,
//                            dP = dout V^T, dS on the fragments, dQ += dS K.
//   flash_bwd_reduce_kernel  only when the wrapper's plan splits the dkdv
//                            grid (flash_bwd.py::plan: fewer CTAs than two
//                            waves of the 132 SMs, as MQA at batch 1 gives):
//                            each split walks an equal share of the tile's
//                            live row blocks and writes fp32 partial dk, dv
//                            to scratch; this pass sums the splits in a
//                            fixed order and writes the inputs' dtype.
// Both passes number their CTAs in one dimension with the heaviest work
// first (under a causal mask the first key tiles and the last row blocks),
// so that no wave ends on them. The pair recomputes the scores: 7 products
// of the [rows x keys x hd] kind where the function needs 5. Blocks that
// every row sees whole skip the per-element mask.
//
// Two bodies of the products, chosen by dtype, with one tiling code:
//   bf16: mma.sync m16n8k16 with fp32 accumulation. A operands (K, V in the
//     dkdv pass; Q, dout in the dq pass) by ldmatrix, B operands by
//     ldmatrix (.trans for dout, Q and K as the second factor). Rows are
//     padded by 16 bytes so ldmatrix's eight row addresses fall on distinct
//     banks. P and dS are rounded to bf16 as they become A operands, as the
//     forward rounds P: the checks' bf16 limit carries a term for it
//     (ref.flash_bwd_rounding_plain).
//   fp32: 3xTF32 on mma.sync m16n8k8 (tf32x3.cuh), P and dS kept in fp32
//     and split too. The m16n8k8 A fragment holds columns t and t+4 where
//     the C fragment holds 2t and 2t+1; a product's sum does not depend on
//     the order of its k index, so each step takes k = t as column 2t and
//     k = t + 4 as 2t + 1, for A and for B alike: the C fragment is the A
//     operand as it stands, with no shuffle and no shared-memory pass. The
//     operands are read from shared memory as fp32 with rows padded to
//     4 (mod 32) floats: every read of a fragment hits 32 banks. The
//     tensor cores' fp32 accumulation truncates, so dk, dv and dq take each
//     block's (tile's) products in a fresh fragment and fold it into their
//     sums with an fp32 add.
// Every head dim the wrapper takes (hd % 8 == 0, hd <= 256) runs with the
// tiles of HDM = hd rounded up to 32, 64, 128 or 256, the columns past hd
// zero in shared memory and never stored.
//
// Tiles (Tiles<T, HDM>): dkdv KN = 64 keys (32 in fp32 at hd 256), RM = 32
// rows a stage; dq QM = 64 rows (32 in fp32 at hd 256), QN = 64 keys a tile
// in bf16 up to hd 128, else 32. A warp's accumulators are 128 fp32 a
// thread (dk and dv of 16 keys at hd 128; dq of 16 rows at hd 256); at hd
// 256 dk and dv would be 256, so two warps share a key group, each holding
// half of the columns (and each computing the group's S^T and dP^T). The
// scores and their gradients take RM (dkdv) or QN (dq) fp32 a thread.
//
// Bound at the training shape (qwen3-4b, B=4, S=2048, Hq=32, Hkv=8, hd=128,
// causal, bf16): the function needs 10 hd operations per valid (query, key)
// pair and query head, 343.8 GFLOP, 0.348 ms on the bf16 tensor cores
// (989 TFLOP/s), against 0.03 ms of bytes: bound by operations. In fp32 the
// same work is 5.13 ms on the CUDA cores' 67 TFLOP/s, while 3xTF32 spends
// three TF32 products (495 TFLOP/s) on each. chip_smoke.py computes the
// bound from each run's inputs; PERF.md holds the times (about 4 ms in
// bf16 on an H100 SXM at 700 W, 12 times the bound: mma.sync with 2 warps
// a scheduler, 229 registers a thread in dkdv).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_common.cuh"
#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash;
using tf32x3::mma3;
using tf32x3::Split;
using tf32x3::split;

template <typename T, int HDM>
struct Tiles {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int NCOL = HDM > 128 ? 2 : 1;  // dkdv warps per key group
  static constexpr int KN = (F32 && HDM > 128) ? 32 : 64;  // dkdv keys a CTA
  static constexpr int KW = KN / 16 * NCOL;                // dkdv warps
  static constexpr int RM = 32;                            // dkdv rows a stage
  static constexpr int QM = (F32 && HDM > 128) ? 32 : 64;  // dq rows a CTA
  static constexpr int QW = QM / 16;                       // dq warps
  static constexpr int QN = (F32 || HDM > 128) ? 32 : 64;  // dq keys a tile
  static constexpr int LDS = F32 ? HDM + 4 : HDM + 8;      // padded row
  static constexpr size_t ROW = (size_t)LDS * sizeof(T);   // its bytes
  // one dkdv stage: Q and dout rows, then the rows' positions, lse, delta
  static constexpr size_t DKDV_STAGE = 2 * RM * ROW + 3 * RM * sizeof(int);
  // one dq stage: K and V rows, then the keys' positions
  static constexpr size_t DQ_STAGE = 2 * QN * ROW + QN * sizeof(int);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// R rows of hd elements of two tensors of one layout (q and dout, or k and
// v) into shared memory [R][LDS] each by cp.async: row r is source row
// i = first + r at ((i / grp) * stride + i % grp) * hd from src0 and src1,
// zero once i >= nvalid and in the columns past hd (hd % 8 == 0: whole
// 16-byte chunks).
template <typename T, int HDM, int R, int NTH>
__device__ __forceinline__ void copy_pair(T* dst0, T* dst1,
                                          const T* __restrict__ src0,
                                          const T* __restrict__ src1,
                                          int first, int nvalid, int grp,
                                          int stride, int hd, int tid) {
  constexpr int VE = 16 / sizeof(T), VPR = HDM / VE, LDS = Tiles<T, HDM>::LDS;
  for (int i = tid; i < R * VPR; i += NTH) {
    const int r = i / VPR, c = i % VPR, gi = first + r;
    const bool ok = gi < nvalid && c * VE < hd;
    const size_t off =
        ok ? ((size_t)(gi / grp) * stride + gi % grp) * hd + c * VE : 0;
    cp_async16(dst0 + r * LDS + c * VE, src0 + off, ok);
    cp_async16(dst1 + r * LDS + c * VE, src1 + off, ok);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One (row, key) pair, unmasked: s = q . k and dp = dout . v in, p and ds
// out. lse2 = lse log2(e) (+inf for a row that does not exist: p = 0),
// scale2 = scale log2(e).
__device__ __forceinline__ void grad_scores(float& s, float& dp, float lse2,
                                            float delta, float scale,
                                            float scale2, float cap) {
  float p, f = scale;
  if (cap > 0.f) {  // the derivative at the capped score
    const float t = tanhf(s * scale / cap);
    f = (1.f - t * t) * scale;
    p = ex2(fmaf(cap * t, LOG2E, -lse2));
  } else {
    p = ex2(fmaf(s, scale2, -lse2));
  }
  s = p;
  dp = p * (dp - delta) * f;
}

// ---- the products, bf16: mma.sync m16n8k16 ---------------------------------
// c[j] += A B^T over the hd columns: A is 16 rows of As, B the 8 NB rows of
// Bs (both [row][LDS]); c[j] holds B's rows 8j .. 8j+7.
template <int HDM, int NB>
__device__ __forceinline__ void mma_abt(float (&c)[NB][4], const bf16* As,
                                        const bf16* Bs, int hd, int lane) {
  constexpr int LDS = HDM + 8;
#pragma unroll
  for (int kk = 0; kk < HDM / 16; ++kk) {
    if (kk * 16 >= hd) continue;
    unsigned a[4];
    ldsm_x4(a, As + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NB / 2; ++np) {
      unsigned bb[4];
      ldsm_x4(bb, Bs + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], a, bb[0], bb[1]);
      mma_bf16(c[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// acc[j] += P X: P is 16 rows by 8 NK columns in C fragments, rounded to
// bf16 here as the A operand; X is rows 0 .. 8 NK of Xs, its columns
// col0 + 8j .. col0 + 8j + 7 for acc[j].
template <int HDM, int NK, int NO>
__device__ __forceinline__ void mma_px(float (&acc)[NO][4],
                                       const float (&p)[NK][4], const bf16* Xs,
                                       int col0, int hd, int lane) {
  constexpr int LDS = HDM + 8;
#pragma unroll
  for (int kc = 0; kc < NK / 2; ++kc) {
    const unsigned a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < NO / 2; ++dp) {
      if (col0 + dp * 16 >= hd) continue;
      unsigned bb[4];
      ldsm_x4_trans(bb, Xs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LDS + col0 + dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
      mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
    }
  }
}

// ---- the products, fp32: 3xTF32 on mma.sync m16n8k8 -----------------------
template <int HDM, int NB>
__device__ __forceinline__ void mma_abt(float (&c)[NB][4], const float* As,
                                        const float* Bs, int hd, int lane) {
  constexpr int LDS = HDM + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HDM / 8; ++kk) {
    if (kk * 8 >= hd) continue;
    const int d = kk * 8 + t;
    const Split a[4] = {split(As[g * LDS + d]), split(As[(g + 8) * LDS + d]),
                        split(As[g * LDS + d + 4]),
                        split(As[(g + 8) * LDS + d + 4])};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float* b = Bs + (j * 8 + g) * LDS + d;
      const Split bb[2] = {split(b[0]), split(b[4])};
      mma3(c[j], a, bb);
    }
  }
}

// k index t of a step is column 2t of the C fragment, t + 4 is 2t + 1.
// The call's NK steps sum into a fresh fragment that an fp32 add then
// folds into acc: the tensor cores' fp32 accumulation truncates, and over
// the thousands of steps of a dk or dv sum its bias reached 1e-3 (the card,
// [1, 2100] MQA hd 256) where the fp32 limit is 5e-5 of it.
template <int HDM, int NK, int NO>
__device__ __forceinline__ void mma_px(float (&acc)[NO][4],
                                       const float (&p)[NK][4],
                                       const float* Xs, int col0, int hd,
                                       int lane) {
  constexpr int LDS = HDM + 4;
  const int g = lane >> 2, t = lane & 3;
  Split a[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    a[j][0] = split(p[j][0]);
    a[j][1] = split(p[j][2]);
    a[j][2] = split(p[j][1]);
    a[j][3] = split(p[j][3]);
  }
  const float* x = Xs + 2 * t * LDS + col0 + g;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (col0 + n * 8 >= hd) continue;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const Split bb[2] = {split(x[j * 8 * LDS + n * 8]),
                           split(x[(j * 8 + 1) * LDS + n * 8])};
      mma3(c, a[j], bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// ---- delta -----------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int Hq,
                       int hd) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);  // (b*Sq + s)*Hq + h
  if (row >= rows) return;
  const T* orow = o + (size_t)row * hd;
  const T* drow = dout + (size_t)row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f(drow[d]), to_f(orow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % Hq, bs = row / Hq, s = bs % Sq, b = bs / Sq;
    delta[((size_t)b * Hq + h) * Sq + s] = acc;  // [B, Hkv, G, Sq]
  }
}

// ---- dk, dv ----------------------------------------------------------------
// part: fp32 [2][splits][B*Skv*Hkv*hd] (dk, then dv) when splits > 1; dk
// and dv are written directly otherwise.
template <typename T, int HDM>
__global__ void __launch_bounds__(Tiles<T, HDM>::KW * 32)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ part, int splits,
                      int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                      int causal, int window, float cap, float scale) {
  using C = Tiles<T, HDM>;
  constexpr int KN = C::KN, RM = C::RM, LDS = C::LDS, NTH = C::KW * 32;
  constexpr int NB = RM / 8;             // score fragments (16 keys x RM rows)
  constexpr int CW = HDM / C::NCOL;      // a warp's columns of dk and dv
  constexpr int NO = CW / 8;             // their fragments
  constexpr size_t STAGE = C::DKDV_STAGE;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + KN * LDS;
  char* stages = reinterpret_cast<char*>(Vs + KN * LDS);
  int* kps = reinterpret_cast<int*>(stages + 2 * STAGE);
  const int G = Hq / Hkv, nrows = Sq * G, nrb = (nrows + RM - 1) / RM;
  unsigned* live = reinterpret_cast<unsigned*>(kps + KN);
  unsigned* full = live + (nrb + 31) / 32;
  __shared__ int krange[3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / C::NCOL, col0 = (warp % C::NCOL) * CW;
  // one block index, key tile slowest: under a causal mask the first tiles
  // are seen by the most rows, and they start first
  const int per_tile = Hkv * B * splits, rest = blockIdx.x % per_tile;
  const int n0 = blockIdx.x / per_tile * KN;
  const int kvh = rest % Hkv, b = rest / Hkv / splits, sp = rest / Hkv % splits;
  const float scale2 = scale * LOG2E;

  const size_t kv_off = ((size_t)b * Skv * Hkv + kvh) * hd;
  copy_pair<T, HDM, KN, NTH>(Ks, Vs, k + kv_off, v + kv_off, n0, Skv, 1, Hkv,
                             hd, tid);
  cp_async_commit();
  if (tid == 0) {
    krange[0] = INT_MAX;
    krange[1] = INT_MIN;
    krange[2] = 1;  // every key of the tile valid
  }
  __syncthreads();
  if (tid < KN) {
    const int kp = n0 + tid < Skv ? kv_pos[n0 + tid] : -1;
    kps[tid] = kp;
    if (kp >= 0) {
      atomicMin(&krange[0], kp);
      atomicMax(&krange[1], kp);
    } else {
      atomicAnd(&krange[2], 0);
    }
  }
  __syncthreads();
  const int kmin = krange[0], kmax = krange[1];
  const bool kany = kmax >= 0, kall = krange[2];
  // the row blocks some row of which may see the tile, and those whose every
  // row sees every key of it
  mark_tiles(live, full, nrows, RM, tid, NTH,
             [&](int i, bool& see, bool& all) {
               const int qp = q_pos[i / G];
               see = kany && (!causal || qp >= kmin) &&
                     (window <= 0 || qp - kmax < window);
               all = kall && (!causal || qp >= kmax) &&
                     (window <= 0 || qp - kmin < window);
             });
  // this split's share of the live blocks: ranks [lo, hi)
  int nlive = 0;
  for (int w = 0; w < (nrb + 31) / 32; ++w) nlive += __popc(live[w]);
  const int lo = (int)((long long)nlive * sp / splits);
  const int hi = (int)((long long)nlive * (sp + 1) / splits);
  int blk = next_live(live, 0, nrb);
  for (int r = 0; r < lo; ++r) blk = next_live(live, blk + 1, nrb);

  const size_t q_off = ((size_t)b * Sq * Hq + kvh * G) * hd;
  const size_t row_lse = ((size_t)b * Hkv + kvh) * G * Sq;
  auto issue = [&](int blk_, int st) {
    T* qs = reinterpret_cast<T*>(stages + st * STAGE);
    T* os = qs + RM * LDS;
    int* qps = reinterpret_cast<int*>(os + RM * LDS);
    float* ls = reinterpret_cast<float*>(qps + RM);
    float* dl = ls + RM;
    const int r0 = blk_ * RM;
    copy_pair<T, HDM, RM, NTH>(qs, os, q + q_off, dout + q_off, r0, nrows, G,
                               Hq, hd, tid);
    if (tid < RM) {
      const int gr = r0 + tid;
      if (gr < nrows) {
        const size_t li = row_lse + (size_t)(gr % G) * Sq + gr / G;
        cp_async4(qps + tid, q_pos + gr / G);
        cp_async4(ls + tid, lse + li);
        cp_async4(dl + tid, delta + li);
      } else {  // no such row: lse = +inf makes its p 0 under any mask
        qps[tid] = 0;
        ls[tid] = INFINITY;
        dl[tid] = 0.f;
      }
    }
  };

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  int st = 0;
  if (lo < hi) issue(blk, 0);
  cp_async_commit();
  for (int rank = lo; rank < hi; ++rank) {
    cp_async_wait<0>();  // this block's rows
    // ... visible to every warp, and every warp done with the other stage
    __syncthreads();
    const int nxt = next_live(live, blk + 1, nrb);
    if (rank + 1 < hi) issue(nxt, st ^ 1);  // in flight while this computes
    cp_async_commit();
    const T* qs = reinterpret_cast<const T*>(stages + st * STAGE);
    const T* os = qs + RM * LDS;
    const int* qps = reinterpret_cast<const int*>(os + RM * LDS);
    const float* ls = reinterpret_cast<const float*>(qps + RM);
    const float* dl = ls + RM;

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<HDM, NB>(s, Ks + kg * 16 * LDS, qs, hd, lane);   // S^T
    mma_abt<HDM, NB>(dp, Vs + kg * 16 * LDS, os, hd, lane);  // dP^T
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = j * 8 + 2 * t + (e & 1);
        grad_scores(s[j][e], dp[j][e], ls[row] * LOG2E, dl[row], scale,
                    scale2, cap);
      }
    // every row of a full block sees every key: no per-element mask
    if (!((full[blk >> 5] >> (blk & 31)) & 1u)) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!key_ok(qps[j * 8 + 2 * t + (e & 1)],
                      kps[kg * 16 + g + 8 * (e >> 1)], causal, window))
            s[j][e] = dp[j][e] = 0.f;
    }
    mma_px<HDM, NB, NO>(dva, s, os, col0, hd, lane);   // dV += P^T dout
    mma_px<HDM, NB, NO>(dka, dp, qs, col0, hd, lane);  // dK += dS^T Q
    blk = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

  const size_t total = (size_t)B * Skv * Hkv * hd;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int n = n0 + kg * 16 + g + 8 * r;
    if (n >= Skv) continue;
    const size_t off = ((size_t)(b * Skv + n) * Hkv + kvh) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = col0 + j * 8 + 2 * t;
      if (d >= hd) continue;
      if (splits == 1) {
        store2(dk + off + d, dka[j][2 * r], dka[j][2 * r + 1]);
        store2(dv + off + d, dva[j][2 * r], dva[j][2 * r + 1]);
      } else {
        float* pk = part + (size_t)sp * total + off + d;
        store2(pk, dka[j][2 * r], dka[j][2 * r + 1]);
        store2(pk + (size_t)splits * total, dva[j][2 * r], dva[j][2 * r + 1]);
      }
    }
  }
}

// ---- the splits' sum --------------------------------------------------
// dk[i] = sum over s of part[0][s][i], dv[i] likewise from part[1], s in
// order; n = B*Skv*Hkv*hd, a multiple of 8.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ dk,
                        T* __restrict__ dv, long long n, int splits) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int which = i >= n;
  const long long off = i - which * n;
  const float* src = part + which * splits * n + off;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * n);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* dst = (which ? dv : dk) + off;
  store2(dst, acc.x, acc.y);
  store2(dst + 2, acc.z, acc.w);
}

// ---- dq --------------------------------------------------------------------
template <typename T, int HDM>
__global__ void __launch_bounds__(Tiles<T, HDM>::QW * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ dq, int B,
                    int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                    int window, float cap, float scale) {
  using C = Tiles<T, HDM>;
  constexpr int QM = C::QM, QN = C::QN, LDS = C::LDS, NTH = C::QW * 32;
  constexpr int NB = QN / 8;   // score fragments (16 rows x QN keys)
  constexpr int NO = HDM / 8;  // dq fragments
  constexpr size_t STAGE = C::DQ_STAGE;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Os = Qs + QM * LDS;
  char* stages = reinterpret_cast<char*>(Os + QM * LDS);
  const int nt = (Skv + QN - 1) / QN;
  unsigned* live = reinterpret_cast<unsigned*>(stages + 2 * STAGE);
  unsigned* full = live + (nt + 31) / 32;
  __shared__ int qrange[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = Hq / Hkv, nrows = Sq * G;
  // one block index, row block slowest and the last row blocks first: under
  // a causal mask they see the most keys, and a wave that ended on them
  // would leave the card idle
  const int per_block = Hkv * B, rest = blockIdx.x % per_block;
  const int kvh = rest % Hkv, b = rest / Hkv;
  const int row0 = (gridDim.x / per_block - 1 - blockIdx.x / per_block) * QM;
  const float scale2 = scale * LOG2E;
  const int wrow = warp * 16;

  const size_t q_off = ((size_t)b * Sq * Hq + kvh * G) * hd;
  copy_pair<T, HDM, QM, NTH>(Qs, Os, q + q_off, dout + q_off, row0, nrows, G,
                             Hq, hd, tid);
  cp_async_commit();

  if (tid == 0) {
    qrange[0] = INT_MAX;
    qrange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < QM) {
    const int p = q_pos[min(row0 + tid, nrows - 1) / G];
    atomicMin(&qrange[0], p);
    atomicMax(&qrange[1], p);
  }
  // this lane's rows g and g+8: position, lse, delta (no such row: lse =
  // +inf, so its p is 0; it is never stored)
  int qp[2];
  float ls2[2], dl[2];  // lse log2(e), delta
  const size_t row_lse = ((size_t)b * Hkv + kvh) * G * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + wrow + g + 8 * r;
    qp[r] = 0;
    ls2[r] = INFINITY;
    dl[r] = 0.f;
    if (gr < nrows) {
      const size_t li = row_lse + (size_t)(gr % G) * Sq + gr / G;
      qp[r] = q_pos[gr / G];
      ls2[r] = lse[li] * LOG2E;
      dl[r] = delta[li];
    }
  }
  __syncthreads();
  mark_live_tiles(live, full, kv_pos, 0, Skv, QN, qrange[0], qrange[1],
                  causal, window, tid, NTH);

  const size_t kv_off = ((size_t)b * Skv * Hkv + kvh) * hd;
  auto issue = [&](int tile, int st) {
    T* ks = reinterpret_cast<T*>(stages + st * STAGE);
    T* vs = ks + QN * LDS;
    int* kp = reinterpret_cast<int*>(vs + QN * LDS);
    const int n0 = tile * QN;
    copy_pair<T, HDM, QN, NTH>(ks, vs, k + kv_off, v + kv_off, n0, Skv, 1,
                               Hkv, hd, tid);
    if (tid < QN) {
      if (n0 + tid < Skv)
        cp_async4(kp + tid, kv_pos + n0 + tid);
      else
        kp[tid] = -1;
    }
  };

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int tile = next_live(live, 0, nt), st = 0;
  if (tile < nt) issue(tile, 0);
  cp_async_commit();
  while (tile < nt) {
    cp_async_wait<0>();  // this tile
    // ... visible to every warp, and every warp done with the other stage
    __syncthreads();
    const int nxt = next_live(live, tile + 1, nt);
    if (nxt < nt) issue(nxt, st ^ 1);  // in flight while this tile computes
    cp_async_commit();
    const T* ks = reinterpret_cast<const T*>(stages + st * STAGE);
    const T* vs = ks + QN * LDS;
    const int* kp = reinterpret_cast<const int*>(vs + QN * LDS);

    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_abt<HDM, NB>(s, Qs + wrow * LDS, ks, hd, lane);   // S
    mma_abt<HDM, NB>(dp, Os + wrow * LDS, vs, hd, lane);  // dP
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        grad_scores(s[j][e], dp[j][e], ls2[e >> 1], dl[e >> 1], scale, scale2,
                    cap);
    // every row sees every key of a full tile: no per-element mask
    if (!((full[tile >> 5] >> (tile & 31)) & 1u)) {
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!key_ok(qp[e >> 1], kp[j * 8 + 2 * t + (e & 1)], causal, window))
            s[j][e] = dp[j][e] = 0.f;
    }
    mma_px<HDM, NB, NO>(acc, dp, ks, 0, hd, lane);  // dQ += dS K
    tile = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + wrow + g + 8 * r;
    if (gr >= nrows) continue;
    T* row = dq + ((size_t)(b * Sq + gr / G) * Hq + kvh * G + gr % G) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = j * 8 + 2 * t;
      if (d < hd) store2(row + d, acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// ---- launches -----------------------------------------------------------
struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *q_pos, *kv_pos;
  int B, Sq, Skv, Hq, Hkv, hd, causal, window;
  float cap, scale;
};

template <typename T, int HDM>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, float* part,
                        int splits, cudaStream_t stream) {
  using C = Tiles<T, HDM>;
  const int nrb = (a.Sq * (a.Hq / a.Hkv) + C::RM - 1) / C::RM;
  const size_t smem = 2 * C::KN * C::ROW + 2 * C::DKDV_STAGE +
                      C::KN * sizeof(int) + 2 * ((nrb + 31) / 32) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HDM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + C::KN - 1) / C::KN * a.Hkv * a.B * splits);
  flash_bwd_dkdv_kernel<T, HDM><<<grid, C::KW * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.q_pos, a.kv_pos, static_cast<T*>(dk), static_cast<T*>(dv),
      part, splits, a.B, a.Sq, a.Skv, a.Hq, a.Hkv, a.hd, a.causal, a.window,
      a.cap, a.scale);
  return cudaGetLastError();
}

template <typename T, int HDM>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  using C = Tiles<T, HDM>;
  const int nt = (a.Skv + C::QN - 1) / C::QN;
  const size_t smem =
      2 * C::QM * C::ROW + 2 * C::DQ_STAGE + 2 * ((nt + 31) / 32) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq * (a.Hq / a.Hkv) + C::QM - 1) / C::QM * a.Hkv * a.B);
  flash_bwd_dq_kernel<T, HDM><<<grid, C::QW * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.q_pos, a.kv_pos, static_cast<T*>(dq), a.B, a.Sq, a.Skv,
      a.Hq, a.Hkv, a.hd, a.causal, a.window, a.cap, a.scale);
  return cudaGetLastError();
}

// HDM: hd rounded up to 32, 64, 128 or 256.
template <typename T>
cudaError_t dkdv_hd(const Args& a, void* dk, void* dv, float* part, int splits,
                    cudaStream_t st) {
  if (a.hd <= 32) return launch_dkdv<T, 32>(a, dk, dv, part, splits, st);
  if (a.hd <= 64) return launch_dkdv<T, 64>(a, dk, dv, part, splits, st);
  if (a.hd <= 128) return launch_dkdv<T, 128>(a, dk, dv, part, splits, st);
  return launch_dkdv<T, 256>(a, dk, dv, part, splits, st);
}

template <typename T, int HDM>
void dkdv_tiles_of(int* keys, int* rows) {
  *keys = Tiles<T, HDM>::KN;
  *rows = Tiles<T, HDM>::RM;
}

template <typename T>
void dkdv_tiles_hd(int hd, int* keys, int* rows) {
  if (hd <= 32) return dkdv_tiles_of<T, 32>(keys, rows);
  if (hd <= 64) return dkdv_tiles_of<T, 64>(keys, rows);
  if (hd <= 128) return dkdv_tiles_of<T, 128>(keys, rows);
  return dkdv_tiles_of<T, 256>(keys, rows);
}

template <typename T>
cudaError_t dq_hd(const Args& a, void* dq, cudaStream_t st) {
  if (a.hd <= 32) return launch_dq<T, 32>(a, dq, st);
  if (a.hd <= 64) return launch_dq<T, 64>(a, dq, st);
  if (a.hd <= 128) return launch_dq<T, 128>(a, dq, st);
  return launch_dq<T, 256>(a, dq, st);
}

}  // namespace

extern "C" {

// The launches of K1b, each on `stream`; each returns the cudaError_t of
// its launch (0 on success). dtype: 0 = fp32, 1 = bf16. window <= 0: none;
// logit_cap <= 0: none. The caller has checked shapes, contiguity, dtypes,
// hd % 8 == 0, hd <= 256 and Hq % Hkv == 0; lse and delta are fp32
// [B,Hkv,G,Sq].

// delta = rowsum(dout * out).
int flash_bwd_delta(const void* out, const void* dout, float* delta, int B,
                    int Sq, int Hq, int hd, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * Sq * Hq;
  const dim3 grid((rows + 7) / 8);
  if (dtype == 0)
    flash_bwd_delta_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout), delta,
        rows, Sq, Hq, hd);
  else if (dtype == 1)
    flash_bwd_delta_kernel<bf16><<<grid, 256, 0, st>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta,
        rows, Sq, Hq, hd);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dk and dv [B,Skv,Hkv,hd]. splits > 1: each of `splits` CTAs per key tile
// takes a share of its live row blocks and writes fp32 partials into part
// [2][splits][B*Skv*Hkv*hd], which flash_bwd_reduce sums into dk and dv.
int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* q_pos, const int* kv_pos, void* dk, void* dv,
                   float* part, int B, int Sq, int Skv, int Hq, int Hkv,
                   int hd, int dtype, int causal, int window, int splits,
                   float logit_cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{q,   k,  v,   dout, lse,    delta,  q_pos,     kv_pos, B,
               Sq,  Skv, Hq, Hkv,  hd,     causal, window, logit_cap, scale};
  if (dtype == 0) return (int)dkdv_hd<float>(a, dk, dv, part, splits, st);
  if (dtype == 1) return (int)dkdv_hd<bf16>(a, dk, dv, part, splits, st);
  return (int)cudaErrorInvalidValue;
}

// The dk/dv tiling at hd and dtype: keys a CTA and rows a stage, which
// flash_bwd.plan's split assumes (its wrapper checks them at load).
int flash_bwd_dkdv_tiles(int hd, int dtype, int* keys, int* rows) {
  if (dtype == 0) dkdv_tiles_hd<float>(hd, keys, rows);
  else if (dtype == 1) dkdv_tiles_hd<bf16>(hd, keys, rows);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

// dk, dv [n elements each] = the sums over the splits of part.
int flash_bwd_reduce(const float* part, void* dk, void* dv, long long n,
                     int splits, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long vecs = 2 * n / 4;
  const dim3 grid((unsigned)((vecs + 255) / 256));
  if (dtype == 0)
    flash_bwd_reduce_kernel<float><<<grid, 256, 0, st>>>(
        part, static_cast<float*>(dk), static_cast<float*>(dv), n, splits);
  else if (dtype == 1)
    flash_bwd_reduce_kernel<bf16><<<grid, 256, 0, st>>>(
        part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, splits);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dq [B,Sq,Hq,hd].
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const int* q_pos,
                 const int* kv_pos, void* dq, int B, int Sq, int Skv, int Hq,
                 int Hkv, int hd, int dtype, int causal, int window,
                 float logit_cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{q,   k,  v,   dout, lse,    delta,  q_pos,     kv_pos, B,
               Sq,  Skv, Hq, Hkv,  hd,     causal, window, logit_cap, scale};
  if (dtype == 0) return (int)dq_hd<float>(a, dq, st);
  if (dtype == 1) return (int)dq_hd<bf16>(a, dq, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
