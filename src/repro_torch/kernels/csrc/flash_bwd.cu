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
// Three kernels, no atomics, so two runs give the same bits:
//   flash_bwd_delta_kernel  one warp per (b, query, head): delta.
//   flash_bwd_dkdv_kernel   one CTA per (b, kv head, tile of BT keys): K and
//                           V stay in shared memory; the CTA walks the row
//                           blocks (query position x the G heads, as in
//                           flash_fwd.cu) whose positions can see the tile,
//                           recomputes p and ds for each and accumulates
//                           dk and dv in registers. The GQA sum over the
//                           group happens inside the CTA.
//   flash_bwd_dq_kernel     one CTA per (b, kv head, row block): Q and dout
//                           stay in shared memory; the CTA walks the key
//                           tiles its rows can see and accumulates dq.
// Both recompute the scores: the pair does 7 products of the
// [rows x keys x hd] kind where the function needs 5.
//
// This first version runs on the CUDA cores in fp32 for both input types
// (bf16 is widened when staged): 256 threads, each a 4 x 4 (2 x 2 at hd
// 256) block of the scores and of dp, and a slice of 2-4 keys (rows) by 4-16
// columns of the accumulators. Tiles are BT = 64 keys and rows (32 at hd
// 256, to stay inside shared memory: 171 KB at hd 128, 143 KB at hd 256).
// Padded rows (+4 floats) keep the float4 reads of 8 neighbouring rows on
// distinct banks.
//
// Bound at the training shape (qwen3-4b, B=4, S=2048, Hq=32, Hkv=8, hd=128,
// causal, bf16): the function needs 10 hd operations per valid (query, key)
// pair and query head, 343.8 GFLOP, 0.348 ms on the bf16 tensor cores
// (989 TFLOP/s), against 0.03 ms of bytes: bound by operations. This body
// does 7/5 of that work on the fp32 CUDA cores (67 TFLOP/s peak), so it
// cannot come within 10x of the bound; the tensor-core form (mma.sync or
// wgmma, as the forward) is the next step (ROADMAP.md, queue 2).
// chip_smoke.py computes the bound from each run's inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;  // threads per CTA of the dk/dv and dq kernels

// Rows (and keys) per tile: 64, or 32 at hd 256.
template <int HDM>
__host__ __device__ constexpr int tile_rows() { return HDM > 128 ? 32 : 64; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T at u -> fp32 at dst (16-byte aligned).
__device__ __forceinline__ void put_f32(float* dst, const uint4& u, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
      __uint_as_float(u.w));
}
__device__ __forceinline__ void put_f32(float* dst, const uint4& u, bf16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
}

// Stage R rows of hd elements as fp32 [R][HDM+4]. Tile row r is source row
// i = first + r, found at src + ((i / grp) * stride + i % grp) * hd; zero
// once i >= nvalid and in columns d >= hd (hd % 8 == 0: whole vectors).
template <typename T, int R, int HDM>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           int first, int nvalid, int grp,
                                           int stride, int hd, int tid) {
  constexpr int LD = HDM + 4;
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VPR = HDM / VE;       // vectors per tile row
  for (int vi = tid; vi < R * VPR; vi += NT) {
    const int r = vi / VPR, c = vi % VPR, i = first + r;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (i < nvalid && c * VE < hd)
      u = *reinterpret_cast<const uint4*>(
          src + ((size_t)(i / grp) * stride + i % grp) * hd + c * VE);
    put_f32(dst + r * LD + c * VE, u, T());
  }
}

// One tile of BT rows by BT keys: s = q.k and dp = dout.v from the staged
// Q, dO, K and V, then p and ds into shared memory ([BT][BT+4]; Ps only
// when WITH_P). Thread (rg, cg) = (tid / 16, tid % 16) takes rows rg + 16 i
// and keys cg + 16 j. Row r is live (rok) if it exists; a row that does not
// exist, a masked pair and a row with no valid key get p = ds = 0.
template <int BT, int HDM, bool WITH_P>
__device__ __forceinline__ void tile_scores(
    const float* Qs, const float* dOs, const float* Ks, const float* Vs,
    const int* qps, const int* rok, const float* lses, const float* dels,
    const int* kps, float* Ps, float* dSs, int hd, int causal, int window,
    float logit_cap, float scale, int tid) {
  constexpr int LD = HDM + 4, LDP = BT + 4, RI = BT / 16;
  const int rg = tid >> 4, cg = tid & 15;
  float s[RI][RI], dp[RI][RI];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RI; ++j) s[i][j] = dp[i][j] = 0.f;
  for (int d = 0; d < hd; d += 4) {
    float4 qa[RI], oa[RI], kb[RI], vb[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(&Qs[(rg + 16 * i) * LD + d]);
      oa[i] = *reinterpret_cast<const float4*>(&dOs[(rg + 16 * i) * LD + d]);
      kb[i] = *reinterpret_cast<const float4*>(&Ks[(cg + 16 * i) * LD + d]);
      vb[i] = *reinterpret_cast<const float4*>(&Vs[(cg + 16 * i) * LD + d]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        float a = s[i][j], c = dp[i][j];
        a = fmaf(qa[i].x, kb[j].x, a);
        a = fmaf(qa[i].y, kb[j].y, a);
        a = fmaf(qa[i].z, kb[j].z, a);
        a = fmaf(qa[i].w, kb[j].w, a);
        c = fmaf(oa[i].x, vb[j].x, c);
        c = fmaf(oa[i].y, vb[j].y, c);
        c = fmaf(oa[i].z, vb[j].z, c);
        c = fmaf(oa[i].w, vb[j].w, c);
        s[i][j] = a;
        dp[i][j] = c;
      }
  }
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int m = rg + 16 * i;
#pragma unroll
    for (int j = 0; j < RI; ++j) {
      const int n = cg + 16 * j;
      const bool ok = rok[m] && flash::key_ok(qps[m], kps[n], causal, window);
      float x = s[i][j] * scale, ug = 1.f;
      if (logit_cap > 0.f) {  // the derivative at the capped score
        const float t = tanhf(x / logit_cap);
        ug = 1.f - t * t;
        x = logit_cap * t;
      }
      const float p = ok ? expf(x - lses[m]) : 0.f;
      if (WITH_P) Ps[m * LDP + n] = p;
      dSs[m * LDP + n] = p * (dp[i][j] - dels[m]) * ug * scale;
    }
  }
}

template <int BT, int HDM>
constexpr size_t smem_bytes(int score_tiles) {
  return ((size_t)4 * BT * (HDM + 4) + (size_t)score_tiles * BT * (BT + 4)) *
             sizeof(float) +
         (size_t)5 * BT * sizeof(int);
}

// Accumulator layout: TC threads across the columns of a row (4 columns a
// thread per chunk), NT / TC rows per pass.
template <int HDM>
struct AccLayout {
  static constexpr int TC = HDM >= 64 ? 16 : 8;
  static constexpr int KR = NT / TC;
  static constexpr int CH = HDM / (4 * TC);  // float4 chunks per thread
};

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

template <typename T, int HDM>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
                      int hd, int causal, int window, float logit_cap,
                      float scale) {
  constexpr int BT = tile_rows<HDM>(), LD = HDM + 4, LDP = BT + 4;
  using L = AccLayout<HDM>;
  constexpr int KPT = BT / L::KR;  // keys per thread
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* Ps = dOs + BT * LD;
  float* dSs = Ps + BT * LDP;
  int* kps = reinterpret_cast<int*>(dSs + BT * LDP);
  int* qps = kps + BT;
  int* rok = qps + BT;
  float* lses = reinterpret_cast<float*>(rok + BT);
  float* dels = lses + BT;

  const int tid = threadIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, nrows = Sq * G, n0 = blockIdx.x * BT;
  const size_t kv_off = ((size_t)b * Skv * Hkv + kvh) * hd;
  stage_rows<T, BT, HDM>(Ks, k + kv_off, n0, Skv, 1, Hkv, hd, tid);
  stage_rows<T, BT, HDM>(Vs, v + kv_off, n0, Skv, 1, Hkv, hd, tid);
  if (tid < BT) kps[tid] = n0 + tid < Skv ? kv_pos[n0 + tid] : -1;
  __syncthreads();
  int kmin = INT_MAX, kmax = INT_MIN;  // over the tile's valid keys
  for (int n = 0; n < BT; ++n)
    if (kps[n] >= 0) {
      kmin = min(kmin, kps[n]);
      kmax = max(kmax, kps[n]);
    }

  const int kr = tid / L::TC, cc = tid % L::TC;
  float dk_acc[KPT][4 * L::CH], dv_acc[KPT][4 * L::CH];
#pragma unroll
  for (int i = 0; i < KPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CH; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const size_t row_lse = ((size_t)b * Hkv + kvh) * G * Sq;
  for (int row0 = 0; kmax >= 0 && row0 < nrows; row0 += BT) {
    // row r: query (row0 + r) / G, head kvh * G + (row0 + r) % G
    int sees = 0;
    if (tid < BT) {
      const int gr = row0 + tid, live = gr < nrows;
      const int qp = live ? q_pos[gr / G] : 0;
      qps[tid] = qp;
      rok[tid] = live;
      lses[tid] = live ? lse[row_lse + (size_t)(gr % G) * Sq + gr / G] : 0.f;
      dels[tid] = live ? delta[row_lse + (size_t)(gr % G) * Sq + gr / G] : 0.f;
      sees = live && (!causal || qp >= kmin) && (window <= 0 || qp - kmax < window);
    }
    if (!__syncthreads_or(sees)) continue;  // no row of the block sees the tile
    const size_t q_off = ((size_t)b * Sq * Hq + kvh * G) * hd;
    stage_rows<T, BT, HDM>(Qs, q + q_off, row0, nrows, G, Hq, hd, tid);
    stage_rows<T, BT, HDM>(dOs, dout + q_off, row0, nrows, G, Hq, hd, tid);
    __syncthreads();
    tile_scores<BT, HDM, true>(Qs, dOs, Ks, Vs, qps, rok, lses, dels, kps, Ps,
                               dSs, hd, causal, window, logit_cap, scale, tid);
    __syncthreads();
    for (int m = 0; m < BT; ++m) {
      float pv[KPT], dsv[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        pv[i] = Ps[m * LDP + kr + L::KR * i];
        dsv[i] = dSs[m * LDP + kr + L::KR * i];
      }
#pragma unroll
      for (int c = 0; c < L::CH; ++c) {
        const int col = 4 * (cc + L::TC * c);
        const float4 o4 = *reinterpret_cast<const float4*>(&dOs[m * LD + col]);
        const float4 q4 = *reinterpret_cast<const float4*>(&Qs[m * LD + col]);
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          dv_acc[i][4 * c + 0] = fmaf(pv[i], o4.x, dv_acc[i][4 * c + 0]);
          dv_acc[i][4 * c + 1] = fmaf(pv[i], o4.y, dv_acc[i][4 * c + 1]);
          dv_acc[i][4 * c + 2] = fmaf(pv[i], o4.z, dv_acc[i][4 * c + 2]);
          dv_acc[i][4 * c + 3] = fmaf(pv[i], o4.w, dv_acc[i][4 * c + 3]);
          dk_acc[i][4 * c + 0] = fmaf(dsv[i], q4.x, dk_acc[i][4 * c + 0]);
          dk_acc[i][4 * c + 1] = fmaf(dsv[i], q4.y, dk_acc[i][4 * c + 1]);
          dk_acc[i][4 * c + 2] = fmaf(dsv[i], q4.z, dk_acc[i][4 * c + 2]);
          dk_acc[i][4 * c + 3] = fmaf(dsv[i], q4.w, dk_acc[i][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // before the next block overwrites the row tiles
  }

#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const int n = n0 + kr + L::KR * i;
    if (n >= Skv) continue;
    const size_t off = ((size_t)(b * Skv + n) * Hkv + kvh) * hd;
#pragma unroll
    for (int c = 0; c < L::CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (cc + L::TC * c) + e;
        if (d < hd) {
          from_f(dk + off + d, dk_acc[i][4 * c + e]);
          from_f(dv + off + d, dv_acc[i][4 * c + e]);
        }
      }
  }
}

template <typename T, int HDM>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, T* __restrict__ dq, int Sq,
                    int Skv, int Hq, int Hkv, int hd, int causal, int window,
                    float logit_cap, float scale) {
  constexpr int BT = tile_rows<HDM>(), LD = HDM + 4, LDP = BT + 4;
  using L = AccLayout<HDM>;
  constexpr int RPT = BT / L::KR;  // rows per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dSs = Vs + BT * LD;
  int* kps = reinterpret_cast<int*>(dSs + BT * LDP);
  int* qps = kps + BT;
  int* rok = qps + BT;
  float* lses = reinterpret_cast<float*>(rok + BT);
  float* dels = lses + BT;
  __shared__ int qrange[2];

  const int tid = threadIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv, nrows = Sq * G, row0 = blockIdx.x * BT;
  const size_t q_off = ((size_t)b * Sq * Hq + kvh * G) * hd;
  stage_rows<T, BT, HDM>(Qs, q + q_off, row0, nrows, G, Hq, hd, tid);
  stage_rows<T, BT, HDM>(dOs, dout + q_off, row0, nrows, G, Hq, hd, tid);
  if (tid == 0) {
    qrange[0] = INT_MAX;
    qrange[1] = INT_MIN;
  }
  __syncthreads();
  const size_t row_lse = ((size_t)b * Hkv + kvh) * G * Sq;
  if (tid < BT) {
    const int gr = row0 + tid, live = gr < nrows;
    const int qp = live ? q_pos[gr / G] : 0;
    qps[tid] = qp;
    rok[tid] = live;
    lses[tid] = live ? lse[row_lse + (size_t)(gr % G) * Sq + gr / G] : 0.f;
    dels[tid] = live ? delta[row_lse + (size_t)(gr % G) * Sq + gr / G] : 0.f;
    if (live) {
      atomicMin(&qrange[0], qp);
      atomicMax(&qrange[1], qp);
    }
  }
  __syncthreads();
  const int qmin = qrange[0], qmax = qrange[1];

  const int mr = tid / L::TC, cc = tid % L::TC;
  float acc[RPT][4 * L::CH];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < 4 * L::CH; ++c) acc[i][c] = 0.f;

  const size_t kv_off = ((size_t)b * Skv * Hkv + kvh) * hd;
  for (int n0 = 0; n0 < Skv; n0 += BT) {
    int see = 0;
    if (tid < BT) {
      const int kp = n0 + tid < Skv ? kv_pos[n0 + tid] : -1;
      kps[tid] = kp;
      see = kp >= 0 && (!causal || kp <= qmax) && (window <= 0 || qmin - kp < window);
    }
    if (!__syncthreads_or(see)) continue;  // no row of the block sees the tile
    stage_rows<T, BT, HDM>(Ks, k + kv_off, n0, Skv, 1, Hkv, hd, tid);
    stage_rows<T, BT, HDM>(Vs, v + kv_off, n0, Skv, 1, Hkv, hd, tid);
    __syncthreads();
    tile_scores<BT, HDM, false>(Qs, dOs, Ks, Vs, qps, rok, lses, dels, kps,
                                nullptr, dSs, hd, causal, window, logit_cap,
                                scale, tid);
    __syncthreads();
    for (int n = 0; n < BT; ++n) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = dSs[(mr + L::KR * i) * LDP + n];
#pragma unroll
      for (int c = 0; c < L::CH; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            &Ks[n * LD + 4 * (cc + L::TC * c)]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[i][4 * c + 0] = fmaf(dsv[i], k4.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(dsv[i], k4.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(dsv[i], k4.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(dsv[i], k4.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites K, V, dS and kps
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gr = row0 + mr + L::KR * i;
    if (gr >= nrows) continue;
    T* row = dq + ((size_t)(b * Sq + gr / G) * Hq + kvh * G + gr % G) * hd;
#pragma unroll
    for (int c = 0; c < L::CH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (cc + L::TC * c) + e;
        if (d < hd) from_f(row + d, acc[i][4 * c + e]);
      }
  }
}

template <typename T, int HDM>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v,
                        const void* dout, const float* lse, const float* delta,
                        const int* q_pos, const int* kv_pos, void* dk, void* dv,
                        int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                        int causal, int window, float logit_cap, float scale,
                        cudaStream_t stream) {
  constexpr int BT = tile_rows<HDM>();
  constexpr size_t smem = smem_bytes<BT, HDM>(2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, HDM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BT - 1) / BT, Hkv, B);
  flash_bwd_dkdv_kernel<T, HDM><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, q_pos,
      kv_pos, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, Hq, Hkv, hd,
      causal, window, logit_cap, scale);
  return cudaGetLastError();
}

template <typename T, int HDM>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const int* q_pos, const int* kv_pos, void* dq, int B,
                      int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                      int window, float logit_cap, float scale,
                      cudaStream_t stream) {
  constexpr int BT = tile_rows<HDM>();
  constexpr size_t smem = smem_bytes<BT, HDM>(1);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq * (Hq / Hkv) + BT - 1) / BT, Hkv, B);
  flash_bwd_dq_kernel<T, HDM><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, q_pos,
      kv_pos, static_cast<T*>(dq), Sq, Skv, Hq, Hkv, hd, causal, window,
      logit_cap, scale);
  return cudaGetLastError();
}

// HDM: hd rounded up to 32, 64, 128 or 256.
template <typename T>
cudaError_t dkdv_hd(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    const int* q_pos, const int* kv_pos, void* dk, void* dv,
                    int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                    int window, float logit_cap, float scale,
                    cudaStream_t stream) {
  if (hd <= 32)
    return launch_dkdv<T, 32>(q, k, v, dout, lse, delta, q_pos, kv_pos, dk, dv,
                              B, Sq, Skv, Hq, Hkv, hd, causal, window,
                              logit_cap, scale, stream);
  if (hd <= 64)
    return launch_dkdv<T, 64>(q, k, v, dout, lse, delta, q_pos, kv_pos, dk, dv,
                              B, Sq, Skv, Hq, Hkv, hd, causal, window,
                              logit_cap, scale, stream);
  if (hd <= 128)
    return launch_dkdv<T, 128>(q, k, v, dout, lse, delta, q_pos, kv_pos, dk,
                               dv, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                               logit_cap, scale, stream);
  return launch_dkdv<T, 256>(q, k, v, dout, lse, delta, q_pos, kv_pos, dk, dv,
                             B, Sq, Skv, Hq, Hkv, hd, causal, window,
                             logit_cap, scale, stream);
}

template <typename T>
cudaError_t dq_hd(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  const int* q_pos, const int* kv_pos, void* dq, int B, int Sq,
                  int Skv, int Hq, int Hkv, int hd, int causal, int window,
                  float logit_cap, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch_dq<T, 32>(q, k, v, dout, lse, delta, q_pos, kv_pos, dq, B,
                            Sq, Skv, Hq, Hkv, hd, causal, window, logit_cap,
                            scale, stream);
  if (hd <= 64)
    return launch_dq<T, 64>(q, k, v, dout, lse, delta, q_pos, kv_pos, dq, B,
                            Sq, Skv, Hq, Hkv, hd, causal, window, logit_cap,
                            scale, stream);
  if (hd <= 128)
    return launch_dq<T, 128>(q, k, v, dout, lse, delta, q_pos, kv_pos, dq, B,
                             Sq, Skv, Hq, Hkv, hd, causal, window, logit_cap,
                             scale, stream);
  return launch_dq<T, 256>(q, k, v, dout, lse, delta, q_pos, kv_pos, dq, B,
                           Sq, Skv, Hq, Hkv, hd, causal, window, logit_cap,
                           scale, stream);
}

}  // namespace

extern "C" {

// The three launches of K1b, each on `stream`; each returns the
// cudaError_t of its launch (0 on success). dtype: 0 = fp32, 1 = bf16.
// window <= 0: none; logit_cap <= 0: none. The caller has checked shapes,
// contiguity, dtypes, hd % 8 == 0, hd <= 256 and Hq % Hkv == 0; lse and
// delta are fp32 [B,Hkv,G,Sq].

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

// dk and dv [B,Skv,Hkv,hd].
int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* q_pos, const int* kv_pos, void* dk, void* dv,
                   int B, int Sq, int Skv, int Hq, int Hkv, int hd, int dtype,
                   int causal, int window, float logit_cap, float scale,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dkdv_hd<float>(q, k, v, dout, lse, delta, q_pos, kv_pos, dk,
                               dv, B, Sq, Skv, Hq, Hkv, hd, causal, window,
                               logit_cap, scale, st);
  if (dtype == 1)
    return (int)dkdv_hd<bf16>(q, k, v, dout, lse, delta, q_pos, kv_pos, dk, dv,
                              B, Sq, Skv, Hq, Hkv, hd, causal, window,
                              logit_cap, scale, st);
  return (int)cudaErrorInvalidValue;
}

// dq [B,Sq,Hq,hd].
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                 const float* lse, const float* delta, const int* q_pos,
                 const int* kv_pos, void* dq, int B, int Sq, int Skv, int Hq,
                 int Hkv, int hd, int dtype, int causal, int window,
                 float logit_cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dq_hd<float>(q, k, v, dout, lse, delta, q_pos, kv_pos, dq, B,
                             Sq, Skv, Hq, Hkv, hd, causal, window, logit_cap,
                             scale, st);
  if (dtype == 1)
    return (int)dq_hd<bf16>(q, k, v, dout, lse, delta, q_pos, kv_pos, dq, B,
                            Sq, Skv, Hq, Hkv, hd, causal, window, logit_cap,
                            scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
