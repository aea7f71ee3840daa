// RWKV-6 WKV scan for Hopper (sm_90a), chunked matrix form: the prefill
// body. The sequential body (decode, short T) is wkv6_scan.cu; the wrapper
// (kernels/rwkv6.py, plan) picks one from the shapes.
//
// Replaces src/repro/kernels/rwkv6_kernel.py::_wkv_kernel (the Pallas TPU
// kernel, called through rwkv6_scan_pallas), in the chunked-matmul form that
// its docstring names as the follow-up. Per (batch b, head h), with the
// k-major state S [hd_k, hd_v] in fp32:
//
//   y_t[v] = sum_k (S[k,v] + u[k] k_t[k] v_t[v]) r_t[k]   (S before the update)
//   S[k,v] <- w_t[k] S[k,v] + k_t[k] v_t[v]
//
// Layout as wkv6_scan.cu: r, k, v [B,T,H,hd] in one type, fp32 or bf16; w
// [B,T,H,hd] fp32; u [H,hd] fp32 or bf16; state and state_out [B,H,hd,hd]
// fp32 (state_out may alias state); y [B,T,H,hd] fp32; hd at most 64.
//
// Bound on the H100 SXM: (5 hd + 5) fp32 operations per element of r, the
// function's own count (wkv6_scan.cu), 6.4 us at rwkv6-3b's prefill (B=1,
// T=512, H=40, hd=64). The sequential body walks 512 steps per (b, h) on 40
// CTAs. Here time is cut into chunks of L=64 steps (the last padded with
// r, k, v = 0 and w = 1), each into 4 sub-chunks of 16, and the work runs as
// matrix products on the tensor cores in three launches:
//
//   1. summaries, one CTA per (b, h, chunk): D_c = exp(Σ lw) and
//      ΔS_c = (k ⊙ decay to the chunk's end)ᵀ V, a 64x64x64 product;
//   2. carry, one thread per (b, h, state element): S_{c+1} = D_c S_c + ΔS_c
//      from state, each chunk's start state written over its ΔS in the
//      scratch, S_T to state_out; the next 8 chunks' loads are in flight
//      while the current 8 are stored. A thread reads its element of state
//      before it writes the same element of state_out, which keeps
//      state_out = state safe; nothing else reads state.
//   3. outputs, one CTA per (b, h, chunk), warp i on sub-chunk i's 16 rows:
//      y = R̃ S_c + A V, R̃[t] = r_t ⊙ exp(Λ[t-1]), and A[t,s] the weight of
//      v_s in y_t: for s in an earlier sub-chunk (r_t ⊙ decay from the
//      sub-chunk's start to t) . (k_s ⊙ decay from s to that start), a
//      product on the tensor cores with both factors <= 1; within the
//      sub-chunk Σ_k r_t k_s Π_{s<m<t} w_m on the CUDA cores with the
//      sequential version's products; A[t,t] = Σ_k r_t u k_t (the u-term).
//
// Decays. lw = max(log w, -88): w may be exactly 0 (the model's
// exp(-exp(.)) underflows) and exp(-88) is already below fp32's normal
// range. Every decay is exp of a sum of lw over a run of steps, and the
// kernel only ever sums runs inside one sub-chunk (from its start, P; to its
// end, Q) and whole sub-chunks (G), never takes the difference of two
// prefix sums: terms of one sign, so the decay of a short run behind a long
// one (a tiny w, then w near 1) keeps its relative precision. The clamp
// keeps every sum finite.
//
// Precision. The products run on mma.sync m16n8k8 in TF32 with the 3xTF32
// split (a = a_hi + a_lo, a_hi = tf32(a), a_lo = tf32(a - a_hi); a b ~ a_lo
// b_hi + a_hi b_lo + a_hi b_hi, fp32 accumulation), close to fp32: one TF32
// product would lose about 2^-11 of each term and break the 2e-4 limit.
// ref.rwkv6_scan_chunked_plain mirrors the arithmetic.
//
// Work spent at the prefill shape, per chunk of (b, h): pass 1 64x64x64 and
// pass 3 on average 4 x (16 x 64 x 24) + 64 x 64 x 64 multiply-adds on the
// tensor cores (each three TF32 products), about 16 x 15 / 2 x 64 x 4 pair
// terms on the CUDA cores, 64 x 64 x 4 exps; pass 2 3 fp32 operations per
// state element per chunk.
//
// The backward (K3b, wkv6_bwd.cu) runs its matrix passes here, through the
// entry points of wkv6_chunk.cuh: passes 1-2 for its chunk start states,
// and the same two on the cotangents (wkv_bwd_cot_kernel: ΔG_c = R̃ᵀ dY,
// R̃[t] = r_t ⊙ decay from the chunk's start to t, a 64x64x64 product;
// wkv_bwd_carry_kernel: G_c = D_c G_{c+1} + ΔG_c from dS_T, last chunk
// first).
//
// Time (PERF.md, scan_phases.py): about 0.078 ms at the prefill shape
// against the 0.0064 ms bound: pass 1 0.015, pass 2 0.004, pass 3 0.056
// (staging 0.008, diagonal blocks 0.016-0.020, runs of log w and decays
// 0.010, off-diagonal blocks 0.005, y 0.013). Every phase of pass 3 is
// latency-bound: 320 CTAs of 4 warps, two an SM (110 KB of shared memory
// each), so each scheduler has two warps to switch between.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "wkv6_chunk.cuh"

namespace {

constexpr int HD = 64;         // head dim the tiles are padded to
constexpr int L = 64;          // steps per chunk
constexpr int SUB = 16;        // steps per sub-chunk
constexpr int NSUB = L / SUB;  // sub-chunks per chunk
constexpr int NT = 128;        // threads of passes 1 and 3: warp i, sub-chunk i
constexpr int LDA = HD + 4;    // row stride of [m][k] operands (A fragments)
constexpr int LDB = HD + 8;    // row stride of [k][n] operands (B fragments)
constexpr int CARRY_NT = 256;  // threads of pass 2
constexpr float LOG_W_FLOOR = -88.f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float log_w(float w) {
  return fmaxf(logf(w), LOG_W_FLOOR);
}

// ---- 3xTF32 on mma.sync m16n8k8 (tf32x3.cuh) ---------------------------
using tf32x3::mma3;
using tf32x3::Split;
using tf32x3::split;

// ---- staging ----------------------------------------------------------------
// A tile is rows t0 .. t0+L-1 of one (b, h) of a [B,T,H,hd] tensor, held in
// shared memory as fp32 [t][0..HD) with row stride ld; steps past T and
// columns past hd get `pad`. Fast path (hd a multiple of 8, tensors 16-byte
// aligned): each thread loads its 16-byte vectors of every tile into
// registers first (load_tile), and only then converts and stores them
// (store_tile), so all of a CTA's loads are in flight at once.
template <typename T>
__host__ __device__ constexpr int tile_vectors() {
  return L * HD * (int)sizeof(T) / 16 / NT;
}

template <typename T>
__device__ __forceinline__ void load_tile(uint4 (&buf)[tile_vectors<T>()],
                                          const T* __restrict__ src, int b,
                                          int t0, int T_, int H, int h,
                                          int hd) {
  constexpr int V = 16 / sizeof(T), PER_ROW = HD / V;
#pragma unroll
  for (int i = 0; i < tile_vectors<T>(); ++i) {
    const int e = threadIdx.x + i * NT;
    const int t = e / PER_ROW, c = (e % PER_ROW) * V;
    buf[i] = t0 + t < T_ && c < hd
                 ? *reinterpret_cast<const uint4*>(
                       src + (((size_t)b * T_ + t0 + t) * H + h) * hd + c)
                 : make_uint4(0, 0, 0, 0);
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(float* dst, int ld,
                                           const uint4 (&buf)[tile_vectors<T>()],
                                           int t0, int T_, int hd, float pad) {
  constexpr int V = 16 / sizeof(T), PER_ROW = HD / V;
#pragma unroll
  for (int i = 0; i < tile_vectors<T>(); ++i) {
    const int e = threadIdx.x + i * NT;
    const int t = e / PER_ROW, c = (e % PER_ROW) * V;
    const bool ok = t0 + t < T_ && c < hd;
    const T* el = reinterpret_cast<const T*>(&buf[i]);
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(dst + t * ld + c + j) =
          ok ? make_float4(to_f(el[j]), to_f(el[j + 1]), to_f(el[j + 2]),
                           to_f(el[j + 3]))
             : make_float4(pad, pad, pad, pad);
  }
}

// The same tile, one element at a time (any hd, any alignment).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src, int b,
                                           int t0, int T_, int H, int h, int hd,
                                           float pad) {
  for (int e = threadIdx.x; e < L * HD; e += NT) {
    const int t = e / HD, c = e % HD;
    dst[t * ld + c] =
        t0 + t < T_ && c < hd
            ? to_f(src[(((size_t)b * T_ + t0 + t) * H + h) * hd + c])
            : pad;
  }
}

// w -> max(log w, floor) over a [L][HD] tile, one element a thread at a time
__device__ __forceinline__ void take_logs(float* a, int ld) {
  for (int e = threadIdx.x; e < L * HD; e += NT)
    a[(e / HD) * ld + e % HD] = log_w(a[(e / HD) * ld + e % HD]);
}

// In place over lw[t][k] (log w) of sub-chunk j, column k: pre[t] = Σ lw of
// the sub-chunk's steps before t (if pre is given), lw[t] <- Σ lw of its
// steps after t; returns Σ lw of the sub-chunk.
__device__ __forceinline__ float run_sums(float* lw, float* pre, int ld, int j,
                                          int k) {
  float acc = 0.f;
  if (pre) {
#pragma unroll
    for (int t = j * SUB; t < (j + 1) * SUB; ++t) {
      pre[t * ld + k] = acc;
      acc += lw[t * ld + k];
    }
  }
  float after = 0.f;
#pragma unroll
  for (int t = (j + 1) * SUB - 1; t >= j * SUB; --t) {
    const float l = lw[t * ld + k];
    lw[t * ld + k] = after;
    after += l;
  }
  return pre ? acc : after;
}

// In place over lw[t][k] of sub-chunk j, column k: lw[t] <- Σ lw of the
// sub-chunk's steps before t; returns Σ lw of the sub-chunk.
__device__ __forceinline__ float run_sums_before(float* lw, int ld, int j,
                                                 int k) {
  float acc = 0.f;
#pragma unroll
  for (int t = j * SUB; t < (j + 1) * SUB; ++t) {
    const float l = lw[t * ld + k];
    lw[t * ld + k] = acc;
    acc += l;
  }
  return acc;
}

// ---- pass 1: the chunk summaries -------------------------------------------
// out[kk][v] = Σ_s a[s][kk] e[s][kk] b[s][v] over the chunk's steps, with
// e[s] the decay from s to the chunk's end (a = k, b = v: ΔS_c; the chunk's
// decay D_c goes to `decay`) or, FROM_START, from the chunk's start to s
// (a = r, b = dy: the backward's ΔG_c; decay is not written).
template <typename TA, typename TB, bool FROM_START>
__device__ __forceinline__ void chunk_summary(
    const TA* __restrict__ a, const TB* __restrict__ bm,
    const float* __restrict__ w, float* __restrict__ scratch,
    float* __restrict__ decay, int T_, int H, int hd, bool vec) {
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                 // [L][LDB]: a, then a ⊙ its decay
  float* vs = ks + L * LDB;       // [L][LDB]: b
  float* qs = vs + L * LDB;       // [L][LDB]: w, log w, then its runs
  __shared__ float g[NSUB][HD];   // Σ lw of each sub-chunk
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = c * L;

  if (vec) {
    uint4 kb[tile_vectors<TA>()], vb[tile_vectors<TB>()],
        wb[tile_vectors<float>()];
    load_tile<TA>(kb, a, b, t0, T_, H, h, hd);
    load_tile<TB>(vb, bm, b, t0, T_, H, h, hd);
    load_tile<float>(wb, w, b, t0, T_, H, h, hd);
    store_tile<TA>(ks, LDB, kb, t0, T_, hd, 0.f);
    store_tile<TB>(vs, LDB, vb, t0, T_, hd, 0.f);
    store_tile<float>(qs, LDB, wb, t0, T_, hd, 1.f);
  } else {
    stage_rows(ks, LDB, a, b, t0, T_, H, h, hd, 0.f);
    stage_rows(vs, LDB, bm, b, t0, T_, H, h, hd, 0.f);
    stage_rows(qs, LDB, w, b, t0, T_, H, h, hd, 1.f);
  }
  __syncthreads();
  take_logs(qs, LDB);
  __syncthreads();
  for (int task = threadIdx.x; task < NSUB * HD; task += NT)
    g[task / HD][task % HD] =
        FROM_START ? run_sums_before(qs, LDB, task / HD, task % HD)
                   : run_sums(qs, nullptr, LDB, task / HD, task % HD);
  __syncthreads();
  // per column: Σ lw of the sub-chunks after j (before j, FROM_START),
  // then the chunk's decay
  float* other = reinterpret_cast<float*>(g);  // reused in place below
  if (threadIdx.x < HD) {
    const int kk = threadIdx.x;
    float acc = 0.f;
    for (int i = 0; i < NSUB; ++i) {
      const int j = FROM_START ? i : NSUB - 1 - i;
      const float gj = g[j][kk];
      other[j * HD + kk] = acc;
      acc += gj;
    }
    if (!FROM_START)
      decay[(((size_t)b * H + h) * n_chunks + c) * HD + kk] = expf(acc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < L * HD; e += NT) {
    const int s = e / HD, kk = e % HD;
    ks[s * LDB + kk] *= expf(qs[s * LDB + kk] + other[(s / SUB) * HD + kk]);
  }
  __syncthreads();

  // out[kk][v] = Σ_s ks[s][kk] vs[s][v]; warp wi takes rows kk of 16 wi ..
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = wi * 16;
  float acc[HD / 8][4] = {};
#pragma unroll 2
  for (int s0 = 0; s0 < L; s0 += 8) {
    const Split fa[4] = {split(ks[(s0 + tq) * LDB + m0 + gq]),
                         split(ks[(s0 + tq) * LDB + m0 + gq + 8]),
                         split(ks[(s0 + tq + 4) * LDB + m0 + gq]),
                         split(ks[(s0 + tq + 4) * LDB + m0 + gq + 8])};
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const Split bb[2] = {split(vs[(s0 + tq) * LDB + nt * 8 + gq]),
                           split(vs[(s0 + tq + 4) * LDB + nt * 8 + gq])};
      mma3(acc[nt], fa, bb);
    }
  }
  float* out = scratch + (((size_t)b * H + h) * n_chunks + c) * HD * HD;
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    *reinterpret_cast<float2*>(out + (m0 + gq) * HD + col) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(out + (m0 + gq + 8) * HD + col) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// ΔS_c = (k ⊙ decay to the chunk's end)ᵀ V, and D_c
template <typename T>
__global__ void __launch_bounds__(NT)
wkv_summary_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ w, float* __restrict__ scratch,
                   float* __restrict__ decay, int T_, int H, int hd, bool vec) {
  chunk_summary<T, T, false>(k, v, w, scratch, decay, T_, H, hd, vec);
}

// the backward's ΔG_c = (r ⊙ decay from the chunk's start)ᵀ dY
template <typename T>
__global__ void __launch_bounds__(NT)
wkv_bwd_cot_kernel(const T* __restrict__ r, const float* __restrict__ dy,
                   const float* __restrict__ w, float* __restrict__ scratch,
                   int T_, int H, int hd, bool vec) {
  chunk_summary<T, float, true>(r, dy, w, scratch, nullptr, T_, H, hd, vec);
}

// ---- pass 2: the carry ------------------------------------------------------
// x_{c+1} = D_c x_c + Δ_c over the chunks from init, first to last (the
// states: each chunk's start state written over its Δ, S_T to out unless
// out is null) or, REVERSE, last to first (the backward's cotangents from
// dS_T: each chunk's end cotangent G_{c+1} written over its ΔG, ds0 to out).
template <bool REVERSE>
__device__ __forceinline__ void chunk_carry(const float* init, float* out,
                                            float* scratch,
                                            const float* __restrict__ decay,
                                            int hd, int n_chunks) {
  const int e = blockIdx.x * CARRY_NT + threadIdx.x;  // of HD * HD
  const int bh = blockIdx.y;
  const int kk = e / HD, vv = e % HD;
  const bool ok = kk < hd && vv < hd;
  const size_t sidx = (size_t)bh * hd * hd + (size_t)kk * hd + vv;
  float s = ok ? init[sidx] : 0.f;
  float* sc = scratch + (size_t)bh * n_chunks * HD * HD + e;
  const float* dc = decay + (size_t)bh * n_chunks * HD + kk;
  // two batches of chunks in registers: the next batch's loads are in
  // flight while the current batch's stores and chain run
  constexpr int BATCH = 8;
  float ds0[BATCH], d0[BATCH], ds1[BATCH], d1[BATCH];
  auto chunk_of = [&](int m) { return REVERSE ? n_chunks - 1 - m : m; };
  auto load = [&](float (&ds)[BATCH], float (&d)[BATCH], int c0) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (c0 + j < n_chunks) {
        ds[j] = sc[(size_t)chunk_of(c0 + j) * HD * HD];
        d[j] = dc[(size_t)chunk_of(c0 + j) * HD];
      }
    }
  };
  auto step = [&](const float (&ds)[BATCH], const float (&d)[BATCH], int c0) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (c0 + j < n_chunks) {
        // the chunk's start state (end cotangent, REVERSE)
        sc[(size_t)chunk_of(c0 + j) * HD * HD] = s;
        s = d[j] * s + ds[j];
      }
    }
  };
  load(ds0, d0, 0);
  for (int c0 = 0; c0 < n_chunks; c0 += 2 * BATCH) {
    load(ds1, d1, c0 + BATCH);
    step(ds0, d0, c0);
    load(ds0, d0, c0 + 2 * BATCH);
    step(ds1, d1, c0 + BATCH);
  }
  if (ok && out) out[sidx] = s;
}

// A thread reads its element of state before it writes the same element of
// state_out, which keeps state_out = state safe; nothing else reads state.
__global__ void __launch_bounds__(CARRY_NT)
wkv_carry_kernel(const float* state, float* state_out, float* scratch,
                 const float* __restrict__ decay, int hd, int n_chunks) {
  chunk_carry<false>(state, state_out, scratch, decay, hd, n_chunks);
}

__global__ void __launch_bounds__(CARRY_NT)
wkv_bwd_carry_kernel(const float* __restrict__ ds_T, float* __restrict__ ds0,
                     float* scratch, const float* __restrict__ decay, int hd,
                     int n_chunks) {
  chunk_carry<true>(ds_T, ds0, scratch, decay, hd, n_chunks);
}

// ---- pass 3: the outputs ----------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(NT)
wkv_output_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ w,
                  const void* __restrict__ u, int u_bf16,
                  const float* __restrict__ scratch, float* __restrict__ y,
                  int T_, int H, int hd, bool vec) {
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                 // [L][LDA]: r, then r ⊙ decay from b_i
  float* ks = rs + L * LDA;       // [L][LDA]: k, then k ⊙ decay to its end
  float* ps = ks + L * LDA;       // [L][LDA]: Σ lw before t, then A
  float* qs = ps + L * LDA;       // [L][LDA]: w, log w, then Σ lw after s
  float* vs = qs + L * LDA;       // [L][LDB]: v
  float* ss = vs + L * LDB;       // [HD][LDB]: S_c
  __shared__ float g[NSUB][HD];        // Σ lw of each sub-chunk
  __shared__ float eb[NSUB][HD];       // exp(Σ lw of sub-chunks before i)
  __shared__ float eg[NSUB * (NSUB - 1) / 2][HD];  // exp(Σ between j and i)
  __shared__ __align__(16) float us[HD];
  __shared__ float dg[NSUB][SUB][SUB];  // the blocks on the diagonal of A
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = c * L;
  const int lane = threadIdx.x % 32, wi = threadIdx.x / 32;
  const int gq = lane / 4, tq = lane % 4;
  const int m0 = wi * SUB;  // this warp's sub-chunk: rows m0 .. m0+15

  const float4* sc = reinterpret_cast<const float4*>(
      scratch + (((size_t)b * H + h) * n_chunks + c) * HD * HD);
  constexpr int NS = HD * HD / 4 / NT;  // float4 of S_c per thread
  float4 sb[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sb[i] = sc[threadIdx.x + i * NT];
  if (vec) {
    uint4 rb[tile_vectors<T>()], kb[tile_vectors<T>()],
        vb[tile_vectors<T>()], wb[tile_vectors<float>()];
    load_tile<T>(rb, r, b, t0, T_, H, h, hd);
    load_tile<T>(kb, k, b, t0, T_, H, h, hd);
    load_tile<T>(vb, v, b, t0, T_, H, h, hd);
    load_tile<float>(wb, w, b, t0, T_, H, h, hd);
    store_tile<T>(rs, LDA, rb, t0, T_, hd, 0.f);
    store_tile<T>(ks, LDA, kb, t0, T_, hd, 0.f);
    store_tile<T>(vs, LDB, vb, t0, T_, hd, 0.f);
    store_tile<float>(qs, LDA, wb, t0, T_, hd, 1.f);
  } else {
    stage_rows(rs, LDA, r, b, t0, T_, H, h, hd, 0.f);
    stage_rows(ks, LDA, k, b, t0, T_, H, h, hd, 0.f);
    stage_rows(qs, LDA, w, b, t0, T_, H, h, hd, 1.f);
    stage_rows(vs, LDB, v, b, t0, T_, H, h, hd, 0.f);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int e = 4 * (threadIdx.x + i * NT);
    *reinterpret_cast<float4*>(ss + (e / HD) * LDB + e % HD) = sb[i];
  }
  if (threadIdx.x < HD) {
    const int kk = threadIdx.x;
    us[kk] = kk >= hd ? 0.f
             : u_bf16 ? __bfloat162float(
                            static_cast<const __nv_bfloat16*>(u)[h * hd + kk])
                      : static_cast<const float*>(u)[h * hd + kk];
  }
  __syncthreads();

  // Within the sub-chunk, on the CUDA cores: lane (s, kh) keeps k_s[kh half]
  // and the running decay Π_{s<m<t} w_m of its 32 columns and walks t (not
  // unrolled: the body is long); the two halves meet by a shuffle. Pair
  // (t, s) of sub-chunk wi goes to dg[wi][t][s].
  {
    const int s = lane % SUB, kh = (lane / SUB) * (HD / 2);
    float kreg[HD / 2], dec[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      kreg[i] = ks[(m0 + s) * LDA + kh + i];
      dec[i] = 1.f;
    }
    const float4* us4 = reinterpret_cast<const float4*>(us + kh);
#pragma unroll 1
    for (int t = 0; t < SUB; ++t) {
      float part = 0.f;
      if (t >= s) {  // four partial sums over float4 reads of r_t and w
        const float4* rt =
            reinterpret_cast<const float4*>(rs + (m0 + t) * LDA + kh);
        const float4* wt =
            reinterpret_cast<const float4*>(qs + (m0 + t - 1) * LDA + kh);
        float p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i4 = 0; i4 < HD / 8; ++i4) {
          const float4 r4 = rt[i4];
          float4 f4;  // u at t = s (the u-term), else the decay
          if (t == s) {
            f4 = us4[i4];
          } else {
            if (t > s + 1) {
              const float4 w4 = wt[i4];
              dec[4 * i4] *= w4.x;
              dec[4 * i4 + 1] *= w4.y;
              dec[4 * i4 + 2] *= w4.z;
              dec[4 * i4 + 3] *= w4.w;
            }
            f4 = make_float4(dec[4 * i4], dec[4 * i4 + 1], dec[4 * i4 + 2],
                             dec[4 * i4 + 3]);
          }
          p[0] = fmaf(r4.x * kreg[4 * i4], f4.x, p[0]);
          p[1] = fmaf(r4.y * kreg[4 * i4 + 1], f4.y, p[1]);
          p[2] = fmaf(r4.z * kreg[4 * i4 + 2], f4.z, p[2]);
          p[3] = fmaf(r4.w * kreg[4 * i4 + 3], f4.w, p[3]);
        }
        part = (p[0] + p[1]) + (p[2] + p[3]);
      }
      part += __shfl_xor_sync(0xffffffffu, part, SUB);
      if (lane < SUB) dg[wi][t][s] = part;  // 0 above the diagonal
    }
  }
  __syncthreads();  // w is read
  take_logs(qs, LDA);
  __syncthreads();

  // the runs of lw: P (before t) into ps, Q (after s) over qs, G
  for (int task = threadIdx.x; task < NSUB * HD; task += NT)
    g[task / HD][task % HD] = run_sums(qs, ps, LDA, task / HD, task % HD);
  __syncthreads();
  if (threadIdx.x < HD) {
    const int kk = threadIdx.x;
    float before = 0.f;
    for (int i = 0; i < NSUB; ++i) {
      eb[i][kk] = expf(before);
      before += g[i][kk];
      float between = 0.f;  // Σ G over j < m < i, for j = i-1 down to 0
      for (int j = i - 1; j >= 0; --j) {
        eg[i * (i - 1) / 2 + j][kk] = expf(between);
        between += g[j][kk];
      }
    }
  }
  for (int e = threadIdx.x; e < L * HD; e += NT) {
    const int t = e / HD, kk = e % HD;
    rs[t * LDA + kk] *= expf(ps[t * LDA + kk]);
    ks[t * LDA + kk] *= expf(qs[t * LDA + kk]);
  }
  __syncthreads();  // ps is free: it becomes A [t][s]

  float* as = ps;
#pragma unroll
  for (int e = lane; e < SUB * SUB; e += 32)
    as[(m0 + e / SUB) * LDA + m0 + e % SUB] = dg[wi][e / SUB][e % SUB];
  // the blocks left of the diagonal: A[t][s < m0] = R̂ K̂ᵀ on the tensor
  // cores, K̂[s] = ks[s] ⊙ exp(Σ G between s's sub-chunk and this one)
  if (wi > 0) {
    float acc[2 * (NSUB - 1)][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < HD; k0 += 8) {
      const Split a[4] = {split(rs[(m0 + gq) * LDA + k0 + tq]),
                          split(rs[(m0 + gq + 8) * LDA + k0 + tq]),
                          split(rs[(m0 + gq) * LDA + k0 + tq + 4]),
                          split(rs[(m0 + gq + 8) * LDA + k0 + tq + 4])};
#pragma unroll
      for (int nt = 0; nt < 2 * (NSUB - 1); ++nt) {
        if (nt < 2 * wi) {
          const int s = nt * 8 + gq;
          const float* e = eg[wi * (wi - 1) / 2 + s / SUB];
          const Split bb[2] = {
              split(ks[s * LDA + k0 + tq] * e[k0 + tq]),
              split(ks[s * LDA + k0 + tq + 4] * e[k0 + tq + 4])};
          mma3(acc[nt], a, bb);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2 * (NSUB - 1); ++nt) {
      if (nt < 2 * wi) {
        const int col = nt * 8 + 2 * tq;
        as[(m0 + gq) * LDA + col] = acc[nt][0];
        as[(m0 + gq) * LDA + col + 1] = acc[nt][1];
        as[(m0 + gq + 8) * LDA + col] = acc[nt][2];
        as[(m0 + gq + 8) * LDA + col + 1] = acc[nt][3];
      }
    }
  }
  __syncwarp();

  // y = A V + R̃ S_c over this warp's rows; A is zero right of the diagonal
  float acc[HD / 8][4] = {};
  for (int s0 = 0; s0 < m0 + SUB; s0 += 8) {
    const Split a[4] = {split(as[(m0 + gq) * LDA + s0 + tq]),
                        split(as[(m0 + gq + 8) * LDA + s0 + tq]),
                        split(as[(m0 + gq) * LDA + s0 + tq + 4]),
                        split(as[(m0 + gq + 8) * LDA + s0 + tq + 4])};
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const Split bb[2] = {split(vs[(s0 + tq) * LDB + nt * 8 + gq]),
                           split(vs[(s0 + tq + 4) * LDB + nt * 8 + gq])};
      mma3(acc[nt], a, bb);
    }
  }
  const float* e = eb[wi];
#pragma unroll 2
  for (int k0 = 0; k0 < HD; k0 += 8) {
    const Split a[4] = {
        split(rs[(m0 + gq) * LDA + k0 + tq] * e[k0 + tq]),
        split(rs[(m0 + gq + 8) * LDA + k0 + tq] * e[k0 + tq]),
        split(rs[(m0 + gq) * LDA + k0 + tq + 4] * e[k0 + tq + 4]),
        split(rs[(m0 + gq + 8) * LDA + k0 + tq + 4] * e[k0 + tq + 4])};
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      const Split bb[2] = {split(ss[(k0 + tq) * LDB + nt * 8 + gq]),
                           split(ss[(k0 + tq + 4) * LDB + nt * 8 + gq])};
      mma3(acc[nt], a, bb);
    }
  }
#pragma unroll
  for (int nt = 0; nt < HD / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + m0 + gq + 8 * half;
      if (t >= T_) continue;
      float* out = y + (((size_t)b * T_ + t) * H + h) * hd;
      const int col = nt * 8 + 2 * tq;
      if (col < hd) out[col] = acc[nt][2 * half];
      if (col + 1 < hd) out[col + 1] = acc[nt][2 * half + 1];
    }
  }
}

constexpr int SUMMARY_SMEM = 3 * L * LDB * sizeof(float);
constexpr int OUTPUT_SMEM = (4 * L * LDA + L * LDB + HD * LDB) * sizeof(float);

// passes 1-2: every chunk's start state into scratch, its decay into decay
template <typename T>
cudaError_t launch_states(const void* k, const void* v, const float* w,
                          const float* state, float* state_out, float* scratch,
                          float* decay, int B, int T_, int H, int hd, bool vec,
                          cudaStream_t stream) {
  const int n_chunks = (T_ + L - 1) / L;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_summary_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SUMMARY_SMEM);
  if (err != cudaSuccess) return err;
  wkv_summary_kernel<T><<<dim3(n_chunks, H, B), NT, SUMMARY_SMEM, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), w, scratch, decay,
      T_, H, hd, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv_carry_kernel<<<dim3(HD * HD / CARRY_NT, B * H), CARRY_NT, 0, stream>>>(
      state, state_out, scratch, decay, hd, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cotangents(const void* r, const float* dy, const float* w,
                              const float* ds_T, float* ds0, float* ends,
                              const float* decay, int B, int T_, int H, int hd,
                              bool vec, cudaStream_t stream) {
  const int n_chunks = (T_ + L - 1) / L;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_cot_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SUMMARY_SMEM);
  if (err != cudaSuccess) return err;
  wkv_bwd_cot_kernel<T><<<dim3(n_chunks, H, B), NT, SUMMARY_SMEM, stream>>>(
      static_cast<const T*>(r), dy, w, ends, T_, H, hd, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wkv_bwd_carry_kernel<<<dim3(HD * HD / CARRY_NT, B * H), CARRY_NT, 0,
                         stream>>>(ds_T, ds0, ends, decay, hd, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const void* u, int u_bf16, const float* state, float* y,
                   float* state_out, float* scratch, float* decay, int B,
                   int T_, int H, int hd, bool vec, cudaStream_t stream) {
  const int n_chunks = (T_ + L - 1) / L;
  cudaError_t err = launch_states<T>(k, v, w, state, state_out, scratch, decay,
                                     B, T_, H, hd, vec, stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             OUTPUT_SMEM);
  if (err != cudaSuccess) return err;
  wkv_output_kernel<T><<<dim3(n_chunks, H, B), NT, OUTPUT_SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, u_bf16, scratch, y, T_, H, hd, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// L and SUB, which the caller needs to size scratch and decay; returns 0.
int wkv6_scan_chunked_steps(int* chunk, int* sub) {
  *chunk = L;
  *sub = SUB;
  return 0;
}

// The chunked body: three launches on the stream. dtype (r, k, v), u_dtype:
// 0 = fp32, 1 = bf16; w is fp32. scratch: fp32 [B, H, ceil(T/64), 64, 64];
// decay: fp32 [B, H, ceil(T/64), 64]. vec: hd is a multiple of 8 and r, k,
// v, w are 16-byte aligned. Returns the first cudaError_t (0 on success).
// The caller has checked shapes, types and contiguity, 1 <= hd <= 64,
// T >= 1, B <= 65535 and H <= 65535.
int wkv6_scan_chunked(const void* r, const void* k, const void* v,
                      const float* w, const void* u, const float* state,
                      float* y, float* state_out, float* scratch, float* decay,
                      int B, int T, int H, int hd, int dtype, int u_dtype,
                      int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > HD || (u_dtype != 0 && u_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(r, k, v, w, u, u_dtype, state, y, state_out,
                              scratch, decay, B, T, H, hd, vec != 0, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(r, k, v, w, u, u_dtype, state, y,
                                      state_out, scratch, decay, B, T, H, hd,
                                      vec != 0, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

// The backward's matrix passes (wkv6_chunk.cuh); dtype: 0 = fp32, 1 = bf16.
namespace wkv6_chunk {

cudaError_t states(const void* k, const void* v, const float* w,
                   const float* state, float* state_out, float* starts,
                   float* decay, int B, int T, int H, int hd, int dtype,
                   bool vec, cudaStream_t stream) {
  if (dtype == 0)
    return launch_states<float>(k, v, w, state, state_out, starts, decay, B,
                                T, H, hd, vec, stream);
  return launch_states<__nv_bfloat16>(k, v, w, state, state_out, starts,
                                      decay, B, T, H, hd, vec, stream);
}

cudaError_t cotangents(const void* r, const float* dy, const float* w,
                       const float* ds_T, float* ds0, float* ends,
                       const float* decay, int B, int T, int H, int hd,
                       int dtype, bool vec, cudaStream_t stream) {
  if (dtype == 0)
    return launch_cotangents<float>(r, dy, w, ds_T, ds0, ends, decay, B, T, H,
                                    hd, vec, stream);
  return launch_cotangents<__nv_bfloat16>(r, dy, w, ds_T, ds0, ends, decay, B,
                                          T, H, hd, vec, stream);
}

}  // namespace wkv6_chunk
