// Flash-attention forward for Hopper (sm_90a), with explicit int32 positions.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel, called through flash_attention_pallas). The Pallas kernel takes a
// contiguous q_offset and a kv_len; this kernel takes the function that both
// it and the model's flash_attention_jnp compute: q_pos [Sq] and kv_pos [Skv]
// (kv_pos -1 marks an empty ring-cache slot), so it serves prefill against
// the ring cache too.
//
//   s   = (q . k) * scale                  scale = 1/sqrt(hd), fp32
//   s   = cap * tanh(s / cap)              if logit_cap > 0
//   ok  = kv_pos >= 0 [&& q_pos - kv_pos >= 0 if causal]
//                     [&& q_pos - kv_pos <  window if window > 0]
//   out = sum_k softmax_k(s | ok) v_k      running m, l, acc in fp32;
//                                          written in q's dtype
//
// A row with no valid key gets 0, as the Pallas kernel gives it
// (flash_attention.py:63,72-73); flash_attention_jnp and attention_reference
// give the mean of V there instead. Causal prefill and a decode slot written
// before attention always leave the diagonal valid, so serving never meets
// such a row.
//
// Layout: q [B,Sq,Hq,hd], k/v [B,Skv,Hkv,hd], out [B,Sq,Hq,hd], contiguous;
// fp32 or bf16; hd a multiple of 8, at most 256.
//
// Two bodies, chosen by dtype. ops.attention sends every call with more
// than one query position here; one query position goes to flash_decode.cu.
// Both bodies take one CTA per (b, kv head, block of rows), where a row is
// (query position x one of the G = Hq/Hkv heads that share the kv head):
// GQA reads each K/V tile once for all G heads and never materialises
// repeated KV. Key tiles that no row of the CTA can see (empty slots,
// beyond the causal edge, outside the window) are skipped whole, which
// halves causal prefill and bounds windowed prefill by the window.
//
// bf16 (the serving type): flash_fwd_mma_kernel, on the tensor cores in the
// FlashAttention-2 form. 8 warps of 16 rows (128 rows a CTA) over tiles of
// 64 keys. Q stays in shared memory as bf16; K and V tiles stream through
// two cp.async stages, the next tile's copies in flight while the current
// one computes. Rows are padded by 16 bytes so that ldmatrix's eight row
// addresses fall on distinct banks. S = Q K^T is mma.sync m16n8k16 with
// fp32 accumulation (K fragments by ldmatrix); the online softmax runs on
// the accumulator fragments in registers (row max and sum over the quad of
// lanes that share a row); P is rounded to bf16 in registers and is the A
// operand of O += P V (V fragments by ldmatrix.trans). Statistics and O
// stay fp32. Rounding P to bf16 is the one step the fp32 Pallas kernel does
// not take: it moves each output by at most 2^-8 of the probability-
// weighted mean of |v|, which the checks' limit carries (chip_smoke.py,
// test_torch_gpu.py). Tiles that every row sees whole skip the per-element
// mask. The last row blocks are launched first: under a causal mask they
// see the most keys, and a wave that ended on them would idle the card.
// Registers: O is hd/8 fp32 fragments of 4 a thread (128 at hd 256), the
// scores 32; ptxas fits hd 256 in 215 registers without a spill. Shared
// memory: Q 128 x (hd+8) + 2 stages x (K + V) x 64 x (hd+8) bf16: 203,264
// bytes at hd 256 (one CTA an SM), 104,960 at hd 128 (two).
//
// fp32 (the checks' type): flash_fwd_kernel, unchanged since its first
// version: 128 threads, 64 rows a CTA, Q and K/V tiles widened to fp32 in
// shared memory, S = Q K^T and acc += P V in scalar fp32 FMAs (each thread
// a 4x8 block of S, 4 rows x hd/8 columns of acc), synchronous 16-byte
// loads. TF32 would break the fp32 limits, and no served model runs fp32.
//
// Bound at the main path's shapes (H100 SXM peaks: 989 TFLOP/s bf16 tensor
// cores, 67 TFLOP/s fp32, 3.35 TB/s):
//   qwen3-4b prefill B=1, S=512, Hq=32, Hkv=8, hd=128, causal:
//     4*hd*Hq*S(S+1)/2 = 2.15 GFLOP over 10.5 MB of q, k, v and out in bf16
//     (205 flop/byte against the card's 295): 2.2 us of tensor-core work
//     against 3.1 us of bytes, at the edge, on the bytes side. The CTAs of
//     the last rows walk all 8 key tiles in series, so the latency of one
//     tile (loads, two products, the softmax between them, two barriers)
//     bounds it in practice.
//   recurrentgemma-9b's local layers, prefill 1 x 2560, MQA 16/1, hd 256,
//     window 2048: 51.6 GFLOP of valid pairs, bound by operations (52 us).
//     mma.sync with 16-row warps reads each K and V fragment from shared
//     memory once per 16 rows; wgmma (64-row warpgroups, operands straight
//     from shared memory) is the step after this one (ROADMAP.md).
// chip_smoke.py computes both bounds from each run's inputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_common.cuh"

namespace {

constexpr int BM = 64;          // rows (query position x group head) per CTA
constexpr int BN = 64;          // keys per tile
constexpr int NT = 128;         // threads per CTA
constexpr int RPT = BM / 16;    // rows per thread (16 row groups)
constexpr int CPT = BN / 8;     // score columns per thread (8 column groups)

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

// 16 bytes of T -> fp32 in shared memory (dst 16-byte aligned).
__device__ __forceinline__ void put_f32(float* dst, const uint4& u, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
      __uint_as_float(u.w));
}

// Stage a 64-row tile of hd-long rows into shared memory as fp32 [64][LD].
// Tile row r is source row i = first + r, found at
// src + ((i / grp) * stride + i % grp) * hd, and is zero once i >= nvalid;
// columns d >= hd are zero. Each thread moves 16-byte vectors, up to 8 of
// them in flight before it stores any, so a tile costs one or two load
// latencies (the source rows are 16-byte aligned: hd % 8 == 0).
template <typename T, int HDM>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int first, int nvalid, int grp,
                                          int stride, int hd, int tid) {
  constexpr int LD = HDM + 4;
  constexpr int VE = 16 / sizeof(T);      // elements per vector
  constexpr int VPR = HDM / VE;           // vectors per tile row
  constexpr int NV = 64 * VPR / NT;       // vectors per thread
  constexpr int GRP = NV < 8 ? NV : 8;    // vectors in flight per thread
  static_assert(NV % GRP == 0, "tile split");
#pragma unroll
  for (int g0 = 0; g0 < NV; g0 += GRP) {
    uint4 buf[GRP];
#pragma unroll
    for (int u = 0; u < GRP; ++u) {
      const int vi = (g0 + u) * NT + tid;
      const int r = vi / VPR, c = vi % VPR;
      const int i = first + r;
      buf[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < nvalid && c * VE < hd)
        buf[u] = *reinterpret_cast<const uint4*>(
            src + ((size_t)(i / grp) * stride + i % grp) * hd + c * VE);
    }
#pragma unroll
    for (int u = 0; u < GRP; ++u) {
      const int vi = (g0 + u) * NT + tid;
      put_f32(dst + (vi / VPR) * LD + (vi % VPR) * VE, buf[u], T());
    }
  }
}

template <int HDM>
constexpr size_t smem_bytes() {
  return (size_t)(BM * (HDM + 4) + BN * (HDM + 4) + BM * (BN + 4)) * sizeof(float) +
         (size_t)(BM + BN) * sizeof(int);
}

// HDM: hd rounded up to 32, 64, 128 or 256 (register arrays need it fixed);
// columns d >= hd are zero in shared memory and never stored.
template <typename T, int HDM>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos, T* __restrict__ o,
                 int Sq, int Skv, int Hq, int Hkv, int hd,
                 int causal, int window, float logit_cap, float scale) {
  constexpr int LD = HDM + 4;   // padded row stride of the Q and K/V tiles
  constexpr int LDP = BN + 4;   // padded row stride of the P tile
  constexpr int DCH = HDM / 32; // float4 column chunks of acc per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [BM][LD]
  float* KVs = Qs + BM * LD;                      // [BN][LD], K then V
  float* Ps = KVs + BN * LD;                      // [BM][LDP]
  int* qps = reinterpret_cast<int*>(Ps + BM * LDP);  // [BM] row positions
  int* kps = qps + BM;                            // [BN] key positions

  const int tid = threadIdx.x;
  const int rg = tid >> 3;      // rows rg + 16*i
  const int cg = tid & 7;       // score columns cg + 8*j; acc chunks cg + 8*c
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int nrows = Sq * G;
  const int row0 = blockIdx.x * BM;

  // Q tile. Row r is query qi = (row0+r)/G, head kvh*G + (row0+r)%G; rows
  // past the end load zeros and take the last query's position.
  load_tile<T, HDM>(Qs, q + ((size_t)b * Sq * Hq + kvh * G) * hd, row0, nrows,
                    G, Hq, hd, tid);
  if (tid < BM) {
    const int gr = min(row0 + tid, nrows - 1);
    qps[tid] = q_pos[gr / G];
  }
  __syncthreads();

  int qmin = INT_MAX, qmax = INT_MIN;
  for (int r = 0; r < BM; ++r) {
    qmin = min(qmin, qps[r]);
    qmax = max(qmax, qps[r]);
  }
  // Rows past the end (3/4 of a block in decode) skip the arithmetic; a row
  // group's 8 lanes agree, and live rows come first (rows rg + 16*i).
  int my_qp[RPT];
  bool live_row[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    my_qp[i] = qps[rg + 16 * i];
    live_row[i] = row0 + rg + 16 * i < nrows;
  }

  float m[RPT], l[RPT], acc[RPT][4 * DCH];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DCH; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < Skv; n0 += BN) {
    int live = 0;
    if (tid < BN) {
      const int kp = (n0 + tid < Skv) ? kv_pos[n0 + tid] : -1;
      kps[tid] = kp;
      live = kp >= 0 && (!causal || kp <= qmax) &&
             (window <= 0 || qmin - kp < window);
    }
    if (!__syncthreads_or(live)) continue;  // no row of this CTA sees the tile

    const size_t kv_off = ((size_t)b * Skv * Hkv + kvh) * hd;
    load_tile<T, HDM>(KVs, k + kv_off, n0, Skv, 1, Hkv, hd, tid);
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int d = 0; live_row[0] && d < hd; d += 4) {
      float4 qa[RPT], kb[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(rg + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&KVs[(cg + 8 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (!live_row[i]) continue;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float t = s[i][j];
          t = fmaf(qa[i].x, kb[j].x, t);
          t = fmaf(qa[i].y, kb[j].y, t);
          t = fmaf(qa[i].z, kb[j].z, t);
          t = fmaf(qa[i].w, kb[j].w, t);
          s[i][j] = t;
        }
      }
    }
    __syncthreads();  // every thread is done with K before V overwrites it

    load_tile<T, HDM>(KVs, v + kv_off, n0, Skv, 1, Hkv, hd, tid);

    // Scores -> probabilities, with the running max and sum of each row.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kp = kps[cg + 8 * j];
        const int dpos = my_qp[i] - kp;
        float x = s[i][j] * scale;
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        const bool ok = kp >= 0 && (!causal || dpos >= 0) &&
                        (window <= 0 || dpos < window);
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      // m_new is -inf only while the row has seen no valid key: acc and l
      // are still 0 then, and every p below is 0.
      const float alpha = (m_new == -INFINITY) ? 1.f : expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - m_new);
        Ps[(rg + 16 * i) * LDP + cg + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DCH; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // P and the V tile are complete

    for (int n = 0; live_row[0] && n < BN; ++n) {
      float pr[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pr[i] = Ps[(rg + 16 * i) * LDP + n];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&KVs[n * LD + (cg + 8 * c) * 4]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          if (!live_row[i]) continue;
          acc[i][4 * c + 0] = fmaf(pr[i], vv.x, acc[i][4 * c + 0]);
          acc[i][4 * c + 1] = fmaf(pr[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites kps, KVs and Ps
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gr = row0 + rg + 16 * i;
    if (gr >= nrows) continue;
    const int qi = gr / G, g = gr % G;
    T* orow = o + ((size_t)(b * Sq + qi) * Hq + kvh * G + g) * hd;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = (cg + 8 * c) * 4 + e;
        if (d < hd) store_f(orow + d, any ? acc[i][4 * c + e] / l[i] : 0.f);
      }
  }
}

// --------------------------------------------------------------------------
// bf16 body on the tensor cores
// --------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

// 8 warps of 16 rows over 64-key tiles, at every head dim: the fastest of
// the tilings timed at the serving prefills (16 or 32 rows a warp, 4 or 8
// warps, tiles of 16 to 64 keys; PERF.md).
constexpr int MMA_NW = 8;               // warps per CTA
constexpr int MMA_NT = MMA_NW * 32;     // threads per CTA
constexpr int MMA_BM = MMA_NW * 16;     // rows per CTA
constexpr int MMA_BN = 64;              // keys per tile

// Bytes of one stage: K and V tiles [MMA_BN][HDM+8] bf16 and their positions.
template <int HDM>
__host__ __device__ constexpr size_t mma_stage_bytes() {
  return (size_t)2 * MMA_BN * (HDM + 8) * sizeof(bf16) + MMA_BN * sizeof(int);
}

// Q [MMA_BM][HDM+8] bf16 and two stages; then two bitmasks over the key
// tiles, sized at launch.
template <int HDM>
__host__ __device__ constexpr size_t mma_smem_fixed() {
  return (size_t)MMA_BM * (HDM + 8) * sizeof(bf16) + 2 * mma_stage_bytes<HDM>();
}

template <int HDM>
__global__ void __launch_bounds__(MMA_NT)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, bf16* __restrict__ o,
                     int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                     int window, float logit_cap, float scale) {
  using namespace flash;
  constexpr int BN = MMA_BN, BM = MMA_BM, NTH = MMA_NT;
  constexpr int LDS = HDM + 8;  // padded row: ldmatrix rows on distinct banks
  constexpr int VPR = HDM / 8;  // 16-byte chunks per row
  constexpr int NB = BN / 8;    // score fragments per warp (16 x 8 each)
  constexpr int NO = HDM / 8;   // output fragments per warp
  constexpr size_t STAGE = mma_stage_bytes<HDM>();
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  char* stages = base + (size_t)BM * LDS * sizeof(bf16);
  const int nt = (Skv + BN - 1) / BN;
  unsigned* live = reinterpret_cast<unsigned*>(stages + 2 * STAGE);
  unsigned* full = live + (nt + 31) / 32;
  __shared__ int qrange[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int nrows = Sq * G;
  // The last row blocks start first: under a causal mask they see the most
  // keys, and a wave that ended on them would leave the card idle.
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int wrow = warp * 16;  // this warp's first row in the CTA

  // Q tile, row r = query (row0+r)/G, head kvh*G + (row0+r)%G; zeros past
  // the last row and past hd.
  for (int i = tid; i < BM * VPR; i += NTH) {
    const int r = i / VPR, c = i % VPR, gr = row0 + r;
    const bool ok = gr < nrows && c * 8 < hd;
    const bf16* src =
        ok ? q + ((size_t)(b * Sq + gr / G) * Hq + kvh * G + gr % G) * hd + c * 8
           : q;
    cp_async16(Qs + r * LDS + c * 8, src, ok);
  }
  cp_async_commit();

  if (tid == 0) {
    qrange[0] = INT_MAX;
    qrange[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < BM) {
    const int p = q_pos[min(row0 + tid, nrows - 1) / G];
    atomicMin(&qrange[0], p);
    atomicMax(&qrange[1], p);
  }
  int qp[2];  // positions of this lane's rows g and g+8 (rows past the end
              // take the last query's; they are never stored)
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qp[r] = q_pos[min(row0 + wrow + g + 8 * r, nrows - 1) / G];
  __syncthreads();
  mark_live_tiles(live, full, kv_pos, 0, Skv, BN, qrange[0], qrange[1],
                  causal, window, tid, NTH);

  auto issue = [&](int tile, int st) {
    bf16* ks = reinterpret_cast<bf16*>(stages + st * STAGE);
    bf16* vs = ks + BN * LDS;
    int* kp = reinterpret_cast<int*>(vs + BN * LDS);
    const int n0 = tile * BN;
    for (int i = tid; i < BN * VPR; i += NTH) {
      const int r = i / VPR, c = i % VPR, n = n0 + r;
      const bool ok = n < Skv && c * 8 < hd;
      const size_t off = ok ? ((size_t)(b * Skv + n) * Hkv + kvh) * hd + c * 8 : 0;
      cp_async16(ks + r * LDS + c * 8, k + off, ok);
      cp_async16(vs + r * LDS + c * 8, v + off, ok);
    }
    if (tid < BN) {
      if (n0 + tid < Skv)
        cp_async4(kp + tid, kv_pos + n0 + tid);
      else
        kp[tid] = -1;
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int tile = next_live(live, 0, nt), st = 0;
  if (tile < nt) issue(tile, 0);
  cp_async_commit();
  while (tile < nt) {
    const int nxt = next_live(live, tile + 1, nt);
    if (nxt < nt) issue(nxt, st ^ 1);  // in flight while this tile computes
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = reinterpret_cast<const bf16*>(stages + st * STAGE);
    const bf16* vs = ks + BN * LDS;
    const int* kp = reinterpret_cast<const int*>(vs + BN * LDS);

    float s[NB][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDM / 16; ++kk) {
      if (kk * 16 >= hd) continue;
      unsigned a[4];
      ldsm_x4(a, Qs + (wrow + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        unsigned bb[4];
        ldsm_x4(bb, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bb[0], bb[1]);
        mma_bf16(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
    // every row sees every key of a full tile: no per-element mask
    const bool whole = (full[tile >> 5] >> (tile & 31)) & 1u;
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = logit2(s[j][e],
                         whole || key_ok(qp[e >> 1], kp[j * 8 + 2 * t + (e & 1)],
                                         causal, window),
                         scale, logit_cap);
    softmax_update(s, m, l, acc);
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HDM / 16; ++dp) {
        if (dp * 16 >= hd) continue;
        unsigned bb[4];
        ldsm_x4_trans(bb, vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                              dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
        mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
    tile = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

  finish_rowsum(l);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gr = row0 + wrow + g + 8 * r;
    if (gr >= nrows) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: 0
    bf16* orow = o + ((size_t)(b * Sq + gr / G) * Hq + kvh * G + gr % G) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = j * 8 + 2 * t;
      if (d < hd) store2(orow + d, acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

template <int HDM>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const int* q_pos, const int* kv_pos, void* o, int B,
                       int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                       int window, float logit_cap, float scale,
                       cudaStream_t stream) {
  const int nt = (Skv + MMA_BN - 1) / MMA_BN;
  const size_t smem = mma_smem_fixed<HDM>() + (size_t)((nt + 31) / 32) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  dim3 grid((Sq * G + MMA_BM - 1) / MMA_BM, Hkv, B);
  flash_fwd_mma_kernel<HDM><<<grid, MMA_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), q_pos, kv_pos, static_cast<bf16*>(o), Sq,
      Skv, Hq, Hkv, hd, causal, window, logit_cap, scale);
  return cudaGetLastError();
}

template <typename T, int HDM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* o, int B, int Sq,
                   int Skv, int Hq, int Hkv, int hd, int causal, int window,
                   float logit_cap, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return launch_mma<HDM>(q, k, v, q_pos, kv_pos, o, B, Sq, Skv, Hq, Hkv, hd,
                           causal, window, logit_cap, scale, stream);
  } else {
    constexpr size_t smem = smem_bytes<HDM>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const int G = Hq / Hkv;
    dim3 grid((Sq * G + BM - 1) / BM, Hkv, B);
    flash_fwd_kernel<T, HDM><<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), q_pos, kv_pos, static_cast<T*>(o), Sq, Skv,
        Hq, Hkv, hd, causal, window, logit_cap, scale);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, void* o, int B,
                        int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                        int window, float logit_cap, float scale,
                        cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, q_pos, kv_pos, o, B, Sq, Skv, Hq, Hkv, hd,
                         causal, window, logit_cap, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, q_pos, kv_pos, o, B, Sq, Skv, Hq, Hkv, hd,
                         causal, window, logit_cap, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, q_pos, kv_pos, o, B, Sq, Skv, Hq, Hkv, hd,
                          causal, window, logit_cap, scale, stream);
  return launch<T, 256>(q, k, v, q_pos, kv_pos, o, B, Sq, Skv, Hq, Hkv, hd,
                        causal, window, logit_cap, scale, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = fp32 (SIMT body), 1 = bf16 (tensor cores). window <= 0: none. logit_cap <= 0: none.
// Returns the cudaError_t of the launch (0 on success). The caller has
// checked shapes, contiguity, hd % 8 == 0, hd <= 256 and Hq % Hkv == 0.
int flash_fwd(const void* q, const void* k, const void* v, const int* q_pos,
              const int* kv_pos, void* o, int B, int Sq, int Skv, int Hq,
              int Hkv, int hd, int dtype, int causal, int window,
              float logit_cap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, q_pos, kv_pos, o, B, Sq, Skv, Hq,
                                   Hkv, hd, causal, window, logit_cap, scale,
                                   st);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, q_pos, kv_pos, o, B, Sq,
                                           Skv, Hq, Hkv, hd, causal, window,
                                           logit_cap, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

