// Flash-attention forward for Hopper (sm_90a), with explicit int32 positions.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel, called through flash_attention_pallas). The Pallas kernel takes a
// contiguous q_offset and a kv_len; this kernel takes the function that both
// it and the model's flash_attention_jnp compute: q_pos [Sq] and kv_pos [Skv]
// (kv_pos -1 marks an empty ring-cache slot), so one kernel serves prefill and
// decode against the ring cache.
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
// Design. One CTA of 128 threads per (b, kv head, block of 64 rows), where a
// row is (query position x one of the G = Hq/Hkv heads that share the kv
// head). GQA thus reads each K/V tile once for all G heads and never
// materialises repeated KV; decode (Sq=1, G=4) fills 4 rows of the block,
// and the rows past the end skip the arithmetic.
// The CTA stages Q [64 x hd] in shared memory as fp32, then walks the keys in
// tiles of 64: K tile -> S = Q K^T in registers (each thread a 4x8 block of
// S) -> online softmax (row max and sum over the 8 lanes sharing a row, by
// warp shuffles) -> P to shared memory -> V tile over the K tile's buffer ->
// acc += P V (each thread 4 rows x hd/8 columns). Tiles move as 16-byte
// vectors, several in flight per thread. Key tiles that no row of the CTA
// can see (empty slots, beyond the causal edge, outside the window) are
// skipped whole, which halves causal prefill.
//
// Bound at the main path's shapes (qwen3-4b; H100 SXM peaks: 989 TFLOP/s
// bf16 tensor cores, 67 TFLOP/s fp32, 3.35 TB/s):
//   prefill B=1, S=512, Hq=32, Hkv=8, hd=128, causal: 4*hd*Hq*S(S+1)/2 =
//     2.15 GFLOP over 10.5 MB of q, k, v and out in bf16 (205 flop/byte,
//     against the card's 295): 2.2 us of tensor-core work against 3.1 us of
//     bytes, so by the card's peaks it sits at the edge, on the bytes side.
//     In fp32 it is bound by operations (32 us). This kernel multiplies in
//     scalar fp32 FMAs, so for it the operations are the bound in practice.
//   decode B=slots, Sq=1, against a C=ctx ring: each cached K and V element
//     (2 bytes in bf16) feeds 2 flops for each of the G=4 query heads of its
//     kv head, 4 flop/byte: bound by the bytes of the K and V cache.
//   recurrentgemma-9b's local layers run it at hd 256 (HDM 256: 151,040
//     bytes of shared memory a CTA, and a small register spill) with MQA
//     16/1 and a 2048-token window: prefill is bound by operations, decode
//     by the bytes of the 2048-slot ring, on only B CTAs.
// chip_smoke.py computes both bounds from each run's inputs. This first
// version does not use the tensor cores and overlaps no load with compute:
// it is far from both bounds. mma/wgmma, TMA pipelining and split-KV decode
// are queued in ROADMAP.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // rows (query position x group head) per CTA
constexpr int BN = 64;          // keys per tile
constexpr int NT = 128;         // threads per CTA
constexpr int RPT = BM / 16;    // rows per thread (16 row groups)
constexpr int CPT = BN / 8;     // score columns per thread (8 column groups)

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes of T -> fp32 in shared memory (dst 16-byte aligned).
__device__ __forceinline__ void put_f32(float* dst, const uint4& u, float) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
      __uint_as_float(u.w));
}
__device__ __forceinline__ void put_f32(float* dst, const uint4& u,
                                        __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(c.x, c.y, d.x, d.y);
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

template <typename T, int HDM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* o, int B, int Sq,
                   int Skv, int Hq, int Hkv, int hd, int causal, int window,
                   float logit_cap, float scale, cudaStream_t stream) {
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

// dtype: 0 = fp32, 1 = bf16. window <= 0: none. logit_cap <= 0: none.
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
