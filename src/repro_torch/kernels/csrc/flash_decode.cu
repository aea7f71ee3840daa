// Split-KV attention decode for Hopper (sm_90a): one query position against
// the ring cache, with explicit int32 positions.
//
// Replaces src/repro/kernels/flash_attention.py::_fwd_kernel (the Pallas TPU
// kernel) for the calls with one query position, which ops.attention sends
// here; flash_fwd.cu takes every other call. It computes the same function
// as flash_fwd.cu (see its head note): kv position -1 marks an empty slot,
// causal, window and tanh softcap, GQA/MQA, fp32 statistics, 0 for a row
// with no valid key, out in q's dtype.
//
// Bound. Each cached K and V element feeds 2 flops for each of the G query
// heads of its kv head: G/2 flop per byte of bf16 cache, 8 at recurrentgemma
// (MQA, G = 16) and 2 at qwen3 (G = 4), far below the card's 295. The bytes
// of the K and V the query sees bound every serving shape: 16.8 MB of
// recurrentgemma's full 2048-slot ring for 8 slots (5.0 us), 29.9 MB of
// qwen3's 1024-slot ring (8.9 us). One CTA per (slot, kv head) walking the
// whole ring, as flash_fwd.cu did, puts 8 CTAs on 132 SMs at recurrentgemma.
//
// Design: flash-decoding in two passes, both launched by one C call.
//   1. flash_decode_kernel, grid (n_splits, Hkv x ceil(G/16), B): a CTA of 4
//      warps takes 16 query rows (the G heads of one kv head, padded to 16)
//      over one contiguous chunk of split_keys keys. Tiles of 64 keys stream
//      through two cp.async stages; warp w computes on keys 16w..16w+15 of
//      each tile with its own online softmax, and the 4 warps merge at the
//      end. The CTA writes its partial (acc[hd], m, l) per row to an fp32
//      scratch [B, Hkv, n_splits, G, hd+2], m in log2 units. Tiles that the
//      query cannot see (empty slots, past the causal edge, outside the
//      window) are skipped; a CTA whose chunk holds none does no
//      arithmetic and writes m = -inf, l = 0, acc = 0. Tiles whose every
//      key the query sees skip the per-element mask.
//   2. flash_decode_combine_kernel, grid (Hq, B): out = sum_s 2^(m_s - M)
//      acc_s / sum_s 2^(m_s - M) l_s over the splits, 0 where every split
//      saw no valid key.
// bf16: the 16 rows are the M = 16 side of mma.sync m16n8k16 (S = Q K^T,
// then O += P V with P rounded to bf16 in registers, as in flash_fwd.cu's
// tensor-core body); at G = 16 the 8 flop per byte sit near the fp32 SIMT
// ridge, so scalar FMAs would not reach the bytes bound. fp32: the same
// splits, tiles and fragment layout, with the products in scalar fp32 FMAs
// (TF32 would break the fp32 limits; fp32 serves only the checks).
// The wrapper (kernels/flash_decode.py) picks n_splits from the shapes: about
// two CTAs per SM, at least one 64-key tile a split.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int NT = 128;    // 4 warps
constexpr int ROWS = 16;   // query rows per CTA
constexpr int TILE = 64;   // keys per tile; warp w takes 16w..16w+15
constexpr int LDP = 17;    // padded row of the fp32 body's P tile

template <typename T, int HDM>
struct Layout {
  static constexpr int VE = 16 / sizeof(T);     // elements per 16 bytes
  static constexpr int LDS = HDM + VE;          // padded row (+16 bytes)
  static constexpr int VPR = HDM / VE;          // 16-byte chunks per row
  static constexpr size_t Q_BYTES = (size_t)ROWS * LDS * sizeof(T);
  // fp32 only: each warp's P [16][LDP], which its lanes exchange
  static constexpr size_t P_BYTES =
      std::is_same<T, float>::value ? (size_t)4 * ROWS * LDP * sizeof(float) : 0;
  // K and V tiles [TILE][LDS] and their positions
  static constexpr size_t STAGE_BYTES =
      (size_t)2 * TILE * LDS * sizeof(T) + TILE * sizeof(int);
  static_assert(STAGE_BYTES >= (size_t)4 * ROWS * (HDM + 2) * sizeof(float),
                "one stage holds the 4 warps' partials for the merge");
  // Two stages overlap a tile's loads with the previous tile's arithmetic
  // wherever a split has more than one tile and they fit in the 227 KB a
  // CTA may use; fp32 at hd 256 needs 267 KB for two, so it takes one and
  // loads each next tile after the current one is done.
  static constexpr bool TWO_STAGES_FIT =
      Q_BYTES + P_BYTES + 2 * STAGE_BYTES + 1024 <= 232448;
  __host__ __device__ static constexpr int stages(int split_keys) {
    return split_keys > TILE && TWO_STAGES_FIT ? 2 : 1;
  }
};

// S = Q K^T for this warp's 16 keys: s[j] is the C fragment of keys 8j..8j+7.
template <int HDM>
__device__ __forceinline__ void scores(float (&s)[2][4], const bf16* Qs,
                                       const bf16* Ks, const float*, int warp,
                                       int lane, int hd) {
  using namespace flash;
  constexpr int LDS = HDM + 8;
#pragma unroll
  for (int kk = 0; kk < HDM / 16; ++kk) {
    if (kk * 16 >= hd) continue;
    unsigned a[4], bb[4];
    ldsm_x4(a, Qs + (lane & 15) * LDS + kk * 16 + (lane >> 4) * 8);
    ldsm_x4(bb, Ks + (warp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                    kk * 16 + ((lane >> 3) & 1) * 8);
    mma_bf16(s[0], a, bb[0], bb[1]);
    mma_bf16(s[1], a, bb[2], bb[3]);
  }
}

template <int HDM>
__device__ __forceinline__ void scores(float (&s)[2][4], const float* Qs,
                                       const float* Ks, const float*, int warp,
                                       int lane, int hd) {
  constexpr int LDS = HDM + 4;
  const int g = lane >> 2, t = lane & 3;
  const float* qa = Qs + g * LDS;
  const float* qb = qa + 8 * LDS;
  const float* kr[4];  // keys 2t, 2t+1, 8+2t, 9+2t of the warp's 16
#pragma unroll
  for (int c = 0; c < 4; ++c)
    kr[c] = Ks + (warp * 16 + (c >> 1) * 8 + 2 * t + (c & 1)) * LDS;
  for (int d = 0; d < hd; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(qa + d);
    const float4 y = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(kr[c] + d);
      float& s0 = s[c >> 1][c & 1];
      float& s1 = s[c >> 1][2 + (c & 1)];
      s0 = fmaf(x.x, kv.x, s0); s0 = fmaf(x.y, kv.y, s0);
      s0 = fmaf(x.z, kv.z, s0); s0 = fmaf(x.w, kv.w, s0);
      s1 = fmaf(y.x, kv.x, s1); s1 = fmaf(y.y, kv.y, s1);
      s1 = fmaf(y.z, kv.z, s1); s1 = fmaf(y.w, kv.w, s1);
    }
  }
}

// acc += P V for this warp's 16 keys; p holds P in the C-fragment layout.
template <int HDM>
__device__ __forceinline__ void accumulate(float (&acc)[HDM / 8][4],
                                           const float (&p)[2][4],
                                           const bf16* Vs, float*, int warp,
                                           int lane, int hd) {
  using namespace flash;
  constexpr int LDS = HDM + 8;
  const unsigned a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
  for (int dp = 0; dp < HDM / 16; ++dp) {
    if (dp * 16 >= hd) continue;
    unsigned bb[4];
    ldsm_x4_trans(bb, Vs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                          dp * 16 + (lane >> 4) * 8);
    mma_bf16(acc[2 * dp], a, bb[0], bb[1]);
    mma_bf16(acc[2 * dp + 1], a, bb[2], bb[3]);
  }
}

template <int HDM>
__device__ __forceinline__ void accumulate(float (&acc)[HDM / 8][4],
                                           const float (&p)[2][4],
                                           const float* Vs, float* Pw, int warp,
                                           int lane, int hd) {
  constexpr int LDS = HDM + 4;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Pw[(g + 8 * (e >> 1)) * LDP + 8 * j + 2 * t + (e & 1)] = p[j][e];
  __syncwarp();
  for (int key = 0; key < 16; ++key) {
    const float pa = Pw[g * LDP + key], pb = Pw[(g + 8) * LDP + key];
    const float* vr = Vs + (warp * 16 + key) * LDS + 2 * t;
#pragma unroll
    for (int j = 0; j < HDM / 8; ++j) {
      if (j * 8 >= hd) continue;
      const float2 x = *reinterpret_cast<const float2*>(vr + 8 * j);
      acc[j][0] = fmaf(pa, x.x, acc[j][0]);
      acc[j][1] = fmaf(pa, x.y, acc[j][1]);
      acc[j][2] = fmaf(pb, x.x, acc[j][2]);
      acc[j][3] = fmaf(pb, x.y, acc[j][3]);
    }
  }
  __syncwarp();  // every lane has read P before the next tile writes it
}

template <typename T, int HDM>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ kv_pos, float* __restrict__ part,
                    int Skv, int Hq, int Hkv, int hd, int n_splits,
                    int split_keys, int causal, int window, float logit_cap,
                    float scale) {
  using namespace flash;
  using L = Layout<T, HDM>;
  constexpr int LDS = L::LDS, VE = L::VE, VPR = L::VPR;
  constexpr int NO = HDM / 8;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* Qs = reinterpret_cast<T*>(base);
  float* Ps = reinterpret_cast<float*>(base + L::Q_BYTES);
  char* stages = base + L::Q_BYTES + L::P_BYTES;
  const int nst = L::stages(split_keys);  // stages in shared memory
  unsigned* live = reinterpret_cast<unsigned*>(stages + nst * L::STAGE_BYTES);
  unsigned* full = live + (split_keys / TILE + 31) / 32;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = Hq / Hkv, RB = (G + ROWS - 1) / ROWS;
  const int split = blockIdx.x, kvh = blockIdx.y / RB, rb = blockIdx.y % RB;
  const int b = blockIdx.z;
  const int nrow = min(ROWS, G - rb * ROWS);  // live rows of this CTA
  const int head0 = kvh * G + rb * ROWS;
  const int qp = q_pos[0];
  const int k0 = split * split_keys;
  const int k1 = max(k0, min(Skv, k0 + split_keys));

  // Q rows: heads head0 .. head0 + nrow - 1; zeros past them and past hd
  for (int i = tid; i < ROWS * VPR; i += NT) {
    const int r = i / VPR, c = i % VPR;
    const bool ok = r < nrow && c * VE < hd;
    const T* src = ok ? q + ((size_t)b * Hq + head0 + r) * hd + c * VE : q;
    cp_async16(Qs + r * LDS + c * VE, src, ok);
  }
  cp_async_commit();
  const int nt = (k1 - k0 + TILE - 1) / TILE;
  mark_live_tiles(live, full, kv_pos, k0, k1, TILE, qp, qp, causal, window,
                  tid, NT);

  auto issue = [&](int tile, int st) {
    T* ks = reinterpret_cast<T*>(stages + st * L::STAGE_BYTES);
    T* vs = ks + TILE * LDS;
    int* kp = reinterpret_cast<int*>(vs + TILE * LDS);
    const int n0 = k0 + tile * TILE;
    for (int i = tid; i < TILE * VPR; i += NT) {
      const int r = i / VPR, c = i % VPR, n = n0 + r;
      const bool ok = n < k1 && c * VE < hd;
      const size_t off = ok ? ((size_t)(b * Skv + n) * Hkv + kvh) * hd + c * VE : 0;
      cp_async16(ks + r * LDS + c * VE, k + off, ok);
      cp_async16(vs + r * LDS + c * VE, v + off, ok);
    }
    for (int r = tid; r < TILE; r += NT) {
      if (n0 + r < k1)
        cp_async4(kp + r, kv_pos + n0 + r);
      else
        kp[r] = -1;
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
    if (nst == 2 && nxt < nt) issue(nxt, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const T* ks = reinterpret_cast<const T*>(stages + st * L::STAGE_BYTES);
    const T* vs = ks + TILE * LDS;
    const int* kp = reinterpret_cast<const int*>(vs + TILE * LDS);

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    scores<HDM>(s, Qs, ks, Ps, warp, lane, hd);
    const bool whole = (full[tile >> 5] >> (tile & 31)) & 1u;  // no mask
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = logit2(s[j][e],
                         whole || key_ok(qp, kp[warp * 16 + 8 * j + 2 * t + (e & 1)],
                                         causal, window),
                         scale, logit_cap);
    softmax_update(s, m, l, acc);
    accumulate<HDM>(acc, s, vs, Ps + warp * ROWS * LDP, warp, lane, hd);
    __syncthreads();  // every warp is done with this stage before it refills
    tile = nxt;
    if (nst == 2) {
      st ^= 1;
    } else if (tile < nt) {  // one stage: refill it now
      issue(tile, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  finish_rowsum(l);

  // Merge the 4 warps' (m, l, acc) through the first stage's memory.
  float* red = reinterpret_cast<float*>(stages);  // [4][ROWS][HDM]
  float* ml = red + 4 * ROWS * HDM;               // [4][ROWS][2]
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      ml[(warp * ROWS + g + 8 * r) * 2] = m[r];
      ml[(warp * ROWS + g + 8 * r) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, ml[(w * ROWS + row) * 2]);
    const float f = (m[r] == -INFINITY) ? 0.f : exp2f(m[r] - M);
    float* dst = red + (warp * ROWS + row) * HDM;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = 8 * j + 2 * t;
      if (d < hd) flash::store2(dst + d, acc[j][2 * r] * f, acc[j][2 * r + 1] * f);
    }
  }
  __syncthreads();
  float* out = part + (((size_t)(b * Hkv + kvh) * n_splits + split) * G +
                       rb * ROWS) * (hd + 2);
  for (int i = tid; i < nrow * hd; i += NT) {
    const int row = i / hd, d = i % hd;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) sum += red[(w * ROWS + row) * HDM + d];
    out[row * (hd + 2) + d] = sum;
  }
  for (int row = tid; row < nrow; row += NT) {
    float M = -INFINITY, Lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, ml[(w * ROWS + row) * 2]);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = ml[(w * ROWS + row) * 2];
      if (mw != -INFINITY) Lsum += exp2f(mw - M) * ml[(w * ROWS + row) * 2 + 1];
    }
    out[row * (hd + 2) + hd] = M;
    out[row * (hd + 2) + hd + 1] = Lsum;
  }
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Block-wide reduction of x (sum, or max when take_max) over blockDim.x
// threads, a multiple of 32; every thread gets the result.
__device__ __forceinline__ float block_reduce(float x, bool take_max,
                                              float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = take_max ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // scratch is free (an earlier call has been read)
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  x = scratch[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
    x = take_max ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

// One CTA per (head, slot): the splits' weights 2^(m_s - M) once, into
// shared memory, then each thread sums its columns of acc over the splits.
template <typename T>
__global__ void flash_decode_combine_kernel(const float* __restrict__ part,
                                            T* __restrict__ o, int Hq, int Hkv,
                                            int hd, int n_splits) {
  extern __shared__ float wts[];  // [n_splits]
  __shared__ float scratch[32];
  const int head = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = Hq / Hkv, kvh = head / G, row = head % G;
  const size_t stride = (size_t)G * (hd + 2);  // from one split to the next
  const float* p = part + ((size_t)(b * Hkv + kvh) * n_splits * G + row) * (hd + 2);
  float M = -INFINITY;
  for (int s = tid; s < n_splits; s += blockDim.x) M = fmaxf(M, p[s * stride + hd]);
  M = block_reduce(M, true, scratch);
  float den = 0.f;
  for (int s = tid; s < n_splits; s += blockDim.x) {
    const float ms = p[s * stride + hd];
    // a split that saw no valid key (m = -inf, acc = 0) weighs 0
    const float w = (ms == -INFINITY) ? 0.f : exp2f(ms - M);
    wts[s] = w;
    den = fmaf(w, p[s * stride + hd + 1], den);
  }
  den = block_reduce(den, false, scratch);  // its barriers publish wts
  const float inv = den > 0.f ? 1.f / den : 0.f;  // no valid key anywhere: 0
  T* out = o + ((size_t)b * Hq + head) * hd;
  for (int d = tid; d < hd; d += blockDim.x) {
    float num = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s) num = fmaf(wts[s], p[s * stride + d], num);
    store_out(out + d, num * inv);
  }
}

template <typename T, int HDM>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, float* part, void* o,
                   int B, int Skv, int Hq, int Hkv, int hd, int causal,
                   int window, float logit_cap, float scale, int n_splits,
                   int split_keys, cudaStream_t stream) {
  using L = Layout<T, HDM>;
  const int nst = L::stages(split_keys);
  const size_t smem = L::Q_BYTES + L::P_BYTES + nst * L::STAGE_BYTES +
                      (size_t)((split_keys / TILE + 31) / 32) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel<T, HDM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  dim3 grid(n_splits, Hkv * ((G + ROWS - 1) / ROWS), B);
  flash_decode_kernel<T, HDM><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, kv_pos, part, Skv, Hq, Hkv, hd,
      n_splits, split_keys, causal, window, logit_cap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = hd > 224 ? 256 : (hd + 31) / 32 * 32;
  flash_decode_combine_kernel<T>
      <<<dim3(Hq, B), threads, n_splits * sizeof(float), stream>>>(
          part, static_cast<T*>(o), Hq, Hkv, hd, n_splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos, float* part,
                        void* o, int B, int Skv, int Hq, int Hkv, int hd,
                        int causal, int window, float logit_cap, float scale,
                        int n_splits, int split_keys, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, q_pos, kv_pos, part, o, B, Skv, Hq, Hkv, hd,
                         causal, window, logit_cap, scale, n_splits,
                         split_keys, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, q_pos, kv_pos, part, o, B, Skv, Hq, Hkv, hd,
                         causal, window, logit_cap, scale, n_splits,
                         split_keys, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, q_pos, kv_pos, part, o, B, Skv, Hq, Hkv,
                          hd, causal, window, logit_cap, scale, n_splits,
                          split_keys, stream);
  return launch<T, 256>(q, k, v, q_pos, kv_pos, part, o, B, Skv, Hq, Hkv, hd,
                        causal, window, logit_cap, scale, n_splits, split_keys,
                        stream);
}

}  // namespace

extern "C" {

// q [B,1,Hq,hd], k/v [B,Skv,Hkv,hd], out [B,1,Hq,hd]; part: fp32 scratch of
// B*Hkv*n_splits*(Hq/Hkv)*(hd+2) floats. dtype: 0 = fp32, 1 = bf16. window
// <= 0: none. logit_cap <= 0: none. Split s takes keys [s*split_keys,
// (s+1)*split_keys); split_keys is a positive multiple of 64. Launches both
// passes on `stream`; returns the cudaError_t of the launches (0 on
// success). The caller has checked shapes, contiguity, hd % 8 == 0,
// hd <= 256 and Hq % Hkv == 0.
int flash_decode(const void* q, const void* k, const void* v,
                 const int* q_pos, const int* kv_pos, float* part, void* o,
                 int B, int Skv, int Hq, int Hkv, int hd, int dtype,
                 int causal, int window, int n_splits, int split_keys,
                 float logit_cap, float scale, void* stream) {
  if (n_splits < 1 || split_keys < TILE || split_keys % TILE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, q_pos, kv_pos, part, o, B, Skv,
                                   Hq, Hkv, hd, causal, window, logit_cap,
                                   scale, n_splits, split_keys, st);
  if (dtype == 1)
    return (int)dispatch_hd<bf16>(q, k, v, q_pos, kv_pos, part, o, B, Skv, Hq,
                                  Hkv, hd, causal, window, logit_cap, scale,
                                  n_splits, split_keys, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
