// Pieces shared by the attention kernels, flash_fwd.cu (prefill),
// flash_decode.cu (one query position against the cache) and flash_bwd.cu
// (the backward): the bf16 tensor-core product m16n8k16, ldmatrix, 16-byte
// cp.async copies, the mask predicate, the set of tiles (of keys, or of
// query rows) a CTA can see, and the online-softmax update on m16n8
// accumulator fragments.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 g + t, g = lane / 4,
// t = lane % 4): A (16 x 16, row-major) a0 = A[g][2t..2t+1],
// a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; B (16 x 8,
// column-major) b0 = B[2t..2t+1][g], b1 = B[2t+8..][g]; C (16 x 8)
// c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]. A score fragment is
// therefore already the A operand of the next product, P V, once rounded to
// bf16: no trip through shared memory.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid (src is
// then not read, but must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a b on the tensor cores: bf16 inputs, fp32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, lo in the low half.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// May query position qp attend to key position kp (-1: empty slot)?
__device__ __forceinline__ bool key_ok(int qp, int kp, int causal,
                                       int window) {
  const int dpos = qp - kp;
  return kp >= 0 && (!causal || dpos >= 0) && (window <= 0 || dpos < window);
}

// s (q . k, fp32) -> the logit in log2 units, or -inf where masked.
__device__ __forceinline__ float logit2(float s, bool ok, float scale,
                                        float logit_cap) {
  float x = s * scale;
  if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
  return ok ? x * LOG2E : -INFINITY;
}

// Mark, in two bitmasks in shared memory, the tiles of `tile` elements among
// n: `live` where pred(i, see, all) sets `see` for some element of the tile,
// `full` where it sets `all` for every one. `tile` is a multiple of 32, so
// that the 32 elements a warp reads at once lie in one tile: one ballot and
// at most two shared atomics per warp and step. A ragged last tile is never
// full. Ends with __syncthreads.
template <typename Pred>
__device__ __forceinline__ void mark_tiles(unsigned* live, unsigned* full,
                                           int n, int tile, int tid,
                                           int nthreads, Pred pred) {
  const int nt = (n + tile - 1) / tile;
  for (int w = tid; w < (nt + 31) / 32; w += nthreads) {
    live[w] = 0u;
    full[w] = ~0u;
  }
  __syncthreads();
  if (tid == 0 && n % tile)
    atomicAnd(&full[(nt - 1) >> 5], ~(1u << ((nt - 1) & 31)));
  const int lane = tid & 31;
  for (int base = tid - lane; base < n; base += nthreads) {
    const int i = base + lane;
    bool see = false, all = false;  // past n: seen by none
    if (i < n) pred(i, see, all);
    const unsigned any_see = __ballot_sync(0xffffffffu, see);
    const unsigned all_see = __ballot_sync(0xffffffffu, all);
    const int t = base / tile;
    if (lane == 0 && any_see) atomicOr(&live[t >> 5], 1u << (t & 31));
    if (lane == 0 && all_see != 0xffffffffu)
      atomicAnd(&full[t >> 5], ~(1u << (t & 31)));
  }
  __syncthreads();
}

// The tiles of `tile` keys among keys [k0, k1) that some query position in
// [qmin, qmax] can see (`live`: a superset of what the rows need, so the
// mask is applied again per element) and those whose every key every one
// of them sees (`full`: no per-element mask needed).
__device__ __forceinline__ void mark_live_tiles(
    unsigned* live, unsigned* full, const int* __restrict__ kv_pos, int k0,
    int k1, int tile, int qmin, int qmax, int causal, int window, int tid,
    int nthreads) {
  mark_tiles(live, full, k1 - k0, tile, tid, nthreads,
             [&](int i, bool& see, bool& all) {
               const int kp = kv_pos[k0 + i];
               see = kp >= 0 && (!causal || kp <= qmax) &&
                     (window <= 0 || qmin - kp < window);
               all = kp >= 0 && (!causal || kp <= qmin) &&
                     (window <= 0 || qmax - kp < window);
             });
}

// The first live tile at or after t (nt when there is none).
__device__ __forceinline__ int next_live(const unsigned* live, int t, int nt) {
  while (t < nt) {
    const unsigned w = live[t >> 5] >> (t & 31);
    if (w) return min(t + __ffs(w) - 1, nt);
    t = (t | 31) + 1;
  }
  return nt;
}

// Online softmax over one tile of scores, for a warp's 16 rows in C-fragment
// layout: s[j] holds the logits (log2 units, -inf where masked) of rows g
// and g+8 at columns 8j + 2t, 8j + 2t + 1. m[r] is the running max of row
// g + 8r (quad-uniform), l[r] this lane's part of the running sum (summed
// over the quad at the end). acc is rescaled, and s becomes p = 2^(s - m).
// A row that has seen no valid key keeps m = -inf, l = 0 and acc = 0.
template <int NB, int NO>
__device__ __forceinline__ void softmax_update(float (&s)[NB][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&acc)[NO][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    const float base = (m_new == -INFINITY) ? 0.f : m_new;
    const float alpha = exp2f(m[r] - base);  // 0 while m[r] is -inf
    m[r] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      s[j][2 * r] = exp2f(s[j][2 * r] - base);
      s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - base);
      rs += s[j][2 * r] + s[j][2 * r + 1];
    }
    l[r] = l[r] * alpha + rs;
#pragma unroll
    for (int o = 0; o < NO; ++o) {
      acc[o][2 * r] *= alpha;
      acc[o][2 * r + 1] *= alpha;
    }
  }
}

// Sum this lane's part of l over the quad that shares its rows.
__device__ __forceinline__ void finish_rowsum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

}  // namespace flash
