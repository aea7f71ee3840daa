// K1's prefill forward for bf16 at head dim 128 on Hopper's own units
// (sm_90a): TMA loads, an mbarrier ring and warpgroup wgmma.
//
// Replaces no TPU kernel beyond K1's: src/repro/kernels/flash_attention.py::
// _fwd_kernel, whose function flash_fwd.cu states (explicit int32 q_pos and
// kv_pos, kv_pos -1 an empty slot, causal, window, the fp32 LSE [B,Hkv,G,Sq]
// when asked for; a row with no valid key gives 0 and LSE -inf). It computes
// that function, without a logit cap, for every bf16 call at hd 128:
// kernels/flash_attention.py picks it from the call's dtype, head dim and
// cap, and sends every other call to flash_fwd.cu's bodies.
//
// Bound. The work is 4 hd flops per valid (query position, key) pair and
// query head; device memory sees Q and O once and K and V about once (the
// other CTAs of a kv head read its tiles again, mostly from L2), so the
// tensor cores bound it: at the served prompts (945-2381 tokens) and
// training's [4, 2048] the operations take 1.6-4x the bytes' time (989
// TFLOP/s against 3.35 TB/s). flash_fwd.cu's mma.sync body reached
// 6-10% of that bound: mma.sync runs at a fraction of the tensor-core rate
// on this card, and its softmax never overlaps a product. This body reaches
// 24-50% (PERF.md): what holds it there is a CTA's fixed chain of latencies
// (positions, Q, the first tiles, the stores: about 9 us, one CTA an SM)
// and a softmax that a warpgroup's own P V hides only in part.
//
// Design (FlashAttention-3's form: a producer warp on TMA, consumer
// warpgroups on wgmma):
//   * A CTA takes 128 rows, a row being (query position, one of the G heads
//     of a kv head), so that each K and V tile is read once for all G heads.
//     The grid is flat, the row blocks that see the most keys first over
//     every kv head and batch entry.
//   * One producer warp keeps TMA loads of 128-key K and V tiles (two boxes
//     of [128 keys x 64 dims] each, the 128-byte swizzle that wgmma reads)
//     in flight through a ring of 2 stages, K and V with barriers of their
//     own, so that a stage's K is refilled as soon as its scores are taken.
//     Beside a tile that needs the per-element mask it writes the tile's
//     key positions.
//   * Two consumer warpgroups take 64 rows each. Q is copied once, swizzled,
//     with cp.async, issued first. S = Q K^T is wgmma m64n128k16 with both
//     operands in shared memory; O += P V is wgmma with P from registers
//     (the score fragments, rounded to bf16, are already its A operand) and
//     V read MN-major. Within a warpgroup the next tile's Q K^T runs while
//     this tile's P V is issued, and the softmax of the next tile waits on
//     the scores only: the softmax overlaps a product. (Two warpgroups
//     taking turns at the tensor cores, a third stage and persistent CTAs
//     were each slower at the served shapes: PERF.md.)
//   * The online softmax runs on the accumulator fragments in fp32, in log2
//     units, as flash_fwd.cu's bf16 body does (the same rounding of P to
//     bf16 before P V, the same statistics; the scale and log2(e) folded
//     into the exponent's fma); a row's statistics live on the quad of
//     lanes that holds it.
//   * The tiles a CTA can see are marked from the positions it loads (no
//     host decision): tiles of empty slots, past the causal edge or outside
//     the window are skipped whole, and tiles that every row sees whole
//     skip the per-element mask.
//   * O is written from registers, normalised, in bf16; the LSE by one lane
//     of the quad.
// Registers: S 64, O 64 and P 32 a consumer thread (setmaxnreg 232; the
// producer gives its own back, down to 40). Shared memory: Q 32 KB and two
// stages of K and V, 64 KB each: one CTA an SM.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int HD = 128;                      // the head dim this body takes
constexpr int BM = 128;                      // rows of a CTA
constexpr int BN = 128;                      // keys of a tile
constexpr int STAGES = 2;
constexpr int CONSUMERS = 2;                 // warpgroups of 64 rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CHUNK = 64;                    // dims of one 128-byte row
constexpr int ROWS_BYTES = 128 * CHUNK * 2;  // [128 x 64] bf16: 16 KB
constexpr int TILE_BYTES = 2 * ROWS_BYTES;   // Q, a K or a V tile: 32 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K then V
constexpr int SMEM_FIXED = 1024 + TILE_BYTES + STAGES * STAGE_BYTES;
constexpr int ATOM = 8 * 128;                // one 128-byte swizzle atom

// Expect `bytes` more on the barrier's phase without arriving.
__device__ __forceinline__ void expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (mma.sync's A
// fragment a warp), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue or its wait.
template <int N>
__device__ __forceinline__ void own(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void own(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 8 key positions a thread, keys base + u THREADS + tid (-1 past the end).
constexpr int MARK_U = 8;
__device__ __forceinline__ void load_positions(int (&kp)[MARK_U],
                                               const int* __restrict__ kv_pos,
                                               int base, int Skv, int tid) {
#pragma unroll
  for (int u = 0; u < MARK_U; ++u) {
    const int i = base + u * THREADS + tid;
    kp[u] = i < Skv ? kv_pos[i] : -1;
  }
}

// Mark those keys' tiles in two bitmasks: `live` where some row of the CTA
// (query positions [qmin, qmax]) can see a key of the tile (the mask is then
// applied again per element), and clear `full` where some row misses some
// key (a tile left full needs no mask). flash_common.cuh's mark_tiles, with
// the loads of a batch in flight at once.
__device__ __forceinline__ void mark_positions(unsigned* live, unsigned* full,
                                               const int (&kp)[MARK_U],
                                               int base, int Skv, int qmin,
                                               int qmax, int causal, int window,
                                               int tid) {
  const int lane = tid & 31;
#pragma unroll
  for (int u = 0; u < MARK_U; ++u) {
    const int first = base + u * THREADS + tid - lane;  // warp-uniform
    if (first >= Skv) break;
    // the warp's 32 keys lie in one tile (BN and THREADS are multiples of 32)
    const bool in = first + lane < Skv;
    const bool see = in && kp[u] >= 0 && (!causal || kp[u] <= qmax) &&
                     (window <= 0 || qmin - kp[u] < window);
    const bool all = in && kp[u] >= 0 && (!causal || kp[u] <= qmin) &&
                     (window <= 0 || qmax - kp[u] < window);
    const unsigned any_see = __ballot_sync(0xffffffffu, see);
    const unsigned all_see = __ballot_sync(0xffffffffu, all);
    const int t = first / BN;
    if (lane == 0 && any_see) atomicOr(&live[t >> 5], 1u << (t & 31));
    if (lane == 0 && all_see != 0xffffffffu)
      atomicAnd(&full[t >> 5], ~(1u << (t & 31)));
  }
}

// grid: one CTA for each (row block, kv head, batch), the row blocks that
// see the most keys first (under a causal mask the last ones: a wave that
// ended on them would leave the card idle); THREADS threads; SMEM_FIXED +
// the two tile bitmasks of dynamic shared memory.
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const bf16* __restrict__ q, const int* __restrict__ q_pos,
                      const int* __restrict__ kv_pos, bf16* __restrict__ o,
                      float* __restrict__ lse, int B, int Sq, int Skv, int Hq,
                      int Hkv, int causal, int window, float scale) {
  using namespace flash;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_k[STAGES], full_v[STAGES];
  __shared__ __align__(8) uint64_t empty_k[STAGES], empty_v[STAGES];
  __shared__ int kpos[STAGES][BN];
  __shared__ int qrange[2];

  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_base = smem_u32(smem);
  const uint32_t kv_base = q_base + TILE_BYTES;  // stage s: K, then V
  const int nt = (Skv + BN - 1) / BN;
  unsigned* live = reinterpret_cast<unsigned*>(smem + TILE_BYTES +
                                               STAGES * STAGE_BYTES);
  unsigned* full = live + (nt + 31) / 32;

  const int tid = threadIdx.x;
  const int G = Hq / Hkv;
  const int nrows = Sq * G;
  const int blocks = (nrows + BM - 1) / BM;
  const int per_block = Hkv * B;
  const int kvh = blockIdx.x % per_block % Hkv;
  const int b = blockIdx.x % per_block / Hkv;
  const int row0 = (blocks - 1 - (int)blockIdx.x / per_block) * BM;

  // The positions' loads go out first, beside Q's copies below: the tiles
  // this CTA sees are marked from them.
  int my_qpos = 0, kp[MARK_U];
  if (tid < BM) my_qpos = q_pos[min(row0 + tid, nrows - 1) / G];
  load_positions(kp, kv_pos, 0, Skv, tid);

  const int wg = tid / 128;
  if (wg < CONSUMERS) {
    // Q: this warpgroup's 64 rows, both 64-dim halves, in the 128-byte
    // swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)); zeros past
    // the last row. Issued first, so that the copies overlap the set-up.
    for (int i = tid & 127; i < 64 * (HD / 8); i += 128) {
      const int r = wg * 64 + i / (HD / 8), c = i % (HD / 8);
      const int gr = row0 + r;
      const bool ok = gr < nrows;
      const bf16* src =
          ok ? q + ((size_t)(b * Sq + gr / G) * Hq + kvh * G + gr % G) * HD + c * 8
             : q;
      uint8_t* dst = smem + (c / 8) * ROWS_BYTES + r * 128 +
                     (((c % 8) ^ (r % 8)) << 4);
      cp_async16(dst, src, ok);
    }
    cp_async_commit();
  }
  for (int w = tid; w < (nt + 31) / 32; w += THREADS) {
    live[w] = 0u;
    // a ragged last tile is never full
    full[w] = (Skv % BN && w == (nt - 1) >> 5) ? ~(1u << ((nt - 1) & 31)) : ~0u;
  }
  if (tid == 0) {
    qrange[0] = INT_MAX;
    qrange[1] = INT_MIN;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_k[s]), 32);  // the producer warp's lanes
      mbar_init(smem_u32(&full_v[s]), 1);
      mbar_init(smem_u32(&empty_k[s]), CONSUMERS * 4);  // a warp each
      mbar_init(smem_u32(&empty_v[s]), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < BM) {
    atomicMin(&qrange[0], my_qpos);
    atomicMax(&qrange[1], my_qpos);
  }
  __syncthreads();
  for (int base = 0; base < Skv; base += MARK_U * THREADS) {
    if (base) load_positions(kp, kv_pos, base, Skv, tid);
    mark_positions(live, full, kp, base, Skv, qrange[0], qrange[1], causal,
                   window, tid);
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // the producer: one warp; its lanes write a tile's key positions, one
    // lane issues the TMA loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid < CONSUMERS * 128 + 32) {
      const int lane = tid & 31;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = next_live(live, 0, nt); t < nt;
           t = next_live(live, t + 1, nt)) {
        const int n0 = t * BN;
        const uint32_t dst = kv_base + stage * STAGE_BYTES;
        mbar_wait(smem_u32(&empty_k[stage]), phase ^ 1);
        const uint32_t kbar = smem_u32(&full_k[stage]);
        if (lane == 0) {  // the copy first: any positions load beside it
          expect_tx(kbar, TILE_BYTES);
          tma_4d(dst, &tm_k, kbar, 0, kvh, n0, b);
          tma_4d(dst + ROWS_BYTES, &tm_k, kbar, CHUNK, kvh, n0, b);
        }
        if (!((full[t >> 5] >> (t & 31)) & 1u))  // the mask will read them
          for (int i = lane; i < BN; i += 32)
            kpos[stage][i] = n0 + i < Skv ? kv_pos[n0 + i] : -1;
        mbar_arrive(kbar);
        mbar_wait(smem_u32(&empty_v[stage]), phase ^ 1);
        if (lane == 0) {
          const uint32_t vbar = smem_u32(&full_v[stage]);
          mbar_expect_tx(vbar, TILE_BYTES);
          tma_4d(dst + TILE_BYTES, &tm_v, vbar, 0, kvh, n0, b);
          tma_4d(dst + TILE_BYTES + ROWS_BYTES, &tm_v, vbar, CHUNK, kvh, n0, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int lt = tid & 127, warp = lt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int wrow = wg * 64 + warp * 16;  // the warp's first row in the CTA

    cp_async_wait<0>();  // this thread's part of Q
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");

    int qp[2];  // positions of rows g and g+8 (past the end: the last query's)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      qp[r] = q_pos[min(row0 + wrow + g + 8 * r, nrows - 1) / G];

    const uint32_t qa = q_base + wg * 64 * 128;
    // S = Q K^T over hd: 8 steps of 16, 4 in each 64-dim half
    auto scores = [&](float (&s)[64], int stage) {
      const uint32_t ka = kv_base + stage * STAGE_BYTES;
      own(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * ROWS_BYTES + (kk % 4) * 32;
        wgmma_ss(s, smem_desc(qa + off, 16, ATOM), smem_desc(ka + off, 16, ATOM),
                 kk > 0);
      }
      wgmma_commit();
    };
    // O += P V over the tile's keys: 8 steps of 16 keys (16 rows of V)
    auto values = [&](float (&acc)[64], uint32_t (&p)[32], int stage) {
      const uint32_t va = kv_base + stage * STAGE_BYTES + TILE_BYTES;
      own(acc);
      own(p);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs(acc, p[4 * kc], p[4 * kc + 1], p[4 * kc + 2], p[4 * kc + 3],
                 smem_desc(va + kc * 16 * 128, ROWS_BYTES, ATOM));
      wgmma_commit();
    };
    // scores -> p = 2^(s scale log2(e) - m), 0 where masked; m (log2 units)
    // and this lane's part of l updated, alpha the rescale of O
    const float scale2 = scale * LOG2E;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    auto softmax = [&](float (&s)[64], int tile, int stage, float (&alpha)[2]) {
      if (!((full[tile >> 5] >> (tile & 31)) & 1u)) {
        // some row misses some key of the tile: the per-element mask
        const int* kp = kpos[stage];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!key_ok(qp[e >> 1], kp[8 * j + 2 * t4 + (e & 1)], causal, window))
              s[4 * j + e] = -INFINITY;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx * scale2);
        const float base = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - base);  // 0 while m[r] is -inf
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          s[4 * j + 2 * r] = exp2f(fmaf(s[4 * j + 2 * r], scale2, -base));
          s[4 * j + 2 * r + 1] = exp2f(fmaf(s[4 * j + 2 * r + 1], scale2, -base));
          rs += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + rs;
      }
    };
    // p rounded to bf16, as the A fragments of P V: keys 16 kc .. 16 kc + 15
    auto pack = [&](uint32_t (&p)[32], const float (&s)[64]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      own(p);  // no read of these scores is left for after the next issue
    };
    auto release = [&](uint64_t* bar) {
      if (lane == 0) mbar_arrive(smem_u32(bar));
    };

    float acc[64], s[64];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = s[i] = 0.f;
    int stage = 0;
    uint32_t phase = 0;
    int tile = next_live(live, 0, nt);
    if (tile < nt) {
      float alpha[2];
      mbar_wait(smem_u32(&full_k[stage]), phase);
      scores(s, stage);
      wgmma_wait<0>();
      own(s);
      softmax(s, tile, stage, alpha);
      release(&empty_k[stage]);
      pack(p, s);
      // Every tile but the last: the next tile's scores run while this
      // tile's P V is issued, and the softmax waits on the scores only. The
      // loop has no branch between a wgmma and its wait.
      for (int nxt = next_live(live, tile + 1, nt); nxt < nt;
           nxt = next_live(live, nxt + 1, nt)) {
        const int cur = stage;
        const uint32_t cur_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        mbar_wait(smem_u32(&full_k[stage]), phase);
        mbar_wait(smem_u32(&full_v[cur]), cur_phase);
        scores(s, stage);
        values(acc, p, cur);
        wgmma_wait<1>();  // the scores are done; P V may not be
        own(s);
        softmax(s, nxt, stage, alpha);
        release(&empty_k[stage]);
        wgmma_wait<0>();
        own(acc);
        release(&empty_v[cur]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          acc[4 * j] *= alpha[0];
          acc[4 * j + 1] *= alpha[0];
          acc[4 * j + 2] *= alpha[1];
          acc[4 * j + 3] *= alpha[1];
        }
        own(acc);
        pack(p, s);
      }
      mbar_wait(smem_u32(&full_v[stage]), phase);
      values(acc, p, stage);
      wgmma_wait<0>();
      own(acc);
      release(&empty_v[stage]);
    }

    finish_rowsum(l);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gr = row0 + wrow + g + 8 * r;
      if (gr >= nrows) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;  // no valid key: 0
      bf16* orow = o + ((size_t)(b * Sq + gr / G) * Hq + kvh * G + gr % G) * HD;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store2(orow + 8 * j + 2 * t4, acc[4 * j + 2 * r] * inv,
               acc[4 * j + 2 * r + 1] * inv);
      // m is in log2 units and uniform over the quad, as l is after
      // finish_rowsum; -inf with no valid key
      if (lse != nullptr && t4 == 0)
        lse[((size_t)(b * Hkv + kvh) * G + gr % G) * Sq + gr / G] =
            m[r] * (1.f / LOG2E) + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

// k or v [B, Skv, Hkv, HD] bf16 in boxes of [1 position x 128 keys x 1 head
// x 64 dims]: a box is one 64-dim half of a K or V tile.
bool map_kv(CUtensorMap* map, const void* ptr, int B, int Skv, int Hkv) {
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)Hkv,
                              (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2, (cuuint64_t)Hkv * HD * 2,
                                 (cuuint64_t)Skv * Hkv * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CHUNK, 1, (cuuint32_t)BN, 1};
  return map_bf16(map, ptr, 4, dims, strides, box);
}

}  // namespace

extern "C" {

// q [B,Sq,Hq,128], k/v [B,Skv,Hkv,128], out [B,Sq,Hq,128] bf16; q_pos [Sq],
// kv_pos [Skv] int32; window <= 0: none; lse: nullptr or fp32 [B,Hkv,G,Sq].
// No logit cap. Returns the cudaError_t of the launch (0 on success). The
// caller has checked shapes, contiguity, 16-byte alignment, Hq % Hkv == 0.
int flash_fwd_sm90(const void* q, const void* k, const void* v,
                   const int* q_pos, const int* kv_pos, void* o, float* lse,
                   int B, int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                   int window, float scale, void* stream) {
  if (hd != HD || B < 1 || Sq < 1 || Skv < 1 || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_k, tm_v;
  if (!map_kv(&tm_k, k, B, Skv, Hkv) || !map_kv(&tm_v, v, B, Skv, Hkv))
    return (int)cudaErrorInvalidValue;
  const int nt = (Skv + BN - 1) / BN;
  const int smem = SMEM_FIXED + 2 * ((nt + 31) / 32) * (int)sizeof(unsigned);
  static int sized = 0;  // the largest dynamic shared memory set so far
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  const long long grid = (long long)((Sq * (Hq / Hkv) + BM - 1) / BM) * Hkv * B;
  if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_fwd_sm90_kernel<<<(unsigned)grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), q_pos, kv_pos,
      static_cast<bf16*>(o), lse, B, Sq, Skv, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
