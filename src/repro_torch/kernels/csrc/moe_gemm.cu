// Grouped SwiGLU experts of the MoE layer for Hopper (sm_90a): the routed
// rows only, grouped by expert, with each expert's row range read on the
// device.
//
// Replaces no TPU kernel. The reference runs its experts as einsums over an
// [E, C, D] capacity buffer and leaves them to XLA
// (src/repro/models/ffn.py), and the port's gradient path does the same with
// torch.bmm. At the serving cell's capacity factor 4.0 every expert has C = T
// rows, so those products run over E T rows of which K T are routed (4x the
// work at mixtral's 8 experts, top-2). A product over the routed rows alone
// needs each expert's row count; read on the host, that is a sync in every
// MoE layer. This kernel takes the counts on the device instead: ``ends``
// [E] is the inclusive prefix of the experts' kept rows in the compact
// buffer that models/ffn.py dispatches into (expert e owns rows
// [ends[e-1], ends[e])), and every CTA turns it into its own tile table.
//
// Two entry points, both launched on the caller's stream:
//   moe_gate_up: H[r] = silu(A[r] Wg[e]) * (A[r] Wu[e]) for the rows r of
//     expert e. Both products accumulate in fp32 in the same CTA over the
//     same A tiles, so A is read once; silu(g) * u is formed in fp32 and
//     rounded to bf16 once.
//   moe_down: O[r] = H[r] Wd[e].
// A, H, O: [R, *] row-major bf16; Wg, Wu [E, D, Fe] and Wd [E, Fe, D]
// row-major bf16, the model's leaves as they are.
//
// Bound. A prefill token computes 2 x 3 x D x Fe flops a routed row (1.21
// GFLOP at mixtral's widths for top-2) against the 2.4 GB of a layer's
// expert weights read once: at the serving cell's prompts (945-2381 tokens,
// 1890-4762 rows) that is 520-1300 flop a weight byte, above the card's 295,
// so a prefill is bound by operations. A decode step of 256 slots (512 rows)
// is 140 flop a byte, bound by the bytes of the expert weights (4.83 GB a
// mixtral layer, 1.44 ms at 3.35 TB/s).
//
// Design (the hopper-kernels guide's shape):
//   * Persistent CTAs, one per SM (196 KB of shared memory each), walk a
//     linear tile index over (expert, n-tile, m-tile) with the m-tile
//     innermost, so that the CTAs running at one time share an expert's
//     weight tile (read from HBM once, the others hit L2); the expert's A
//     rows stay in L2 across its n-tiles. The tile count is at most
//     (floor(R / BM) + E) x n-tiles, which the wrapper sizes the grid by
//     without reading anything on the host.
//   * TMA loads A row tiles [128 x 64] from the compact buffer and B tiles
//     [64 x 64] per 64-column chunk from the 3-d weight leaf (expert as the
//     third coordinate), both with the 128-byte swizzle that wgmma reads.
//     B is MN-major (columns contiguous), which wgmma takes transposed.
//     Rows and columns past the tensors are filled with zeros by the TMA.
//   * A ring of 4 stages with full/empty mbarriers; one producer thread (a
//     warpgroup of its own, registers given back with setmaxnreg) keeps the
//     ring full across tile boundaries, so a tile's epilogue overlaps the
//     next tile's loads.
//   * Two consumer warpgroups take 64 rows each of a 128-row tile and run
//     wgmma.mma_async m64nNk16 (gate-up: two n128 products, gate and up;
//     down: one n256), one wgmma group in flight while the next stage is
//     awaited.
//   * Rows past the expert's end (the tile's padding, or the next expert's
//     rows) are computed and masked at the store, straight from the
//     accumulators to device memory.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                  // rows of a tile: 2 warpgroups of 64
constexpr int BK = 64;                   // depth of a stage: a 128-byte row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;             // warpgroups running wgmma
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int MAX_E = 256;
constexpr int A_BYTES = BM * BK * 2;     // 16 KB
constexpr int CHUNK = 64;                // columns of one B box (128 bytes)
constexpr int CHUNK_BYTES = BK * CHUNK * 2;  // 8 KB
constexpr int SWIZZLE_ROWS_BYTES = 8 * 128;  // one 128-byte swizzle atom

template <bool GATED>
struct Tile {
  static constexpr int BN = GATED ? 128 : 256;  // columns of a tile
  static constexpr int NB = GATED ? 2 : 1;      // B operands: gate, up / down
  static constexpr int ACC = BN / 2;            // fp32 accumulators a thread
  static constexpr int ACC1 = GATED ? ACC : 1;  // the up product's, if any
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + NB * B_BYTES;  // 48 KB
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;    // + alignment
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  return ok != 0;
}

// Wait until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// D[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major), bf16 in, fp32 out
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
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
      " %64, %65, p, 1, 1, 0, 1;\n"
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

// D[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (MN-major), bf16 in, fp32 out
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <bool GATED>
__device__ __forceinline__ void mma_stage(float (&acc0)[Tile<GATED>::ACC],
                                          float (&acc1)[Tile<GATED>::ACC1],
                                          uint32_t a, uint32_t b, int first) {
  // A [64 x 64] K-major: 8-row groups 1024 bytes apart, a k16 step 32 bytes
  // along the swizzled row. B: 64-column chunks CHUNK_BYTES apart, 8-row
  // (k) groups 1024 bytes apart, a k16 step 16 rows.
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = smem_desc(a + kk * 32, 16, SWIZZLE_ROWS_BYTES);
    const uint64_t db = smem_desc(b + kk * 16 * 128, CHUNK_BYTES,
                                  SWIZZLE_ROWS_BYTES);
    const int scale = !(first && kk == 0);
    if constexpr (GATED) {
      const uint64_t du = smem_desc(b + Tile<GATED>::B_BYTES + kk * 16 * 128,
                                    CHUNK_BYTES, SWIZZLE_ROWS_BYTES);
      wgmma_n128(acc0, da, db, scale);
      wgmma_n128(acc1, da, du, scale);
    } else {
      wgmma_n256(acc0, da, db, scale);
    }
  }
}

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// grid: persistent CTAs; THREADS threads; Tile<GATED>::SMEM dynamic bytes.
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b0,
                const __grid_constant__ CUtensorMap tm_b1,
                const long long* __restrict__ ends, int E,
                bf16* __restrict__ out, int N, int K) {
  using T = Tile<GATED>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ int s_start[MAX_E + 1];  // expert e's rows: [s_start[e], s_start[e+1])
  __shared__ int s_tile[MAX_E + 1];   // its tiles: [s_tile[e], s_tile[e+1])

  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int k_iters = (K + BK - 1) / BK;

  if (tid < E) s_start[tid + 1] = static_cast<int>(ends[tid]);
  if (tid == 0) s_start[0] = 0;
  __syncthreads();
  if (tid == 0) {
    int acc = 0;
    for (int e = 0; e < E; ++e) {
      s_tile[e] = acc;
      acc += (s_start[e + 1] - s_start[e] + BM - 1) / BM * n_tiles;
    }
    s_tile[E] = acc;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMERS * 4);  // a warp each
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int total = s_tile[E];

  // tile t -> (expert, first row, first column, the expert's end row)
  auto locate = [&](int t, int& e, int& row0, int& col0, int& row_end) {
    int lo = 1, hi = E;  // the first i with s_tile[i] > t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_tile[mid] > t) hi = mid; else lo = mid + 1;
    }
    e = lo - 1;
    const int local = t - s_tile[e];
    const int m_tiles = (s_start[e + 1] - s_start[e] + BM - 1) / BM;
    const int n = local / m_tiles;
    row0 = s_start[e] + (local - n * m_tiles) * BM;
    col0 = n * T::BN;
    row_end = s_start[e + 1];
  };

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // the producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < total; t += gridDim.x) {
        int e, row0, col0, row_end;
        locate(t, e, row0, col0, row_end);
        for (int kb = 0; kb < k_iters; ++kb) {
          mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full_bar[stage]);
          mbar_expect_tx(bar, T::STAGE_BYTES);
          const uint32_t st = smem_u32(smem + stage * T::STAGE_BYTES);
          tma_2d(st, &tm_a, bar, kb * BK, row0);
#pragma unroll
          for (int j = 0; j < T::BN / CHUNK; ++j) {
            tma_3d(st + A_BYTES + j * CHUNK_BYTES, &tm_b0, bar,
                   col0 + j * CHUNK, kb * BK, e);
            if constexpr (GATED)
              tma_3d(st + A_BYTES + T::B_BYTES + j * CHUNK_BYTES, &tm_b1, bar,
                     col0 + j * CHUNK, kb * BK, e);
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0;
    float acc0[T::ACC];
    float acc1[T::ACC1];
    for (int t = blockIdx.x; t < total; t += gridDim.x) {
      int e, row0, col0, row_end;
      locate(t, e, row0, col0, row_end);
#pragma unroll
      for (int i = 0; i < T::ACC; ++i) acc0[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < T::ACC1; ++i) acc1[i] = 0.0f;
      int prev = -1;
      for (int kb = 0; kb < k_iters; ++kb) {
        mbar_wait(smem_u32(&full_bar[stage]), phase);
        const uint32_t st = smem_u32(smem + stage * T::STAGE_BYTES);
        wgmma_fence();
        mma_stage<GATED>(acc0, acc1, st + wg * (64 * 128), st + A_BYTES,
                         kb == 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (prev >= 0 && lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));

      // accumulator i of m64nNk16: row 16 warp + lane / 4 + 8 ((i / 2) % 2),
      // column 8 (i / 4) + 2 (lane % 4) + i % 2
      const int r0 = row0 + wg * 64 + warp * 16 + lane / 4;
      const int c0 = col0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < T::BN / 8; ++j) {
        const int c = c0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const int i = 4 * j + 2 * h;
          float v0, v1;
          if constexpr (GATED) {
            v0 = silu(acc0[i]) * acc1[i];
            v1 = silu(acc0[i + 1]) * acc1[i + 1];
          } else {
            v0 = acc0[i];
            v1 = acc0[i + 1];
          }
          if (r < row_end && c < N)
            *reinterpret_cast<__nv_bfloat162*>(
                out + static_cast<size_t>(r) * N + c) =
                __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, cols] row-major bf16 matrix in boxes of [box_rows, 64].
bool map_2d(CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An [E, rows, cols] row-major bf16 weight leaf in boxes of [1, 64, 64].
bool map_3d(CUtensorMap* map, const void* ptr, int E, int rows, int cols) {
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)CHUNK, (cuuint32_t)BK, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GATED>
cudaError_t launch(const void* a, const void* b0, const void* b1,
                   const long long* ends, void* out, int rows, int E, int K,
                   int N, int grid, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorNotSupported;
  CUtensorMap tm_a, tm_b0, tm_b1;
  if (!map_2d(&tm_a, a, rows, K, BM) || !map_3d(&tm_b0, b0, E, K, N) ||
      !map_3d(&tm_b1, b1, E, K, N))
    return cudaErrorInvalidValue;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_kernel<GATED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<GATED>::SMEM);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  moe_gemm_kernel<GATED><<<grid, THREADS, Tile<GATED>::SMEM, stream>>>(
      tm_a, tm_b0, tm_b1, ends, E, static_cast<bf16*>(out), N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns of a tile: the wrapper sizes its grid by them.
int moe_gemm_tiles(int* gate_up_bn, int* down_bn) {
  *gate_up_bn = Tile<true>::BN;
  *down_bn = Tile<false>::BN;
  return 0;
}

// a [rows, D], w_gate / w_up [E, D, Fe], h [rows, Fe], all bf16 row-major;
// ends: int64 [E], the inclusive prefix of each expert's rows in a (at most
// rows). Writes h's rows [0, ends[E-1]); leaves the others. D and Fe are
// multiples of 8 (the TMA's 16-byte strides), E <= 256, grid >= 1. Returns a
// cudaError_t (0 on success).
int moe_gate_up(const void* a, const void* w_gate, const void* w_up,
                const long long* ends, void* h, int rows, int E, int D, int Fe,
                int grid, void* stream) {
  if (E < 1 || E > MAX_E || D % 8 || Fe % 8 || grid < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch<true>(a, w_gate, w_up, ends, h, rows, E, D, Fe, grid,
                           static_cast<cudaStream_t>(stream));
}

// h [rows, Fe], w_down [E, Fe, D], out [rows, D]; as moe_gate_up.
int moe_down(const void* h, const void* w_down, const long long* ends,
             void* out, int rows, int E, int Fe, int D, int grid,
             void* stream) {
  if (E < 1 || E > MAX_E || D % 8 || Fe % 8 || grid < 1)
    return (int)cudaErrorInvalidValue;
  return (int)launch<false>(h, w_down, w_down, ends, out, rows, E, Fe, D, grid,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
