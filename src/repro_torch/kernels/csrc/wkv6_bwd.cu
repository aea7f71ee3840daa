// RWKV-6 WKV backward (K3b) for Hopper (sm_90a): the gradients of the WKV
// scan of wkv6_scan.cu / wkv6_chunk.cu (K3).
//
// The reference writes no kernel for it: its gradient is jax.grad through
// src/repro/kernels/ref.py::rwkv6_scan_ref's lax.scan (the Pallas forward,
// src/repro/kernels/rwkv6_kernel.py::_wkv_kernel, has no backward). Per
// (batch b, head h), with the k-major state S [hd_k, hd_v] of the forward
// and G = dL/dS_t from dS_T, each step t, last to first, with S = S_{t-1}:
//
//   dr_i = sum_j S_ij dy_j + u_i k_i (v . dy)
//   dk_i = r_i u_i (v . dy) + sum_j G_ij v_j
//   dv_j = (sum_i r_i u_i k_i) dy_j + sum_i G_ij k_i
//   du_i += r_i k_i (v . dy);   dw_i = sum_j G_ij S_ij
//   G <- diag(w) G + r dy^T
//
// and ds0 is the last G.
//
// Layout: r, k, v [B,T,H,hd] in one type, fp32 or bf16, and dr, dk, dv in
// it; w and dw [B,T,H,hd] fp32; u [H,hd] fp32 or bf16 and du in it; dy
// [B,T,H,hd] fp32; state, dS_T and ds0 [B,H,hd,hd] fp32; scratch: starts
// and ends [B,H,ceil(T/64),64,64] fp32, decay [B,H,ceil(T/64),64] fp32,
// du_part [B,H,ceil(T/64),hd] fp32; all contiguous; hd at most 64.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32): 14 fp32 operations per
// state element per step (3 for the state S_{t-1} itself, 3 for G's update,
// 2 each for the sums of dr, dk, dv and dw), 14 hd^2 per element of r,
// against 24 bytes per element moved in bf16 (r, k, v, w, dy read; dr, dk,
// dv, dw written): the operations. At rwkv6-3b's training shape (B=4,
// T=2048, H=40, hd=64) that is 18.8 GFLOP, 0.28 ms.
//
// Design: the chunked matrix form of K3 (wkv6_chunk.cu), on its chunks of
// L = 64 steps and sub-chunks of 16, with its 3xTF32 mma.sync and its
// decays (exp of sums of lw = max(log w, -88) over runs, never a
// difference of prefix sums). S_c is the state before chunk c's first step,
// G_{c+1} the cotangent of the state after its last. Six launches:
//
//   1. states (wkv_summary_kernel, wkv_carry_kernel: K3's passes 1-2):
//      S_c of every chunk into `starts` and D_c into `decay`, a 64x64x64
//      product per (b, h, chunk), then one thread per state element;
//   2. cotangents (wkv_bwd_cot_kernel, wkv_bwd_carry_kernel): ΔG_c =
//      Σ_{t in c} (r_t ⊙ Π_{c0<=m<t} w_m) dy_tᵀ, pass 1 with (r, dy, decays
//      from the chunk's start), then G_c = diag(D_c) G_{c+1} + ΔG_c from
//      dS_T, last chunk first: each G_{c+1} into `ends`, ds0 = G_0;
//   3. the walk (wkv_bwd_walk_kernel): one CTA per (b, h, chunk), every
//      chunk at once (5,120 CTAs at the training shape where one CTA per
//      (b, h) walked all 2048 steps before), dr, dk, dw and dv; below;
//   4. du (wkv_bwd_du_kernel): each (b, h, chunk)'s row sums of
//      r_t k_t (v_t . dy_t), summed over b and the chunks in order.
//
// dv in the walk. Its matrix form, dv = Aᵀ dY + K̂ G_{c+1} (A K3's
// intra-chunk weights as its pass 3 builds them, K̂[t] = k_t ⊙ Π_{t<m<=end}
// w_m), took a launch of its own, pass 3's structure at two CTAs an SM; the
// column sums G_tᵀ k_t in the walk cost less (PERF.md), so the walk keeps
// them, and the matrix form is a lever for later.
//
// No atomics and no order that depends on timing: reruns give the same
// bits. The chunk states and cotangents regroup the sequential sums (3xTF32
// products, a few ulps from the plain version's states), so K3b agrees
// with ref.rwkv6_scan_bwd_plain to rounding, within the 2e-4 limit, not bit
// for bit; ref.rwkv6_scan_bwd_chunked_plain mirrors the scheme.
//
// The walk. The rows i of S and G are independent: only the outputs sum across
// them. CTA of 256 threads: warp (slice cs, block rb of 32 rows), lane row i;
// the thread keeps S[i, 16 cs .. 16 cs + 15] and G's same entries in
// registers. It walks S forward from S_c over the chunk's first three
// sub-chunks and keeps each sub-chunk's start state in shared memory; then it
// takes the sub-chunks last to first from G_{c+1}, and in each the groups of
// U = 4 steps last to first: it steps the sub-chunk's start state forward to the
// group's start, then the group's 4 states into registers, and runs their 4
// reverse steps (dr, dk, dw as partial row sums over its 16 columns, du's
// term, dv's column sums over the warp's 32 rows by a reduce-scatter of 16
// shuffles, G <- w G + r dy). dw is the row sum of G ⊙ S: w is never divided
// by (the model's w = exp(-exp(.)) reaches 0). That is about 3 state steps
// recomputed per reverse step (0.75 for the sub-chunk starts, 2.25 within the
// groups). A sub-chunk's r, k, w, v, dy are staged as fp32; a warp reads one
// slice of v and dy (a broadcast) and its 32 rows' r, k, w (consecutive
// words), so the shared-memory reads of a step are few wavefronts (a row's 4
// slices in one warp, with shuffled row sums, was slower: 16-byte reads of 4
// distinct slices a step). The partial sums of a group (and dv's by row block)
// go to shared memory, and after a barrier one thread per (step, row or
// column) adds the 4 slices (the 2 row blocks and the u-term) in order and
// writes dr, dk, dw, dv over the step's r, k, w, v, which no earlier step
// reads; the sub-chunk's are written out together, consecutive threads on
// consecutive entries. v . dy and r . (u k) of every step are summed by one
// warp each at staging. 98 KB of shared memory (64 KB of it the start states)
// and at most 128 registers: two CTAs an SM.
//
// Work at the training shape, per (b, h, chunk): passes 1 and 2 each a
// 64x64x64 product (three TF32 products each) and a carry; the walk about 13
// fp32 operations per state element and step (4 recomputing S, 2 updating G, 3
// row sums, 2 for dv's column sums, 2 of index and decay work), 84 M
// thread-steps of about 250 instructions: near 0.7 ms at full issue on 132
// SMs. Each pass's time is in PERF.md (chip_smoke.py times them).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wkv6_chunk.cuh"

namespace {

constexpr int HD = 64;            // largest head dim; smaller ones are padded
constexpr int L = 64;             // steps per chunk (wkv6_chunk.cu's)
constexpr int SUB = 16;           // steps per sub-chunk (wkv6_chunk.cu's)
constexpr int NSUB = L / SUB;
constexpr int U = 4;              // steps per group (states in registers)
constexpr int CS = 4;             // column slices per row
constexpr int CPT = HD / CS;      // columns a thread holds
constexpr int NT = HD * CS;       // threads per CTA
constexpr int NW = NT / 32;       // warps per CTA
constexpr int RB = HD / 32;       // blocks of 32 rows (a warp's lanes)
// the sub-chunks' start states: [NSUB][CPT / 4][NT] float4, each thread's
// own entries, consecutive threads on consecutive 16 bytes
constexpr int WALK_SMEM = NSUB * CPT * NT * sizeof(float);
static_assert(SUB % U == 0 && SUB % NW == 0 && U * HD == NT,
              "whole groups, whole warps, a thread per (step, row)");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// S <- w S + k v for this thread's 16 entries of row i (v: its slice)
__device__ __forceinline__ void state_step(float (&S)[CPT], float kk, float ww,
                                           const float* vrow) {
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q) {
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * q);
    S[4 * q] = fmaf(ww, S[4 * q], kk * v4.x);
    S[4 * q + 1] = fmaf(ww, S[4 * q + 1], kk * v4.y);
    S[4 * q + 2] = fmaf(ww, S[4 * q + 2], kk * v4.z);
    S[4 * q + 3] = fmaf(ww, S[4 * q + 3], kk * v4.w);
  }
}

__device__ __forceinline__ void save(float4* ck, const float (&S)[CPT]) {
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q)
    ck[q * NT + threadIdx.x] =
        make_float4(S[4 * q], S[4 * q + 1], S[4 * q + 2], S[4 * q + 3]);
}

__device__ __forceinline__ void restore(float (&S)[CPT], const float4* ck) {
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q) {
    const float4 s4 = ck[q * NT + threadIdx.x];
    S[4 * q] = s4.x, S[4 * q + 1] = s4.y, S[4 * q + 2] = s4.z,
    S[4 * q + 3] = s4.w;
  }
}

// this thread's 16 entries of row i of a padded [64][64] matrix
__device__ __forceinline__ void load_row(float (&S)[CPT], const float* m,
                                         int i, int cs) {
  const float4* p = reinterpret_cast<const float4*>(m + i * HD + cs * CPT);
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q) {
    const float4 s4 = p[q];
    S[4 * q] = s4.x, S[4 * q + 1] = s4.y, S[4 * q + 2] = s4.z,
    S[4 * q + 3] = s4.w;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
wkv_bwd_walk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const void* __restrict__ u, int u_bf16,
                    const float* __restrict__ dy,
                    const float* __restrict__ starts,
                    const float* __restrict__ ends, T* __restrict__ dr,
                    T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ dw, float* __restrict__ du_part,
                    int T_, int H, int hd) {
  extern __shared__ __align__(16) float4 ck[];  // [NSUB][CPT / 4][NT]
  __shared__ float rs[SUB][HD], ks[SUB][HD], ws[SUB][HD];
  __shared__ __align__(16) float vs[SUB][HD];
  __shared__ __align__(16) float dys[SUB][HD];
  __shared__ float vdy[SUB], ruk[SUB], us[HD];
  __shared__ float part[U][3][CS][HD];  // a group's row sums by slice
  __shared__ float dvp[U][RB][HD];      // its column sums by row block

  // warp (slice cs, block rb of 32 rows), lane: row i
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cs = warp / RB, rb = warp % RB, i = rb * 32 + lane;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int t0 = c * L;
  const int n = min(L, T_ - t0);             // the chunk's steps inside T
  const int nsub = (n + SUB - 1) / SUB;
  const size_t cidx = ((size_t)b * H + h) * n_chunks + c;

  if (tid < HD) {
    const size_t ui = (size_t)h * hd + tid;
    us[tid] = tid >= hd ? 0.f
              : u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[ui])
                       : static_cast<const float*>(u)[ui];
  }
  // sub-chunk j's steps into shared memory as fp32 (past T: r, k, v, dy 0
  // and w 1); with_r_dy: r and dy too
  auto stage = [&](int j, bool with_r_dy) {
#pragma unroll
    for (int it = 0; it < SUB * HD / NT; ++it) {
      const int e = tid + it * NT;
      const int t = e / HD, kk = e % HD;
      const int tt = t0 + j * SUB + t;
      const bool ok = kk < hd && tt < T_;
      const size_t gi = (((size_t)b * T_ + tt) * H + h) * hd + kk;
      ks[t][kk] = ok ? to_f(k[gi]) : 0.f;
      ws[t][kk] = ok ? w[gi] : 1.f;
      vs[t][kk] = ok ? to_f(v[gi]) : 0.f;
      if (with_r_dy) {
        rs[t][kk] = ok ? to_f(r[gi]) : 0.f;
        dys[t][kk] = ok ? dy[gi] : 0.f;
      }
    }
  };

  // forward: the start state of every sub-chunk
  float S[CPT];
  load_row(S, starts + cidx * HD * HD, i, cs);
  save(ck, S);
  for (int j = 0; j + 1 < nsub; ++j) {
    __syncthreads();  // the previous sub-chunk is read
    stage(j, false);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < SUB; ++t)
      state_step(S, ks[t][i], ws[t][i], &vs[t][cs * CPT]);
    save(ck + (j + 1) * (CPT / 4) * NT, S);
  }

  // reverse: the sub-chunks last to first, from G_{c+1}
  float G[CPT];
  load_row(G, ends + cidx * HD * HD, i, cs);
  float du_acc = 0.f;
  for (int j = nsub - 1; j >= 0; --j) {
    const int nj = min(SUB, n - j * SUB);    // the sub-chunk's steps inside T
    __syncthreads();  // the previous sub-chunk is read
    stage(j, true);
    __syncthreads();
    // v . dy and r . (u k) of every step of the sub-chunk, one warp a step
    for (int t = warp; t < SUB; t += NW) {
      float a = 0.f, z = 0.f;
#pragma unroll
      for (int m = 0; m < HD / 32; ++m) {
        const int kk = lane + 32 * m;
        a = fmaf(vs[t][kk], dys[t][kk], a);
        z = fmaf(rs[t][kk] * us[kk], ks[t][kk], z);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        z += __shfl_xor_sync(0xffffffffu, z, o);
      }
      if (lane == 0) vdy[t] = a, ruk[t] = z;
    }
    __syncthreads();

    const float4* start = ck + j * (CPT / 4) * NT;
    for (int q = (nj + U - 1) / U - 1; q >= 0; --q) {
      float Sq[U][CPT];
      restore(Sq[0], start);
      for (int t = 0; t < q * U; ++t)
        state_step(Sq[0], ks[t][i], ws[t][i], &vs[t][cs * CPT]);
#pragma unroll
      for (int p = 1; p < U; ++p) {
        const int t = q * U + p - 1;
#pragma unroll
        for (int e = 0; e < CPT; ++e) Sq[p][e] = Sq[p - 1][e];
        state_step(Sq[p], ks[t][i], ws[t][i], &vs[t][cs * CPT]);
      }
#pragma unroll
      for (int p = U - 1; p >= 0; --p) {
        const int t = q * U + p;
        if (t >= nj) continue;   // the same for every thread
        const float ri = rs[t][i], ki = ks[t][i], wi = ws[t][i];
        const float vd = vdy[t];
        const float* vrow = &vs[t][cs * CPT];
        const float* drow = &dys[t][cs * CPT];
        float p_dr = 0.f, p_dk = 0.f, p_dw = 0.f, pv[CPT];
#pragma unroll
        for (int q4 = 0; q4 < CPT / 4; ++q4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * q4);
          const float4 d4 = *reinterpret_cast<const float4*>(drow + 4 * q4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jj = 4 * q4 + e;
            p_dr = fmaf(Sq[p][jj], dd[e], p_dr);
            p_dk = fmaf(G[jj], vv[e], p_dk);
            p_dw = fmaf(G[jj], Sq[p][jj], p_dw);
            pv[jj] = G[jj] * ki;
            G[jj] = fmaf(wi, G[jj], ri * dd[e]);
          }
        }
        part[p][0][cs][i] = p_dr;
        part[p][1][cs][i] = p_dk;
        part[p][2][cs][i] = p_dw;
        du_acc = fmaf(ri * ki, vd, du_acc);
        // dv's column sums G ᵀ k over the warp's 32 rows: a reduce-scatter
        // of the slice's 16 columns, each lane pair ends with one column
        const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
        float r1[8], r2[4], r3[2];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          r1[e] = (b4 ? pv[e + 8] : pv[e]) +
                  __shfl_xor_sync(0xffffffffu, b4 ? pv[e] : pv[e + 8], 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          r2[e] = (b3 ? r1[e + 4] : r1[e]) +
                  __shfl_xor_sync(0xffffffffu, b3 ? r1[e] : r1[e + 4], 8);
#pragma unroll
        for (int e = 0; e < 2; ++e)
          r3[e] = (b2 ? r2[e + 2] : r2[e]) +
                  __shfl_xor_sync(0xffffffffu, b2 ? r2[e] : r2[e + 2], 4);
        float r4 = (b1 ? r3[1] : r3[0]) +
                   __shfl_xor_sync(0xffffffffu, b1 ? r3[0] : r3[1], 2);
        r4 += __shfl_xor_sync(0xffffffffu, r4, 1);
        if (!(lane & 1))
          dvp[p][rb][cs * CPT + 8 * b4 + 4 * b3 + 2 * b2 + b1] = r4;
        __syncwarp();  // one step's loads at a time: no spill
      }
      __syncthreads();
      {  // the group's sums over the 4 slices, in order, one thread per
         // (step, row); step t's r, k, w are read and no earlier step reads
         // them: they take its dr, dk, dw
        const int p = tid / HD, ii = tid % HD, t = q * U + p;
        if (t < nj) {
          const float ri = rs[t][ii], ki = ks[t][ii], ui = us[ii];
          const float vd = vdy[t];
          float sum[3];
#pragma unroll
          for (int m = 0; m < 3; ++m)
            sum[m] = ((part[p][m][0][ii] + part[p][m][1][ii]) +
                      part[p][m][2][ii]) + part[p][m][3][ii];
          rs[t][ii] = sum[0] + ui * ki * vd;
          ks[t][ii] = sum[1] + ri * ui * vd;
          ws[t][ii] = sum[2];
          // v_t is read too (no earlier step reads it): it takes dv
          vs[t][ii] = (dvp[p][0][ii] + dvp[p][1][ii]) + ruk[t] * dys[t][ii];
        }
      }
      __syncthreads();  // part is read before the next group writes it
    }
#pragma unroll
    for (int it = 0; it < SUB * HD / NT; ++it) {  // the sub-chunk's dr, dk, dw
      const int e = tid + it * NT;
      const int t = e / HD, kk = e % HD;
      if (kk < hd && t < nj) {
        const size_t gi =
            (((size_t)b * T_ + t0 + j * SUB + t) * H + h) * hd + kk;
        store(dr + gi, rs[t][kk]);
        store(dk + gi, ks[t][kk]);
        store(dv + gi, vs[t][kk]);
        dw[gi] = ws[t][kk];
      }
    }
  }
  if (cs == 0 && i < hd) du_part[cidx * hd + i] = du_acc;
}

// du[n] = sum over b and the chunks of du_part[b, h, c, i], n = h * hd + i,
// b outer, the chunks inner, in order
__global__ void wkv_bwd_du_kernel(const float* __restrict__ part,
                                  void* __restrict__ du, int u_bf16, int B,
                                  int H, int hd, int n_chunks) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= H * hd) return;
  const int h = n / hd, i = n % hd;
  float total = 0.f;
  for (int b = 0; b < B; ++b) {
    const float* p = part + (((size_t)b * H + h) * n_chunks) * hd + i;
    for (int c = 0; c < n_chunks; ++c) total += p[(size_t)c * hd];
  }
  if (u_bf16)
    static_cast<__nv_bfloat16*>(du)[n] = __float2bfloat16(total);
  else
    static_cast<float*>(du)[n] = total;
}

template <typename T>
cudaError_t launch_walk(const void* r, const void* k, const void* v,
                        const float* w, const void* u, int u_bf16,
                        const float* dy, const float* starts,
                        const float* ends, void* dr, void* dk, void* dv,
                        float* dw, float* du_part, int B, int T_, int H,
                        int hd, cudaStream_t stream) {
  const int n_chunks = (T_ + L - 1) / L;
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_walk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WALK_SMEM);
  if (err != cudaSuccess) return err;
  wkv_bwd_walk_kernel<T><<<dim3(n_chunks, H, B), NT, WALK_SMEM, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, u_bf16, dy, starts, ends,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw,
      du_part, T_, H, hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// L and SUB, which the caller needs to size the scratch; returns 0.
int wkv6_scan_bwd_steps(int* chunk, int* sub) {
  *chunk = L;
  *sub = SUB;
  return 0;
}

// dtype (r, k, v and dr, dk, dv), u_dtype (u and du): 0 = fp32, 1 = bf16;
// w, dw, dy, the states and the scratch are fp32. starts and ends hold
// [B, H, ceil(T / 64), 64, 64] floats, decay [B, H, ceil(T / 64), 64],
// du_part [B, H, ceil(T / 64), hd]. vec: hd is a multiple of 8 and r, k, v,
// w, dy are 16-byte aligned. Six launches: the chunk states (2), the
// chunk cotangents (2), the walk, du's sum. Returns the first
// cudaError_t of the launches (0 on success). The caller has checked
// shapes, types and contiguity, 1 <= hd <= 64, T >= 1 and B * H <= 65535.
int wkv6_scan_bwd(const void* r, const void* k, const void* v, const float* w,
                  const void* u, const float* state, const float* dy,
                  const float* ds_T, void* dr, void* dk, void* dv, float* dw,
                  void* du, float* ds0, float* starts, float* ends,
                  float* decay, float* du_part, int B, int T, int H, int hd,
                  int dtype, int u_dtype, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > HD || (u_dtype != 0 && u_dtype != 1) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const bool vc = vec != 0;
  cudaError_t err = wkv6_chunk::states(k, v, w, state, nullptr, starts, decay,
                                       B, T, H, hd, dtype, vc, st);
  if (err != cudaSuccess) return (int)err;
  err = wkv6_chunk::cotangents(r, dy, w, ds_T, ds0, ends, decay, B, T, H, hd,
                               dtype, vc, st);
  if (err != cudaSuccess) return (int)err;
  err = dtype == 0
            ? launch_walk<float>(r, k, v, w, u, u_dtype, dy, starts, ends, dr,
                                 dk, dv, dw, du_part, B, T, H, hd, st)
            : launch_walk<__nv_bfloat16>(r, k, v, w, u, u_dtype, dy, starts,
                                         ends, dr, dk, dv, dw, du_part, B, T,
                                         H, hd, st);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (T + L - 1) / L;
  wkv_bwd_du_kernel<<<(H * hd + 255) / 256, 256, 0, st>>>(
      du_part, du, u_dtype, B, H, hd, n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
