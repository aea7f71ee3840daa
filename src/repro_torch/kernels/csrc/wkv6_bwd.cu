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
// [B,T,H,hd] fp32; state, dS_T and ds0 [B,H,hd,hd] fp32; scratch: ckpt
// [B,H,ceil(T/L),hd,hd] fp32 and du_part [B,H,hd] fp32; all contiguous; hd
// at most 64.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32): 14 fp32 operations per
// state element per step (3 for the state S_{t-1} itself, 3 for G's update,
// 2 each for the sums of dr, dk, dv and dw), 14 hd^2 per element of r,
// against 24 bytes per element moved in bf16 (r, k, v, w, dy read; dr, dk,
// dv, dw written): the operations. At rwkv6-3b's training shape (B=4,
// T=2048, H=40, hd=64) that is 18.8 GFLOP, 0.28 ms.
//
// Recovering S_{t-1} from S_t by dividing by w_t is not an option: w =
// exp(-exp(.)) reaches 0 in fp32. So the states are recomputed:
//   - wkv_bwd_ckpt_kernel walks forward once and stores S at the start of
//     every chunk of L steps (ckpt), state updates only;
//   - wkv_bwd_kernel walks the chunks last to first. Within a chunk it takes
//     its sub-chunks of U steps last to first: it steps the sub-chunk's start
//     state forward from the chunk's checkpoint, then the U states of the
//     sub-chunk into registers, and runs their U reverse steps. That is
//     about 2.3 state steps recomputed per step (L = 16, U = 4) and 16 KB of
//     checkpoint per (b, h) and chunk: 335 MB at the training shape.
//     ref.rwkv6_scan_bwd_chunked_plain mirrors the scheme.
//   - a third launch sums du's per-row sums over b in order.
// The state steps are written without contraction (w S + k v, each rounded)
// as the plain versions compute them, so the recomputed states are the
// plain version's.
//
// Design of the reverse walk. One CTA of 256 threads per (b, h), as
// wkv6_scan.cu: thread (row i, slice cs) = (tid / 4, tid % 4) keeps
// G[i, cs*16 .. cs*16+15] and the U states' same entries in registers. The
// row sums (dr, dk, dw) are its own 16 products and two shuffles within its
// row's 4 lanes; the column sums (dv) are a reduce-scatter across the warp's
// 8 rows (14 shuffles) into shared memory, then a sum over the 8 warps in
// order once per sub-chunk. r, k, w, v and dy of a chunk are staged in
// shared memory as fp32, v and dy padded so that the 4 slices' 16-byte reads
// fall in distinct banks; v . dy and r . (u k) of every step are summed by
// one warp each at staging. No atomics: reruns give the same bits. At B=4,
// H=40 there are 160 CTAs, two an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;            // largest head dim; smaller ones are padded
constexpr int CS = 4;             // column slices per row
constexpr int CPT = HD / CS;      // columns a thread holds
constexpr int NT = HD * CS;       // threads per CTA
constexpr int NW = NT / 32;       // warps per CTA
constexpr int SLICE = CPT + 4;    // padded floats per column slice
constexpr int LDC = CS * SLICE;   // padded row of v and dy
constexpr int L = 16;             // steps per checkpoint
constexpr int U = 4;              // steps per sub-chunk (states in registers)
static_assert(U * HD == NT, "one thread per (step of a sub-chunk, column)");
static_assert(L % U == 0 && L % NW == 0, "whole sub-chunks, whole warps");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ int padded(int col) {
  return (col / CPT) * SLICE + col % CPT;
}

// S <- w S + k v for this thread's 16 entries of row i (v: its padded slice)
__device__ __forceinline__ void state_step(float (&S)[CPT], float kk, float ww,
                                           const float* vrow) {
#pragma unroll
  for (int q = 0; q < CPT / 4; ++q) {
    const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * q);
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      S[4 * q + e] = __fadd_rn(__fmul_rn(ww, S[4 * q + e]), __fmul_rn(kk, vv[e]));
  }
}

// the state S_{t0} at the start of every chunk: ckpt[b, h, c] = S_{c L}
template <typename T>
__global__ void __launch_bounds__(NT)
wkv_bwd_ckpt_kernel(const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ w, const float* __restrict__ s0,
                    float* __restrict__ ckpt, int T_, int H, int hd,
                    int n_chunks) {
  __shared__ float ks[L][HD], ws[L][HD];
  __shared__ __align__(16) float vs[L][LDC];
  const int tid = threadIdx.x, i = tid / CS, cs = tid % CS;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t hh = (size_t)hd * hd;
  float S[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = cs * CPT + j;
    S[j] = i < hd && col < hd ? s0[((size_t)b * H + h) * hh + i * hd + col]
                              : 0.f;
  }
  for (int c = 0; c < n_chunks; ++c) {
    float* out = ckpt + (((size_t)b * H + h) * n_chunks + c) * hh;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int col = cs * CPT + j;
      if (i < hd && col < hd) out[i * hd + col] = S[j];
    }
    if (c + 1 == n_chunks) break;
    const int t0 = c * L;
    __syncthreads();  // the previous chunk is read
    for (int e = tid; e < L * HD; e += NT) {
      const int t = e / HD, kk = e % HD;
      const bool ok = kk < hd && t0 + t < T_;
      const size_t gi = (((size_t)b * T_ + t0 + t) * H + h) * hd + kk;
      ks[t][kk] = ok ? to_f(k[gi]) : 0.f;
      ws[t][kk] = ok ? w[gi] : 1.f;
      vs[t][padded(kk)] = ok ? to_f(v[gi]) : 0.f;
    }
    __syncthreads();
    for (int t = 0; t < L; ++t)   // a whole chunk: c is not the last
      state_step(S, ks[t][i], ws[t][i], &vs[t][cs * SLICE]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const void* __restrict__ u, int u_bf16,
               const float* __restrict__ dy, const float* __restrict__ ds_T,
               const float* __restrict__ ckpt, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dw,
               float* __restrict__ ds0, float* __restrict__ du_part, int T_,
               int H, int hd, int n_chunks) {
  __shared__ float rs[L][HD], ks[L][HD], ws[L][HD];
  __shared__ __align__(16) float vs[L][LDC];
  __shared__ __align__(16) float dys[L][LDC];
  __shared__ float vdy[L], ruk[L], us[HD];
  __shared__ float red[U][NW][HD];   // dv's sums over each warp's 8 rows

  const int tid = threadIdx.x, i = tid / CS, cs = tid % CS;
  const int lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const bool row_ok = i < hd;
  const size_t hh = (size_t)hd * hd;
  const size_t sbase = ((size_t)b * H + h) * hh;

  if (tid < HD) {
    const size_t ui = (size_t)h * hd + tid;
    us[tid] = tid >= hd ? 0.f
              : u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[ui])
                       : static_cast<const float*>(u)[ui];
  }
  float G[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = cs * CPT + j;
    G[j] = row_ok && col < hd ? ds_T[sbase + i * hd + col] : 0.f;
  }
  float du_acc = 0.f;
  // the columns this lane holds after the reduce-scatter of dv
  const int red_col = cs * CPT + 8 * ((lane >> 4) & 1) + 4 * ((lane >> 3) & 1) +
                      2 * ((lane >> 2) & 1);

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * L;
    const int n = min(L, T_ - t0);
    __syncthreads();  // the previous chunk is read
    for (int e = tid; e < L * HD; e += NT) {
      const int t = e / HD, kk = e % HD;
      const bool ok = kk < hd && t0 + t < T_;
      const size_t gi = (((size_t)b * T_ + t0 + t) * H + h) * hd + kk;
      rs[t][kk] = ok ? to_f(r[gi]) : 0.f;
      ks[t][kk] = ok ? to_f(k[gi]) : 0.f;
      ws[t][kk] = ok ? w[gi] : 1.f;
      vs[t][padded(kk)] = ok ? to_f(v[gi]) : 0.f;
      dys[t][padded(kk)] = ok ? dy[gi] : 0.f;
    }
    __syncthreads();
    // v . dy and r . (u k) of every step of the chunk, one warp a step
    for (int t = warp; t < L; t += NW) {
      float a = 0.f, q = 0.f;
#pragma unroll
      for (int m = 0; m < HD / 32; ++m) {
        const int kk = lane + 32 * m;
        a = fmaf(vs[t][padded(kk)], dys[t][padded(kk)], a);
        q = fmaf(__fmul_rn(rs[t][kk], us[kk]), ks[t][kk], q);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        q += __shfl_xor_sync(0xffffffffu, q, o);
      }
      if (lane == 0) {
        vdy[t] = a;
        ruk[t] = q;
      }
    }
    __syncthreads();

    const float* ck = ckpt + (((size_t)b * H + h) * n_chunks + c) * hh;
    for (int sc = (n + U - 1) / U - 1; sc >= 0; --sc) {
      float S[U][CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int col = cs * CPT + j;
        S[0][j] = row_ok && col < hd ? ck[i * hd + col] : 0.f;
      }
      for (int t = 0; t < sc * U; ++t)
        state_step(S[0], ks[t][i], ws[t][i], &vs[t][cs * SLICE]);
#pragma unroll
      for (int q = 1; q < U; ++q) {
        const int t = sc * U + q - 1;
#pragma unroll
        for (int j = 0; j < CPT; ++j) S[q][j] = S[q - 1][j];
        state_step(S[q], ks[t][i], ws[t][i], &vs[t][cs * SLICE]);
      }
#pragma unroll
      for (int q = U - 1; q >= 0; --q) {
        const int t = sc * U + q;
        if (t >= n) continue;   // the same for every thread
        const float ri = rs[t][i], ki = ks[t][i], wi = ws[t][i];
        const float vd = vdy[t];
        const float* vrow = &vs[t][cs * SLICE];
        const float* drow = &dys[t][cs * SLICE];
        float p_dr = 0.f, p_dk = 0.f, p_dw = 0.f, pv[CPT];
#pragma unroll
        for (int q4 = 0; q4 < CPT / 4; ++q4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vrow + 4 * q4);
          const float4 d4 = *reinterpret_cast<const float4*>(drow + 4 * q4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
          const float dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q4 + e;
            p_dr = fmaf(S[q][j], dd[e], p_dr);
            p_dk = fmaf(G[j], vv[e], p_dk);
            p_dw = fmaf(G[j], S[q][j], p_dw);
            pv[j] = G[j] * ki;
            G[j] = fmaf(wi, G[j], ri * dd[e]);
          }
        }
        // the row's 4 slices
#pragma unroll
        for (int o = 1; o < CS; o <<= 1) {
          p_dr += __shfl_xor_sync(0xffffffffu, p_dr, o);
          p_dk += __shfl_xor_sync(0xffffffffu, p_dk, o);
          p_dw += __shfl_xor_sync(0xffffffffu, p_dw, o);
        }
        const float ui = us[i];
        du_acc = fmaf(__fmul_rn(ri, ki), vd, du_acc);
        if (cs == 0 && row_ok) {
          const size_t gi = (((size_t)b * T_ + t0 + t) * H + h) * hd + i;
          store(dr + gi, p_dr + __fmul_rn(ui, ki) * vd);
          store(dk + gi, p_dk + __fmul_rn(ri, ui) * vd);
          dw[gi] = p_dw;
        }
        // dv: reduce-scatter the 16 columns over the warp's 8 rows (lanes
        // 4 apart); each lane ends with 2 columns' sums
        float r1[8], r2[4], r3[2];
        const bool b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1,
                   b2 = (lane >> 2) & 1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          r1[j] = (b4 ? pv[j + 8] : pv[j]) +
                  __shfl_xor_sync(0xffffffffu, b4 ? pv[j] : pv[j + 8], 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r2[j] = (b3 ? r1[j + 4] : r1[j]) +
                  __shfl_xor_sync(0xffffffffu, b3 ? r1[j] : r1[j + 4], 8);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          r3[j] = (b2 ? r2[j + 2] : r2[j]) +
                  __shfl_xor_sync(0xffffffffu, b2 ? r2[j] : r2[j + 2], 4);
        red[q][warp][red_col] = r3[0];
        red[q][warp][red_col + 1] = r3[1];
      }
      __syncthreads();
      {  // dv of the sub-chunk's steps: one thread per (step, column)
        const int q = tid / HD, col = tid % HD, t = sc * U + q;
        if (t < n && col < hd) {
          float s = red[q][0][col];
#pragma unroll
          for (int wp = 1; wp < NW; ++wp) s += red[q][wp][col];
          const size_t gi = (((size_t)b * T_ + t0 + t) * H + h) * hd + col;
          store(dv + gi, s + ruk[t] * dys[t][padded(col)]);
        }
      }
      __syncthreads();  // red is read before the next sub-chunk writes it
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int col = cs * CPT + j;
    if (row_ok && col < hd) ds0[sbase + i * hd + col] = G[j];
  }
  if (cs == 0 && row_ok) du_part[((size_t)b * H + h) * hd + i] = du_acc;
}

// du[n] = sum over b of du_part[b, n], the rows in order, n = h * hd + i
__global__ void wkv_bwd_du_kernel(const float* __restrict__ part,
                                  void* __restrict__ du, int u_bf16, int B,
                                  int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float total = part[n];
  for (int b = 1; b < B; ++b) total += part[(size_t)b * N + n];
  if (u_bf16)
    static_cast<__nv_bfloat16*>(du)[n] = __float2bfloat16(total);
  else
    static_cast<float*>(du)[n] = total;
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const void* u, int u_bf16, const float* s0, const float* dy,
                   const float* ds_T, void* dr, void* dk, void* dv, float* dw,
                   void* du, float* ds0, float* ckpt, float* du_part, int B,
                   int T_, int H, int hd, cudaStream_t stream) {
  const int n_chunks = (T_ + L - 1) / L;
  dim3 grid(H, B);
  wkv_bwd_ckpt_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), w, s0, ckpt, T_, H,
      hd, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv_bwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, u_bf16, dy, ds_T, ckpt,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dw, ds0,
      du_part, T_, H, hd, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int N = H * hd;
  wkv_bwd_du_kernel<<<(N + 255) / 256, 256, 0, stream>>>(du_part, du, u_bf16,
                                                         B, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// L and U, which the caller needs to size ckpt; returns 0.
int wkv6_scan_bwd_steps(int* steps, int* sub) {
  *steps = L;
  *sub = U;
  return 0;
}

// dtype (r, k, v and dr, dk, dv), u_dtype (u and du): 0 = fp32, 1 = bf16;
// w, dw, dy, the states and the scratch are fp32. ckpt holds
// [B, H, ceil(T / 16), hd, hd] floats, du_part [B, H, hd]. Three launches:
// the checkpoints, the reverse walk, du's sum over the batch rows. Returns
// the cudaError_t of the launches (0 on success). The caller has checked
// shapes, types and contiguity, 1 <= hd <= 64, T >= 1 and B <= 65535.
int wkv6_scan_bwd(const void* r, const void* k, const void* v, const float* w,
                  const void* u, const float* state, const float* dy,
                  const float* ds_T, void* dr, void* dk, void* dv, float* dw,
                  void* du, float* ds0, float* ckpt, float* du_part, int B,
                  int T, int H, int hd, int dtype, int u_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > HD || (u_dtype != 0 && u_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(r, k, v, w, u, u_dtype, state, dy, ds_T, dr, dk,
                              dv, dw, du, ds0, ckpt, du_part, B, T, H, hd, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(r, k, v, w, u, u_dtype, state, dy, ds_T,
                                      dr, dk, dv, dw, du, ds0, ckpt, du_part,
                                      B, T, H, hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
