// RG-LRU backward (K2b) for Hopper (sm_90a): the gradients of the RG-LRU
// scan of rglru_scan.cu (K2).
//
// The reference writes no kernel for it: its gradient is jax.grad through
// src/repro/kernels/ref.py::rglru_scan_ref's lax.scan (the Pallas forward,
// src/repro/kernels/rglru_kernel.py::_rglru_kernel, has no backward). For
// batch row b and channel c, with coef = -8 softplus(a_log[c]),
// a_t = exp(coef r_t), s_t = sqrt(max(1 - a_t^2, 0)), u_t = i_t x_t and the
// forward's h sequence y (h_{t-1} = y[t-1], h0 at the first step):
//
//   g_T = dy_T + dh_T;   g_t = dy_t + a_{t+1} g_{t+1}
//   dx_t = g_t s_t i_t;  di_t = g_t s_t x_t
//   da_t = g_t (h_{t-1} - (a_t / s_t) u_t)    (the u-term is 0 where s_t = 0)
//   dr_t = coef a_t da_t
//   da_log[c] = -8 sigmoid(a_log[c]) sum_b sum_t r_t a_t da_t;  dh0 = a_1 g_1
//
// Where the clamp holds (1 - a_t^2 <= 0, so s_t = 0) JAX's gradient through
// sqrt at 0 is not finite; this kernel and its plain version take the
// gradient of the clamped branch, 0, for the u-term.
//
// Layout: x, r, i [B,T,W] in one type, fp32 or bf16, and dx, dr, di in it;
// a_log [W] fp32 or bf16 and da_log in it; h0, dh_T, dh0 [B,W] fp32; y, dy
// [B,T,W] fp32; part [B,W] fp32 scratch; all contiguous.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32): about 25 fp32
// operations per element against 20 bytes moved in bf16 (x, r, i, y and dy
// read, dx, dr and di written), so the bytes bound it. At recurrentgemma-9b's
// training shape (B=2, T=2560, W=4096, bf16) that is 419 MB, 0.125 ms.
//
// Design: the forward's sequential body run backwards in time. One thread
// per (b, channel), CTAs of 64 threads along W, so every load and store is
// coalesced over W; each thread walks time from T-1 down in blocks of U
// steps, all of a block's loads issued before it computes the block. The
// arithmetic is written without contraction (__fmul_rn, __fadd_rn) in the
// plain version's order (ref.rglru_scan_bwd_plain), so the two differ only
// by the rounding of expf, log1pf and sqrtf. Each thread sums its r a da
// over t; a second launch sums the rows' sums over b in order (no atomics,
// so reruns give the same bits) and scales them by -8 sigmoid(a_log). At
// B=2 the 8192 threads are 128 CTAs, about one an SM: the walk is bound by
// the latency of its loads, far from the bytes bound; the forward's chunked
// body (a scan of affine maps) is the model for a faster one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;   // threads (channels) per CTA
constexpr int U = 8;     // time steps whose loads are in flight together

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float load_alog(const void* a_log, int alog_bf16,
                                           int c) {
  return alog_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(a_log)[c])
             : static_cast<const float*>(a_log)[c];
}

// -8 * softplus(a_log), softplus as rglru_scan.cu computes it
__device__ __forceinline__ float decay_coef(float al) {
  const float decay = __fadd_rn(fmaxf(al, 0.f), log1pf(expf(-fabsf(al))));
  return __fmul_rn(-8.f, decay);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                 const T* __restrict__ gi, const void* __restrict__ a_log,
                 int alog_bf16, const float* __restrict__ h0,
                 const float* __restrict__ y, const float* __restrict__ dy,
                 const float* __restrict__ dh_T, T* __restrict__ dx,
                 T* __restrict__ dr, T* __restrict__ di,
                 float* __restrict__ dh0, float* __restrict__ part, int T_,
                 int W) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  const float coef = decay_coef(load_alog(a_log, alog_bf16, c));
  const size_t row = (size_t)b * W + c;
  const size_t base = (size_t)b * T_ * W + c;
  const float h_first = h0[row];
  float g = dh_T[row];   // a_{t+1} g_{t+1}, then g_t
  float acc = 0.f;       // sum over t of r_t a_t da_t

  for (int t1 = T_; t1 > 0; t1 -= U) {   // steps t1-1 down to t1-U
    float xs[U], rs[U], is[U], hs[U], ds[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - 1 - u;
      const bool in = t >= 0;
      const size_t off = base + (size_t)max(t, 0) * W;
      xs[u] = in ? to_f(x[off]) : 0.f;
      rs[u] = in ? to_f(gr[off]) : 0.f;
      is[u] = in ? to_f(gi[off]) : 0.f;
      ds[u] = in ? dy[off] : 0.f;
      hs[u] = t > 0 ? y[off - W] : h_first;   // h_{t-1}
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t1 - 1 - u;
      if (t < 0) break;
      const float a = expf(__fmul_rn(coef, rs[u]));
      const float s = sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f));
      const float term =
          s > 0.f ? __fmul_rn(__fdiv_rn(a, s), __fmul_rn(is[u], xs[u])) : 0.f;
      g = __fadd_rn(ds[u], g);
      const float gs = __fmul_rn(g, s);
      const size_t off = base + (size_t)t * W;
      store(dx + off, __fmul_rn(gs, is[u]));
      store(di + off, __fmul_rn(gs, xs[u]));
      const float da = __fmul_rn(g, __fsub_rn(hs[u], term));
      store(dr + off, __fmul_rn(__fmul_rn(coef, a), da));
      acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(rs[u], a), da));
      g = __fmul_rn(a, g);
    }
  }
  dh0[row] = g;
  part[row] = acc;
}

// da_log[c] = -8 sigmoid(a_log[c]) * sum over b of part[b, c], the rows
// summed in order
__global__ void rglru_bwd_alog_kernel(const float* __restrict__ part,
                                      const void* __restrict__ a_log,
                                      int alog_bf16, void* __restrict__ da_log,
                                      int B, int W) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= W) return;
  float total = part[c];
  for (int b = 1; b < B; ++b) total = __fadd_rn(total, part[(size_t)b * W + c]);
  const float al = load_alog(a_log, alog_bf16, c);
  const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-al)));
  const float d = __fmul_rn(__fmul_rn(-8.f, sig), total);
  if (alog_bf16)
    static_cast<__nv_bfloat16*>(da_log)[c] = __float2bfloat16(d);
  else
    static_cast<float*>(da_log)[c] = d;
}

template <typename T>
cudaError_t launch(const void* x, const void* gr, const void* gi,
                   const void* a_log, int alog_bf16, const float* h0,
                   const float* y, const float* dy, const float* dh_T, void* dx,
                   void* dr, void* di, void* da_log, float* dh0, float* part,
                   int B, int T_, int W, cudaStream_t stream) {
  dim3 grid((W + NT - 1) / NT, B);
  rglru_bwd_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<const T*>(gi), a_log, alog_bf16, h0, y, dy, dh_T,
      static_cast<T*>(dx), static_cast<T*>(dr), static_cast<T*>(di), dh0, part,
      T_, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rglru_bwd_alog_kernel<<<(W + 255) / 256, 256, 0, stream>>>(
      part, a_log, alog_bf16, da_log, B, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (x, r, i and dx, dr, di) and alog_dtype (a_log and da_log): 0 =
// fp32, 1 = bf16. Two launches: the reverse walk, then da_log's sum over the
// batch rows. Returns the cudaError_t of the launches (0 on success). The
// caller has checked shapes, types and contiguity, and that T >= 1 and
// B <= 65535.
int rglru_scan_bwd(const void* x, const void* gate_r, const void* gate_i,
                   const void* a_log, const float* h0, const float* y,
                   const float* dy, const float* dh_T, void* dx,
                   void* dgate_r, void* dgate_i, void* da_log, float* dh0,
                   float* part, int B, int T, int W, int dtype, int alog_dtype,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (alog_dtype != 0 && alog_dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, gate_r, gate_i, a_log, alog_dtype, h0, y, dy,
                              dh_T, dx, dgate_r, dgate_i, da_log, dh0, part, B,
                              T, W, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, gate_r, gate_i, a_log, alog_dtype, h0,
                                      y, dy, dh_T, dx, dgate_r, dgate_i,
                                      da_log, dh0, part, B, T, W, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
