// RG-LRU scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rglru_kernel.py::_rglru_kernel (the Pallas TPU
// kernel, called through rglru_scan_pallas). For batch row b and channel c:
//
//   a_t = exp(-8 * softplus(a_log[c]) * r_t)
//   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 0)) * (i_t * x_t)
//   y[b,t,c] = h_t;   h_T is written to h_out, which may alias h0
//
// Layout: x, r, i [B,T,W] in one type, fp32 or bf16; a_log [W] fp32 or bf16;
// h0 and h_out [B,W] fp32; y [B,T,W] fp32; all contiguous.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32): about 8 fp32 operations
// per element against 10 bytes moved (bf16 x, r, i read, fp32 y written), so
// the bytes bound it. At recurrentgemma-9b's prefill (B=1, T=2560, W=4096,
// bf16) that is 105 MB, 31 us; at decode (B=8, T=1) 0.6 MB, under 1 us, where
// the launch itself dominates.
//
// Design. Channels are independent and only h = a*h + b is serial: one thread
// per (b, channel), CTAs of 64 threads along W, so B=1 at W=4096 still fills
// 64 SMs. Loads along W are coalesced. Each thread walks time in chunks of U
// steps and issues the loads of the next chunk before it computes the current
// one, so the serial loop waits on memory once per chunk, not once per step.
// a_t and b_t do not depend on h; the chain is one multiply and one add per
// step. The arithmetic is written without contraction (__fmul_rn, __fadd_rn)
// in the plain version's order, so the two differ only by the rounding of
// expf, log1pf and sqrtf. With 4096 threads of 16 steps in flight, the
// memory system holds about 0.4 MB at a time: far from the bytes bound, which
// needs several MB in flight; a chunked parallel scan over time is the
// follow-up (ROADMAP.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;   // threads (channels) per CTA
constexpr int U = 16;    // time steps per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                  const T* __restrict__ gi, const void* __restrict__ a_log,
                  int alog_bf16, const float* h0, float* __restrict__ y,
                  float* h_out, int T_, int W) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  const float al =
      alog_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a_log)[c])
                : static_cast<const float*>(a_log)[c];
  // softplus as jax.nn.softplus computes it: logaddexp(x, 0)
  const float decay = __fadd_rn(fmaxf(al, 0.f), log1pf(expf(-fabsf(al))));
  const float coef = __fmul_rn(-8.f, decay);
  float h = h0[(size_t)b * W + c];
  const size_t base = (size_t)b * T_ * W + c;

  float xc[U], rc[U], ic[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const bool in = u < T_;
    const size_t off = base + (size_t)u * W;
    xc[u] = in ? to_f(x[off]) : 0.f;
    rc[u] = in ? to_f(gr[off]) : 0.f;
    ic[u] = in ? to_f(gi[off]) : 0.f;
  }
  for (int t0 = 0; t0 < T_; t0 += U) {
    float xn[U], rn[U], in_[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // the next chunk, in flight meanwhile
      const int t = t0 + U + u;
      const bool in = t < T_;
      const size_t off = base + (size_t)t * W;
      xn[u] = in ? to_f(x[off]) : 0.f;
      rn[u] = in ? to_f(gr[off]) : 0.f;
      in_[u] = in ? to_f(gi[off]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t >= T_) break;
      const float a = expf(__fmul_rn(coef, rc[u]));
      const float s = sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f));
      const float bt = __fmul_rn(s, __fmul_rn(ic[u], xc[u]));
      h = __fadd_rn(__fmul_rn(a, h), bt);
      y[base + (size_t)t * W] = h;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      xc[u] = xn[u];
      rc[u] = rn[u];
      ic[u] = in_[u];
    }
  }
  h_out[(size_t)b * W + c] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* gr, const void* gi,
                   const void* a_log, int alog_bf16, const float* h0, float* y,
                   float* h_out, int B, int T_, int W, cudaStream_t stream) {
  dim3 grid((W + NT - 1) / NT, B);
  rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<const T*>(gi), a_log, alog_bf16, h0, y, h_out, T_, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (x, r, i) and alog_dtype: 0 = fp32, 1 = bf16. Returns the
// cudaError_t of the launch (0 on success). The caller has checked shapes,
// types and contiguity, and that T >= 1 and B <= 65535.
int rglru_scan(const void* x, const void* gate_r, const void* gate_i,
               const void* a_log, const float* h0, float* y, float* h_out,
               int B, int T, int W, int dtype, int alog_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (alog_dtype != 0 && alog_dtype != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(x, gate_r, gate_i, a_log, alog_dtype, h0, y,
                              h_out, B, T, W, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, gate_r, gate_i, a_log, alog_dtype,
                                      h0, y, h_out, B, T, W, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
