// RWKV-6 WKV scan for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rwkv6_kernel.py::_wkv_kernel (the Pallas TPU
// kernel, called through rwkv6_scan_pallas). Per (batch b, head h), with the
// k-major state S [hd_k, hd_v] in fp32:
//
//   y_t[v] = sum_k (S[k,v] + u[k] k_t[k] v_t[v]) r_t[k]   (S before the update)
//   S[k,v] <- w_t[k] S[k,v] + k_t[k] v_t[v]
//
// Layout: r, k, v [B,T,H,hd] in one type, fp32 or bf16; w [B,T,H,hd] fp32
// (decays near 1 lose their precision in bf16); u [H,hd] fp32 or bf16; state
// and state_out [B,H,hd,hd] fp32 (state_out may alias state); y [B,T,H,hd]
// fp32; all contiguous; hd at most 64.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32). The u-term factors
// out, y_t = S^T r_t + v_t ((u . k_t) . r_t), which leaves 2 fp32 operations
// per state element per step for S^T r and 3 for w S + k v^T, plus 5 per
// (t, h, k) for the u-term: (5 hd + 5) per element of r. At rwkv6-3b's
// prefill (B=1, T=512, H=40, hd=64) that is 0.43 GFLOP, 6.4 us, against 20 MB
// of inputs, outputs and state, 5.9 us: operations. At decode (B=8, T=1) the
// 10.5 MB of state read and written bound it: 3.1 us. This kernel does not
// factor the u-term out: it spends 7 operations per state element per step.
//
// Design. One CTA of 256 threads per (b, h): thread (v, ks) = (tid / 4,
// tid % 4) keeps S[ks*16 .. ks*16+15, v] in registers for the whole time
// loop, and the 4 threads of a column sum their parts of y_t[v] with two warp
// shuffles. r, k, w of CT steps are staged in shared memory as fp32 (v
// beside them), each k-slice padded to 20 floats so that the four slices'
// 16-byte reads fall in distinct banks; each thread then reads its slice as
// float4 broadcasts. Only the fp32 FMAs of the state are left per step.
// Columns and rows past hd are zero and never written. At B=1 there are only
// H=40 CTAs for 132 SMs, and a CTA stages each chunk before it computes it;
// the chunked matrix form (tensor cores) is the follow-up (ROADMAP.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;          // largest head dim; smaller ones are padded
constexpr int KS = 4;           // k-slices per column
constexpr int KPT = HD / KS;    // state rows per thread
constexpr int NT = HD * KS;     // threads per CTA
constexpr int SLICE = KPT + 4;  // padded floats per k-slice in shared memory
constexpr int LDK = KS * SLICE; // padded row of r, k, w
constexpr int CT = 32;          // time steps staged per chunk

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ int padded(int k) { return (k / KPT) * SLICE + k % KPT; }

template <typename T>
__global__ void __launch_bounds__(NT)
wkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ w,
                 const void* __restrict__ u, int u_bf16, const float* s0,
                 float* __restrict__ y, float* s_out, int T_, int H, int hd) {
  __shared__ __align__(16) float rs[CT][LDK];
  __shared__ __align__(16) float ks_[CT][LDK];
  __shared__ __align__(16) float ws[CT][LDK];
  __shared__ float vs[CT][HD];

  const int tid = threadIdx.x;
  const int col = tid / KS;      // v
  const int sl = tid % KS;       // k-slice: rows sl*KPT .. sl*KPT + KPT-1
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const bool col_ok = col < hd;

  float S[KPT], uu[KPT];
  const size_t sbase = ((size_t)b * H + h) * hd * hd;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kk = sl * KPT + j;
    const bool ok = col_ok && kk < hd;
    S[j] = ok ? s0[sbase + (size_t)kk * hd + col] : 0.f;
    uu[j] = 0.f;
    if (kk < hd) {
      const size_t ui = (size_t)h * hd + kk;
      uu[j] = u_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(u)[ui])
                     : static_cast<const float*>(u)[ui];
    }
  }

  for (int t0 = 0; t0 < T_; t0 += CT) {
    __syncthreads();  // the previous chunk is read
#pragma unroll 4
    for (int e = tid; e < CT * HD; e += NT) {
      const int t = e / HD, kk = e % HD;
      const bool ok = kk < hd && t0 + t < T_;
      const size_t gi = (((size_t)b * T_ + t0 + t) * H + h) * hd + kk;
      const int p = padded(kk);
      rs[t][p] = ok ? to_f(r[gi]) : 0.f;
      ks_[t][p] = ok ? to_f(k[gi]) : 0.f;
      ws[t][p] = ok ? w[gi] : 1.f;
      vs[t][kk] = ok ? to_f(v[gi]) : 0.f;
    }
    __syncthreads();

    const int n = min(CT, T_ - t0);
    for (int t = 0; t < n; ++t) {
      const float vv = vs[t][col];
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < KPT / 4; ++q) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[t][sl * SLICE + 4 * q]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks_[t][sl * SLICE + 4 * q]);
        const float4 w4 = *reinterpret_cast<const float4*>(&ws[t][sl * SLICE + 4 * q]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          const float kv = kk[e] * vv;
          part = fmaf(fmaf(uu[j], kv, S[j]), rr[e], part);
          S[j] = fmaf(ww[e], S[j], kv);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (sl == 0 && col_ok)
        y[(((size_t)b * T_ + t0 + t) * H + h) * hd + col] = part;
    }
  }

#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kk = sl * KPT + j;
    if (col_ok && kk < hd) s_out[sbase + (size_t)kk * hd + col] = S[j];
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const float* w,
                   const void* u, int u_bf16, const float* s0, float* y,
                   float* s_out, int B, int T_, int H, int hd,
                   cudaStream_t stream) {
  dim3 grid(H, B);
  wkv6_scan_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, u_bf16, s0, y, s_out, T_, H, hd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (r, k, v), u_dtype: 0 = fp32, 1 = bf16; w is fp32. Returns the
// cudaError_t of the launch (0 on success). The caller has checked shapes,
// types and contiguity, 1 <= hd <= 64, T >= 1 and B <= 65535.
int wkv6_scan(const void* r, const void* k, const void* v, const float* w,
              const void* u, const float* state, float* y, float* state_out,
              int B, int T, int H, int hd, int dtype, int u_dtype,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > HD || (u_dtype != 0 && u_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch<float>(r, k, v, w, u, u_dtype, state, y, state_out, B,
                              T, H, hd, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(r, k, v, w, u, u_dtype, state, y,
                                      state_out, B, T, H, hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
