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
// [B,T,W] fp32; scratch: maps [2, B, ceil(T/L), W] fp32 and part
// [B, ceil(T/L), W] fp32; all contiguous.
//
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32): about 25 fp32
// operations per element against 20 bytes moved in bf16 (x, r, i, y and dy
// read, dx, dr and di written), so the bytes bound it. At recurrentgemma-9b's
// training shape (B=2, T=2560, W=4096, bf16) that is 419 MB, 0.125 ms.
//
// Design: chunk-parallel, a reduce-then-scan in four launches. With c_t the
// carry into step t (dh_T at the last step), the reverse recurrence is the
// affine map c_{t-1} = a_t (dy_t + c_t), so chunks of L = 32 steps reduce in
// parallel and join through a carry, with no division and nothing that can
// overflow (every |a| <= 1):
//
//   1. maps (rglru_bwd_maps_kernel): one CTA per (batch row, chunk, block of
//      32 x VEC channels, VEC = 16 bytes of inputs: 8 bf16 or 4 fp32), 4
//      quarters of 32 lanes; thread (quarter, lane) copies its quarter's r
//      and dy into shared memory with cp.async (16 bytes a copy, all of its
//      steps at once, the decay coefficients computed meanwhile), composes
//      the quarter's map last step first (P = Π a, Q = the carry reached
//      from 0), and quarter 0 composes the 4 maps into the chunk's, last
//      quarter first;
//   2. carry (rglru_bwd_carry_kernel): one thread per (b, channel) walks the
//      chunks last to first from dh_T, c <- P c + Q, writing each chunk's
//      carry in over its P (loads 8 chunks ahead); dh0 is the last c;
//   3. rescan (rglru_bwd_rescan_kernel): one thread per (b, chunk, VEC
//      channels) walks its chunk last to first from its carry, its loads 16
//      bytes each, two steps in flight, and writes dx, di and dr; it sums
//      its r a da over the chunk into part;
//   4. da_log (rglru_bwd_alog_kernel): per channel, 8 segments of the
//      (b, chunk) partial sums, each summed in order, then the 8 in order,
//      times -8 sigmoid(a_log).
//
// No atomics, and no grouping that depends on timing (the forward's
// decoupled look-back would give one): reruns give the same bits. Steps past
// T are the identity (a = 1, dy = 0) in pass 1 and are not walked in pass 3.
// The arithmetic is written without contraction (__fmul_rn, __fadd_rn); the
// carries regroup the sequential version's products and sums, so K2b agrees
// with ref.rglru_scan_bwd_plain to rounding (within 1e-5), not bit for bit;
// ref.rglru_scan_bwd_chunked_plain mirrors the scheme. A W that is not a
// multiple of VEC, or unaligned inputs, take the scalar path (element loads
// and stores, masked channels). Bytes moved: pass 1 reads r and dy again
// (6 of 26 bytes an element in bf16), passes 2 and 4 about 0.5 more.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int L = 32;          // steps per chunk
constexpr int SUB = 8;         // steps per quarter (a maps thread's)
constexpr int NQ = L / SUB;    // quarters per chunk
constexpr int CL = 32;         // lanes per quarter
constexpr int MAPS_NT = CL * NQ;
constexpr int RESCAN_NT = 64;  // rescan threads per CTA, along the channels
constexpr int U = 2;           // rescan steps whose loads are in flight
constexpr int CARRY_NT = 256;
constexpr int SUM_LANES = 32, SUM_SEGS = 8;

// the maps pass's staging: r, then dy's 16-byte planes, [L][CL] x 16 bytes
// each (48 KB in bf16, 32 KB in fp32)
template <typename T>
constexpr int maps_smem() {
  return (1 + 16 / (int)sizeof(T) / 4) * L * CL * 16;
}

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// VEC values of a row at p (n of them inside the row) as floats: 16-byte
// loads on the vector path, masked element loads otherwise
template <int VEC, bool VECTOR, typename T>
__device__ __forceinline__ void load_vec(float (&out)[VEC], const T* p,
                                         int n) {
  if (VECTOR) {
    constexpr int PER = 16 / sizeof(T);  // values per 16-byte load
#pragma unroll
    for (int q = 0; q < VEC / PER; ++q) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + q * PER);
      const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) out[q * PER + e] = to_f(el[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = e < n ? to_f(p[e]) : 0.f;
  }
}

template <int VEC, bool VECTOR, typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC], int n) {
  if (VECTOR) {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < VEC / PER; ++q) {
      uint4 raw;
      T* el = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int e = 0; e < PER; ++e) store(el + e, v[q * PER + e]);
      *reinterpret_cast<uint4*>(p + q * PER) = raw;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < n) store(p + e, v[e]);
  }
}

// ---- pass 1: the chunk maps -------------------------------------------------
// maps holds P [B, n_chunks, W], then Q [B, n_chunks, W]
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(MAPS_NT)
rglru_bwd_maps_kernel(const T* __restrict__ gr, const float* __restrict__ dy,
                      const void* __restrict__ a_log, int alog_bf16,
                      float* __restrict__ maps, int B, int T_, int W,
                      int n_chunks, int n_wblk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = CL * VEC;          // channels per CTA
  constexpr int DP = VEC / 4;           // 16-byte planes of dy per step
  // [1 + DP planes][L][CL] x 16 B: r, then dy
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ float qp[NQ][CH], qq[NQ][CH];  // the quarters' maps
  const int chunk = blockIdx.x / n_wblk, wb = blockIdx.x % n_wblk;
  const int b = blockIdx.y;
  const int lane = threadIdx.x % CL, q = threadIdx.x / CL;
  const int c0 = wb * CH + lane * VEC;  // this thread's first channel
  const int nc = min(VEC, W - c0);      // its channels inside W
  const int t0 = chunk * L, j0 = q * SUB;
  const int nj = max(0, min(SUB, T_ - t0 - j0));  // its steps inside T
  auto plane = [&](int p, int j) {
    return stage + ((size_t)(p * L + j) * CL + lane) * 16;
  };

  for (int j = 0; j < nj; ++j) {
    const size_t off = ((size_t)b * T_ + t0 + j0 + j) * W + c0;
    if (VECTOR) {
      if (nc > 0) {
        cp_async16(plane(0, j0 + j), gr + off);
#pragma unroll
        for (int p = 0; p < DP; ++p)
          cp_async16(plane(1 + p, j0 + j), dy + off + 4 * p);
      }
    } else {
      T* rs = reinterpret_cast<T*>(plane(0, j0 + j));
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        rs[e] = e < nc ? gr[off + e] : T(0.f);
        reinterpret_cast<float*>(plane(1 + e / 4, j0 + j))[e % 4] =
            e < nc ? dy[off + e] : 0.f;
      }
    }
  }
  float coef[VEC];  // while the copies are in flight
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    coef[e] = e < nc ? decay_coef(load_alog(a_log, alog_bf16, c0 + e)) : 0.f;
  if (VECTOR) asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");

  // the quarter's map, its last step first: c -> a (dy + c)
  float P[VEC], Q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) P[e] = 1.f, Q[e] = 0.f;
  for (int j = nj - 1; j >= 0; --j) {
    const T* rs = reinterpret_cast<const T*>(plane(0, j0 + j));
    const float* ds = reinterpret_cast<const float*>(plane(1, j0 + j));
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // dy's planes are consecutive 16-byte slots CL * 16 bytes apart
      const float d = ds[(e / 4) * L * CL * 4 + e % 4];
      const float a = expf(__fmul_rn(coef[e], to_f(rs[e])));
      Q[e] = __fmul_rn(a, __fadd_rn(d, Q[e]));
      P[e] = __fmul_rn(a, P[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    qp[q][lane * VEC + e] = P[e];
    qq[q][lane * VEC + e] = Q[e];
  }
  __syncthreads();
  if (q == 0) {  // the chunk's map: quarter NQ-1 first
    const size_t at = ((size_t)b * n_chunks + chunk) * W + c0;
    const size_t per_array = (size_t)B * n_chunks * W;
    float cp[VEC], cq[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      cp[e] = qp[NQ - 1][lane * VEC + e];
      cq[e] = qq[NQ - 1][lane * VEC + e];
#pragma unroll
      for (int k = NQ - 2; k >= 0; --k) {
        const float pk = qp[k][lane * VEC + e];
        cq[e] = __fadd_rn(__fmul_rn(pk, cq[e]), qq[k][lane * VEC + e]);
        cp[e] = __fmul_rn(pk, cp[e]);
      }
    }
    if (nc > 0) {
      store_vec<VEC, VECTOR>(maps + at, cp, nc);
      store_vec<VEC, VECTOR>(maps + per_array + at, cq, nc);
    }
  }
}

// ---- pass 2: the carry ------------------------------------------------------
// c <- P c + Q over the chunks, last first, from dh_T; each chunk's carry in
// is written over its P; dh0 = the last c
__global__ void __launch_bounds__(CARRY_NT)
rglru_bwd_carry_kernel(float* __restrict__ maps,
                       const float* __restrict__ dh_T,
                       float* __restrict__ dh0, int B, int W, int n_chunks) {
  const int c = blockIdx.x * CARRY_NT + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= W) return;
  float* P = maps + (size_t)b * n_chunks * W + c;
  const float* Q = P + (size_t)B * n_chunks * W;
  float h = dh_T[(size_t)b * W + c];
  constexpr int BATCH = 8;
  for (int c0 = 0; c0 < n_chunks; c0 += BATCH) {
    float p[BATCH], q[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {  // every load of the batch first
      const size_t ch = (size_t)(n_chunks - 1 - (c0 + j));
      if (c0 + j < n_chunks) {
        p[j] = P[ch * W];
        q[j] = Q[ch * W];
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const size_t ch = (size_t)(n_chunks - 1 - (c0 + j));
      if (c0 + j < n_chunks) {
        P[ch * W] = h;
        h = __fadd_rn(__fmul_rn(p[j], h), q[j]);
      }
    }
  }
  dh0[(size_t)b * W + c] = h;
}

// ---- pass 3: the rescan -----------------------------------------------------
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(RESCAN_NT)
rglru_bwd_rescan_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                        const T* __restrict__ gi,
                        const void* __restrict__ a_log, int alog_bf16,
                        const float* __restrict__ h0,
                        const float* __restrict__ y,
                        const float* __restrict__ dy,
                        const float* __restrict__ carry, T* __restrict__ dx,
                        T* __restrict__ dr, T* __restrict__ di,
                        float* __restrict__ part, int T_, int W, int n_chunks,
                        int n_wblk) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunk = blockIdx.x / n_wblk, wb = blockIdx.x % n_wblk;
  const int b = blockIdx.y;
  const int c0 = (wb * RESCAN_NT + threadIdx.x) * VEC;
  if (c0 >= W) return;
  const int nc = min(VEC, W - c0);
  const int t0 = chunk * L, t1 = min(t0 + L, T_);
  const size_t at = ((size_t)b * n_chunks + chunk) * W + c0;
  float coef[VEC], c[VEC], acc[VEC];
  load_vec<VEC, VECTOR>(c, carry + at, nc);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    coef[e] = e < nc ? decay_coef(load_alog(a_log, alog_bf16, c0 + e)) : 0.f;
    acc[e] = 0.f;
  }
  const size_t base = (size_t)b * T_ * W + c0;
  constexpr int NU = VECTOR ? U : 1;  // the scalar path: one step (no spill)
  for (int tb = t1 - 1; tb >= t0; tb -= NU) {  // steps tb down to tb-NU+1
    float xs[NU][VEC], rs[NU][VEC], is[NU][VEC], ds[NU][VEC], hs[NU][VEC];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int t = max(tb - u, t0);
      const size_t off = base + (size_t)t * W;
      load_vec<VEC, VECTOR>(xs[u], x + off, nc);
      load_vec<VEC, VECTOR>(rs[u], gr + off, nc);
      load_vec<VEC, VECTOR>(is[u], gi + off, nc);
      load_vec<VEC, VECTOR>(ds[u], dy + off, nc);
      const float* hp = t > 0 ? y + off - W : h0 + (size_t)b * W + c0;
      load_vec<VEC, VECTOR>(hs[u], hp, nc);   // h_{t-1}
    }
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int t = tb - u;
      if (t < t0) break;
      float ox[VEC], orr[VEC], oi[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float a = expf(__fmul_rn(coef[e], rs[u][e]));
        const float s = sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f));
        const float term =
            s > 0.f ? __fmul_rn(__fdiv_rn(a, s), __fmul_rn(is[u][e], xs[u][e]))
                    : 0.f;
        const float g = __fadd_rn(ds[u][e], c[e]);
        const float gs = __fmul_rn(g, s);
        ox[e] = __fmul_rn(gs, is[u][e]);
        oi[e] = __fmul_rn(gs, xs[u][e]);
        const float da = __fmul_rn(g, __fsub_rn(hs[u][e], term));
        orr[e] = __fmul_rn(__fmul_rn(coef[e], a), da);
        acc[e] = __fadd_rn(acc[e], __fmul_rn(__fmul_rn(rs[u][e], a), da));
        c[e] = __fmul_rn(a, g);
      }
      const size_t off = base + (size_t)t * W;
      store_vec<VEC, VECTOR>(dx + off, ox, nc);
      store_vec<VEC, VECTOR>(dr + off, orr, nc);
      store_vec<VEC, VECTOR>(di + off, oi, nc);
    }
  }
  store_vec<VEC, VECTOR>(part + at, acc, nc);
}

// ---- pass 4: da_log ---------------------------------------------------------
// da_log[c] = -8 sigmoid(a_log[c]) * the sum over (b, chunk) of part: 8
// segments of the N = B * n_chunks rows, each summed in order, then the 8
// in order
__global__ void __launch_bounds__(SUM_LANES * SUM_SEGS)
rglru_bwd_alog_kernel(const float* __restrict__ part,
                      const void* __restrict__ a_log, int alog_bf16,
                      void* __restrict__ da_log, int N, int W) {
  __shared__ float seg[SUM_SEGS][SUM_LANES];
  const int lane = threadIdx.x, s = threadIdx.y;
  const int c = blockIdx.x * SUM_LANES + lane;
  const int per = (N + SUM_SEGS - 1) / SUM_SEGS;
  float total = 0.f;
  if (c < W)
    for (int m = s * per; m < min(N, (s + 1) * per); ++m)
      total = __fadd_rn(total, part[(size_t)m * W + c]);
  seg[s][lane] = total;
  __syncthreads();
  if (s != 0 || c >= W) return;
  total = seg[0][lane];
#pragma unroll
  for (int k = 1; k < SUM_SEGS; ++k) total = __fadd_rn(total, seg[k][lane]);
  const float al = load_alog(a_log, alog_bf16, c);
  const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-al)));
  const float d = __fmul_rn(__fmul_rn(-8.f, sig), total);
  if (alog_bf16)
    static_cast<__nv_bfloat16*>(da_log)[c] = __float2bfloat16(d);
  else
    static_cast<float*>(da_log)[c] = d;
}

template <typename T, bool VECTOR>
cudaError_t launch(const void* x, const void* gr, const void* gi,
                   const void* a_log, int alog_bf16, const float* h0,
                   const float* y, const float* dy, const float* dh_T,
                   void* dx, void* dr, void* di, void* da_log, float* dh0,
                   float* maps, float* part, int B, int T_, int W,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int n_chunks = (T_ + L - 1) / L;
  const int n_maps = (W + CL * VEC - 1) / (CL * VEC);
  cudaError_t err = cudaFuncSetAttribute(
      rglru_bwd_maps_kernel<T, VECTOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, maps_smem<T>());
  if (err != cudaSuccess) return err;
  rglru_bwd_maps_kernel<T, VECTOR><<<dim3(n_chunks * n_maps, B), MAPS_NT,
                                     maps_smem<T>(), stream>>>(
      static_cast<const T*>(gr), dy, a_log, alog_bf16, maps, B, T_, W,
      n_chunks, n_maps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rglru_bwd_carry_kernel<<<dim3((W + CARRY_NT - 1) / CARRY_NT, B), CARRY_NT,
                           0, stream>>>(maps, dh_T, dh0, B, W, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int n_rescan = (W + RESCAN_NT * VEC - 1) / (RESCAN_NT * VEC);
  rglru_bwd_rescan_kernel<T, VECTOR><<<dim3(n_chunks * n_rescan, B),
                                       RESCAN_NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<const T*>(gi), a_log, alog_bf16, h0, y, dy, maps,
      static_cast<T*>(dx), static_cast<T*>(dr), static_cast<T*>(di), part, T_,
      W, n_chunks, n_rescan);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rglru_bwd_alog_kernel<<<(W + SUM_LANES - 1) / SUM_LANES,
                          dim3(SUM_LANES, SUM_SEGS), 0, stream>>>(
      part, a_log, alog_bf16, da_log, B * n_chunks, W);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// L and SUB, which the caller needs to size maps and part; returns 0.
int rglru_scan_bwd_steps(int* chunk, int* sub) {
  *chunk = L;
  *sub = SUB;
  return 0;
}

// dtype (x, r, i and dx, dr, di) and alog_dtype (a_log and da_log): 0 =
// fp32, 1 = bf16. maps: fp32 [2, B, ceil(T/32), W]; part: fp32
// [B, ceil(T/32), W]. vector: W is a multiple of 16 bytes of channels and
// x, r, i, y, dy are 16-byte aligned. Four launches: the chunk maps, the
// carry, the rescan, da_log's sum. Returns the first cudaError_t of the
// launches (0 on success). The caller has checked shapes, types and
// contiguity, and that T >= 1 and B <= 65535.
int rglru_scan_bwd(const void* x, const void* gate_r, const void* gate_i,
                   const void* a_log, const float* h0, const float* y,
                   const float* dy, const float* dh_T, void* dx,
                   void* dgate_r, void* dgate_i, void* da_log, float* dh0,
                   float* maps, float* part, int B, int T, int W, int dtype,
                   int alog_dtype, int vector, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (alog_dtype != 0 && alog_dtype != 1) return (int)cudaErrorInvalidValue;
#define RGLRU_BWD(TYPE, VEC_OK)                                              \
  return (int)launch<TYPE, VEC_OK>(x, gate_r, gate_i, a_log, alog_dtype, h0, \
                                   y, dy, dh_T, dx, dgate_r, dgate_i, da_log, \
                                   dh0, maps, part, B, T, W, st)
  if (dtype == 0) {
    if (vector) RGLRU_BWD(float, true);
    RGLRU_BWD(float, false);
  }
  if (dtype == 1) {
    if (vector) RGLRU_BWD(__nv_bfloat16, true);
    RGLRU_BWD(__nv_bfloat16, false);
  }
#undef RGLRU_BWD
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
