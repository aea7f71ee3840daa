// RG-LRU scan for Hopper (sm_90a): a sequential body for decode and short
// T, and a chunk-parallel body for prefill.
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
// Bound on the H100 SXM (3.35 TB/s; 67 TFLOP/s fp32): about 9 fp32 operations
// per element against 10 bytes moved (bf16 x, r, i read, fp32 y written), so
// the bytes bound it. At recurrentgemma-9b's prefill (B=1, T=2560, W=4096,
// bf16) that is 105 MB, 31 us; at decode (B=8, T=1) 0.6 MB, under 1 us, where
// the launch itself dominates. The wrapper (kernels/rglru.py, plan) picks the
// body from the shapes: T up to one chunk (decode) takes the sequential body,
// longer T the chunked one.
//
// Sequential body. Channels are independent and only h = a*h + b is serial:
// one thread per (b, channel), CTAs of 64 threads along W. Each thread walks
// time in chunks of U steps and issues the loads of the next chunk before it
// computes the current one. a_t and b_t do not depend on h; the chain is one
// multiply and one add per step. The arithmetic is written without
// contraction (__fmul_rn, __fadd_rn) in the plain version's order, so the
// two differ only by the rounding of expf, log1pf and sqrtf. At B=1 it keeps
// about 0.4 MB in flight, far from what the bytes bound needs.
//
// Chunked body. The recurrence composes affine maps h -> a h + b, so chunks
// of time reduce in parallel and join through a carry, with no division and
// nothing that can overflow (every |a| <= 1). A CTA owns one (batch row,
// chunk of L steps, block of 32 x VEC channels), VEC = 16 bytes of inputs
// (8 bf16 or 4 fp32 channels); its 128 threads are 4 quarters of 32 lanes,
// and thread (quarter q, lane) takes the lane's VEC channels over the
// quarter's L/4 steps. At the prefill shape (L=32, bf16) that is 80 x 16 =
// 1280 CTAs, three an SM.
//   - Loads. Each thread copies its own x, r, i (16 bytes each per step)
//     into shared memory with cp.async, all of its steps at once (the decay
//     coefficients load meanwhile), and reads them back itself, 16 bytes at
//     a time (a warp reads 512 consecutive bytes, no bank conflict): no
//     barrier, and every input byte is read from device memory once.
//   - Pass 1. Each thread composes its quarter's map (A = prod a, E = the
//     state reached from 0) and writes a_t, b_t over the step's inputs (4
//     planes of 16 bytes a lane and step, 64 KB a CTA at L=32); the 4
//     quarters' maps compose into the chunk's map.
//   - Carry: decoupled look-back (Merrill and Garland's single-pass scan),
//     in warp 0, each lane for its own channels. Chunk 0 reads h0 and
//     publishes its end state h_end(0) = A h0 + E with the INCLUSIVE flag.
//     Every other chunk publishes its map (AGGREGATE), then walks back over
//     its predecessors, composing their maps, until it meets an INCLUSIVE
//     end state (at chunk 0 at the latest); it publishes its own end state
//     as INCLUSIVE. Values are written, then the flag with a release store;
//     a reader spins on the flag with acquire loads (and __nanosleep), then
//     reads the values through L2.
//   - Forward progress. A CTA takes its chunk from an atomic ticket, chunk
//     the slowest index, not from blockIdx: every chunk it waits on belongs
//     to a CTA that took its ticket earlier and is therefore running.
//   - Pass 2. Each thread rescans its quarter from the carry (chunk carry
//     composed with the earlier quarters' maps) with the stored a_t, b_t,
//     one multiply and one add an element, and writes y (two float4 stores
//     per step at VEC=8). The last chunk's last quarter writes h_T.
//   - Aliasing. h_out may alias h0. Only chunk 0 reads h0, before it
//     publishes; the last chunk writes h_T only after its look-back met an
//     INCLUSIVE flag, which every chunk publishes only after it met one
//     itself, down to chunk 0's. So every read of h0 comes before the write
//     of h_T (release by the writer's flag store, acquire by the reader's
//     load).
//   - Ragged sizes. Steps past T are the identity (a = 1, b = 0) and write
//     nothing. A W that is not a multiple of VEC, or unaligned inputs, take
//     the scalar path (element loads and stores, masked channels).
//   - Numbers. a_t and b_t are the sequential body's to the bit; the
//     composition regroups products and sums, within 1e-5 of the plain
//     version (ref.rglru_scan_chunked_plain mirrors the arithmetic). The
//     look-back may group maps differently from run to run.
//   - Time (PERF.md, scan_phases.py): about 0.09 ms at the prefill shape
//     against the 0.031 ms bound: staging about 0.028 ms, pass 1 0.012, the
//     carry 0.045, pass 2 0.008. The carry is the wait on predecessors and
//     the round trips of publishing: each CTA holds its SM slot through
//     them, over 3.2 waves of CTAs. Reading 32 predecessors' flags at once
//     did not shorten it, so the walk is not what costs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;   // sequential body: threads (channels) per CTA
constexpr int U = 16;    // sequential body: time steps per chunk
constexpr int CL = 32;   // chunked body: lanes per quarter
constexpr int NQ = 4;    // chunked body: quarters per chunk
constexpr int NTC = CL * NQ;
constexpr int MAX_CHUNK = 64;   // chunk * 2 KB of staging <= 128 KB

constexpr int FLAG_AGGREGATE = 1;
constexpr int FLAG_INCLUSIVE = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// -8 * softplus(a_log[c]), softplus as jax.nn.softplus computes it:
// logaddexp(x, 0)
__device__ __forceinline__ float decay_coef(const void* a_log, int alog_bf16,
                                            int c) {
  const float al =
      alog_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a_log)[c])
                : static_cast<const float*>(a_log)[c];
  const float decay = __fadd_rn(fmaxf(al, 0.f), log1pf(expf(-fabsf(al))));
  return __fmul_rn(-8.f, decay);
}

// a_t and b_t of one step, in the plain version's order
__device__ __forceinline__ void step_terms(float coef, float r, float i,
                                           float x, float& a, float& b) {
  a = expf(__fmul_rn(coef, r));
  const float s = sqrtf(fmaxf(__fsub_rn(1.f, __fmul_rn(a, a)), 0.f));
  b = __fmul_rn(s, __fmul_rn(i, x));
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
  const float coef = decay_coef(a_log, alog_bf16, c);
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
      float a, bt;
      step_terms(coef, rc[u], ic[u], xc[u], a, bt);
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// Spin until the flag is set (backing off, so that hundreds of spinning
// CTAs do not crowd the L2); the acquire load orders the reads after it.
__device__ __forceinline__ int wait_flag(const int* flag) {
  int f;
  for (;;) {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(f) : "l"(flag) : "memory");
    if (f) return f;
    __nanosleep(64);
  }
}

// Called by the 32 lanes of one warp after each wrote its values: after the
// warp barrier, lane 0's release store orders every lane's writes before the
// flag (the pattern of CUTLASS's semaphores, with bar.sync in place of
// bar.warp.sync).
__device__ __forceinline__ void publish(int* flag, int value, int lane) {
  __syncwarp();
  if (lane == 0)
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
                 :: "l"(flag), "r"(value) : "memory");
}

// flags [B * n_wblk * n_chunks] and *ticket are zero at launch; pairs holds
// three [B, n_chunks, W] fp32 arrays: the AGGREGATE maps' A and E, and the
// INCLUSIVE end states.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(NTC)
rglru_chunk_kernel(const T* __restrict__ x, const T* __restrict__ gr,
                   const T* __restrict__ gi, const void* __restrict__ a_log,
                   int alog_bf16, const float* h0, float* __restrict__ y,
                   float* h_out, int* ticket, int* flags, float* pairs, int B,
                   int T_, int W, int L, int n_chunks, int n_wblk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = CL * VEC;  // channels per CTA
  // [4 planes][L][CL] x 16 B: x, r, i staged in planes 0-2, then a_t and
  // b_t written over them
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ float qa[NQ][CH], qe[NQ][CH];  // the quarters' maps
  __shared__ float carry[CH];               // h at the start of the chunk
  __shared__ int s_ticket;

  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket, 1);
  __syncthreads();
  const int per_chunk = B * n_wblk;
  const int chunk = s_ticket / per_chunk;
  const int b = (s_ticket % per_chunk) / n_wblk;
  const int wb = s_ticket % n_wblk;
  const int lane = threadIdx.x % CL, q = threadIdx.x / CL;
  const int c0 = wb * CH + lane * VEC;  // this thread's first channel
  const int t0 = chunk * L;
  const int sub = L / NQ;
  const int j0 = q * sub;                          // first step of the quarter
  const int nj = max(0, min(sub, T_ - t0 - j0));   // its steps inside T
  const T* src[3] = {x, gr, gi};
  // this thread's 16 bytes of plane p at step j; the lanes of a warp touch
  // 512 consecutive bytes, no bank conflict
  auto plane = [&](int p, int j) {
    return stage + ((size_t)(p * L + j) * CL + lane) * 16;
  };
  auto slot = [&](int input, int j) { return reinterpret_cast<T*>(plane(input, j)); };
  auto staged = [&](int input, int j) {
    return *reinterpret_cast<const uint4*>(plane(input, j));
  };

  // stage this thread's inputs
  for (int j = 0; j < nj; ++j) {
    const size_t off = ((size_t)b * T_ + t0 + j0 + j) * W + c0;
#pragma unroll
    for (int in = 0; in < 3; ++in) {
      if (VECTOR) {
        if (c0 < W) cp_async16(slot(in, j0 + j), src[in] + off);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          slot(in, j0 + j)[e] = c0 + e < W ? src[in][off + e] : T(0.f);
      }
    }
  }
  float coef[VEC];  // while the copies are in flight
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    coef[e] = c0 + e < W ? decay_coef(a_log, alog_bf16, c0 + e) : 0.f;
  if (VECTOR) asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");

  // pass 1: the quarter's map
  float A[VEC], E[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) A[e] = 1.f, E[e] = 0.f;
  for (int j = 0; j < nj; ++j) {
    const uint4 xv = staged(0, j0 + j), rv = staged(1, j0 + j),
                iv = staged(2, j0 + j);
    const T* xs = reinterpret_cast<const T*>(&xv);
    const T* rs = reinterpret_cast<const T*>(&rv);
    const T* is = reinterpret_cast<const T*>(&iv);
    float a[VEC], bt[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      step_terms(coef[e], to_f(rs[e]), to_f(is[e]), to_f(xs[e]), a[e], bt[e]);
      E[e] = __fadd_rn(__fmul_rn(a[e], E[e]), bt[e]);
      A[e] = __fmul_rn(A[e], a[e]);
    }
    // a_t and b_t for pass 2, over this step's inputs (planes 0 .. 2VEC/4)
#pragma unroll
    for (int g = 0; g < VEC / 4; ++g) {
      *reinterpret_cast<float4*>(plane(g, j0 + j)) =
          make_float4(a[4 * g], a[4 * g + 1], a[4 * g + 2], a[4 * g + 3]);
      *reinterpret_cast<float4*>(plane(VEC / 4 + g, j0 + j)) =
          make_float4(bt[4 * g], bt[4 * g + 1], bt[4 * g + 2], bt[4 * g + 3]);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    qa[q][lane * VEC + e] = A[e];
    qe[q][lane * VEC + e] = E[e];
  }
  __syncthreads();

  // the chunk's map and the carry, by quarter 0 (warp 0) alone; each lane
  // looks back for its own channels
  if (q == 0) {
    const size_t pair = ((size_t)b * n_chunks + chunk) * W;
    const size_t per_array = (size_t)B * n_chunks * W;
    float* agg_a = pairs;
    float* agg_e = pairs + per_array;
    float* incl = pairs + 2 * per_array;
    int* my_flag = flags + ((size_t)b * n_wblk + wb) * n_chunks;
    float ca[VEC], ce[VEC], P[VEC], Q[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      ca[e] = A[e], ce[e] = E[e], P[e] = 1.f, Q[e] = 0.f;
#pragma unroll
      for (int k = 1; k < NQ; ++k) {
        const float ak = qa[k][lane * VEC + e];
        ce[e] = __fadd_rn(__fmul_rn(ak, ce[e]), qe[k][lane * VEC + e]);
        ca[e] = __fmul_rn(ak, ca[e]);
      }
    }
    if (chunk == 0) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (c0 + e >= W) continue;
        const float hin = h0[(size_t)b * W + c0 + e];  // the only read of h0
        carry[lane * VEC + e] = hin;
        incl[pair + c0 + e] = __fadd_rn(__fmul_rn(ca[e], hin), ce[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (c0 + e >= W) continue;
        agg_a[pair + c0 + e] = ca[e];
        agg_e[pair + c0 + e] = ce[e];
      }
      publish(my_flag + chunk, FLAG_AGGREGATE, lane);
      // h_in = P h_end(j) + Q, composing maps until an end state
      for (int j = chunk - 1;; --j) {
        const int f = wait_flag(my_flag + j);
        const size_t pj = ((size_t)b * n_chunks + j) * W + c0;
        if (f == FLAG_INCLUSIVE) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            if (c0 + e >= W) continue;
            const float hin =
                __fadd_rn(__fmul_rn(P[e], __ldcg(incl + pj + e)), Q[e]);
            carry[lane * VEC + e] = hin;
            incl[pair + c0 + e] = __fadd_rn(__fmul_rn(ca[e], hin), ce[e]);
          }
          break;
        }
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (c0 + e >= W) continue;
          Q[e] = __fadd_rn(__fmul_rn(P[e], __ldcg(agg_e + pj + e)), Q[e]);
          P[e] = __fmul_rn(P[e], __ldcg(agg_a + pj + e));
        }
      }
    }
    publish(my_flag + chunk, FLAG_INCLUSIVE, lane);
  }
  __syncthreads();  // carry is written

  // pass 2: rescan the quarter from its carry and write y
  float h[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    h[e] = carry[lane * VEC + e];
    for (int k = 0; k < q; ++k)
      h[e] = __fadd_rn(__fmul_rn(qa[k][lane * VEC + e], h[e]),
                       qe[k][lane * VEC + e]);
  }
  for (int j = 0; j < nj; ++j) {
#pragma unroll
    for (int g = 0; g < VEC / 4; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(plane(g, j0 + j));
      const float4 bt =
          *reinterpret_cast<const float4*>(plane(VEC / 4 + g, j0 + j));
      float* hg = h + 4 * g;
      hg[0] = __fadd_rn(__fmul_rn(a.x, hg[0]), bt.x);
      hg[1] = __fadd_rn(__fmul_rn(a.y, hg[1]), bt.y);
      hg[2] = __fadd_rn(__fmul_rn(a.z, hg[2]), bt.z);
      hg[3] = __fadd_rn(__fmul_rn(a.w, hg[3]), bt.w);
    }
    float* yo = y + ((size_t)b * T_ + t0 + j0 + j) * W + c0;
    if (VECTOR) {
      if (c0 < W) {
#pragma unroll
        for (int e = 0; e < VEC; e += 4)
          *reinterpret_cast<float4*>(yo + e) =
              make_float4(h[e], h[e + 1], h[e + 2], h[e + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (c0 + e < W) yo[e] = h[e];
    }
  }
  if (chunk == n_chunks - 1 && q == NQ - 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (c0 + e < W) h_out[(size_t)b * W + c0 + e] = h[e];
  }
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

template <typename T, bool VECTOR>
cudaError_t launch_chunked(const void* x, const void* gr, const void* gi,
                           const void* a_log, int alog_bf16, const float* h0,
                           float* y, float* h_out, int* flags, float* pairs,
                           int B, int T_, int W, int L, cudaStream_t stream) {
  constexpr int CH = CL * (16 / sizeof(T));
  const int n_chunks = (T_ + L - 1) / L;
  const int n_wblk = (W + CH - 1) / CH;
  const int smem = 4 * L * CL * 16;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_chunk_kernel<T, VECTOR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // flags[0 .. B*n_wblk*n_chunks) and the ticket after them
  int* ticket = flags + (size_t)B * n_wblk * n_chunks;
  rglru_chunk_kernel<T, VECTOR><<<n_chunks * B * n_wblk, NTC, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<const T*>(gi), a_log, alog_bf16, h0, y, h_out, ticket, flags,
      pairs, B, T_, W, L, n_chunks, n_wblk);
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

// The chunked body. chunk: steps per chunk, a multiple of 4 up to 128.
// flags: int32 [B * n_wblk * n_chunks + 1], zero (the last entry is the
// ticket); pairs: fp32 [3, B, n_chunks, W]; n_chunks = ceil(T / chunk),
// n_wblk = ceil(W / (32 * (16 / element size))). vector: W is a multiple of
// 16 bytes of channels and x, r, i are 16-byte aligned.
int rglru_scan_chunked(const void* x, const void* gate_r, const void* gate_i,
                       const void* a_log, const float* h0, float* y,
                       float* h_out, int* flags, float* pairs, int B, int T,
                       int W, int dtype, int alog_dtype, int chunk, int vector,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((alog_dtype != 0 && alog_dtype != 1) || chunk < NQ || chunk % NQ ||
      chunk > MAX_CHUNK)
    return (int)cudaErrorInvalidValue;
#define RGLRU_CHUNKED(TYPE, VEC_OK)                                         \
  return (int)launch_chunked<TYPE, VEC_OK>(x, gate_r, gate_i, a_log,        \
                                           alog_dtype, h0, y, h_out, flags, \
                                           pairs, B, T, W, chunk, st)
  if (dtype == 0) {
    if (vector) RGLRU_CHUNKED(float, true);
    RGLRU_CHUNKED(float, false);
  }
  if (dtype == 1) {
    if (vector) RGLRU_CHUNKED(__nv_bfloat16, true);
    RGLRU_CHUNKED(__nv_bfloat16, false);
  }
#undef RGLRU_CHUNKED
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
