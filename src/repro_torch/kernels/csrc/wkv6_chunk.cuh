// The matrix passes of the chunked WKV (wkv6_chunk.cu) that the WKV
// backward (K3b, wkv6_bwd.cu) launches, on chunks of 64 steps. Each returns
// the first cudaError_t of its launches. dtype (r, k, v): 0 = fp32, 1 =
// bf16; w, dy and the scratch are fp32; vec: hd is a multiple of 8 and the
// [B,T,H,hd] inputs are 16-byte aligned. starts, ends: fp32
// [B, H, ceil(T/64), 64, 64]; decay: fp32 [B, H, ceil(T/64), 64].
#pragma once

#include <cuda_runtime.h>

namespace wkv6_chunk {

// each chunk's start state S_c into starts and its decay D_c into decay (the
// forward's passes 1-2); S_T into state_out unless it is null
cudaError_t states(const void* k, const void* v, const float* w,
                   const float* state, float* state_out, float* starts,
                   float* decay, int B, int T, int H, int hd, int dtype,
                   bool vec, cudaStream_t stream);

// each chunk's end cotangent G_{c+1} into ends (G_n = ds_T), ds0 = G_0,
// from the decays that states() wrote: the cotangent summaries, then the
// reverse carry
cudaError_t cotangents(const void* r, const float* dy, const float* w,
                       const float* ds_T, float* ds0, float* ends,
                       const float* decay, int B, int T, int H, int hd,
                       int dtype, bool vec, cudaStream_t stream);

}  // namespace wkv6_chunk
