// Complex float32 helpers and the segment addressing of the fused
// overlap-save kernels (B8, fused_fir.cu; B9, fused_fir3.cu), shared with
// the register-resident Stockham passes (stockham.cuh).
#pragma once

#include <cuda_runtime.h>

namespace dsp {

static __device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// The segment of row r of the flattened (channels, segments) grid.
struct Segment {
  long long ch;     // its channel: samples at ch * t
  long long first;  // s*block - (k-1): signal index of transform point 0
  long long out;    // s*block: signal index of the first kept output
};

static __device__ __forceinline__ Segment segment(long long r, long long nb, long long k,
                                                  long long block) {
  const long long ch = r / nb;
  const long long s = r - ch * nb;
  return {ch, s * block - (k - 1), s * block};
}

// Sample g of a channel, zero outside [0, t).
static __device__ __forceinline__ float sample(const float* xc, long long g, long long t) {
  return (g >= 0 && g < t) ? xc[g] : 0.0f;
}

}  // namespace dsp
