// Exact-schedule cubic Farrow resampling for any rational rate up/down (B21).
//
// Replaces digital_signal_processsing_tpu/ops/farrow.py
// _farrow_segment_kernel. Output m of channel c sits at ext position
// num = 4*up + m*down (ext = [0, 0, 0, 0, x]):
//
//   n  = floor(num / up),   mu = (num mod up) * (1/up)   (float32)
//   y  = v0 + mu*(v1 + mu*(v2 + mu*v3))
//
// where v0..v3 are the Farrow power-form combinations of ext[n-1 .. n+2]
// (farrow.py:493-498).
//
// The TPU kernel prefetches a host-side segment schedule as scalars, pulls
// each output's four stream values out of a VMEM window with one-hot
// matmuls, fixes up a float reciprocal for the division and buckets shapes
// so that one compile serves many rates: answers to slow TPU gathers and
// per-rate compiles. Here one thread computes one output: it reads its four
// neighbours, which are monotone and nearly contiguous across a warp,
// straight from device memory, and evaluates the polynomial in registers.
// The four v streams are never materialised (that would read 4x the bytes).
//
// Integer arithmetic: a block owns a segment of `segment` outputs of one
// channel and computes its one int64 start, n0 = floor(num0 / up) and
// rho0 = num0 mod up, once (64-bit division is a software routine here).
// Inside the segment the phase rho = rho0 + i*down stays below 2^31 (the
// wrapper's envelope, 1024*up + segment*down < 2^31), so n = n0 + rho / up
// and mu's numerator rho mod up come from exact 32-bit arithmetic.
//
// What bounds it on the H100: memory bytes, 4 bytes read a sample and 4
// written an output; the 20 or so float32 operations an output are far below
// 67 TFLOP/s.

#include <cstdint>

#include <cuda_runtime.h>

namespace dsp {

constexpr int kFarrowThreads = 256;

static __device__ __forceinline__ float ext_sample(const float* __restrict__ xc, long long j,
                                                   long long t) {
  const long long i = j - 4;  // ext[j] = x[j - 4], zeros before the stream
  return (i >= 0 && i < t) ? __ldg(xc + i) : 0.0f;
}

__global__ void __launch_bounds__(kFarrowThreads)
farrow_kernel(const float* __restrict__ x, float* __restrict__ y, long long t, long long m_out,
              long long up, long long down, int segment, float inv_up) {
  __shared__ long long n0_s;
  __shared__ unsigned rho0_s;
  const long long m0 = static_cast<long long>(blockIdx.x) * segment;
  if (threadIdx.x == 0) {
    const long long num0 = 4 * up + m0 * down;
    const long long n0 = num0 / up;
    n0_s = n0;
    rho0_s = static_cast<unsigned>(num0 - n0 * up);
  }
  __syncthreads();
  const long long c = blockIdx.y;
  const float* xc = x + c * t;
  float* yc = y + c * m_out;
  const unsigned uup = static_cast<unsigned>(up);
  const unsigned udown = static_cast<unsigned>(down);
  const float third = 1.0f / 3.0f, sixth = 1.0f / 6.0f;
  for (int i = threadIdx.x; i < segment; i += blockDim.x) {
    const long long m = m0 + i;
    if (m >= m_out) break;
    const unsigned rho = rho0_s + static_cast<unsigned>(i) * udown;
    const unsigned jj = rho / uup;
    const unsigned mu_num = rho - jj * uup;
    const long long n = n0_s + jj;
    const float xm1 = ext_sample(xc, n - 1, t);
    const float x0 = ext_sample(xc, n, t);
    const float x1 = ext_sample(xc, n + 1, t);
    const float x2 = ext_sample(xc, n + 2, t);
    const float v0 = x0;
    const float v1 = -third * xm1 - 0.5f * x0 + x1 - sixth * x2;
    const float v2 = 0.5f * (xm1 + x1) - x0;
    const float v3 = sixth * (x2 - xm1) + 0.5f * (x0 - x1);
    const float mu = static_cast<float>(mu_num) * inv_up;
    yc[m] = v0 + mu * (v1 + mu * (v2 + mu * v3));
  }
}

}  // namespace dsp

// x: (channels, t) float32; y: (channels, m_out) float32, both contiguous.
// inv_up: 1/up rounded to float32.
extern "C" int dsp_farrow(const float* x, float* y, int64_t t, int64_t channels, int64_t m_out,
                          int64_t up, int64_t down, int64_t segment, float inv_up, void* stream) {
  if (t < 4 || channels < 1 || channels > 65535 || m_out < 1 || up < 1 || down < 1 ||
      segment < 1 || segment % 128 != 0 || 1024 * up + segment * down >= (int64_t{1} << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (m_out + segment - 1) / segment;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(channels));
  dsp::farrow_kernel<<<grid, dsp::kFarrowThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, t, m_out, up, down, static_cast<int>(segment), inv_up);
  return static_cast<int>(cudaGetLastError());
}
