// Fused overlap-save FIR over planar (channels, t) float32 (B8): each
// segment's forward transform, tap multiply and inverse transform in one
// block's shared memory, nfft <= 16384.
//
// Replaces digital_signal_processsing_tpu/ops/fft_mxu.py _fused_kernel, which
// runs the DFT as (A, 128) matmuls on the TPU's matrix unit in VMEM. Here the
// transform is a radix-4 FFT (fft.cuh) in plain float32.
//
// y[c, n] = sum_j h[j] x[c, n - j],  x[c, < 0] = 0.
//
// Row r of the flattened (channels, segments) grid keeps outputs
// [s*block, (s+1)*block) of its channel and transforms the nfft samples from
// s*block - (k-1) on, reading zeros outside [0, t): the k-1 halo is re-read
// from device memory, so blocks need no carry and run in any order. The
// taps are real, so IFFT(FFT(a + i*b) * H) = (a*h) + i*(b*h): block p
// transforms rows 2p and 2p+1 together as a + i*b and writes the real part
// to the first and the imaginary part to the second. The samples load in
// natural order, the decimation-in-frequency FFT leaves the spectrum in
// bit-reversed order, the product takes H (the taps' spectrum, computed once
// in float64 by the wrapper and stored in bit-reversed order), and the
// decimation-in-time inverse returns to natural order for the store
// (fft.cuh). nfft complex values sit in place in shared memory (with
// fft.cuh's padding): 136 KB at nfft 16384; 32768 would need 272 KB, past
// the 227 KB a block may have (the limit of B8; B9 takes longer transforms).
//
// What bounds it on the H100: by the work, memory bytes (x read once, y
// written once, 8 bytes an output; the 5 N log2 N flops of each transform
// are below that at 66.9 TFLOP/s fp32). By this design, shared memory: each
// radix-4 pass reads and writes every point (16 bytes a point, 7 passes a
// transform at nfft 16384, at 128 bytes a clock an SM), about 3x the bound
// by bytes. Radix-4 passes halved that traffic and the barriers against
// radix-2 stages; longer radices held in registers would cut it further.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "fft.cuh"

namespace dsp {

__global__ void __launch_bounds__(1024)
fused_fir_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const float2* __restrict__ tw, const float2* __restrict__ H, long long t,
                 long long rows, long long nb, long long k, long long block, int logn) {
  extern __shared__ float2 buf[];
  const int n = 1 << logn;
  const long long r0 = 2LL * blockIdx.x;
  const bool has_b = r0 + 1 < rows;
  const Segment a = segment(r0, nb, k, block);
  const Segment b = segment(has_b ? r0 + 1 : r0, nb, k, block);
  const float* xa = x + a.ch * t;
  const float* xb = x + b.ch * t;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float va = sample(xa, a.first + i, t);
    const float vb = has_b ? sample(xb, b.first + i, t) : 0.0f;
    buf[slot(0, i, logn)] = make_float2(va, vb);
  }
  __syncthreads();
  fft_dif(buf, logn, 1, tw, 1);
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int i = slot(0, f, logn);
    buf[i] = cmul(buf[i], H[f]);
  }
  __syncthreads();
  ifft_dit(buf, logn, 1, tw, 1);
  const float scale = 1.0f / static_cast<float>(n);
  const int kept = static_cast<int>(block);
  const int lead = static_cast<int>(k - 1);
  float* ya = y + a.ch * t;
  float* yb = y + b.ch * t;
  for (int j = threadIdx.x; j < kept; j += blockDim.x) {
    const float2 v = buf[slot(0, lead + j, logn)];
    const long long oa = a.out + j;
    if (oa < t) ya[oa] = v.x * scale;
    if (has_b) {
      const long long ob = b.out + j;
      if (ob < t) yb[ob] = v.y * scale;
    }
  }
}

}  // namespace dsp

// x, y: (channels, t) float32, contiguous; tw: nfft complex64 twiddles
// exp(-2*pi*i*q/nfft); H: the taps' nfft-point spectrum in bit-reversed order,
// H[f] = spectrum[bitrev(f)], complex64.
extern "C" int dsp_fused_fir(const float* x, float* y, const void* tw, const void* H, int64_t t,
                             int64_t channels, int64_t k, int64_t block, int64_t log2n,
                             int64_t threads, int64_t smem_bytes, void* stream) {
  if (t <= 0 || channels <= 0 || k < 1 || block < 1 || log2n < 1 || log2n > 14 ||
      block + k - 1 > (int64_t{1} << log2n) || threads < 32 || threads > 1024 ||
      smem_bytes != 8 * int64_t{dsp::line_slots(static_cast<int>(log2n))}) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nb = (t + block - 1) / block;
  const int64_t rows = channels * nb;
  const int64_t pairs = (rows + 1) / 2;
  if (pairs > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[dsp::kMaxDevices] = {};
  cudaError_t err = dsp::allow_smem(dsp::fused_fir_kernel, allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dsp::fused_fir_kernel<<<static_cast<unsigned>(pairs), static_cast<unsigned>(threads),
                          static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream)>>>(
      x, y, static_cast<const float2*>(tw), static_cast<const float2*>(H), t, rows, nb, k,
      block, static_cast<int>(log2n));
  return static_cast<int>(cudaGetLastError());
}
