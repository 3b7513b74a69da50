// Polyphase filter-bank analysis: branch FIR + N-point channel DFT in one
// block, from the raw stream (B19) or from a commutated (M, N) tensor (B20).
//
// B19 replaces digital_signal_processsing_tpu/ops/channelizer.py
// _fused_pfb_raw_kernel, B20 replaces _fused_pfb_kernel there. Both compute,
// for output row m and channel k,
//
//   v[m, q] = sum_{r<P} hq[r, q] * in(m - d*r, q),   in(< 0, q) = 0
//   Y[m, k] = sum_q v[m, q] * exp(sign * 2*pi*i * q*k / N)
//
// with in(m, q) = x[N*m - q] (zero before the stream) for B19, the
// reverse-running commutator read straight from the stream, and
// in(m, q) = u[m, q] for B20. d is the dilation (2 for the oversampled bank).
//
// The TPU kernels' lane rolls, per-lane tap tables, block-diagonal DFT
// matmuls and the raw-row carry across the sequential grid keep the
// commutator out of (8, 128) tiles and the DFT on the matrix unit. None of
// that is needed here. A block owns `rows` output rows. Thread (row, q)
// reads its P branch inputs from device memory: neighbouring threads read
// neighbouring addresses, and the look-back of (P-1)*d rows, which the
// previous block reads too, comes from L2. So blocks carry nothing and run
// in any order. The block keeps one line of v a row in shared memory:
//
// - N a power of two, 2..8192: complex lines (fft.cuh's padded slots), the
//   radix-4 decimation-in-frequency FFT of fft.cuh (B8's), which leaves
//   F = FFT(v) in bit-reversed order; the store reads F[k] at position
//   bitrev(k). v is real, so Y = conj(F) for sign +1 and F for sign -1.
// - any other N (B20's `fused` route, e.g. 48 or 96), and N = 1: real lines
//   (one float of padding a line) and a direct DFT, with the exponent q*k
//   kept exact modulo N and the twiddle read from the same table.
//
// The store writes the layout the caller returns: (M, N) planes, (N, M)
// planes or (N, M) complex64, through the strides sk (channel) and sm (row),
// with the row index fastest across threads for the channel-major layouts.
//
// What bounds it on the H100: by the work, memory bytes (B19: 4 bytes read
// and 8 written a sample; the FFT's 5 log2 N flops a complex point are about
// 50 a sample at N = 1024, far below 67 TFLOP/s fp32). By this design, the
// shared-memory passes of the FFT (one read and one write of each point a
// radix-4 pass) and, for the direct DFT, its N multiply-adds an output.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "fft.cuh"

namespace dsp {

constexpr int kPfbThreads = 256;
constexpr int kPfbMaxN = 8192;

struct PfbArgs {
  const float* src;  // B19: the (T,) stream; B20: the (M, N) branch inputs
  const float* hq;   // (P, N) branch taps
  const float2* tw;  // N twiddles exp(-2*pi*i*q/N)
  float* re;
  float* im;
  long long m;   // output rows
  long long sk;  // output stride of channel k, in floats
  long long sm;  // output stride of row m, in floats
  int n, logn, p, d, rows;
  float im_sign;  // -sign: Y = conj(F) for sign +1, F for sign -1
  int m_fastest;  // channel-major store: threads walk rows first
};

template <bool kRaw>
static __device__ __forceinline__ float branch_input(const float* __restrict__ src, long long mr,
                                                     int n, int q) {
  if (kRaw) {
    const long long i = mr * n - q;
    return i >= 0 ? __ldg(src + i) : 0.0f;
  }
  return __ldg(src + mr * n + q);
}

// v[m, q]: the taps in order r = 0..P-1, their loads issued a group of
// kTapGroup at a time before the multiply-adds, so that a group's loads are
// in flight together rather than each waiting on the last.
constexpr int kTapGroup = 8;

template <bool kRaw>
static __device__ __forceinline__ float branch_fir(const PfbArgs& a, long long m, int q) {
  float acc = 0.0f;
  for (int r0 = 0; r0 < a.p; r0 += kTapGroup) {
    float xv[kTapGroup], hv[kTapGroup];
#pragma unroll
    for (int j = 0; j < kTapGroup; ++j) {
      const int r = r0 + j;
      const long long mr = m - static_cast<long long>(a.d) * r;
      xv[j] = (r < a.p && mr >= 0) ? branch_input<kRaw>(a.src, mr, a.n, q) : 0.0f;
      hv[j] = r < a.p ? __ldg(a.hq + r * a.n + q) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kTapGroup; ++j) acc = fmaf(hv[j], xv[j], acc);  // + 0 past P: exact
  }
  return acc;
}

template <bool kRaw, bool kFft>
__global__ void __launch_bounds__(kPfbThreads) pfb_kernel(PfbArgs a) {
  extern __shared__ float2 buf[];
  float* vbuf = reinterpret_cast<float*>(buf);
  const int vstride = a.n + 1;  // real lines: one float of padding against bank conflicts
  const long long m0 = static_cast<long long>(blockIdx.x) * a.rows;
  const int total = a.rows * a.n;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int g = e / a.n;
    const int q = e - g * a.n;
    const long long m = m0 + g;
    const float acc = m < a.m ? branch_fir<kRaw>(a, m, q) : 0.0f;
    if (kFft) {
      buf[slot(g, q, a.logn)] = make_float2(acc, 0.0f);
    } else {
      vbuf[g * vstride + q] = acc;
    }
  }
  __syncthreads();
  if (kFft) fft_dif(buf, a.logn, a.rows, a.tw, 1);
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int g, k;
    if (a.m_fastest) {
      k = e / a.rows;
      g = e - k * a.rows;
    } else {
      g = e / a.n;
      k = e - g * a.n;
    }
    const long long m = m0 + g;
    if (m >= a.m) continue;
    float2 f;
    if (kFft) {
      f = buf[slot(g, bit_reverse(k, a.logn), a.logn)];
    } else {
      const float* v = vbuf + g * vstride;
      f = make_float2(0.0f, 0.0f);
      int j = 0;  // q*k mod N
      for (int q = 0; q < a.n; ++q) {
        const float2 w = __ldg(a.tw + j);
        f.x = fmaf(v[q], w.x, f.x);
        f.y = fmaf(v[q], w.y, f.y);
        j += k;
        if (j >= a.n) j -= a.n;
      }
    }
    const long long o = k * a.sk + m * a.sm;
    a.re[o] = f.x;
    a.im[o] = a.im_sign * f.y;
  }
}

template <bool kRaw, bool kFft>
static int launch(const PfbArgs& a, long long blocks, int smem_bytes, cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  cudaError_t err = allow_smem(pfb_kernel<kRaw, kFft>, allowed, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfb_kernel<kRaw, kFft><<<static_cast<unsigned>(blocks), kPfbThreads,
                           static_cast<size_t>(smem_bytes), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRaw>
static int launch_pfb(const float* src, const float* hq, const void* tw, float* re, float* im,
                      int64_t m, int64_t n, int64_t p, int64_t d, int64_t sign, int64_t sk,
                      int64_t sm, int64_t rows, int64_t smem_bytes, void* stream) {
  if (m < 1 || n < 1 || n > kPfbMaxN || p < 1 || d < 1 || (sign != 1 && sign != -1) ||
      rows < 1 || rows * n > (int64_t{1} << 20) || sk < 1 || sm < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int logn = 0;
  while ((int64_t{1} << logn) < n) ++logn;
  const bool fft = n >= 2 && (int64_t{1} << logn) == n;
  const int64_t want = fft ? 8 * rows * line_slots(logn) : 4 * rows * (n + 1);
  const int64_t blocks = (m + rows - 1) / rows;
  if (smem_bytes != want || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  PfbArgs a{src, hq, static_cast<const float2*>(tw), re, im, m, sk, sm,
            static_cast<int>(n), logn, static_cast<int>(p), static_cast<int>(d),
            static_cast<int>(rows), -static_cast<float>(sign), sm < sk ? 1 : 0};
  const auto s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(smem_bytes);
  return fft ? launch<kRaw, true>(a, blocks, smem, s) : launch<kRaw, false>(a, blocks, smem, s);
}

}  // namespace dsp

// B19. x: the (m * n,) float32 stream; hq: (p, n) float32; tw: n complex64
// twiddles exp(-2*pi*i*q/n); re, im: outputs, element (row m, channel k) at
// m * sm + k * sk floats (im may point 4 bytes past re for complex64).
extern "C" int dsp_pfb_raw(const float* x, const float* hq, const void* tw, float* re, float* im,
                           int64_t m, int64_t n, int64_t p, int64_t d, int64_t sign, int64_t sk,
                           int64_t sm, int64_t rows, int64_t smem_bytes, void* stream) {
  return dsp::launch_pfb<true>(x, hq, tw, re, im, m, n, p, d, sign, sk, sm, rows, smem_bytes,
                               stream);
}

// B20. u: the (m, n) float32 branch inputs; the rest as for dsp_pfb_raw.
extern "C" int dsp_pfb_branch(const float* u, const float* hq, const void* tw, float* re,
                              float* im, int64_t m, int64_t n, int64_t p, int64_t d,
                              int64_t sign, int64_t sk, int64_t sm, int64_t rows,
                              int64_t smem_bytes, void* stream) {
  return dsp::launch_pfb<false>(u, hq, tw, re, im, m, n, p, d, sign, sk, sm, rows, smem_bytes,
                                stream);
}
