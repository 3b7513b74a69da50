// Overlap-save FIR past B8's envelope (B9): nfft = n1 * n2 up to 2^20 by the
// four-step FFT, in three launches through a scratch in device memory.
//
// Replaces digital_signal_processsing_tpu/ops/fft_mxu.py _fused3_kernel, which
// splits the DFT in three factors of matmuls and lane slices held in VMEM.
//
// y[c, n] = sum_j h[j] x[c, n - j],  x[c, < 0] = 0.
//
// Segments and pairs as in B8 (fused_fir.cu): row r keeps [s*block,
// (s+1)*block) and transforms the nfft samples from s*block - (k-1) on;
// rows 2p and 2p+1 ride one complex transform as a + i*b. A point of the
// transform is n = n2*i1 + i2 (i1 < n1, i2 < n2) in time and
// f = f1 + n1*f2 in frequency, and
//
//   X[f1 + n1 f2] = sum_i2 W_n2^(i2 f2) W_N^(i2 f1) sum_i1 x[n2 i1 + i2] W_n1^(i1 f1).
//
//   1. fir3_columns   for each i2: the n1-point FFT over i1 of the samples
//                     read straight from x (halo and zeros as in B8), times
//                     W_N^(i2 f1); scratch[f1][i2]
//   2. fir3_rows      for each f1: the n2-point FFT over i2, the product with
//                     the taps' spectrum (permuted by the wrapper to
//                     [f1][bitrev(f2)]), the inverse n2-point FFT, times
//                     W_N^-(i2 f1); scratch[f1][i2] in place
//   3. fir3_outputs   for each i2: the inverse n1-point FFT over f1, scaled
//                     by 1/N, the kept points written to y
//
// The forward line transforms leave their points in bit-reversed order and
// the inverse ones take them so (fft.cuh): pass 1 writes point pos to row
// f1 = bitrev(pos) of the scratch, pass 3 reads it back from there, and
// pass 2's product reads the spectrum in the order the wrapper stored it.
// Every twiddle exponent i2*f1 is an exact integer below N (i2 < n2,
// f1 < n1), an index into the float64-made table of W_N: no phase is
// accumulated in float32. A block of the column passes takes g1 neighbouring
// i2 (runs of g1 samples in x and g1 points in the scratch), a block of the
// row pass g2 whole rows: 8192 points, 68-69 KB of shared memory with
// fft.cuh's padding. The pairs go in waves that bound the scratch (the
// wrapper sizes it); all three launches of a wave run, in stream order,
// before the next wave reuses it.
//
// What bounds it on the H100: by the work, memory bytes of x and y, as B8.
// By this design, the scratch: each point is written once by pass 1, read
// and written by pass 2 and read by pass 3 (32 bytes a complex point, 16 an
// output sample at block = nfft - k + 1 near nfft), plus B8's shared-memory
// stages. A single launch with thread-block clusters and distributed shared
// memory would keep the scratch on chip; that is later work.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "fft.cuh"

namespace dsp {

constexpr int kFir3Threads = 256;

struct Fir3 {
  long long t, rows, nb, k, block;
  int logn1, logn2, logg1, logg2;
  long long pair0;  // first pair of this wave
};

__global__ void __launch_bounds__(kFir3Threads)
fir3_columns(const float* __restrict__ x, float2* __restrict__ scratch,
             const float2* __restrict__ tw, Fir3 p) {
  extern __shared__ float2 buf[];  // g1 lines of n1 points
  const int n1 = 1 << p.logn1, n2 = 1 << p.logn2, g1 = 1 << p.logg1;
  const long long r0 = 2 * (p.pair0 + blockIdx.y);
  const bool has_b = r0 + 1 < p.rows;
  const Segment a = segment(r0, p.nb, p.k, p.block);
  const Segment b = segment(has_b ? r0 + 1 : r0, p.nb, p.k, p.block);
  const float* xa = x + a.ch * p.t;
  const float* xb = x + b.ch * p.t;
  const int i2_0 = blockIdx.x * g1;
  for (int e = threadIdx.x; e < (g1 << p.logn1); e += blockDim.x) {
    const int l = e & (g1 - 1);
    const int i1 = e >> p.logg1;
    const long long n = static_cast<long long>(i1) * n2 + i2_0 + l;
    const float va = sample(xa, a.first + n, p.t);
    const float vb = has_b ? sample(xb, b.first + n, p.t) : 0.0f;
    buf[slot(l, i1, p.logn1)] = make_float2(va, vb);
  }
  __syncthreads();
  fft_dif(buf, p.logn1, g1, tw, n2);
  float2* s = scratch + static_cast<long long>(blockIdx.y) * (n1 * n2);
  for (int e = threadIdx.x; e < (g1 << p.logn1); e += blockDim.x) {
    const int l = e & (g1 - 1);
    const int pos = e >> p.logg1;
    const int f1 = bit_reverse(pos, p.logn1);
    const int i2 = i2_0 + l;
    s[static_cast<long long>(f1) * n2 + i2] = cmul(buf[slot(l, pos, p.logn1)], tw[i2 * f1]);
  }
}

__global__ void __launch_bounds__(kFir3Threads)
fir3_rows(float2* __restrict__ scratch, const float2* __restrict__ tw,
          const float2* __restrict__ Hp, Fir3 p) {
  extern __shared__ float2 buf[];  // g2 lines of n2 points
  const int n1 = 1 << p.logn1, n2 = 1 << p.logn2, g2 = 1 << p.logg2;
  float2* s = scratch + static_cast<long long>(blockIdx.y) * (n1 * n2);
  const int f1_0 = blockIdx.x * g2;
  const int count = g2 << p.logn2;
  // this block's rows are contiguous in the scratch and in Hp: [f1_0 * n2, +count)
  float2* rows = s + static_cast<long long>(f1_0) * n2;
  const float2* h = Hp + static_cast<long long>(f1_0) * n2;
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    buf[slot(e >> p.logn2, e & (n2 - 1), p.logn2)] = rows[e];
  }
  __syncthreads();
  fft_dif(buf, p.logn2, g2, tw, n1);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int i = slot(e >> p.logn2, e & (n2 - 1), p.logn2);
    buf[i] = cmul(buf[i], h[e]);
  }
  __syncthreads();
  ifft_dit(buf, p.logn2, g2, tw, n1);
  for (int e = threadIdx.x; e < count; e += blockDim.x) {
    const int l = e >> p.logn2;
    const int i2 = e & (n2 - 1);
    rows[e] = cmul_conj(buf[slot(l, i2, p.logn2)], tw[i2 * (f1_0 + l)]);
  }
}

__global__ void __launch_bounds__(kFir3Threads)
fir3_outputs(const float2* __restrict__ scratch, float* __restrict__ y,
             const float2* __restrict__ tw, Fir3 p) {
  extern __shared__ float2 buf[];  // g1 lines of n1 points
  const int n1 = 1 << p.logn1, n2 = 1 << p.logn2, g1 = 1 << p.logg1;
  const long long r0 = 2 * (p.pair0 + blockIdx.y);
  const bool has_b = r0 + 1 < p.rows;
  const Segment a = segment(r0, p.nb, p.k, p.block);
  const Segment b = segment(has_b ? r0 + 1 : r0, p.nb, p.k, p.block);
  float* ya = y + a.ch * p.t;
  float* yb = y + b.ch * p.t;
  const float2* s = scratch + static_cast<long long>(blockIdx.y) * (n1 * n2);
  const int i2_0 = blockIdx.x * g1;
  for (int e = threadIdx.x; e < (g1 << p.logn1); e += blockDim.x) {
    const int l = e & (g1 - 1);
    const int pos = e >> p.logg1;  // holds f1 = bitrev(pos): the inverse takes bit-reversed order
    const int f1 = bit_reverse(pos, p.logn1);
    buf[slot(l, pos, p.logn1)] = s[static_cast<long long>(f1) * n2 + i2_0 + l];
  }
  __syncthreads();
  ifft_dit(buf, p.logn1, g1, tw, n2);
  const float scale = 1.0f / static_cast<float>(static_cast<long long>(n1) * n2);
  const long long lead = p.k - 1;
  for (int e = threadIdx.x; e < (g1 << p.logn1); e += blockDim.x) {
    const int l = e & (g1 - 1);
    const int i1 = e >> p.logg1;
    const long long n = static_cast<long long>(i1) * n2 + i2_0 + l;
    if (n < lead || n >= lead + p.block) continue;
    const float2 v = buf[slot(l, i1, p.logn1)];
    const long long oa = a.out + (n - lead);
    if (oa < p.t) ya[oa] = v.x * scale;
    if (has_b) {
      const long long ob = b.out + (n - lead);
      if (ob < p.t) yb[ob] = v.y * scale;
    }
  }
}

static int log2_exact(int64_t v) {
  int l = 0;
  while ((int64_t{1} << l) < v) ++l;
  return (int64_t{1} << l) == v ? l : -1;
}

}  // namespace dsp

// x, y: (channels, t) float32, contiguous; scratch: wave_pairs * n1 * n2
// complex64; tw: the N = n1*n2 twiddles exp(-2*pi*i*q/N), complex64; Hp: the
// taps' N-point spectrum permuted to Hp[f1 * n2 + q] = H[f1 + n1 * bitrev(q)].
extern "C" int dsp_fused_fir3(const float* x, float* y, void* scratch, const void* tw,
                              const void* Hp, int64_t t, int64_t channels, int64_t k,
                              int64_t block, int64_t log2n1, int64_t log2n2, int64_t g1,
                              int64_t g2, int64_t wave_pairs, int64_t threads,
                              int64_t smem_bytes, void* stream) {
  const int logg1 = dsp::log2_exact(g1), logg2 = dsp::log2_exact(g2);
  if (t <= 0 || channels <= 0 || k < 1 || block < 1 || log2n1 < 1 || log2n1 > 10 ||
      log2n2 < 1 || log2n2 > 10 || block + k - 1 > (int64_t{1} << (log2n1 + log2n2)) ||
      logg1 < 0 || logg2 < 0 || g1 > (int64_t{1} << log2n2) || g2 > (int64_t{1} << log2n1) ||
      threads != dsp::kFir3Threads || wave_pairs < 1 || wave_pairs > 65535 ||
      smem_bytes < 8 * g1 * dsp::line_slots(static_cast<int>(log2n1)) ||
      smem_bytes < 8 * g2 * dsp::line_slots(static_cast<int>(log2n2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nb = (t + block - 1) / block;
  const int64_t rows = channels * nb;
  const int64_t pairs = (rows + 1) / 2;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto smem = static_cast<size_t>(smem_bytes);
  auto* sc = static_cast<float2*>(scratch);
  const auto* w = static_cast<const float2*>(tw);
  const auto* h = static_cast<const float2*>(Hp);
  static int allowed_c[dsp::kMaxDevices] = {};
  static int allowed_r[dsp::kMaxDevices] = {};
  static int allowed_o[dsp::kMaxDevices] = {};
  cudaError_t err;
  if ((err = dsp::allow_smem(dsp::fir3_columns, allowed_c, static_cast<int>(smem))) !=
          cudaSuccess ||
      (err = dsp::allow_smem(dsp::fir3_rows, allowed_r, static_cast<int>(smem))) != cudaSuccess ||
      (err = dsp::allow_smem(dsp::fir3_outputs, allowed_o, static_cast<int>(smem))) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  dsp::Fir3 p{t, rows, nb, k, block, static_cast<int>(log2n1), static_cast<int>(log2n2),
              logg1, logg2, 0};
  const unsigned col_blocks = static_cast<unsigned>((int64_t{1} << log2n2) / g1);
  const unsigned row_blocks = static_cast<unsigned>((int64_t{1} << log2n1) / g2);
  for (int64_t p0 = 0; p0 < pairs; p0 += wave_pairs) {
    const auto wave = static_cast<unsigned>(pairs - p0 < wave_pairs ? pairs - p0 : wave_pairs);
    p.pair0 = p0;
    dsp::fir3_columns<<<dim3(col_blocks, wave), dsp::kFir3Threads, smem, s>>>(x, sc, w, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dsp::fir3_rows<<<dim3(row_blocks, wave), dsp::kFir3Threads, smem, s>>>(sc, w, h, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    dsp::fir3_outputs<<<dim3(col_blocks, wave), dsp::kFir3Threads, smem, s>>>(sc, y, w, p);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// What the compiler gave B9's launch `which` (0 columns, 1 rows, 2 outputs)
// with `smem_bytes` of dynamic shared memory: registers a thread, local
// bytes a thread, shared bytes a block (static and dynamic), blocks an SM,
// threads a block (5 int64 in out).
extern "C" int dsp_fused_fir3_attrs(int64_t which, int64_t smem_bytes, int64_t* out) {
  const void* k = which == 0   ? reinterpret_cast<const void*>(dsp::fir3_columns)
                  : which == 1 ? reinterpret_cast<const void*>(dsp::fir3_rows)
                  : which == 2 ? reinterpret_cast<const void*>(dsp::fir3_outputs)
                               : nullptr;
  if (k == nullptr || smem_bytes < 0 || smem_bytes > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = static_cast<int>(smem_bytes);
  cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, k)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, dsp::kFir3Threads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  out[2] = static_cast<int64_t>(a.sharedSizeBytes) + bytes;
  out[3] = blocks;
  out[4] = dsp::kFir3Threads;
  return 0;
}
