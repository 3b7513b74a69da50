// Fused overlap-save FIR over planar (channels, t) float32 (B8): each
// segment's forward transform, tap multiply and inverse transform in one
// block, nfft <= 16384, the points held in registers.
//
// Replaces digital_signal_processsing_tpu/ops/fft_mxu.py _fused_kernel, which
// runs the DFT as (A, 128) matmuls on the TPU's matrix unit in VMEM. Here the
// transform is a Stockham FFT in plain float32, register-resident.
//
// y[c, n] = sum_j h[j] x[c, n - j],  x[c, < 0] = 0.
//
// Segments. Row r of the flattened (channels, segments) grid keeps outputs
// [s*block, (s+1)*block) of its channel and transforms the N = nfft samples
// from s*block - (k-1) on, reading zeros outside [0, t): the k-1 halo is
// re-read from device memory, so blocks need no carry and run in any order.
// The taps are real, so IFFT(FFT(a + i*b) * H) = (a*h) + i*(b*h): a pair of
// rows 2p and 2p+1 rides one complex transform as a + i*b, the real part
// going to the first and the imaginary part to the second.
//
// The transform: stockham.cuh's register-resident Stockham passes. T = N/P
// threads carry a pair, each holding P points (16, or 32 at N >= 8192):
// thread j holds point j + s*T in v[s]. A plan of two or three passes
// (Plan<> below: 4096 = 16*16*16, 16384 = 16*32*32) exchanging through
// shared memory, so 4096 takes 3 passes and 2 exchanges a transform, 16384
// 3 and 2. The spectrum comes out in natural order in the layout the
// samples went in with, so the tap product needs no exchange: v[s] *=
// H[j + s*T], H in natural order (computed once in float64 by the
// wrapper). The inverse is the same forward transform of the conjugate,
// IFFT(Z) = conj(FFT(conj Z)) / N, so the product writes conj(X*H) and the
// store takes (re, -im) / N. Twiddles are computed with sincospif of exact
// arguments (stockham.cuh).
//
// Shared memory is only the exchange: N points a pair, one pad after every
// 16, so that the writes of the first pass (neighbouring threads R points
// apart) and the later passes' runs of Ns fall on distinct banks (the
// emulation in tests/test_torch_fir.py checks the main plans). Blocks hold
// G pairs, so that a block has at least 256 threads: G = 16 at N = 256, one
// pair from N = 4096. Loads of x and stores of y are coalesced 128-byte
// warp accesses (thread j reads point j + s*T); 16-byte vector loads would
// need a segment start s*block - (k-1) aligned to 4 samples, which k does
// not give in general.
//
// Registers. Every index into v must fold to a constant, or v goes to local
// memory: the butterflies, DFT stages and bit reversals are template
// constants or flat loops of constant trip count, and the loads and stores
// take one base pointer and 32-bit bounds a side. The plan's launch bounds
// give 128 registers a thread from nfft 512 to 4096 (two blocks an SM), 255
// at 8192 (one block of 256 threads), and 128 at 16384, where 512 threads
// hold the pair's 128 KB of points in half the register file and the rest
// spills a little (the compiler's report is in chip_smoke.py's build lines).
//
// What bounds it on the H100: by the work, memory bytes (x read once, y
// written once, 8 bytes an output; the 5 N log2 N flops of each transform
// are below that at 66.9 TFLOP/s fp32). By this design, per pair: its
// registers (one pair in flight an SM at nfft 16384, two at 4096), the
// instructions of the DFTs and twiddles, and two exchanges a transform of
// 16 bytes a point through shared memory at 128 bytes a clock an SM.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "stockham.cuh"

namespace dsp {
namespace b8 {

using namespace stockham;

constexpr int kMaxLog = 14;  // nfft 16384
constexpr int kMinThreads = 256;

// The plan at nfft 2^LOG: points a thread, the radices of its passes (the
// third 0 for two; the smallest first, as the first pass has no twiddles),
// and the blocks an SM its launch bounds ask for (ops/fft_mxu.py B8_PLANS
// mirrors P and the radices).
template <int LOG> struct Plan;
template <> struct Plan<7> { static constexpr int P = 16, R0 = 8, R1 = 16, R2 = 0, B = 3; };
template <> struct Plan<8> { static constexpr int P = 16, R0 = 16, R1 = 16, R2 = 0, B = 3; };
template <> struct Plan<9> { static constexpr int P = 16, R0 = 8, R1 = 8, R2 = 8, B = 2; };
template <> struct Plan<10> { static constexpr int P = 16, R0 = 4, R1 = 16, R2 = 16, B = 2; };
template <> struct Plan<11> { static constexpr int P = 16, R0 = 8, R1 = 16, R2 = 16, B = 2; };
template <> struct Plan<12> { static constexpr int P = 16, R0 = 16, R1 = 16, R2 = 16, B = 2; };
template <> struct Plan<13> { static constexpr int P = 32, R0 = 16, R1 = 16, R2 = 32, B = 1; };
template <> struct Plan<14> { static constexpr int P = 32, R0 = 16, R1 = 32, R2 = 32, B = 1; };

template <int LOG> struct Geometry {
  static constexpr int N = 1 << LOG;
  static constexpr int T = N / Plan<LOG>::P;                            // threads a pair
  static constexpr int G = T >= kMinThreads ? 1 : kMinThreads / T;      // pairs a block
  static constexpr int kThreads = G * T;
  static constexpr int kSlots = N + N / 16;                             // a pair's exchange
  static constexpr int kSmemBytes = 8 * G * kSlots;
};

// The forward DFT of the pair's N points: natural order in v, natural out.
template <int LOG>
static __device__ __forceinline__ void fft(float2 (&v)[Plan<LOG>::P], int j, float2* buf) {
  using Pl = Plan<LOG>;
  stockham::fft<1 << LOG, Pl::P, Pl::R0, Pl::R1, Pl::R2>(v, j, buf);
}

// The offsets n in [0, N) with 0 <= base + n < limit, as [lo, hi) in 32 bits
// (empty when `live` is false).
struct Window {
  int lo, hi;
};

static __device__ __forceinline__ Window window(bool live, long long base, long long limit,
                                                int N) {
  if (!live) return {0, 0};
  const long long lo = -base, hi = limit - base;
  return {static_cast<int>(lo < 0 ? 0 : lo > N ? N : lo),
          static_cast<int>(hi < 0 ? 0 : hi > N ? N : hi)};
}

template <int LOG>
__global__ void __launch_bounds__(Geometry<LOG>::kThreads, Plan<LOG>::B)
fused_fir_kernel(const float* __restrict__ x, float* __restrict__ y,
                 const float2* __restrict__ H, long long t, long long rows, long long nb,
                 long long k, long long block) {
  using Geo = Geometry<LOG>;
  constexpr int N = Geo::N, T = Geo::T, P = Plan<LOG>::P;
  extern __shared__ float2 sbuf[];
  const int gi = threadIdx.x / T;
  const int j = threadIdx.x - gi * T;
  float2* buf = sbuf + gi * Geo::kSlots;
  const long long r0 = 2LL * (static_cast<long long>(blockIdx.x) * Geo::G + gi);
  const bool has_a = r0 < rows;  // a block's last pairs may be past the grid
  const bool has_b = r0 + 1 < rows;
  const Segment a = segment(has_a ? r0 : 0, nb, k, block);
  const Segment b = segment(has_b ? r0 + 1 : 0, nb, k, block);
  // point n = j + s*T reads sample first + n, taken where 0 <= first + n < t:
  // s*T in [lo, hi) with 32-bit bounds, one base pointer a side
  const Window wa = window(has_a, a.first + j, t, N);
  const Window wb = window(has_b, b.first + j, t, N);
  const float* xa = x + a.ch * t + (a.first + j);
  const float* xb = x + b.ch * t + (b.first + j);
  float2 v[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int n = s * T;
    v[s] = make_float2(n >= wa.lo && n < wa.hi ? xa[n] : 0.0f,
                       n >= wb.lo && n < wb.hi ? xb[n] : 0.0f);
  }
  fft<LOG>(v, j, buf);
#pragma unroll
  for (int s = 0; s < P; ++s) {  // conj(X H): the inverse as a forward transform
    const float2 z = cmul(v[s], H[j + s * T]);
    v[s] = make_float2(z.x, -z.y);
  }
  fft<LOG>(v, j, buf);
  constexpr float scale = 1.0f / N;
  // point n = j + s*T is output n - (k-1) of the segment, kept below `block`
  // and t: s*T in [lo, hi) again, one base pointer a side
  const Window oa = window(has_a, j - (k - 1), block < t - a.out ? block : t - a.out, N);
  const Window ob = window(has_b, j - (k - 1), block < t - b.out ? block : t - b.out, N);
  float* ya = y + a.ch * t + a.out + (j - (k - 1));
  float* yb = y + b.ch * t + b.out + (j - (k - 1));
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int n = s * T;
    if (n >= oa.lo && n < oa.hi) ya[n] = v[s].x * scale;
    if (n >= ob.lo && n < ob.hi) yb[n] = -v[s].y * scale;
  }
}

struct Launch {
  const void* kernel;
  int threads, smem, pairs_per_block;
};

template <int LOG>
static Launch launch_of() {
  using Geo = Geometry<LOG>;
  return {reinterpret_cast<const void*>(fused_fir_kernel<LOG>), Geo::kThreads, Geo::kSmemBytes,
          Geo::G};
}

static bool launch_for(int64_t log2n, Launch* out) {
  switch (log2n) {
    case 7: *out = launch_of<7>(); return true;
    case 8: *out = launch_of<8>(); return true;
    case 9: *out = launch_of<9>(); return true;
    case 10: *out = launch_of<10>(); return true;
    case 11: *out = launch_of<11>(); return true;
    case 12: *out = launch_of<12>(); return true;
    case 13: *out = launch_of<13>(); return true;
    case 14: *out = launch_of<14>(); return true;
    default: return false;
  }
}

}  // namespace b8
}  // namespace dsp

// x, y: (channels, t) float32, contiguous; H: the taps' nfft-point spectrum
// in natural order, complex64. threads and smem_bytes must be the plan's
// (the wrapper's FusedGeometry computes the same).
extern "C" int dsp_fused_fir(const float* x, float* y, const void* H, int64_t t, int64_t channels,
                             int64_t k, int64_t block, int64_t log2n, int64_t threads,
                             int64_t smem_bytes, void* stream) {
  using namespace dsp::b8;
  Launch l;
  if (t <= 0 || channels <= 0 || k < 1 || block < 1 || !launch_for(log2n, &l) ||
      block + k - 1 > (int64_t{1} << log2n) || threads != l.threads || smem_bytes != l.smem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nb = (t + block - 1) / block;
  const int64_t rows = channels * nb;
  const int64_t pairs = (rows + 1) / 2;
  const int64_t blocks = (pairs + l.pairs_per_block - 1) / l.pairs_per_block;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[kMaxLog + 1][dsp::kMaxDevices] = {};
  cudaError_t err = dsp::allow_smem(l.kernel, allowed[log2n], l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long tt = t, rr = rows, nn = nb, kk = k, bb = block;
  void* args[] = {&x, &y, &H, &tt, &rr, &nn, &kk, &bb};
  err = cudaLaunchKernel(l.kernel, dim3(static_cast<unsigned>(blocks)),
                         dim3(static_cast<unsigned>(l.threads)), args,
                         static_cast<size_t>(l.smem), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave B8 at nfft 2^log2n: registers a thread, local bytes
// a thread, shared bytes a block (static and dynamic), blocks an SM, threads
// a block (5 int64 in out).
extern "C" int dsp_fused_fir_attrs(int64_t log2n, int64_t* out) {
  using namespace dsp::b8;
  Launch l;
  if (!launch_for(log2n, &l)) return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[kMaxLog + 1][dsp::kMaxDevices] = {};
  cudaError_t err = dsp::allow_smem(l.kernel, allowed[log2n], l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, l.kernel)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, l.kernel, l.threads, l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  out[2] = static_cast<int64_t>(a.sharedSizeBytes) + l.smem;
  out[3] = blocks;
  out[4] = l.threads;
  return 0;
}
