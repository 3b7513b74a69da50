// Overlap-save FIR past B8's envelope (B9): nfft = n1 * n2 up to 2^20 by the
// four-step FFT, three launches a wave of pairs through a scratch in device
// memory (one wave at the main path, below).
//
// Replaces digital_signal_processsing_tpu/ops/fft_mxu.py _fused3_kernel, which
// splits the DFT in three factors of matmuls and lane slices held in VMEM.
//
// y[c, n] = sum_j h[j] x[c, n - j],  x[c, < 0] = 0.
//
// Segments and pairs as in B8 (fused_fir.cu): row r keeps [s*block,
// (s+1)*block) and transforms the N = nfft samples from s*block - (k-1) on;
// rows 2p and 2p+1 ride one complex transform as a + i*b. A point of the
// transform is n = n2*i1 + i2 (i1 < n1, i2 < n2) in time and
// f = f1 + n1*f2 in frequency, and
//
//   X[f1 + n1 f2] = sum_i2 W_n2^(i2 f2) W_N^(i2 f1) sum_i1 x[n2 i1 + i2] W_n1^(i1 f1).
//
// The inverse runs as forward transforms of the conjugate (as in B8): with
// Z = X H, C[f1][i2] = W_N^(i2 f1) sum_f2 W_n2^(i2 f2) conj(Z[f1 + n1 f2]) and
// y[n2 i1 + i2] = conj(sum_f1 W_n1^(i1 f1) C[f1][i2]) / N. So every line
// transform is forward and every inter-step twiddle W_N^(i2 f1):
//
//   1. fir3_columns  for each i2: the n1-point FFT over i1 of the samples
//                    read from x (halo and zeros as in B8), times
//                    W_N^(i2 f1); scratch[f1][i2]
//   2. fir3_rows     for each f1: the n2-point FFT over i2 = f2, conj(X H)
//                    with the taps' spectrum stored [f1][f2], the n2-point
//                    FFT again, times W_N^(i2 f1); scratch[f1][i2] in place
//   3. fir3_outputs  for each i2: the n1-point FFT over f1, conjugated and
//                    scaled by 1/N, the kept points written to y
//
// The lines: stockham.cuh's register-resident Stockham passes, a thread
// holding P = 16 points of a line (Line<> below): 128 and 256 points by the
// warp plans (8 or 16 lanes, one exchange by shuffles, no barrier), 512 and
// 1024 by B8's plans (8 x 8 x 8, 4 x 16 x 16) exchanging through padded
// shared memory. Stockham leaves natural order, so nothing is bit-reversed:
// the scratch rows, the taps' spectrum ([f1][f2], a transpose of H) and the
// outputs are all in natural order. Every twiddle is computed: W_N^e for
// e = i2*f1 < N with sincospif of e * 2/N, exact in float32 (within 1 ulp),
// and the line passes' own as in stockham.cuh; no table is read.
//
// Memory. A column task is G1 neighbouring i2 of one pair (runs of G1
// samples in x, G1 points in the scratch, G1 outputs in y); its loads and
// stores go through G1 padded lines in shared memory, so that x, the
// scratch and y move in runs and the registers hold whole lines. The column
// and output launches are persistent, as many blocks as fit at once, and
// each block loads its next task by cp.async into a second stage while it
// transforms this one: the loads' latency hides under the transforms. A row
// task takes G2 whole rows of a chunk of pairs, read and written by the
// lanes in order (below, fir3_rows). The pairs go in waves of equal size
// that fit a scratch of FUSED3_SCRATCH_BYTES (ops/fft_mxu.py), all three
// launches of a wave before the next: one wave at the main path's 280 pairs.
// Waves small enough for the scratch to stay in L2 measured slower on the
// H100 (tools/ab_fir3_scan.py): each wave's three launches fill and drain
// the card, which costs more than the scratch's round trip through device
// memory saves.
//
// What bounds it on the H100: by the work, memory bytes of x and y, as B8
// (8 bytes an output; the 5 N log2 N flops of the transforms are below that
// at 66.9 TFLOP/s). By this design: instruction issue at 16 warps an SM
// (128 registers a thread hold a line's 16 points and the warp plan's
// transpose), and the scratch's 32 bytes a point with the staging through
// shared memory (4 sweeps of 16 bytes a point, plus the exchanges of the
// 512- and 1024-point plans), which overlap the transforms only in part.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "stockham.cuh"

namespace dsp {
namespace b9 {

using namespace stockham;

// A line of 2^LOG points: P points a thread, its passes' radices (a warp
// plan: R0 = P, R1 = M/P; the others exchange through shared memory), as
// ops/fft_mxu.py B9_LINE_PLANS mirrors them.
template <int LOG> struct Line;
template <> struct Line<7> { static constexpr int P = 16, R0 = 16, R1 = 8, R2 = 0; static constexpr bool kWarp = true; };
template <> struct Line<8> { static constexpr int P = 16, R0 = 16, R1 = 16, R2 = 0; static constexpr bool kWarp = true; };
template <> struct Line<9> { static constexpr int P = 16, R0 = 8, R1 = 8, R2 = 8; static constexpr bool kWarp = false; };
template <> struct Line<10> { static constexpr int P = 16, R0 = 4, R1 = 16, R2 = 16; static constexpr bool kWarp = false; };

template <int LOG> struct LineGeo {
  static constexpr int M = 1 << LOG;
  static constexpr int P = Line<LOG>::P;
  static constexpr int T = M / P;                        // threads a line
  static constexpr int kStride = M + M / 16 + 1;         // slots a line in shared memory
  static constexpr int G = T >= 32 ? 8 : 256 / T;        // lines a column block
  static constexpr int kColThreads = G * T;
  static constexpr int kColBlocks = kColThreads > 256 ? 1 : 2;  // launch bounds: 128 registers
  static constexpr int kRows = 256 / T;                  // lines a row block
};

// The forward DFT of a line held in v (point j + s*T in v[s]), natural order
// in and out; `buf` is the line's exchange (the shared-memory plans).
template <int LOG>
static __device__ __forceinline__ void line_fft(float2 (&v)[Line<LOG>::P], int j, float2* buf) {
  using L = Line<LOG>;
  if constexpr (L::kWarp) {
    warp_fft<1 << LOG, L::P>(v, j);
  } else {
    stockham::fft<1 << LOG, L::P, L::R0, L::R1, L::R2>(v, j, buf);
  }
}

// W_N^e = exp(-2 pi i e / N), e < N: sincospif of e * 2^(1 - logN), exact.
static __device__ __forceinline__ float2 w_n(int e, float two_over_n) {
  float s, c;
  sincospif(static_cast<float>(e) * two_over_n, &s, &c);
  return make_float2(c, -s);
}

struct Fir3 {
  long long t, rows, nb, k, block;
  long long pair0;   // first pair of this wave
  int pairs;         // pairs of this wave
  int tasks;         // column tasks of this wave: its pairs x (n2 / G) column groups
  int row_tasks;     // row tasks of this wave: (n1 / G2) f1 blocks x chunks of ppb pairs
  int ppb;           // pairs a row task walks
  int rot;           // (k - 1) mod n2: task columns start there (aligned runs of x and y)
  float two_over_n;  // 2 / N
};

// One 4- or 8-byte copy into shared memory by cp.async (zero-filled where
// `live` is false; `src` stays a valid address).
static __device__ __forceinline__ void copy4(float* dst, const float* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0));
}

static __device__ __forceinline__ void copy8(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

static __device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

static __device__ __forceinline__ void wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The pair of column task `task` (wave-local) and its segments.
struct Task {
  int pair;  // in the wave
  int i2_0;  // its first column: column l is (i2_0 + l) mod n2
  bool has_b;
  Segment a, b;
};

template <int G, int N2>
static __device__ __forceinline__ Task task_of(int task, const Fir3& p) {
  constexpr int kGroups = N2 / G;
  Task k;
  k.pair = task / kGroups;
  k.i2_0 = ((task - k.pair * kGroups) * G + p.rot) & (N2 - 1);
  const long long r0 = 2 * (p.pair0 + k.pair);
  k.has_b = r0 + 1 < p.rows;
  k.a = segment(r0, p.nb, p.k, p.block);
  k.b = segment(k.has_b ? r0 + 1 : r0, p.nb, p.k, p.block);
  return k;
}

// The column and output launches are persistent: block b takes tasks b, b +
// gridDim.x, ..., and the loads of its next task (cp.async into the other
// half of its shared memory) run while it transforms this one. A task is G
// columns of one pair; its points sit in G padded lines, point (i1, i2) of
// x or of the scratch, i2 = (i2_0 + l) mod n2, at line l, slot xslot(i1), so
// that both move in runs of G. The groups start at (k - 1) mod n2: sample
// first + n2*i1 + i2 of x and output n2*i1 + i2 - (k - 1) of y then fall in
// whole 32-byte sectors (block and n2 are multiples of 128), no sector is
// written in part, and none read twice.

// x of task `task` into `dst` (a + i*b, zeros off the signal), 4 bytes a copy.
template <int LOG1, int LOG2>
static __device__ __forceinline__ void stage_x(const float* __restrict__ x, float2* dst,
                                               int task, const Fir3& p) {
  using G1 = LineGeo<LOG1>;
  constexpr int G = G1::G, n2 = 1 << LOG2;
  const Task k = task_of<G, n2>(task, p);
  const float* xa = x + k.a.ch * p.t;
  const float* xb = x + k.b.ch * p.t;
#pragma unroll
  for (int u = 0; u < G1::P; ++u) {
    const int e = threadIdx.x + u * G1::kColThreads;
    const long long n = static_cast<long long>(e / G) * n2 + ((k.i2_0 + e % G) & (n2 - 1));
    const long long ga = k.a.first + n, gb = k.b.first + n;
    const bool la = ga >= 0 && ga < p.t, lb = k.has_b && gb >= 0 && gb < p.t;
    float2* d = dst + (e % G) * G1::kStride + xslot(e / G);
    copy4(&d->x, la ? xa + ga : x, la);
    copy4(&d->y, lb ? xb + gb : x, lb);
  }
}

// The scratch points of task `task` into `dst`, 8 bytes a copy.
template <int LOG1, int LOG2>
static __device__ __forceinline__ void stage_scratch(const float2* __restrict__ scratch, float2* dst,
                                                     int task, const Fir3& p) {
  using G1 = LineGeo<LOG1>;
  constexpr int G = G1::G, n2 = 1 << LOG2, kGroups = n2 / G;
  const int pair = task / kGroups;
  const int i2_0 = ((task - pair * kGroups) * G + p.rot) & (n2 - 1);
  const float2* sc = scratch + static_cast<long long>(pair) * (n2 << LOG1);
#pragma unroll
  for (int u = 0; u < G1::P; ++u) {
    const int e = threadIdx.x + u * G1::kColThreads;
    copy8(dst + (e % G) * G1::kStride + xslot(e / G), sc + (e / G) * n2 + ((i2_0 + e % G) & (n2 - 1)));
  }
}

template <int LOG1, int LOG2>
__global__ void __launch_bounds__(LineGeo<LOG1>::kColThreads, LineGeo<LOG1>::kColBlocks)
fir3_columns(const float* __restrict__ x, float2* __restrict__ scratch, Fir3 p) {
  using G1 = LineGeo<LOG1>;
  constexpr int n1 = G1::M, n2 = 1 << LOG2, P = G1::P, T = G1::T, G = G1::G;
  constexpr int kStage = G * G1::kStride;
  extern __shared__ float2 buf[];  // two stages of G lines
  const int l = threadIdx.x / T, j = threadIdx.x % T;
  if (static_cast<int>(blockIdx.x) < p.tasks) stage_x<LOG1, LOG2>(x, buf, blockIdx.x, p);
  commit();
  int it = 0;
  for (int task = blockIdx.x; task < p.tasks; task += gridDim.x, ++it) {
    float2* cur = buf + (it & 1) * kStage;
    __syncthreads();  // the last task's reads of the other stage are done
    if (task + static_cast<int>(gridDim.x) < p.tasks) {
      stage_x<LOG1, LOG2>(x, buf + ((it + 1) & 1) * kStage, task + gridDim.x, p);
    }
    commit();
    wait_all_but_last();
    __syncthreads();
    float2* line = cur + l * G1::kStride;
    float2 v[P];
#pragma unroll
    for (int s = 0; s < P; ++s) v[s] = line[xslot(j + s * T)];
    __syncthreads();
    line_fft<LOG1>(v, j, line);
    const Task k = task_of<G, n2>(task, p);
    const int i2 = (k.i2_0 + l) & (n2 - 1);
#pragma unroll
    for (int s = 0; s < P; ++s) {
      line[xslot(j + s * T)] = cmul(v[s], w_n(i2 * (j + s * T), p.two_over_n));
    }
    __syncthreads();
    // scratch[f1][i2] in runs of G points
    float2* sc = scratch + static_cast<long long>(k.pair) * (n1 * n2);
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int e = threadIdx.x + u * G1::kColThreads;
      sc[static_cast<long long>(e / G) * n2 + ((k.i2_0 + e % G) & (n2 - 1))] =
          cur[(e % G) * G1::kStride + xslot(e / G)];
    }
  }
}

// 16 bytes into shared memory by cp.async, through L2 only.
static __device__ __forceinline__ void copy16(float2* dst, const float2* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// `count` contiguous complex points (a multiple of 2, 16-byte aligned) into `dst`.
template <int kCount>
static __device__ __forceinline__ void stage_rows(float2* dst, const float2* src) {
  static_assert(kCount % (2 * 256) == 0, "whole 16-byte copies for every thread");
#pragma unroll
  for (int u = 0; u < kCount / (2 * 256); ++u) {
    const int e = 2 * (threadIdx.x + u * 256);
    copy16(dst + e, src + e);
  }
}

// The row launch is persistent too: task (f1 block, chunk of p.ppb pairs)
// loads the block's G2 rows of the taps' spectrum once, then walks the
// chunk's pairs, the next pair's rows loading by cp.async while this one's
// transform, product, transform and twiddles run.
template <int LOG1, int LOG2>
__global__ void __launch_bounds__(256, 2)
fir3_rows(float2* __restrict__ scratch, const float2* __restrict__ H, Fir3 p) {
  using G2 = LineGeo<LOG2>;
  constexpr int n1 = 1 << LOG1, n2 = G2::M, P = G2::P, T = G2::T, R = G2::kRows;
  constexpr int kBlocks = n1 / R;  // f1 blocks
  extern __shared__ float2 buf[];  // H's rows, the staged rows, the plans' exchanges
  float2* hrows = buf;
  float2* stage = buf + R * n2;
  float2* line = buf + 2 * R * n2 + (threadIdx.x / T) * G2::kStride;
  const int r = threadIdx.x / T, j = threadIdx.x % T;
  for (int task = blockIdx.x; task < p.row_tasks; task += gridDim.x) {
    const int fb = task % kBlocks;
    const int lo = (task / kBlocks) * p.ppb;
    const int hi = lo + p.ppb < p.pairs ? lo + p.ppb : p.pairs;
    const int f1 = fb * R + r;
    const long long off = static_cast<long long>(fb) * R * n2;  // the block's rows in a pair
    __syncthreads();  // the last task is done with hrows and stage
    stage_rows<R * n2>(hrows, H + off);
    stage_rows<R * n2>(stage, scratch + static_cast<long long>(lo) * (n1 * n2) + off);
    commit();
    for (int pair = lo; pair < hi; ++pair) {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      float2 v[P];
#pragma unroll
      for (int s = 0; s < P; ++s) v[s] = stage[r * n2 + j + s * T];
      __syncthreads();
      if (pair + 1 < hi) {
        stage_rows<R * n2>(stage, scratch + static_cast<long long>(pair + 1) * (n1 * n2) + off);
      }
      commit();
      line_fft<LOG2>(v, j, line);
#pragma unroll
      for (int s = 0; s < P; ++s) {  // conj(X H): the inverse as a forward transform
        const float2 z = cmul(v[s], hrows[r * n2 + j + s * T]);
        v[s] = make_float2(z.x, -z.y);
      }
      line_fft<LOG2>(v, j, line);
      float2* row = scratch + static_cast<long long>(pair) * (n1 * n2) + off + r * n2;
#pragma unroll
      for (int s = 0; s < P; ++s) row[j + s * T] = cmul(v[s], w_n((j + s * T) * f1, p.two_over_n));
    }
  }
}

template <int LOG1, int LOG2>
__global__ void __launch_bounds__(LineGeo<LOG1>::kColThreads, LineGeo<LOG1>::kColBlocks)
fir3_outputs(const float2* __restrict__ scratch, float* __restrict__ y, Fir3 p) {
  using G1 = LineGeo<LOG1>;
  constexpr int n1 = G1::M, n2 = 1 << LOG2, P = G1::P, T = G1::T, G = G1::G;
  constexpr int kStage = G * G1::kStride;
  extern __shared__ float2 buf[];  // two stages of G lines
  const int l = threadIdx.x / T, j = threadIdx.x % T;
  const float scale = 1.0f / static_cast<float>(n1 * n2);
  const long long lead = p.k - 1;
  if (static_cast<int>(blockIdx.x) < p.tasks) stage_scratch<LOG1, LOG2>(scratch, buf, blockIdx.x, p);
  commit();
  int it = 0;
  for (int task = blockIdx.x; task < p.tasks; task += gridDim.x, ++it) {
    float2* cur = buf + (it & 1) * kStage;
    __syncthreads();
    if (task + static_cast<int>(gridDim.x) < p.tasks) {
      stage_scratch<LOG1, LOG2>(scratch, buf + ((it + 1) & 1) * kStage, task + gridDim.x, p);
    }
    commit();
    wait_all_but_last();
    __syncthreads();
    float2* line = cur + l * G1::kStride;
    float2 v[P];
#pragma unroll
    for (int s = 0; s < P; ++s) v[s] = line[xslot(j + s * T)];
    __syncthreads();
    line_fft<LOG1>(v, j, line);
#pragma unroll
    for (int s = 0; s < P; ++s) line[xslot(j + s * T)] = make_float2(v[s].x * scale, -v[s].y * scale);
    __syncthreads();
    // point n = n2*i1 + i2 is output n - (k-1) of the segment, kept below block and t
    const Task k = task_of<G, n2>(task, p);
    float* ya = y + k.a.ch * p.t;
    float* yb = y + k.b.ch * p.t;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int e = threadIdx.x + u * G1::kColThreads;
      const long long n = static_cast<long long>(e / G) * n2 + ((k.i2_0 + e % G) & (n2 - 1));
      if (n < lead || n >= lead + p.block) continue;
      const float2 val = cur[(e % G) * G1::kStride + xslot(e / G)];
      const long long oa = k.a.out + (n - lead);
      if (oa < p.t) __stcs(ya + oa, val.x);
      if (k.has_b) {
        const long long ob = k.b.out + (n - lead);
        if (ob < p.t) __stcs(yb + ob, val.y);
      }
    }
  }
}

struct Launches {
  const void* columns;
  const void* rows;
  const void* outputs;
  int n2, col_threads, col_smem, groups, row_smem, row_blocks;  // groups: column tasks a pair
  int* allowed;  // 3 x kMaxDevices
};

template <int LOG1, int LOG2>
static Launches launches_of() {
  using G1 = LineGeo<LOG1>;
  using G2 = LineGeo<LOG2>;
  static int allowed[3 * kMaxDevices] = {};
  return {reinterpret_cast<const void*>(fir3_columns<LOG1, LOG2>),
          reinterpret_cast<const void*>(fir3_rows<LOG1, LOG2>),
          reinterpret_cast<const void*>(fir3_outputs<LOG1, LOG2>),
          1 << LOG2,
          G1::kColThreads,
          2 * 8 * G1::G * G1::kStride,  // two stages
          (1 << LOG2) / G1::G,
          8 * (2 * G2::kRows * G2::M + (Line<LOG2>::kWarp ? 0 : G2::kRows * G2::kStride)),
          (1 << LOG1) / G2::kRows,
          allowed};
}

// nfft 2^15 .. 2^20: n1 = 2^(log2n / 2), n2 = nfft / n1
static bool launches_for(int64_t log2n, Launches* out) {
  switch (log2n) {
    case 15: *out = launches_of<7, 8>(); return true;
    case 16: *out = launches_of<8, 8>(); return true;
    case 17: *out = launches_of<8, 9>(); return true;
    case 18: *out = launches_of<9, 9>(); return true;
    case 19: *out = launches_of<9, 10>(); return true;
    case 20: *out = launches_of<10, 10>(); return true;
    default: return false;
  }
}

static cudaError_t allow_all(const Launches& l) {
  cudaError_t err;
  if ((err = allow_smem(l.columns, l.allowed, l.col_smem)) != cudaSuccess) return err;
  if ((err = allow_smem(l.rows, l.allowed + kMaxDevices, l.row_smem)) != cudaSuccess) return err;
  return allow_smem(l.outputs, l.allowed + 2 * kMaxDevices, l.col_smem);
}

// Blocks of a persistent launch: as many as are resident at once.
static cudaError_t resident_blocks(const void* kernel, int threads, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
          cudaSuccess) {
    return err;
  }
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

}  // namespace b9
}  // namespace dsp

// x, y: (channels, t) float32, contiguous; scratch: wave_pairs * nfft complex64;
// Hk: the taps' nfft-point spectrum as [f1][f2], Hk[f1 * n2 + f2] = H[f1 + n1 * f2].
// The pairs go in ceil(pairs / wave_pairs) waves of equal size (at most
// wave_pairs each); the wrapper's FusedGeometry computes the same launches.
extern "C" int dsp_fused_fir3(const float* x, float* y, void* scratch, const void* Hk, int64_t t,
                              int64_t channels, int64_t k, int64_t block, int64_t log2n,
                              int64_t wave_pairs, void* stream) {
  using namespace dsp::b9;
  Launches l;
  if (t <= 0 || channels <= 0 || k < 1 || block < 1 || !launches_for(log2n, &l) ||
      block + k - 1 > (int64_t{1} << log2n) || wave_pairs < 1 || wave_pairs > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nb = (t + block - 1) / block;
  const int64_t rows = channels * nb;
  const int64_t pairs = (rows + 1) / 2;
  const int64_t waves = (pairs + wave_pairs - 1) / wave_pairs;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<float2*>(scratch);
  const auto* h = static_cast<const float2*>(Hk);
  cudaError_t err = allow_all(l);
  int col_grid = 0, out_grid = 0;
  if (err != cudaSuccess ||
      (err = resident_blocks(l.columns, l.col_threads, l.col_smem, &col_grid)) != cudaSuccess ||
      (err = resident_blocks(l.outputs, l.col_threads, l.col_smem, &out_grid)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int row_grid = 0;
  if ((err = resident_blocks(l.rows, 256, l.row_smem, &row_grid)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  Fir3 p{t, rows, nb, k, block, 0, 0, 0, 0, 0, static_cast<int>((k - 1) % l.n2),
         2.0f / static_cast<float>(int64_t{1} << log2n)};
  for (int64_t w = 0; w < waves; ++w) {
    p.pair0 = w * pairs / waves;
    const auto count = static_cast<unsigned>((w + 1) * pairs / waves - p.pair0);
    p.pairs = static_cast<int>(count);
    p.tasks = p.pairs * l.groups;
    // chunks of pairs so that the row tasks just fill the resident blocks
    p.ppb = static_cast<int>((int64_t{p.pairs} * l.row_blocks + row_grid - 1) / row_grid);
    p.row_tasks = l.row_blocks * ((p.pairs + p.ppb - 1) / p.ppb);
    const unsigned rg = static_cast<unsigned>(p.row_tasks < row_grid ? p.row_tasks : row_grid);
    const unsigned cg = static_cast<unsigned>(p.tasks < col_grid ? p.tasks : col_grid);
    const unsigned og = static_cast<unsigned>(p.tasks < out_grid ? p.tasks : out_grid);
    void* col_args[] = {&x, &sc, &p};
    void* row_args[] = {&sc, &h, &p};
    void* out_args[] = {&sc, &y, &p};
    if ((err = cudaLaunchKernel(l.columns, dim3(cg), dim3(l.col_threads), col_args,
                                l.col_smem, s)) != cudaSuccess ||
        (err = cudaLaunchKernel(l.rows, dim3(rg), dim3(256), row_args, l.row_smem, s)) != cudaSuccess ||
        (err = cudaLaunchKernel(l.outputs, dim3(og), dim3(l.col_threads), out_args,
                                l.col_smem, s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave B9's launch `which` (0 columns, 1 rows, 2 outputs) at
// nfft 2^log2n: registers a thread, local bytes a thread, shared bytes a block
// (static and dynamic), blocks an SM, threads a block (5 int64 in out).
extern "C" int dsp_fused_fir3_attrs(int64_t log2n, int64_t which, int64_t* out) {
  using namespace dsp::b9;
  Launches l;
  if (!launches_for(log2n, &l) || which < 0 || which > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_all(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* kern = which == 0 ? l.columns : which == 1 ? l.rows : l.outputs;
  const int threads = which == 1 ? 256 : l.col_threads;
  const int smem = which == 1 ? l.row_smem : l.col_smem;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, kern)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  out[2] = static_cast<int64_t>(a.sharedSizeBytes) + smem;
  out[3] = blocks;
  out[4] = threads;
  return 0;
}
