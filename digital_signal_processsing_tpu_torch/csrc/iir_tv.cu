// Time-varying SOS cascades over planar (channels, n) float32: every section
// with per-sample rows (B16), one section with per-sample rows (B17), and
// every section with one row a frame (B18). One template, tv_tile_kernel;
// the three differ in the number of sections and in how a sample finds its row.
//
// Replaces, in digital_signal_processsing_tpu/ops/iir.py:
//   B16 _biquad_tv_fused_kernel   all time-varying sections over a tile;
//   B17 _biquad_tv_kernel         one time-varying section, seeded or not;
//   B18 _biquad_tv_frames_kernel  all sections, one coefficient row a frame.
// A section is the standard time-varying direct form II transposed, each row
// (b0 b1 b2 a0 a1 a2) divided by its own a0:
//   y = b0 x + s1;  s1' = b1 x - a1 y + s2;  s2' = b2 x - a2 y.
// Eliminating y, the state moves by the affine map s' = Phi s + c x with
// Phi = [[-a1, 1], [-a2, 0]]: a section over a run of samples is the affine
// map (A, z), A the product of the Phis and z the state reached from rest.
//
// Rows are (S, Cc, F, 6) float32: Cc = 1 rows shared by every channel, read
// with a channel stride of 0 and never copied a channel, or Cc = C; F = n (a
// row a sample) or a row a frame of `frame_len` samples (B18: row
// floor(t / frame_len), any frame_len).
//
// The TPU kernels walk their grid in order and carry the state in VMEM. CUDA
// blocks run in no order, so the carry takes three launches, B12's design
// (iir.cu) with the tile transition taken from the data:
//   1. tile kernel, ends   a column of one tile is the signal of channel c
//                          from zero state, or the zero input from the unit
//                          state e_j of coefficient channel cc. It leaves its
//                          exit state: z_t of channel c, or column j of the
//                          tile's 2S x 2S transition M_t (block lower
//                          triangular: a section's zero-input output drives
//                          the sections after it; a unit column's state stays
//                          zero through the sections before its own). So the
//                          transition is composed in the first launch, from
//                          the rows alone: once a tile for shared rows,
//                          whatever C is;
//   2. carry kernel        a warp a channel chains s_{t+1} = M_t s_t + z_t in
//                          float64 from the seed (zero, or the chunk's
//                          incoming state), leaving s_t in place of z_t;
//   3. tile kernel, apply  each tile of each channel from s_t, writing y; the
//                          thread holding sample n-1 writes the end state.
// Blocks are ordered column group fastest, so the blocks of one time tile run
// together and read its shared rows from L2 (B16's rows at the main path, 4
// sections of 2^22 samples, are 403 MB: far more than the 50 MB L2).
// More than kGroup sections run as groups of kGroup, the signal passing
// through y in device memory between groups (the cost of the transition
// grows as S^2); B17 is the S = 1 instance, launched once a section by
// sosfilt_tv(method="scan").
//
// Inside a tile a block of kThreads = 256 walks sub-tiles of kSub = 2048
// samples for G columns at once (G = 3, or 4 on the state route, where the
// rows are shared by the channels; G = 1 for per-channel rows). Thread i owns
// kSeg = 8 consecutive samples of each column, staged by coalesced cp.async
// copies into a padded shared buffer a column, where they stay through every
// section, y overwriting x. The host picks one of three routes by which a
// sample finds its coefficients; none holds them in registers across a
// section:
//   rows    (B16, B17) before each section the block stages the section's
//           rows of the sub-tile with coalesced 16-byte loads (two rows in
//           three float4), divides each row by its a0 once (one IEEE
//           reciprocal and five products, float32) and keeps them as five
//           padded planes in shared memory, which both runs of every column
//           read;
//   compose (B18, frame_len not a multiple of kSpan = 32 kSeg = 256) the same
//           planes hold one entry a frame the sub-tile touches; a thread
//           steps from entry to entry by a mask of its frame edges;
//   state   (B18, frame_len a multiple of kSpan) a warp's 256 samples lie in
//           one frame, so a section is time-invariant across the warp, as
//           B12's sections are. Once a sub-tile the block stages one entry a
//           (section, warp): the divided row and the powers Psi^(2^k), k =
//           0..5, of Psi = Phi^kSeg, squared in float64.
// A section over the sub-tile, for the G columns in lockstep:
//   a. each thread runs its samples of every column from rest in float64,
//      reaching z_i; on the rows and compose routes the product A_i of their
//      Phis runs once for all G columns (it depends on the rows alone); on
//      the state route A_i is Psi on every lane and only the states run;
//   b. a warp's Hillis-Steele steps scan the maps, inclusive: A once and each
//      column's z (the reference's _compose_affine) on the rows and compose
//      routes; on the state route each column's z alone, z_i += Psi^d
//      z_{i-d}, the factor the same on every lane;
//   c. lane 31 leaves its warp's totals; after a barrier warp 0 scans the
//      eight totals of every column at once, lanes 8g to 8g + 7 column g,
//      three shuffle steps in float64 from the column's carry, and leaves the
//      state entering each warp and the state leaving the sub-tile (the next
//      carry, two buffers by sub-tile); a second barrier;
//   d. each thread takes the true state entering its samples (rows, compose:
//      its inclusive map applied to the warp's entry state, shifted up a
//      lane; state: Psi^lane from the bits of the lane, plus the exclusive
//      sum), rounds it to float32 and runs the recurrence from it in float32.
// Steps a-d run in float64 up to the entry state because a resonant section's
// composed maps and segment states grow far past the state they sum to (a
// tone at a notch's frequency, pole angles of 0.1 rad): in float32 the entry
// states cost 2-14x the sequential recurrence's error at pole radius
// 0.95-0.995, in float64 they are exact to float32 and the kernel sits at or
// under the sequential error. The rest is IEEE fp32 FMAs, products and
// reciprocals, never a tensor core; launch 2 accumulates in float64. The
// recurrences are ordered so that a sample adds two dependent FMAs to the
// chain (s1' = fma(-a1, y, b1 x + s2), s2' = fma(-a2, y, b2 x)).
//
// Each tile kernel is held to 80 registers, three blocks (24 warps) an SM,
// with no local memory; the block's bookkeeping sits in shared memory (Block),
// read where it is used.
// Shared memory a block: the planes (46 KB) and three column buffers (27 KB),
// or the state route's entries (2 KB a section) and four buffers (36 KB).
//
// What bounds it on the H100: memory bytes. The function reads x once, reads
// the rows once and writes y once: 8 bytes a sample and channel plus 24 a
// sample and section of per-sample rows (0.281 ms for B16 at 16 x 2^22 with
// 4 shared sections at 3.35 TB/s). This design reads x twice (launches 1 and
// 3) and the rows once a column group and launch: 2 ceil(C / G) + ceil(2S / G)
// times a tile (the signal and unit groups of launch 1, the signal groups of
// launch 3), from L2 where a tile's blocks meet there. Inside the block a sample
// and section costs six float-to-double conversions (16 a clock an SM) and,
// on the rows and compose routes, 60 bytes of shared memory for the planes;
// a section waits at two barriers (and two more to stage rows). The float64
// chains of steps a and b, and those barriers, hold it above the bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace dsp {
namespace iir_tv {

constexpr int kThreads = 256;            // threads a block
constexpr int kWarps = kThreads / 32;    // warp totals a section's block scan takes
constexpr int kSeg = 8;                  // consecutive samples a thread
constexpr int kRow = kSeg + 1;           // a thread's row of a padded plane
constexpr int kSub = kThreads * kSeg;    // samples a sub-tile
constexpr int kSpan = 32 * kSeg;         // samples a warp: the state route's unit
constexpr int kPlane = kThreads * kRow;  // floats a padded plane
constexpr int kGroup = 16;               // sections a pass: 2 kGroup lanes of launch 2
constexpr int kMinBlocks = 3;            // blocks an SM: 80 registers a thread
constexpr unsigned kFull = 0xffffffffu;

enum Route { kRows = 0, kCompose = 1, kState = 2 };

// The state route's section k on warp w's frame.
struct Entry {
  double q[6][4];  // Psi^(2^k), Psi = Phi^kSeg, row-major; q[5] is the warp's map
  double c[5];     // b0 b1 b2 -a1 -a2, divided by a0
  float f[5];      // the same, float32
  float pad;
};
static_assert(sizeof(Entry) == 256, "an entry is 256 bytes");

static __device__ __forceinline__ int slot(int k) { return (k / kSeg) * kRow + k % kSeg; }

// What every thread of a tile kernel's block reads about the block, kept in
// shared memory and read where it is used: held in registers through the
// passes, it would crowd them.
struct Block {
  int64_t x0;  // column 0's first sample in x: c0 n + t0 (signal columns)
  int64_t r0;  // the coefficient channel's rows: cc chan_stride
  int64_t t0;  // the tile's first sample
  int len;     // the tile's samples
  int c0;      // the first channel (signal columns)
  int u0;      // the first unit (unit columns)
  int cc;      // the coefficient channel
  int cols;    // the columns carried (G at most)
  int signal;  // signal columns, else unit columns
};
__shared__ Block tv_blk;

// A column's x buffer (a padded plane) <- x[k] at slot(k) for k < count, 0
// beyond: coalesced 4-byte cp.async copies when the whole sub-tile is there,
// which land by the next cp_async_wait().
static __device__ void load_x(float* buf, const float* x, int count) {
  if (count == kSub) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf));
    for (int k = threadIdx.x; k < kSub; k += kThreads) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * slot(k)),
                   "l"(x + k));
    }
  } else {
    for (int k = threadIdx.x; k < kSub; k += kThreads) buf[slot(k)] = k < count ? x[k] : 0.0f;
  }
}

static __device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_all;\n" ::); }

// y[k] <- buf[slot(k)] for k < count; 16-byte stores when `vec`.
static __device__ void store_y(float* y, const float* buf, int count, bool vec) {
  if (vec && count == kSub) {
    float4* y4 = reinterpret_cast<float4*>(y);
    for (int q = threadIdx.x; q < kSub / 4; q += kThreads) {
      const float* p = buf + slot(4 * q);  // kSeg % 4 == 0: the four share a row
      y4[q] = make_float4(p[0], p[1], p[2], p[3]);
    }
  } else {
    for (int k = threadIdx.x; k < count; k += kThreads) y[k] = buf[slot(k)];
  }
}

// Entry i of the five planes: b0 b1 b2 a1 a2 of the row, divided by its a0.
static __device__ __forceinline__ void put_row(float* pl, int i, float b0, float b1, float b2,
                                               float a0, float a1, float a2) {
  const float inv = 1.0f / a0;
  pl[i] = b0 * inv;
  pl[kPlane + i] = b1 * inv;
  pl[2 * kPlane + i] = b2 * inv;
  pl[3 * kPlane + i] = a1 * inv;
  pl[4 * kPlane + i] = a2 * inv;
}

static __device__ __forceinline__ void put_row(float* pl, int i, const float* r) {
  const float2 u = reinterpret_cast<const float2*>(r)[0];  // b0 b1
  const float2 v = reinterpret_cast<const float2*>(r)[1];  // b2 a0
  const float2 w = reinterpret_cast<const float2*>(r)[2];  // a1 a2
  put_row(pl, i, u.x, u.y, v.x, v.y, w.x, w.y);
}

static __device__ __forceinline__ void zero_row(float* pl, int i) {
#pragma unroll
  for (int p = 0; p < 5; ++p) pl[p * kPlane + i] = 0.0f;
}

// The rows route: sample k of the sub-tile at slot(k), zero from `count` on.
// `rs` is the section's row of the sub-tile's first sample. A call of its own:
// inlined into B16's loop over sections, its loads crowd the passes' registers
// and push block values out to local memory.
static __device__ __noinline__ void stage_rows(float* pl, const float* rs, int count) {
  if (count == kSub && (reinterpret_cast<uintptr_t>(rs) & 15) == 0) {
    // rows 2q and 2q + 1 in three float4, q = tid + kThreads m: the loads of
    // kBatch pairs first
    constexpr int kPairs = kSub / 2 / kThreads, kBatch = 2;
    const float4* r4 = reinterpret_cast<const float4*>(rs) + 3 * threadIdx.x;
#pragma unroll
    for (int m0 = 0; m0 < kPairs; m0 += kBatch) {
      float4 a[kBatch], b[kBatch], c[kBatch];
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        a[m] = r4[3 * kThreads * (m0 + m)];
        b[m] = r4[3 * kThreads * (m0 + m) + 1];
        c[m] = r4[3 * kThreads * (m0 + m) + 2];
      }
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const int q = threadIdx.x + kThreads * (m0 + m);
        put_row(pl, slot(2 * q), a[m].x, a[m].y, a[m].z, a[m].w, b[m].x, b[m].y);
        put_row(pl, slot(2 * q + 1), b[m].z, b[m].w, c[m].x, c[m].y, c[m].z, c[m].w);
      }
    }
  } else {
    for (int k = threadIdx.x; k < kSub; k += kThreads) {
      if (k < count) {
        put_row(pl, slot(k), rs + 6 * k);
      } else {
        zero_row(pl, slot(k));
      }
    }
  }
}

// The compose route: frame fb + i at entry i for every frame the sub-tile of
// `count` samples from s0 touches (fb the first), zero past the last with a
// sample. `rs` is the section's first row.
static __device__ void stage_frames(float* pl, const float* rs, int64_t s0, int count,
                                    int64_t frame_len) {
  const int64_t fb = s0 / frame_len;
  const int64_t flive = (s0 + count - 1) / frame_len;
  const int nf = static_cast<int>((s0 + kSub - 1) / frame_len - fb + 1);
  for (int i = threadIdx.x; i < nf; i += kThreads) {
    if (fb + i <= flive) {
      put_row(pl, i, rs + 6 * (fb + i));
    } else {
      zero_row(pl, i);
    }
  }
}

// [[a b] [c d]] <- its square.
static __device__ __forceinline__ void square(double& a, double& b, double& c, double& d) {
  const double bc = b * c;
  const double t = a + d;
  a = fma(a, a, bc);
  d = fma(d, d, bc);
  b *= t;
  c *= t;
}

// The state route: entry k kWarps + w for sections first <= k < S, from the
// row of the frame of warp w's first sample (zero when that lies at or past
// t1, the tile's last sample + 1). `rc` is section 0's first row.
static __device__ void stage_table(Entry* tab, const float* rc, int64_t sec_stride, int S,
                                   int first, int64_t s0, int64_t t1, int64_t frame_len) {
  for (int e = threadIdx.x; e < S * kWarps; e += kThreads) {
    const int k = e / kWarps;
    const int64_t g = s0 + static_cast<int64_t>(e % kWarps) * kSpan;
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    if (k >= first && g < t1) {
      const float* r = rc + k * sec_stride + (g / frame_len) * 6;
      const float2 u = reinterpret_cast<const float2*>(r)[0];
      const float2 v = reinterpret_cast<const float2*>(r)[1];
      const float2 w = reinterpret_cast<const float2*>(r)[2];
      const float inv = 1.0f / v.y;
      b0 = u.x * inv;
      b1 = u.y * inv;
      b2 = v.x * inv;
      a1 = w.x * inv;
      a2 = w.y * inv;
    }
    Entry& t = tab[e];
    t.f[0] = b0;
    t.f[1] = b1;
    t.f[2] = b2;
    t.f[3] = -a1;
    t.f[4] = -a2;
#pragma unroll
    for (int i = 0; i < 5; ++i) t.c[i] = t.f[i];
    double m11 = -static_cast<double>(a1), m12 = 1.0, m21 = -static_cast<double>(a2), m22 = 0.0;
#pragma unroll
    for (int i = 1; i < kSeg; i <<= 1) square(m11, m12, m21, m22);  // Phi^kSeg
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      if (p > 0) square(m11, m12, m21, m22);
      t.q[p][0] = m11;
      t.q[p][1] = m12;
      t.q[p][2] = m21;
      t.q[p][3] = m22;
    }
  }
}

// Step c, on warp 0, in lanes of eight: lane u = lane % kWarps of a group
// holds warp u's map (A, z) over the section's sub-tile for the group's
// column; three shuffle steps scan them, the column's carry `car` folded into
// warp 0's. Where `live`, lane u leaves the state entering warp u in wbeg[2u],
// wbeg[2u + 1] and lane kWarps - 1 the state leaving the sub-tile in `next`.
static __device__ __forceinline__ void block_scan(double a11, double a12, double a21, double a22,
                                                  double z1, double z2, const double* car,
                                                  double* next, double* wbeg, bool live) {
  const int u = threadIdx.x & (kWarps - 1);
  const double k1 = car[0], k2 = car[1];
  if (u == 0) {
    const double n1 = fma(a11, k1, fma(a12, k2, z1));
    z2 = fma(a21, k1, fma(a22, k2, z2));
    z1 = n1;
  }
#pragma unroll
  for (int d = 1; d < kWarps; d <<= 1) {
    const double e11 = __shfl_up_sync(kFull, a11, d, kWarps);
    const double e12 = __shfl_up_sync(kFull, a12, d, kWarps);
    const double e21 = __shfl_up_sync(kFull, a21, d, kWarps);
    const double e22 = __shfl_up_sync(kFull, a22, d, kWarps);
    const double f1 = __shfl_up_sync(kFull, z1, d, kWarps);
    const double f2 = __shfl_up_sync(kFull, z2, d, kWarps);
    if (u >= d) {
      const double n1 = fma(a11, f1, fma(a12, f2, z1));
      z2 = fma(a21, f1, fma(a22, f2, z2));
      z1 = n1;
      const double n11 = fma(a11, e11, a12 * e21);
      const double n12 = fma(a11, e12, a12 * e22);
      const double n21 = fma(a21, e11, a22 * e21);
      a22 = fma(a21, e12, a22 * e22);
      a11 = n11;
      a12 = n12;
      a21 = n21;
    }
  }
  // lane u holds the state leaving warp u
  const double p1 = __shfl_up_sync(kFull, z1, 1, kWarps);
  const double p2 = __shfl_up_sync(kFull, z2, 1, kWarps);
  if (live) {
    wbeg[2 * u] = u == 0 ? k1 : p1;
    wbeg[2 * u + 1] = u == 0 ? k2 : p2;
    if (u == kWarps - 1) {
      next[0] = z1;
      next[1] = z2;
    }
  }
}

// Step d's float32 run from (s1, s2), y in place of x in the thread's row xs
// of column g's buffer; the state after sample jlast (of the chunk's last
// sample, else -1) is section k's end state, out[(k C + c) 2 + i].
static __device__ __forceinline__ void run32(float* xs, int j, float b0, float b1, float b2,
                                             float ma1, float ma2, float& s1, float& s2,
                                             int jlast, int g, int k, int C, float* out) {
  const float xv = xs[j];
  const float yv = fmaf(b0, xv, s1);
  const float n1 = fmaf(ma1, yv, fmaf(b1, xv, s2));
  s2 = fmaf(ma2, yv, b2 * xv);
  s1 = n1;
  xs[j] = yv;
  if (j == jlast && g < tv_blk.cols) {
    float* e = out + (static_cast<int64_t>(k) * C + tv_blk.c0 + g) * 2;
    e[0] = s1;
    e[1] = s2;
  }
}

// A section's planes for the sub-tile of `count` samples from s0; `rs` is the
// section's first row.
template <int ROUTE>
static __device__ __forceinline__ void stage(float* pl, const float* rs, int64_t s0, int count,
                                             int64_t frame_len) {
  if constexpr (ROUTE == kRows) {
    stage_rows(pl, rs + s0 * 6, count);
  } else {
    stage_frames(pl, rs, s0, count, frame_len);
  }
}

// Step c on warp 0 for G columns, lanes 8g to 8g + 7 column g: a (4 a warp)
// the warps' maps A of the columns (on the state route `a` is null and A is
// each warp's Psi^32 from the table), z (2 a column and warp) their states;
// car, next: column 0's carry in and out, column g's 2 kGroup further on. The
// states entering the warps go to wbeg (2 a column and warp).
template <int G>
static __device__ __forceinline__ void block_scans(const double* a, const Entry* tab, int k,
                                                   const double* z, const double* car,
                                                   double* next, double* wbeg) {
  const int lane = threadIdx.x & 31;
  const int u = lane & (kWarps - 1);
  const int g = lane / kWarps < G ? lane / kWarps : 0;
  const double* m = a != nullptr ? a + 4 * u : tab[k * kWarps + u].q[5];
  const double* zu = z + 2 * (g * kWarps + u);
  block_scan(m[0], m[1], m[2], m[3], zu[0], zu[1], car + g * 2 * kGroup, next + g * 2 * kGroup,
             wbeg + 2 * kWarps * g, lane / kWarps < tv_blk.cols);
}

// One section over the sub-tile for the block's G columns in lockstep, on the
// rows or compose route, in place in their buffers (xs: the thread's row of
// column 0's, column g's kPlane further on). The product of the Phis and its
// scan are the same for every column (their rows are), so they run once; each
// column runs its own state. pl: the staged planes, the thread's first entry
// idx0, bit j of adv set where its sample j + 1 reads the next; car, next:
// column 0's carry in and out (column g's 2 kGroup further on); wt: the warp
// totals and entry states; jlast, k, C, out: as run32 (columns past
// tv_blk.cols run on zeros and leave nothing); UNROLL: the sample loops' unrolling.
template <int G, int UNROLL>
static __device__ __forceinline__ void compose_pass(float* xs, const float* pl, int idx0,
                                                    unsigned adv, const double* car, double* next,
                                                    double* wt, int jlast, int k, int C,
                                                    float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a. from rest in float64: each column's state z, and A, the product of the Phis
  double P11 = 1.0, P12 = 0.0, P21 = 0.0, P22 = 1.0;
  double Z1[G], Z2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) Z1[g] = Z2[g] = 0.0;
  {
    int i = idx0;
#pragma unroll UNROLL
    for (int j = 0; j < kSeg; ++j) {
      const double b0 = pl[i], b1 = pl[kPlane + i], b2 = pl[2 * kPlane + i];
      const double ma1 = -pl[3 * kPlane + i], ma2 = -pl[4 * kPlane + i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double xv = xs[g * kPlane + j];
        const double yv = fma(b0, xv, Z1[g]);
        const double n1 = fma(ma1, yv, fma(b1, xv, Z2[g]));
        Z2[g] = fma(ma2, yv, b2 * xv);
        Z1[g] = n1;
      }
      const double m11 = fma(ma1, P11, P21);
      const double m12 = fma(ma1, P12, P22);
      P21 = ma2 * P11;
      P22 = ma2 * P12;
      P11 = m11;
      P12 = m12;
      i += (adv >> j) & 1;
    }
  }
  // b. inclusive warp scan: (A, z) after (A', z') is (A A', A z' + z)
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double e11 = __shfl_up_sync(kFull, P11, d);
    const double e12 = __shfl_up_sync(kFull, P12, d);
    const double e21 = __shfl_up_sync(kFull, P21, d);
    const double e22 = __shfl_up_sync(kFull, P22, d);
    double f1[G], f2[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      f1[g] = __shfl_up_sync(kFull, Z1[g], d);
      f2[g] = __shfl_up_sync(kFull, Z2[g], d);
    }
    if (lane >= d) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        Z1[g] = fma(P11, f1[g], fma(P12, f2[g], Z1[g]));
        Z2[g] = fma(P21, f1[g], fma(P22, f2[g], Z2[g]));
      }
      const double n11 = fma(P11, e11, P12 * e21);
      const double n12 = fma(P11, e12, P12 * e22);
      const double n21 = fma(P21, e11, P22 * e21);
      P22 = fma(P21, e12, P22 * e22);
      P11 = n11;
      P12 = n12;
      P21 = n21;
    }
  }
  // c. the warp totals, scanned by warp 0 from each column's carry
  if (lane == 31) {
    double* w = wt + 4 * warp;
    w[0] = P11;
    w[1] = P12;
    w[2] = P21;
    w[3] = P22;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wt[4 * kWarps + 2 * (g * kWarps + warp)] = Z1[g];
      wt[4 * kWarps + 2 * (g * kWarps + warp) + 1] = Z2[g];
    }
  }
  __syncthreads();
  double* wbeg = wt + 4 * kWarps + 2 * kWarps * G;
  if (warp == 0) block_scans<G>(wt, nullptr, 0, wt + 4 * kWarps, car, next, wbeg);
  __syncthreads();
  // d. each column's state leaving the lane, shifted up a lane: the state entering it
  float s1[G], s2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const double c1 = wbeg[2 * (g * kWarps + warp)], c2 = wbeg[2 * (g * kWarps + warp) + 1];
    const double o1 = fma(P11, c1, fma(P12, c2, Z1[g]));
    const double o2 = fma(P21, c1, fma(P22, c2, Z2[g]));
    const double e1 = __shfl_up_sync(kFull, o1, 1);
    const double e2 = __shfl_up_sync(kFull, o2, 1);
    s1[g] = static_cast<float>(lane == 0 ? c1 : e1);
    s2[g] = static_cast<float>(lane == 0 ? c2 : e2);
  }
  int i = idx0;
#pragma unroll UNROLL
  for (int j = 0; j < kSeg; ++j) {
    const float b0 = pl[i], b1 = pl[kPlane + i], b2 = pl[2 * kPlane + i];
    const float ma1 = -pl[3 * kPlane + i], ma2 = -pl[4 * kPlane + i];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      run32(xs + g * kPlane, j, b0, b1, b2, ma1, ma2, s1[g], s2[g], jlast, g, k, C, out);
    }
    i += (adv >> j) & 1;
  }
}

// One section k over the sub-tile for the block's G columns in lockstep on the
// state route (arguments as compose_pass). Each warp's section is its table
// entry e: the lanes' states from rest in float64, their inclusive warp scan
// z_i += Psi^d z_{i-d}, the block scans, then the state entering each lane,
// Psi^lane (the warp's entry state) plus the exclusive sum, and the float32
// runs from it.
template <int G>
static __device__ __forceinline__ void state_pass(float* xs, const Entry* tab, int k,
                                                  const double* car, double* next, double* wt,
                                                  int jlast, int C, float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Entry& e = tab[k * kWarps + warp];
  // a. the lanes' samples from rest in float64, the state alone
  const double b0 = e.c[0], b1 = e.c[1], b2 = e.c[2], ma1 = e.c[3], ma2 = e.c[4];
  double Z1[G], Z2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) Z1[g] = Z2[g] = 0.0;
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const double xv = xs[g * kPlane + j];
      const double yv = fma(b0, xv, Z1[g]);
      const double n1 = fma(ma1, yv, fma(b1, xv, Z2[g]));
      Z2[g] = fma(ma2, yv, b2 * xv);
      Z1[g] = n1;
    }
  }
  // b. inclusive warp scan of the states
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const int d = 1 << p;
    double f1[G], f2[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      f1[g] = __shfl_up_sync(kFull, Z1[g], d);
      f2[g] = __shfl_up_sync(kFull, Z2[g], d);
    }
    if (lane >= d) {
      const double* q = e.q[p];
      const double q11 = q[0], q12 = q[1], q21 = q[2], q22 = q[3];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double n1 = fma(q11, f1[g], fma(q12, f2[g], Z1[g]));
        Z2[g] = fma(q21, f1[g], fma(q22, f2[g], Z2[g]));
        Z1[g] = n1;
      }
    }
  }
  // c. the warp totals: Psi^32 from the table, z from lane 31
  if (lane == 31) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      wt[2 * (g * kWarps + warp)] = Z1[g];
      wt[2 * (g * kWarps + warp) + 1] = Z2[g];
    }
  }
  __syncthreads();
  double* wbeg = wt + 2 * kWarps * G;
  if (warp == 0) block_scans<G>(nullptr, tab, k, wt, car, next, wbeg);
  __syncthreads();
  // d. Psi^lane times the warp's entry state, by the bits of the lane, plus the exclusive sum
  double c1[G], c2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    c1[g] = wbeg[2 * (g * kWarps + warp)];
    c2[g] = wbeg[2 * (g * kWarps + warp) + 1];
  }
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    if ((lane >> p) & 1) {
      const double* q = e.q[p];
      const double q11 = q[0], q12 = q[1], q21 = q[2], q22 = q[3];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const double n1 = fma(q11, c1[g], q12 * c2[g]);
        c2[g] = fma(q21, c1[g], q22 * c2[g]);
        c1[g] = n1;
      }
    }
  }
  float s1[G], s2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const double x1 = __shfl_up_sync(kFull, Z1[g], 1);
    const double x2 = __shfl_up_sync(kFull, Z2[g], 1);
    s1[g] = static_cast<float>(c1[g] + (lane == 0 ? 0.0 : x1));
    s2[g] = static_cast<float>(c2[g] + (lane == 0 ? 0.0 : x2));
  }
  const float f0 = e.f[0], f1 = e.f[1], f2 = e.f[2], f3 = e.f[3], f4 = e.f[4];
#pragma unroll
  for (int j = 0; j < kSeg; ++j) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      run32(xs + g * kPlane, j, f0, f1, f2, f3, f4, s1[g], s2[g], jlast, g, k, C, out);
    }
  }
}

// Dynamic shared bytes of a block: five planes, or the state route's S kWarps
// entries; then G column buffers, padded planes.
static __host__ __device__ __forceinline__ int coef_bytes(int route, int S) {
  return route == kState ? S * kWarps * static_cast<int>(sizeof(Entry)) : 5 * kPlane * 4;
}

// Launches 1 (ends != 0) and 3 (ends == 0) of one group of S <= kGroup
// sections. A block carries G columns of one tile in lockstep, which share its
// staged coefficients (G > 1 only for shared rows): block b is column group b
// % ncols of tile b / ncols. Launch 1: ncols = ceil(C / G) + Cc ceil(2S / G);
// channel c's column is its signal from zero state, leaving carry[c, t]; unit
// column j of coefficient channel cc is the zero input from the unit state e_j
// with cc's rows, leaving column j of trans[cc, t] (it runs from the section of
// the group's first unit on: before its own its state and input are zero, and
// stay so). Launch 3: ncols = ceil(C / G), from carry[c, t], writing y and,
// where it holds sample n-1, state_out[(k C + c) 2 + i]. A group's last block
// may carry fewer columns than G: the rest run on zeros and are not written.
// NS > 0 fixes S (B17: NS = 1); ROUTE is how a sample finds its row (rows:
// B16, B17; compose and state: B18).
template <int NS, int ROUTE, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
tv_tile_kernel(const float* x, float* y, const float* __restrict__ rows, int64_t sec_stride,
               int64_t chan_stride, int64_t frame_len, int sections, float* __restrict__ carry,
               float* __restrict__ trans, float* __restrict__ state_out, int64_t n, int64_t tile,
               int64_t ntiles, int C, int Cc, int ends) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ double wtot[4 * kWarps + 4 * kWarps * G];  // warp totals and entry states
  __shared__ double scar[2][G * 2 * kGroup];             // carries by the sub-tile's parity
  const int S = NS > 0 ? NS : sections;
  const int D = 2 * S;
  const int tid = threadIdx.x;
  // the sample loops' unrolling: what keeps each instantiation within 80 registers
  constexpr int kJu = NS == 0 && ROUTE == kRows ? kSeg : kSeg / 2;
  {
    const int sg = (C + G - 1) / G;  // signal column groups
    const int ug = (D + G - 1) / G;  // unit column groups a coefficient channel
    const int64_t ncols = ends ? sg + static_cast<int64_t>(Cc) * ug : sg;
    const int64_t gi = blockIdx.x % ncols;
    const int64_t t = blockIdx.x / ncols;
    const bool signal = gi < sg;
    const int c0 = signal ? static_cast<int>(gi) * G : 0;
    const int u0 = signal ? 0 : static_cast<int>((gi - sg) % ug) * G;  // the first unit
    const int cc = signal ? (Cc == 1 ? 0 : c0) : static_cast<int>((gi - sg) / ug);
    const int cols = signal ? min(G, C - c0) : min(G, D - u0);
    const int64_t t0 = t * tile;
    if (tid == 0) {
      tv_blk.x0 = static_cast<int64_t>(c0) * n + t0;
      tv_blk.r0 = static_cast<int64_t>(cc) * chan_stride;
      tv_blk.t0 = t0;
      tv_blk.len = static_cast<int>(t0 + tile < n ? tile : n - t0);
      tv_blk.c0 = c0;
      tv_blk.u0 = u0;
      tv_blk.cc = cc;
      tv_blk.cols = cols;
      tv_blk.signal = signal;
    }
    if (tid < G * D) {
      const int j = tid / D, i = tid % D;
      float v = 0.0f;
      if (j < cols) {
        if (!ends) {
          v = carry[(static_cast<int64_t>(c0 + j) * ntiles + t) * D + i];
        } else if (!signal && i == u0 + j) {
          v = 1.0f;
        }
      }
      scar[0][j * 2 * kGroup + i] = v;
      scar[1][j * 2 * kGroup + i] = v;
    }
  }
  __syncthreads();
  float* pl = reinterpret_cast<float*>(smem);
  const Entry* tab = reinterpret_cast<const Entry*>(smem);
  float* xb = reinterpret_cast<float*>(smem + coef_bytes(ROUTE, S));
  float* xs = xb + tid * kRow;
  int par = 0;
#pragma unroll 1
  for (int s = 0; s < tv_blk.len; s += kSub) {
    const int count = tv_blk.len - s < kSub ? tv_blk.len - s : kSub;
    const int64_t s0 = tv_blk.t0 + s;  // the sub-tile's first sample
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const bool on = tv_blk.signal && j < tv_blk.cols;
      load_x(xb + j * kPlane, x + (on ? tv_blk.x0 + j * n + s : 0), on ? count : 0);
    }
    int jlast = -1;  // the thread's sample n - 1 in launch 3, if it has it
    if (!ends && state_out != nullptr && n - 1 - s0 < kSub) {
      const int p = static_cast<int>(n - 1 - s0);
      if (p / kSeg == tid) jlast = p % kSeg;
    }
    // the thread's first plane entry and where its samples step to the next:
    // every sample on the rows route, at frame edges on the compose route
    int idx0 = tid * kRow;
    unsigned adv = 0xffu;
    if constexpr (ROUTE == kCompose) {
      const int64_t g0 = s0 + static_cast<int64_t>(tid) * kSeg;
      const int64_t f0 = g0 / frame_len;
      idx0 = static_cast<int>(f0 - s0 / frame_len);
      adv = 0;
      for (int64_t j = 0, rem = g0 - f0 * frame_len; j < kSeg; ++j) {
        if (++rem == frame_len) {
          rem = 0;
          adv |= 1u << j;
        }
      }
    }
    // the first section's coefficients while x lands
    const int kmin = tv_blk.u0 / 2;  // the first section run: the first unit's
    if constexpr (ROUTE == kState) {
      stage_table(reinterpret_cast<Entry*>(smem), rows + tv_blk.r0, sec_stride, S, kmin, s0,
                  tv_blk.t0 + tv_blk.len, frame_len);
    } else {
      stage<ROUTE>(pl, rows + tv_blk.r0 + kmin * sec_stride, s0, count, frame_len);
    }
    cp_async_wait();
    __syncthreads();
    const double* cin = scar[par];
    double* cout = scar[par ^ 1];
    auto section = [&](int k) {
      if constexpr (ROUTE == kState) {
        state_pass<G>(xs, tab, k, cin + 2 * k, cout + 2 * k, wtot, jlast, C, state_out);
      } else {
        if (k != kmin) {
          __syncthreads();  // the planes' last readers are done
          stage<ROUTE>(pl, rows + tv_blk.r0 + k * sec_stride, tv_blk.t0 + s, count, frame_len);
          __syncthreads();
        }
        compose_pass<G, kJu>(xs, pl, idx0, adv, cin + 2 * k, cout + 2 * k, wtot, jlast, k, C,
                             state_out);
      }
    };
    if constexpr (NS > 0) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (k >= kmin) section(k);
      }
    } else {
#pragma unroll 1
      for (int k = kmin; k < S; ++k) section(k);
    }
    if (!ends) {
      __syncthreads();
#pragma unroll 1
      for (int j = 0; j < tv_blk.cols; ++j) {
        float* yr = y + tv_blk.x0 + j * n + s;
        store_y(yr, xb + j * kPlane, count, (reinterpret_cast<uintptr_t>(yr) & 15) == 0);
      }
    }
    __syncthreads();
    par ^= 1;
  }
  if (ends && tid < tv_blk.cols * D) {
    const int j = tid / D, i = tid % D;
    const float v = static_cast<float>(scar[par][j * 2 * kGroup + i]);
    const int64_t t = tv_blk.t0 / tile;
    if (tv_blk.signal) {
      carry[(static_cast<int64_t>(tv_blk.c0 + j) * ntiles + t) * D + i] = v;
    } else {
      trans[((static_cast<int64_t>(tv_blk.cc) * (ntiles - 1) + t) * D + i) * D + tv_blk.u0 + j] =
          v;
    }
  }
}

// Row r of M_t (zeros past D) into m.
template <int W>
static __device__ __forceinline__ void load_m(float (&m)[W], const float* mt, int64_t t, int r,
                                              int D) {
#pragma unroll
  for (int q = 0; q < W; ++q) m[q] = (r < D && q < D) ? mt[(t * D + r) * D + q] : 0.0f;
}

// Launch 2. Warp c walks channel c's tiles: carry[c, t] <- s_t, with s_0 the
// seed ((S, C, 2), zero when null) and s_{t+1} = M_t s_t + z_t, M_t read from
// trans[cc] (cc = 0 for shared rows) and z_t from carry[c, t], in float64.
// Lane r < D holds s[r]; the next tile's row of M and z are loaded while this
// tile's step runs. W is a compile-time width >= D.
template <int W>
__global__ void __launch_bounds__(32)
tv_carry_kernel(float* __restrict__ carry, const float* __restrict__ trans,
                const float* __restrict__ seed, int64_t ntiles, int C, int Cc, int D) {
  const int c = blockIdx.x;
  const int r = threadIdx.x;
  const int cc = Cc == 1 ? 0 : c;
  double s = 0.0;
  if (seed != nullptr && r < D) s = seed[(static_cast<int64_t>(r >> 1) * C + c) * 2 + (r & 1)];
  float* base = carry + static_cast<int64_t>(c) * ntiles * D;
  const float* mt = trans + static_cast<int64_t>(cc) * (ntiles - 1) * D * D;
  float m[W], mnext[W];
  float znext = 0.0f;
  if (ntiles > 1) {
    load_m(mnext, mt, 0, r, D);
    if (r < D) znext = base[r];
  }
  for (int64_t t = 0; t < ntiles; ++t) {
    const float z = znext;
    if (r < D) base[t * D + r] = static_cast<float>(s);
    if (t == ntiles - 1) break;
#pragma unroll
    for (int q = 0; q < W; ++q) m[q] = mnext[q];
    if (t + 1 < ntiles - 1) {
      load_m(mnext, mt, t + 1, r, D);
      if (r < D) znext = base[(t + 1) * D + r];
    }
    double acc0 = z, acc1 = 0.0;
#pragma unroll
    for (int q = 0; q < W; q += 2) {
      acc0 = fma(static_cast<double>(m[q]), __shfl_sync(kFull, s, q), acc0);
      if constexpr (W > 1) {
        acc1 = fma(static_cast<double>(m[q + 1]), __shfl_sync(kFull, s, q + 1), acc1);
      }
    }
    s = acc0 + acc1;
  }
}

static cudaError_t launch_carry(float* carry, const float* trans, const float* seed,
                                int64_t ntiles, int C, int Cc, int D, cudaStream_t s) {
  const auto g = static_cast<unsigned>(C);
  if (D <= 2) {
    tv_carry_kernel<2><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else if (D <= 4) {
    tv_carry_kernel<4><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else if (D <= 8) {
    tv_carry_kernel<8><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else if (D <= 16) {
    tv_carry_kernel<16><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  } else {
    tv_carry_kernel<32><<<g, 32, 0, s>>>(carry, trans, seed, ntiles, C, Cc, D);
  }
  return cudaGetLastError();
}

using TileKernel = void (*)(const float*, float*, const float*, int64_t, int64_t, int64_t, int,
                            float*, float*, float*, int64_t, int64_t, int64_t, int, int, int);

constexpr int kRowsColumns = 3;   // columns a block on the rows and compose routes
constexpr int kStateColumns = 4;  // and on the state route: three blocks an SM

// The tile kernel of each kind: 0 B16 (rows), 1 B17 (rows, S = 1), 2 B18 on
// the compose route, 3 B18 on the state route; `grouped`: columns in groups
// (rows shared by more than one channel), else one a block.
static TileKernel tile_kernel(int64_t kind, bool grouped) {
  switch (kind) {
    case 0: return grouped ? tv_tile_kernel<0, kRows, kRowsColumns> : tv_tile_kernel<0, kRows, 1>;
    case 1: return grouped ? tv_tile_kernel<1, kRows, kRowsColumns> : tv_tile_kernel<1, kRows, 1>;
    case 2:
      return grouped ? tv_tile_kernel<0, kCompose, kRowsColumns> : tv_tile_kernel<0, kCompose, 1>;
    case 3:
      return grouped ? tv_tile_kernel<0, kState, kStateColumns> : tv_tile_kernel<0, kState, 1>;
    default: return nullptr;
  }
}

static int columns(int64_t kind, bool grouped) {
  return !grouped ? 1 : kind == 3 ? kStateColumns : kRowsColumns;
}

// The launch's dynamic shared bytes; allows them on the kernel.
static cudaError_t prepare(TileKernel k, int64_t kind, int S, int group, int* bytes) {
  *bytes = coef_bytes(kind == 3 ? kState : kRows, S) + group * kPlane * 4;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(k),
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace iir_tv
}  // namespace dsp

// B16 (kind 0: per-sample rows, any S), B17 (kind 1: per-sample rows, S = 1)
// and B18 (kind 2: a row a frame of frame_len samples, any S, composing the
// maps; kind 3: the same with frame_len a multiple of 256, scanning the state
// alone). x, y: (C, n), y may be written in place of x only by the groups
// after the first; rows: (S, Cc, F, 6), 8-byte aligned, section k and
// coefficient channel cc at rows + k sec_stride + cc chan_stride (chan_stride
// 0 when Cc = 1); carry: C ceil(n / tile) 2G floats and trans: Cc (ceil(n /
// tile) - 1) (2G)^2 floats of scratch, G = min(S, 16); seed, state_out: (S,
// C, 2) or null.
extern "C" int dsp_tv_cascade(const float* x, float* y, const float* rows, int64_t sec_stride,
                              int64_t chan_stride, int64_t frame_len, float* carry, float* trans,
                              const float* seed, float* state_out, int64_t n, int64_t channels,
                              int64_t coef_channels, int64_t sections, int64_t tile, int64_t kind,
                              void* stream) {
  using namespace dsp::iir_tv;
  const bool bad =
      n < 1 || channels < 1 || channels > 65535 || tile < kSub || tile % kSub != 0 ||
      frame_len < 1 || sections < 1 || (coef_channels != 1 && coef_channels != channels) ||
      (kind == 1 && sections != 1) || kind < 0 || kind > 3 ||
      (kind == 3 && frame_len % kSpan != 0) ||
      (reinterpret_cast<uintptr_t>(rows) & 7) != 0 || sec_stride % 2 != 0 || chan_stride % 2 != 0;
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + tile - 1) / tile;
  const int64_t widest = channels + coef_channels * 2 * (sections < kGroup ? sections : kGroup);
  if ((ntiles - 1) * widest > 0x7fffffff || ntiles * channels > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool grouped = coef_channels == 1 && channels > 1;
  const TileKernel k = tile_kernel(kind, grouped);
  const int G = columns(kind, grouped);
  const auto s = static_cast<cudaStream_t>(stream);
  const int C = static_cast<int>(channels);
  const int Cc = static_cast<int>(coef_channels);
  for (int64_t g = 0; g < sections; g += kGroup) {
    const int S = static_cast<int>(sections - g < kGroup ? sections - g : kGroup);
    const int D = 2 * S;
    const float* in = g == 0 ? x : y;
    const float* rg = rows + g * sec_stride;
    const float* sg = seed != nullptr ? seed + g * C * 2 : nullptr;
    float* og = state_out != nullptr ? state_out + g * C * 2 : nullptr;
    int bytes = 0;
    cudaError_t err = prepare(k, kind, S, G, &bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t signal_groups = (C + G - 1) / G;
    if (ntiles > 1) {
      const int64_t ncols = signal_groups + static_cast<int64_t>(Cc) * ((D + G - 1) / G);
      k<<<static_cast<unsigned>((ntiles - 1) * ncols), kThreads, bytes, s>>>(
          in, nullptr, rg, sec_stride, chan_stride, frame_len, S, carry, trans, nullptr, n, tile,
          ntiles, C, Cc, 1);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    if ((err = launch_carry(carry, trans, sg, ntiles, C, Cc, D, s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    k<<<static_cast<unsigned>(ntiles * signal_groups), kThreads, bytes, s>>>(
        in, y, rg, sec_stride, chan_stride, frame_len, S, carry, trans, og, n, tile, ntiles, C,
        Cc, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// What the compiler gave the tile kernel of `kind` (as dsp_tv_cascade), and
// the blocks it keeps on an SM at `sections` sections of rows shared by the
// channels (coef_channels 1) or not: out[0] registers a thread, out[1] local
// memory bytes a thread (spills), out[2] shared bytes a block, static and
// dynamic, out[3] blocks resident on an SM, out[4] columns a block.
extern "C" int dsp_tv_attrs(int64_t kind, int64_t sections, int64_t coef_channels, int64_t* out) {
  using namespace dsp::iir_tv;
  const TileKernel k = tile_kernel(kind, coef_channels == 1);
  if (k == nullptr || sections < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int S = static_cast<int>(sections < kGroup ? sections : kGroup);
  const int G = columns(kind, coef_channels == 1);
  int bytes = 0;
  cudaError_t err = prepare(k, kind, S, G, &bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(k))) != cudaSuccess) {
    return static_cast<int>(err);
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, reinterpret_cast<const void*>(k),
                                                      kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int64_t>(a.localSizeBytes);
  out[2] = static_cast<int64_t>(a.sharedSizeBytes) + bytes;
  out[3] = blocks;
  out[4] = G;
  return 0;
}

