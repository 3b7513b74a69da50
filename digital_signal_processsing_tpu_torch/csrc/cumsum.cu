// Per-channel inclusive cumsum of an interleaved int16 stream, int32 modular
// (B4).
//
// Replaces digital_signal_processsing_tpu/ops/pallas_scan.py _cumsum_kernel.
//
// y[f*C + c] = sum_{f' <= f} x[f'*C + c]  mod 2^32, read as int32.
//
// The TPU kernel walks its grid in order and carries a row of sums in VMEM
// scratch. CUDA blocks run in no order, so the carry between tiles is a
// decoupled look-back, in one launch after a memset of its status words:
//   - persistent blocks take an atomic ticket each time they are ready to
//     start a tile (B12's rule, iir.cu): tiles start in ticket order, so a
//     block only ever waits on tiles that are already running (taking the
//     next ticket during the look-back, to issue the next tile's loads
//     before the stores, was tried and lost: PERF.md §6);
//   - right after its in-tile scan a block publishes each channel's tile
//     total (its aggregate) as one 64-bit status word, a flag and the 32-bit
//     value in one relaxed store (tile 0 publishes its totals as inclusive
//     prefixes);
//   - the block then walks back over its predecessors' status words, all
//     its threads' loads in flight at once (256 / C tiles a round; the
//     generic kernel a thread a channel, kBatch words at a time), adding
//     aggregates until each channel meets an inclusive prefix, and
//     publishes its own inclusive prefixes (those sums plus its totals); a
//     block waits only for aggregates, which depend on nothing;
//   - the exclusive prefix is added to every sample and the int32 prefix
//     stored.
// Sums are uint32, exact modulo 2^32: the result is bit-identical whatever
// the look-back's depth or the order in which the tiles finish.
//
// The tile, for C in {1, 2, 4, 8, 16} (a template instance each): steps 1-4
// of run_tile.cuh, B3's tile with the Hillis-Steele scan (B1's): 256
// threads, each holding 4 runs of 8 int16 in registers, its four 16-byte
// loads issued together where the tile lies inside the stream and x is
// 16-byte aligned (else run by run and sample by sample); the per-channel
// in-run prefix, across the lanes by __shfl_up_sync, then over the 8 warp
// totals; no shared tile buffer. A run of 8 becomes 8 int32, two 16-byte
// stores where y is aligned, else sample by sample.
//
// Any other C (up to one tile of whole frames in shared memory, about 29000
// channels): cumsum_generic_kernel keeps the stream interleaved as a tile of
// tile_frames frames x C channels in shared memory (block_prefix.cuh's
// segments), and looks back a thread a channel. Its loads and stores go a
// sample at a time.
//
// What bounds it on the H100: memory bytes, 2 bytes in and 4 out a sample
// (0.12 ms at 64M samples), plus 16 bytes a tile and channel of status
// words (1 MB at C = 16). What the 3-4 resident blocks an SM do not hide is
// the look-back: a block holds its tile in registers while its
// predecessors' prefixes arrive, about three rounds of loads at C = 16
// (PERF.md §6).

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"
#include "run_tile.cuh"

namespace dsp {
namespace cum {

using namespace runs;

constexpr unsigned long long kAgg = 1ull << 32;   // flag: the value is the tile's total
constexpr unsigned long long kIncl = 2ull << 32;  // flag: the value is the inclusive prefix
constexpr int kBatch = 8;                         // words a generic look-back loads at once

static __device__ __forceinline__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

static __device__ __forceinline__ void st_status(unsigned long long* p, unsigned long long w) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(w) : "memory");
}

// The exclusive prefix of channel c before tile t, by one thread (the
// generic kernel's): st holds C words a tile.
static __device__ __forceinline__ uint32_t look_back(const unsigned long long* st, long long t, int C, int c) {
  uint32_t acc = 0;
  bool done = false;
  for (long long t1 = t - 1; !done; t1 -= kBatch) {
    unsigned long long w[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) w[k] = t1 - k >= 0 ? ld_status(st + (t1 - k) * C + c) : kIncl;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (!done) {
        while (w[k] < kAgg) {
          __nanosleep(32);
          w[k] = ld_status(st + (t1 - k) * C + c);
        }
        acc += static_cast<uint32_t>(w[k]);
        done = w[k] >= kIncl;
      }
    }
  }
  return acc;
}

// The instances' look-back, by the whole block (C in 1, 2, 4, 8, 16): in
// round r thread i reads the word of channel i % C of tile
// tile - 1 - i / C - r D (D = kThreads / C tiles a round, all loads in
// flight at once), spinning while it is unpublished; the shallowest
// inclusive prefix of each channel is found by atomicMin into hit[r % 3]
// before the round's barrier; after it, the words up to that depth are
// summed into cs (each warp's lanes of one channel first reduced by
// shuffles). A channel that met an inclusive prefix stops; every thread
// reads the same hit row, so the rounds stay uniform. hit[0] holds D and cs
// zeros on entry; round r sets hit[(r + 1) % 3], last read two rounds ago.
template <int C>
static __device__ __forceinline__ void block_look_back(const unsigned long long* st, long long tile,
                                                       uint32_t* cs, int (*hit)[C]) {
  constexpr int D = kThreads / C;
  const int tid = threadIdx.x, c = tid % C, j = tid / C;
  uint32_t open = (1u << C) - 1u;  // the channels still looking
  for (int r = 0; open != 0u; ++r) {
    int* h = hit[r % 3];
    if (tid < C) hit[(r + 1) % 3][tid] = D;
    const bool mine = (open >> c) & 1u;
    const long long pt = tile - 1 - j - static_cast<long long>(r) * D;
    unsigned long long w = kIncl;  // before the stream: an inclusive prefix of 0
    if (mine && pt >= 0) {
      w = ld_status(st + pt * C + c);
      while (w < kAgg) {
        __nanosleep(32);
        w = ld_status(st + pt * C + c);
      }
    }
    if (mine && w >= kIncl) atomicMin(&h[c], j);
    __syncthreads();
    uint32_t v = mine && j <= h[c] ? static_cast<uint32_t>(w) : 0u;
#pragma unroll
    for (int o = C; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((tid & 31) < C && mine) atomicAdd(&cs[c], v);
    uint32_t still = 0u;
#pragma unroll
    for (int k = 0; k < C; ++k) still |= ((open >> k) & 1u) && h[k] == D ? 1u << k : 0u;
    open = still;
  }
}

// Eight int32 of a run from sample p0 on: two 16-byte stores where y is
// aligned and the run lies inside the stream, else sample by sample.
static __device__ __forceinline__ void store_run32(int32_t* y, long long p0, long long n, bool vec,
                                                   const uint32_t (&o)[kRun]) {
  if (vec && p0 + kRun <= n) {
    int4* d = reinterpret_cast<int4*>(y + p0);
    __stcs(d, make_int4(static_cast<int>(o[0]), static_cast<int>(o[1]), static_cast<int>(o[2]),
                        static_cast<int>(o[3])));
    __stcs(d + 1, make_int4(static_cast<int>(o[4]), static_cast<int>(o[5]),
                            static_cast<int>(o[6]), static_cast<int>(o[7])));
  } else {
#pragma unroll
    for (int m = 0; m < kRun; ++m) {
      if (p0 + m < n) y[p0 + m] = static_cast<int32_t>(o[m]);
    }
  }
}

// C in {1, 2, 4, 8, 16}: tiles of kTile samples. rec[0] is the ticket, rec[1 +
// t*C + c] tile t's status word of channel c (all zero at launch).
template <int C>
__global__ void __launch_bounds__(kThreads, C >= 8 ? 3 : 4)
cumsum_kernel(const int16_t* __restrict__ x, int32_t* __restrict__ y,
              unsigned long long* __restrict__ rec, long long n, long long tiles, int xvec,
              int yvec) {
  constexpr int SL = C < kRun ? C : kRun;  // channels a run
  constexpr int PH = C / SL;                // phases of the lanes
  __shared__ uint32_t wt[kWarps * C];
  __shared__ uint32_t cs[C];  // the tile's exclusive prefix, by channel
  __shared__ int hit[3][C];   // the look-back's rounds
  __shared__ long long ticket;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int phase = lane & (PH - 1);
  unsigned long long* st = rec + 1;
  Args a = {};
  a.x = x;
  a.len = n;
  a.vec = xvec;
  const uint32_t u[4][2] = {};  // the tensor cores' fragments: unused by this scan
  for (;;) {
    if (tid == 0) ticket = static_cast<long long>(atomicAdd(rec, 1ull));
    __syncthreads();
    const long long tile = ticket;
    if (tile >= tiles) break;
    const long long t0 = tile * kTile;
    if (tid < C) {  // ordered before the look-back by tile_prefix's barrier
      cs[tid] = 0u;
      hit[0][tid] = kThreads / C;
    }
    uint32_t v[kNQ][kRun], off[kNQ][SL], carry[SL];
#pragma unroll
    for (int c = 0; c < SL; ++c) carry[c] = 0u;
    load_tile<false>(a, x, t0, 0, v);
    tile_prefix<kHillisSteele, C>(v, off, carry, wt, lane, warp, u);
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
#pragma unroll
      for (int m = 0; m < kRun; ++m) v[q][m] += off[q][m % SL];
    }
    uint32_t tot = 0;  // channel tid's total (tid < C)
    if (tid < C) {
#pragma unroll
      for (int i = 0; i < kWarps; ++i) tot += wt[i * C + tid];
      st_status(st + tile * C + tid, (tile == 0 ? kIncl : kAgg) | tot);
    }
    if (tile > 0) block_look_back<C>(st, tile, cs, hit);
    __syncthreads();
    if (tile > 0 && tid < C) st_status(st + tile * C + tid, kIncl | static_cast<uint32_t>(cs[tid] + tot));
    uint32_t add[SL];
#pragma unroll
    for (int c = 0; c < SL; ++c) add[c] = cs[SL * phase + c];
#pragma unroll
    for (int q = 0; q < kNQ; ++q) {
      const int run = (warp * kNQ + q) * 32 + lane;
#pragma unroll
      for (int m = 0; m < kRun; ++m) v[q][m] += add[m % SL];
      store_run32(y, t0 + static_cast<long long>(run) * kRun, n, yvec, v[q]);
    }
  }
}

// Any C: tiles of tf whole frames in shared memory as uint32, frame-major,
// scanned by block_prefix.cuh's segments (S of R frames); each channel's
// look-back by one thread. No static shared memory, so a tile may take all
// 227 KB a block can have: the ticket passes through seg's first two words,
// which no thread reads between a tile's last barrier and the next tile's.
__global__ void __launch_bounds__(kThreads)
cumsum_generic_kernel(const int16_t* __restrict__ x, int32_t* __restrict__ y,
                      unsigned long long* __restrict__ rec, long long n, long long tiles, int C,
                      int tf, int R, int S) {
  extern __shared__ uint32_t smem[];
  const int T = tf * C;
  uint32_t* buf = smem;
  uint32_t* seg = smem + T;  // S * C >= 3 words
  unsigned long long* st = rec + 1;
  for (;;) {
    if (threadIdx.x == 0) {
      const unsigned long long tk = atomicAdd(rec, 1ull);
      seg[0] = static_cast<uint32_t>(tk);
      seg[1] = static_cast<uint32_t>(tk >> 32);
    }
    __syncthreads();
    const long long tile = static_cast<long long>(seg[0] | static_cast<unsigned long long>(seg[1]) << 32);
    if (tile >= tiles) break;
    const long long t0 = tile * T;
    for (int j = threadIdx.x; j < T; j += blockDim.x) {
      const long long g = t0 + j;
      buf[j] = g < n ? widen(x[g]) : 0u;
    }
    __syncthreads();
    segment_sums(buf, seg, tf, C, R, S);
    __syncthreads();
    {  // each channel's tile total, published: an aggregate, or at tile 0 the inclusive prefix
      unsigned long long* row = st + tile * C;
      const unsigned long long flag = tile == 0 ? kIncl : kAgg;
      segment_offsets(seg, C, S, [=](int c, uint32_t sum) { st_status(row + c, flag | sum); });
    }
    __syncthreads();
    if (tile > 0) {
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        unsigned long long* mine = st + tile * C + c;
        const uint32_t tot = static_cast<uint32_t>(ld_status(mine));
        const uint32_t ex = look_back(st, tile, C, c);
        st_status(mine, kIncl | static_cast<uint32_t>(ex + tot));
        for (int s = 0; s < S; ++s) seg[c * S + s] += ex;
      }
      __syncthreads();
    }
    segment_apply(buf, seg, tf, C, R, S);
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      const long long g = t0 + t;
      if (g >= n) break;
      y[g] = static_cast<int32_t>(buf[t]);
    }
  }
}

using Kernel = const void*;

static Kernel kernel_of(int kernel_c) {
  switch (kernel_c) {
    case 1: return reinterpret_cast<Kernel>(cumsum_kernel<1>);
    case 2: return reinterpret_cast<Kernel>(cumsum_kernel<2>);
    case 4: return reinterpret_cast<Kernel>(cumsum_kernel<4>);
    case 8: return reinterpret_cast<Kernel>(cumsum_kernel<8>);
    case 16: return reinterpret_cast<Kernel>(cumsum_kernel<16>);
    case 0: return reinterpret_cast<Kernel>(cumsum_generic_kernel);
    default: return nullptr;
  }
}

static int slot_of(int kernel_c) {  // 0..5: the kernel's row of the tables below
  return kernel_c == 0 ? 0 : 1 + __builtin_ctz(static_cast<unsigned>(kernel_c));
}

static int allowed[6][kMaxDevices] = {};
static int per_sm[6][kMaxDevices] = {};

// Blocks of the kernel an SM at `smem` dynamic bytes (its limit raised first).
static cudaError_t occupancy(int kernel_c, int smem, int* blocks) {
  const Kernel k = kernel_of(kernel_c);
  cudaError_t err = allow_smem(k, allowed[slot_of(kernel_c)], smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads,
                                                       static_cast<size_t>(smem));
}

}  // namespace cum
}  // namespace dsp

// B4. kernel_c: 1, 2, 4, 8 or 16 (the stream's channels: their instance,
// tiles of 8192 samples) or 0 (the generic kernel: tiles of tile_frames
// frames, seg_frames x segs segments, smem_bytes of shared memory). rec: 1 +
// tiles * channels int64 of scratch, zeroed here.
extern "C" int dsp_cumsum_i16(const int16_t* x, int32_t* y, int64_t* rec, int64_t n,
                              int64_t channels, int64_t kernel_c, int64_t tile_frames,
                              int64_t seg_frames, int64_t segs, int64_t smem_bytes,
                              void* stream) {
  using namespace dsp::cum;
  if (n <= 0 || channels < 1 || channels > 0x7fffffff || n % channels != 0 ||
      kernel_of(static_cast<int>(kernel_c)) == nullptr ||
      (kernel_c != 0 && kernel_c != channels) || smem_bytes < 0 || smem_bytes > 232448 ||
      (kernel_c == 0 && (tile_frames < 1 || seg_frames < 1 || segs < 1 ||
                         seg_frames * segs < tile_frames ||
                         smem_bytes != 4 * (tile_frames + segs) * channels))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tile = kernel_c != 0 ? static_cast<int64_t>(kTile) : tile_frames * channels;
  const int64_t tiles = (n + tile - 1) / tile;
  const int smem = kernel_c != 0 ? 0 : static_cast<int>(smem_bytes);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= dsp::kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // blocks an SM: cached for the instances; the generic kernel's shared memory grows with C
  int& blocks = per_sm[slot_of(static_cast<int>(kernel_c))][dev];
  if ((blocks == 0 || kernel_c == 0) &&
      (err = occupancy(static_cast<int>(kernel_c), smem, &blocks)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int64_t resident = static_cast<int64_t>(blocks) * sms;
  const auto grid = static_cast<unsigned>(tiles < resident ? tiles : resident);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* r = reinterpret_cast<unsigned long long*>(rec);
  if ((err = cudaMemsetAsync(r, 0, 8 * static_cast<size_t>(1 + tiles * channels), s)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int yvec = reinterpret_cast<uintptr_t>(y) % 16 == 0;
  switch (kernel_c) {
    case 1: cumsum_kernel<1><<<grid, dsp::kThreads, 0, s>>>(x, y, r, n, tiles, xvec, yvec); break;
    case 2: cumsum_kernel<2><<<grid, dsp::kThreads, 0, s>>>(x, y, r, n, tiles, xvec, yvec); break;
    case 4: cumsum_kernel<4><<<grid, dsp::kThreads, 0, s>>>(x, y, r, n, tiles, xvec, yvec); break;
    case 8: cumsum_kernel<8><<<grid, dsp::kThreads, 0, s>>>(x, y, r, n, tiles, xvec, yvec); break;
    case 16: cumsum_kernel<16><<<grid, dsp::kThreads, 0, s>>>(x, y, r, n, tiles, xvec, yvec); break;
    default:
      cumsum_generic_kernel<<<grid, dsp::kThreads, static_cast<size_t>(smem), s>>>(
          x, y, r, n, tiles, static_cast<int>(channels), static_cast<int>(tile_frames),
          static_cast<int>(seg_frames), static_cast<int>(segs));
  }
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave B4's kernel (kernel_c as above): registers a thread,
// local bytes a thread, shared bytes a block (static and dynamic), blocks an
// SM with `smem_bytes` of dynamic shared memory (the generic kernel's; 4
// int64 in out).
extern "C" int dsp_cumsum_attrs(int64_t kernel_c, int64_t smem_bytes, int64_t* out) {
  using namespace dsp::cum;
  const Kernel k = kernel_of(static_cast<int>(kernel_c));
  if (k == nullptr || smem_bytes < 0 || smem_bytes > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kernel_c != 0 ? 0 : static_cast<int>(smem_bytes);
  int blocks = 0;
  cudaError_t err = occupancy(static_cast<int>(kernel_c), smem, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = static_cast<int64_t>(attr.sharedSizeBytes) + smem;
  out[3] = blocks;
  return 0;
}
