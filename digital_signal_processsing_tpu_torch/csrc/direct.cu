// Direct moving averager over an interleaved int16 stream (B5): the window
// sum as k shifted adds, k <= 256.
//
// Replaces digital_signal_processsing_tpu/ops/pallas_direct.py _direct_kernel,
// the reference's shared-memory tiled averager (profilable_sm_averager.cu:14-45).
//
// out[i] = trunc( sum_{j=0..k-1} x[i - j*C] / k ),  x[<0] = 0.
//
// A tile is tf frames of every channel, starting at a frame boundary. Blocks
// are persistent (as many as fit the card), each walking its tiles; it stages
// frames [tile - (k-1), tile end + kRun) of the interleaved stream by 16-byte
// cp.async from the aligned address below the halo into a raw buffer, zeros
// before the stream and past its end, then sends each value to its channel's
// plane in shared memory as int32; the raw buffer then takes the next tile's
// stream, in flight while this tile is summed and stored. A plane pads every
// kRun words with two, so the runs of a warp's 32
// threads, read at the same offset, fall on 32 banks (8-byte loads: two
// wavefronts of 16 lanes). The TPU kernel took the halo from the previous
// tile in VMEM scratch; here every tile re-reads it from global memory, so
// tiles need no carry and run in any order.
//
// A thread owns kRun consecutive frames of one channel and keeps their kRun
// int32 sums in registers. It walks the k + kRun - 1 values that feed them
// once, in pairs (8-byte shared loads), and adds each value to every sum it
// belongs to: value u of the walk to sums r with u - k < r <= u. The head
// (u < kRun) and the tail (u >= k) are unrolled with the sums they reach
// fixed, the middle (every sum) is a runtime loop over pairs, and the tail
// has a copy for each parity of k, so that every index into the sums folds to
// a constant. k < kRun takes a walk of the first 2 kRun - 2 values with each
// add predicated. Each add is its own add.s32 (PTX), so that no sum of two
// values is shared between outputs: every output costs exactly k adds, the
// direct rung of the reference's ladder (a sum shared across outputs is B1's
// sliding window). ptxas fuses a value pair's two adds into one IADD3, which
// runs on the ALU pipe at half rate; in the middle, kRun - kAluSums of the
// sums take their pair as two multiply-adds by 1 (IMAD, the FMA pipe) so that
// both pipes add (the split from tools/ab_lookback_direct.py). Sums stay exact
// in int32 (256 * 32768 < 2^31); the division is a multiply-high by
// ceil(2^32 / k), exact for |sum| < 2^24, truncating toward zero. The results
// go back interleaved through a shared buffer padded by a word a run, and
// leave as 16-byte stores.
//
// What bounds the work on the H100: at 2 bytes in and 2 out a sample, memory
// bytes bound it only for a window of a few tens or less; beyond that the k
// adds a sample do. At 64M samples that is 0.080 ms by bytes (3.35 TB/s)
// against 0.086 ms by int32 adds at k=64 and 0.342 ms at k=256 (a clock of
// an SM adds 192: 64 lanes of IADD3 at two adds, 64 of IMAD at one; 132 SMs
// at 1.98 GHz). Shared-memory loads, (k + kRun) / (2 kRun) an output, are
// no longer the limit; the adds are, with the staging's instructions beside
// them on the ALU pipe.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {

constexpr int kRun = 16;           // consecutive frames a thread sums
constexpr int kRunWords = kRun + 2;  // a run's words in a plane, padded

static __device__ __forceinline__ void add_to(int32_t& acc, int32_t v) {
  asm("add.s32 %0, %0, %1;" : "+r"(acc) : "r"(v));
}

// Both values of a pair to one sum: two adds, which ptxas issues as one
// three-input IADD3 on the ALU pipe.
static __device__ __forceinline__ void add_pair(int32_t& acc, int32_t a, int32_t b) {
  add_to(acc, a);
  add_to(acc, b);
}

// The same two adds as multiply-adds by `one` (1, from the host, so that
// ptxas keeps them): IMAD on the FMA pipe, which the adds leave idle.
static __device__ __forceinline__ void mad_pair(int32_t& acc, int32_t a, int32_t b, int32_t one) {
  asm("mad.lo.s32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(one));
  asm("mad.lo.s32 %0, %1, %2, %0;" : "+r"(acc) : "r"(b), "r"(one));
}

// The sums that take a middle pair as multiply-adds: kRun - kAluSums of them,
// so that the ALU's IADD3 (two adds, half rate) and the FMA pipe's IMAD (one
// add, half rate) finish together, the ALU also carrying the staging.
constexpr int kAluSums = 12;

// Value u of a thread's walk (its run's start + u) in its plane.
static __device__ __forceinline__ int walk_word(int u) {
  return (u / kRun) * kRunWords + u % kRun;
}

static __device__ __forceinline__ int2 pair_at(const int32_t* run, int u) {
  return *reinterpret_cast<const int2*>(run + walk_word(u));
}

// The tail of the walk for k >= kRun: values u = k .. k + kRun - 2 (value
// k + t reaches sums t + 1 .. kRun - 1). Odd k: the pair at k - 1 holds the
// middle's last value (every sum) and value k.
template <bool kOdd>
static __device__ __forceinline__ void walk_tail(const int32_t* run, int k, int32_t (&acc)[kRun]) {
  if constexpr (kOdd) {
    const int2 v = pair_at(run, k - 1);
#pragma unroll
    for (int r = 0; r < kRun; ++r) add_to(acc[r], v.x);
#pragma unroll
    for (int r = 1; r < kRun; ++r) add_to(acc[r], v.y);
  }
  constexpr int t0 = kOdd ? 1 : 0;
#pragma unroll
  for (int t = t0; t < kRun - 1; t += 2) {
    const int2 v = pair_at(run, k + t);
#pragma unroll
    for (int r = t + 1; r < kRun; ++r) add_to(acc[r], v.x);
#pragma unroll
    for (int r = t + 2; r < kRun; ++r) add_to(acc[r], v.y);
  }
}

// The sums of one run: acc[r] = sum of values r .. r + k - 1 of its walk.
static __device__ __forceinline__ void run_sums(const int32_t* run, int k, int32_t one,
                                                int32_t (&acc)[kRun]) {
#pragma unroll
  for (int r = 0; r < kRun; ++r) acc[r] = 0;
  if (k >= kRun) {
    // head: values 0 .. kRun - 1, value u to sums 0 .. u (u - k < 0 <= r)
#pragma unroll
    for (int u = 0; u < kRun; u += 2) {
      const int2 v = pair_at(run, u);
#pragma unroll
      for (int r = 0; r <= u; ++r) add_to(acc[r], v.x);
#pragma unroll
      for (int r = 0; r <= u + 1; ++r) add_to(acc[r], v.y);
    }
    // middle: values kRun .. k - 1 (or k - 2 for odd k), every sum; a padded
    // row of kRun values at a time (fixed offsets), then the pairs left
    const int mid_end = k & ~1;
    int u = kRun;
    for (const int32_t* row = run + kRunWords; u + kRun <= mid_end; u += kRun, row += kRunWords) {
#pragma unroll
      for (int j = 0; j < kRun; j += 2) {
        const int2 v = *reinterpret_cast<const int2*>(row + j);
#pragma unroll
        for (int r = 0; r < kAluSums; ++r) add_pair(acc[r], v.x, v.y);
#pragma unroll
        for (int r = kAluSums; r < kRun; ++r) mad_pair(acc[r], v.x, v.y, one);
      }
    }
    for (; u < mid_end; u += 2) {
      const int2 v = pair_at(run, u);
#pragma unroll
      for (int r = 0; r < kAluSums; ++r) add_pair(acc[r], v.x, v.y);
#pragma unroll
      for (int r = kAluSums; r < kRun; ++r) mad_pair(acc[r], v.x, v.y, one);
    }
    if (k & 1) {
      walk_tail<true>(run, k, acc);
    } else {
      walk_tail<false>(run, k, acc);
    }
  } else {
    // k < kRun: values 0 .. k + kRun - 2 < 2 kRun - 2, each add predicated
#pragma unroll
    for (int u = 0; u < 2 * kRun - 2; u += 2) {
      const int2 v = pair_at(run, u);
#pragma unroll
      for (int r = 0; r < kRun; ++r) {
        if (r <= u && u - r < k) add_to(acc[r], v.x);
        if (r <= u + 1 && u + 1 - r < k) add_to(acc[r], v.y);
      }
    }
  }
}

// trunc(sum / k) for |sum| < 2^24: magic = ceil(2^32 / k) (k >= 2), 0 for k = 1.
static __device__ __forceinline__ int16_t mean_of(int32_t sum, uint32_t magic) {
  if (magic == 0) return static_cast<int16_t>(sum);
  const uint32_t a = static_cast<uint32_t>(sum < 0 ? -sum : sum);
  const int32_t q = static_cast<int32_t>(__umulhi(a, magic));
  return static_cast<int16_t>(sum < 0 ? -q : q);
}

// A tile's raw stream: 16-byte chunks of the interleaved samples from the
// aligned address below its halo, zeros outside [0, n), by cp.async (waited
// for by the caller) where x is 16-byte aligned, else by plain loads.
static __device__ __forceinline__ void stage_raw(const int16_t* x, int64_t n, int64_t ga,
                                                 int chunks, int16_t* raw, bool vec) {
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    const int64_t gs = ga + 8 * static_cast<int64_t>(i);
    int16_t* dst = raw + 8 * i;
    if (vec) {
      const int64_t left = gs >= 0 && gs < n ? n - gs : 0;
      const int bytes = left < 8 ? static_cast<int>(2 * left) : 16;
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                   "l"(bytes > 0 ? x + gs : x), "r"(bytes));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) dst[e] = (gs + e >= 0 && gs + e < n) ? x[gs + e] : int16_t(0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// CT: the channel count when fixed at compile time (1, 2), else 0. Blocks
// are persistent: block b takes tiles b, b + gridDim.x, ...; the next tile's
// raw stream is in flight while this one is summed and stored.
template <int CT>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const int16_t* __restrict__ x, int16_t* __restrict__ y, int64_t n, int window,
              uint32_t magic, int one, int channels, int tf, int plane_words, int in_words) {
  extern __shared__ __align__(16) int32_t buf[];
  const int C = CT > 0 ? CT : channels;
  const int k = window;
  int32_t* planes = buf;
  int16_t* outh = reinterpret_cast<int16_t*>(buf + in_words);
  int16_t* raw = reinterpret_cast<int16_t*>(buf + in_words + ((tf * C / 2 + tf / kRun + 3) & ~3));
  const int64_t frames = n / C;
  const int64_t tiles = (frames + tf - 1) / tf;
  const int lead = k - 1;
  const int span = lead + tf + kRun;  // frames staged a plane
  const int lim = span * C;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // frames [f0 - lead, f0 + tf + kRun) of every channel, from the aligned chunk below
  const auto first = [&](int64_t b) { return (b * tf - lead) * C; };
  const auto below = [](int64_t g0) {
    return g0 >= 0 ? (g0 & ~static_cast<int64_t>(7)) : -((-g0 + 7) & ~static_cast<int64_t>(7));
  };
  const auto chunks_of = [&](int64_t g0) {
    return static_cast<int>((g0 + lim - below(g0) + 7) / 8);
  };
  int64_t b = blockIdx.x;
  if (b < tiles) stage_raw(x, n, below(first(b)), chunks_of(first(b)), raw, vec);
  for (; b < tiles; b += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this tile's stream is in; the last tile's results are stored
    // each value of the raw stream to its channel's plane
    const int64_t g0 = first(b);
    const int64_t ga = below(g0);
    const int chunks = chunks_of(g0);
    for (int i = threadIdx.x; i < chunks; i += kThreads) {
      const uint4 q = *reinterpret_cast<const uint4*>(raw + 8 * i);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
      const int rel = static_cast<int>(ga + 8 * i - g0);  // >= -7
      if (CT > 0 && rel >= 0 && rel + 8 <= lim) {
        // a whole chunk inside, C fixed: (rel + e) / C and % C fold, rel % C
        // being 0 (C = 2: g0 and ga are even)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int re = rel + e;
          planes[(e % CT) * plane_words + walk_word(re / CT)] =
              static_cast<int16_t>(w[e / 2] >> (16 * (e % 2)));
        }
        continue;
      }
      const int re0 = rel > 0 ? rel : 0;
      int f = re0 / C;
      int c = re0 - f * C;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int re = rel + e;
        if (re >= 0) {
          if (re < lim) {
            planes[c * plane_words + walk_word(f)] = static_cast<int16_t>(w[e / 2] >> (16 * (e % 2)));
          }
          if (++c == C) {
            c = 0;
            ++f;
          }
        }
      }
    }
    __syncthreads();  // the planes are in; the raw buffer is free
    const int64_t bn = b + gridDim.x;
    if (bn < tiles) stage_raw(x, n, below(first(bn)), chunks_of(first(bn)), raw, vec);
    const int runs = tf / kRun;
    for (int wk = threadIdx.x; wk < C * runs; wk += kThreads) {
      const int c = wk / runs;
      const int q = wk - c * runs;
      int32_t acc[kRun];
      run_sums(planes + c * plane_words + q * kRunWords, k, one, acc);
      // frame q kRun + r of channel c, interleaved: int16 i = (q kRun + r) C + c,
      // after q pad words
#pragma unroll
      for (int r = 0; r < kRun; ++r) outh[(q * kRun + r) * C + c + 2 * q] = mean_of(acc[r], magic);
    }
    __syncthreads();
    const int64_t f0 = b * tf;
    const int64_t fe = f0 + tf < frames ? f0 + tf : frames;
    const int count = static_cast<int>((fe - f0) * C);
    int16_t* yt = y + f0 * C;
    const uint32_t* outw = reinterpret_cast<const uint32_t*>(outh);
    for (int h = threadIdx.x; 8 * h < count; h += kThreads) {
      const int wd = 4 * h + 4 * h / (8 * C);  // the chunk's first word, past its pads
      if (8 * h + 8 <= count) {
        reinterpret_cast<uint4*>(yt)[h] = make_uint4(outw[wd], outw[wd + 1], outw[wd + 2], outw[wd + 3]);
      } else {
        for (int e = 8 * h; e < count; ++e) yt[e] = outh[e + 2 * (e / (kRun * C))];
      }
    }
  }
}

// The dynamic shared memory allowed each instance (C = 1, 2, other) on each device.
static int direct_allowed[3][kMaxDevices] = {};

}  // namespace dsp

// B5. x, y: n int16 (whole frames of `channels`); tile_frames a multiple of
// kRun; plane_words, in_words and smem_bytes as ops/pallas_direct.py's
// DirectGeometry gives them. As many blocks as fit the card, each walking
// tiles.
extern "C" int dsp_direct_i16(const int16_t* x, int16_t* y, int64_t n, int64_t window,
                              int64_t channels, int64_t tile_frames, int64_t plane_words,
                              int64_t in_words, int64_t smem_bytes, void* stream) {
  const int64_t tile = tile_frames * channels;
  if (n <= 0 || channels < 1 || n % channels != 0 || tile <= 0 || tile > 0x7fffffff ||
      tile_frames % dsp::kRun != 0 || window < 1 || window > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tiles = (n + tile - 1) / tile;
  const uint32_t magic =
      window == 1 ? 0u : static_cast<uint32_t>(((1ull << 32) + window - 1) / window);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto bytes = static_cast<int>(smem_bytes);
  const auto launch = [&](auto kernel, int* allowed) {
    cudaError_t err = dsp::allow_smem(kernel, allowed, bytes);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
      return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), dsp::kThreads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int64_t resident = static_cast<int64_t>(per_sm) * sms;
    kernel<<<static_cast<unsigned>(tiles < resident ? tiles : resident), dsp::kThreads,
             static_cast<size_t>(bytes), s>>>(
        x, y, n, static_cast<int>(window), magic, 1, static_cast<int>(channels),
        static_cast<int>(tile_frames), static_cast<int>(plane_words), static_cast<int>(in_words));
    return cudaGetLastError();
  };
  cudaError_t err;
  if (channels == 1) {
    err = launch(dsp::direct_kernel<1>, dsp::direct_allowed[0]);
  } else if (channels == 2) {
    err = launch(dsp::direct_kernel<2>, dsp::direct_allowed[1]);
  } else {
    err = launch(dsp::direct_kernel<0>, dsp::direct_allowed[2]);
  }
  return static_cast<int>(err);
}

// What the compiler gave B5's kernel for `channels`, and its blocks an SM at
// `smem_bytes`: registers a thread, local bytes a thread, shared bytes a block
// (static and dynamic), blocks an SM (4 int64 in out).
extern "C" int dsp_direct_attrs(int64_t channels, int64_t smem_bytes, int64_t* out) {
  if (channels < 1 || smem_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto bytes = static_cast<int>(smem_bytes);
  const auto attrs = [&](auto kernel, int* allowed) {
    cudaError_t err = dsp::allow_smem(kernel, allowed, bytes);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(kernel))) != cudaSuccess) {
      return err;
    }
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, reinterpret_cast<const void*>(kernel), dsp::kThreads, bytes);
    out[0] = a.numRegs;
    out[1] = static_cast<int64_t>(a.localSizeBytes);
    out[2] = static_cast<int64_t>(a.sharedSizeBytes) + bytes;
    out[3] = blocks;
    return err;
  };
  cudaError_t err;
  if (channels == 1) {
    err = attrs(dsp::direct_kernel<1>, dsp::direct_allowed[0]);
  } else if (channels == 2) {
    err = attrs(dsp::direct_kernel<2>, dsp::direct_allowed[1]);
  } else {
    err = attrs(dsp::direct_kernel<0>, dsp::direct_allowed[2]);
  }
  return static_cast<int>(err);
}
