// The seeded all-pole recurrence of LPC synthesis over frames (B22):
//   y[t] = e[t] - sum_{i<p} a[i] h[i],  h <- (y[t], h[0], ..., h[p-2])
// for every frame at once, from a given entry state h (most recent output
// first), returning y and the state after the frame's last sample; or, for
// the passes whose y is thrown away, the end state alone.
//
// Replaces digital_signal_processsing_tpu/ops/lpc.py:_lpc_synth_kernel, which
// puts the frames on the TPU's (8, 128) lanes and walks time as the ordered
// inner grid axis with the history in VMEM scratch. Here one thread walks one
// frame's L samples in order with its p coefficients and its p-deep history in
// registers: p is a template parameter for orders 1..32, and a runtime-p
// instance keeps the history as a circular row of a device-memory scratch
// (L1-cached, like local memory, but of any size), so no order is refused.
// Each step subtracts the p products in the reference's order, newest term
// first, each product and difference rounded apart (__fmul_rn/__fsub_rn, no
// contraction), so the kernel's outputs are bit for bit its plain PyTorch
// version's.
//
// Frames stay in the caller's (frames, L) layout. A block of kFrames frames
// stages kChunk samples of each through a ring of kStages shared-memory
// stages with 16-byte cp.async copies (4-byte ones where e or a row is not
// 16-byte aligned, or at a ragged end), every copy's address computed once a
// block and advanced by a constant: the next chunk lands while this one is
// computed, and the y of the previous chunk, written in place over its e,
// leaves as 16-byte stores meanwhile. One barrier a chunk. The time loop is
// unrolled over the chunk, so the history is a ring of P registers indexed by
// constants (no moves a step); at the chunk's end a rotation by kChunk mod P,
// P moves, puts it back in order. A ragged last chunk guards each step, and
// its end state is read out of the ring by the count of its steps.
//
// What bounds it on the H100: memory bytes, 8 bytes a sample (e read once, y
// written once; 4 for the state-only passes) plus 8p bytes a frame for a and
// the state, 0.040 ms a full pass for 2^24 samples at 3.35 TB/s. The floor of
// the recurrence itself: a step is one multiply and p dependent subtractions
// (the newest product needs the last output; reordering the chain would
// change the bits), 13 x 4 cycles at p = 12, about 7.6 us for 256 samples,
// which the 16 warps an SM that 65536 frames give must cover by issue: 2p
// float instructions a step and frame.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {
namespace lpc {

constexpr int kFrames = 128;                 // frames (threads) a block
constexpr int kChunk = 32;                   // samples of each frame a stage holds
constexpr int kUnits = kChunk / 4;           // 16-byte pieces of a frame's chunk
constexpr int kRow = kChunk + 4;             // a frame's row: 9 pieces, an odd count, so
                                             // 8 lanes' 16-byte reads fall on 32 banks
constexpr int kStages = 3;                   // chunk c+1 lands, c computes, c-1 leaves
constexpr int kStageFloats = kFrames * kRow;
constexpr int kSmemBytes = kStages * kStageFloats * 4;
constexpr int kLanesFrames = kFrames / kUnits;  // frames a pass of the block's copies covers
constexpr int kMaxUnrolled = 32;             // orders with the history in registers
constexpr int kMinBlocks = 4;                // blocks an SM (so at most 128 registers): 512 blocks,
                                             // the main path's 65536 frames, in one wave

static __device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

static __device__ __forceinline__ void cp4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

static __device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

static __device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// This thread's share of a stage's copies: piece q of the frames fr0, fr0 +
// kLanesFrames, ...; g0: the global offset of piece q of frame fr0's chunk 0.
struct Stager {
  int q, fr0, nfr;  // piece, first frame of the block, frames of the block it copies
  int64_t g0, step; // offset of its first piece; offset between its frames (kLanesFrames * L)
  bool evec, yvec;  // e's (y's) rows start on the 16-byte grid

  __device__ __forceinline__ Stager(int64_t f0, int64_t frames, int64_t L, bool ealigned,
                                    bool yaligned) {
    q = threadIdx.x % kUnits;
    fr0 = threadIdx.x / kUnits;
    const int64_t left = frames - f0 - fr0;  // frames from fr0 on in the stream
    nfr = left <= 0 ? 0 : static_cast<int>((left + kLanesFrames - 1) / kLanesFrames);
    g0 = (f0 + fr0) * L + 4 * q;
    step = kLanesFrames * L;
    evec = ealigned;
    yvec = yaligned;
  }

  // Copies samples [t0, t0 + cnt) of the frames into stage buf.
  __device__ __forceinline__ void load(const float* e, float* buf, int64_t t0, int cnt) const {
    const float* src = e + g0 + t0;
    float* dst = buf + fr0 * kRow + 4 * q;
#pragma unroll
    for (int k = 0; k < kFrames / kLanesFrames; ++k) {
      if (k < nfr) {
        if (evec && 4 * q + 4 <= cnt) {
          cp16(dst, src);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * q + i < cnt) cp4(dst + i, src + i);
          }
        }
      }
      src += step;
      dst += kLanesFrames * kRow;
    }
  }

  // Stores samples [t0, t0 + cnt) of the frames from stage buf.
  __device__ __forceinline__ void store(float* y, const float* buf, int64_t t0, int cnt) const {
    float* dst = y + g0 + t0;
    const float* src = buf + fr0 * kRow + 4 * q;
#pragma unroll
    for (int k = 0; k < kFrames / kLanesFrames; ++k) {
      if (k < nfr) {
        if (yvec && 4 * q + 4 <= cnt) {
          *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (4 * q + i < cnt) dst[i] = src[i];
          }
        }
      }
      dst += step;
      src += kLanesFrames * kRow;
    }
  }
};

// kChunk steps of order P over row (e in, y out, in place), the history a
// ring: at the chunk's start h[i] = hr[P-1-i], step j's output goes to hr[j
// % P]. GUARD: only the first cnt steps run (a ragged last chunk), and the
// ring is left as it is; else it is rotated back to the start's order.
template <int P, bool GUARD>
static __device__ __forceinline__ void chunk_steps(float* row, const float (&ar)[P], float (&hr)[P],
                                                   int cnt) {
#pragma unroll
  for (int j4 = 0; j4 < kChunk; j4 += 4) {
    const float4 in = *reinterpret_cast<const float4*>(row + j4);
    float v[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j4 + k;
      if (!GUARD || j < cnt) {
        float acc = v[k];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          acc = __fsub_rn(acc, __fmul_rn(ar[i], hr[((j - 1 - i) % P + P) % P]));
        }
        hr[j % P] = acc;
        v[k] = acc;
      }
    }
    *reinterpret_cast<float4*>(row + j4) = make_float4(v[0], v[1], v[2], v[3]);
  }
  if constexpr (!GUARD) {
    float t[P];
#pragma unroll
    for (int k = 0; k < P; ++k) t[k] = hr[(k + kChunk) % P];
#pragma unroll
    for (int k = 0; k < P; ++k) hr[k] = t[k];
  }
}

// P > 0: orders 1..32 with a and h in registers. P == 0: order p, h a
// circular row of `hist` (frames x p): h[i] at hist[(pos + i) % p]. y null:
// the end state alone.
template <int P>
__global__ void __launch_bounds__(kFrames, kMinBlocks)
lpc_kernel(const float* __restrict__ a, const float* __restrict__ s0,
           const float* __restrict__ e, float* __restrict__ y, float* __restrict__ z,
           float* __restrict__ hist, int64_t frames, int64_t L, int p, int evec, int yvec) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kFrames;
  const int64_t f = f0 + tid;
  const bool live = f < frames;
  constexpr int R = P > 0 ? P : 1;
  float ar[R], hr[R];
  float* hg = nullptr;
  const float* ag = a + f * p;
  int pos = 0;
  if constexpr (P > 0) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      ar[i] = live ? ag[i] : 0.0f;
      hr[P - 1 - i] = live ? s0[f * P + i] : 0.0f;
    }
  } else if (live) {
    hg = hist + f * p;
    for (int i = 0; i < p; ++i) hg[i] = s0[f * p + i];
  }
  const Stager io(f0, frames, L, evec != 0, yvec != 0);
  const int64_t nch = (L + kChunk - 1) / kChunk;
  io.load(e, sm, 0, static_cast<int>(L < kChunk ? L : kChunk));
  commit();
  int cur = 0;  // the stage of chunk c
  for (int64_t c = 0; c < nch; ++c) {
    wait_all();
    __syncthreads();  // chunk c has landed; chunk c-1 is computed; chunk c-2 has left
    const int nxt = cur == kStages - 1 ? 0 : cur + 1;
    const int prv = cur == 0 ? kStages - 1 : cur - 1;
    const int64_t t0 = c * kChunk;
    if (c + 1 < nch) {
      const int64_t left = L - t0 - kChunk;
      io.load(e, sm + nxt * kStageFloats, t0 + kChunk, static_cast<int>(left < kChunk ? left : kChunk));
    }
    commit();
    if (c > 0 && y != nullptr) io.store(y, sm + prv * kStageFloats, t0 - kChunk, kChunk);
    float* row = sm + cur * kStageFloats + tid * kRow;
    const int cnt = static_cast<int>(L - t0 < kChunk ? L - t0 : kChunk);
    if (live) {
      if constexpr (P > 0) {
        if (c + 1 < nch) {
          chunk_steps<P, false>(row, ar, hr, cnt);
        } else {
          chunk_steps<P, true>(row, ar, hr, cnt);
        }
      } else {
        for (int j = 0; j < cnt; ++j) {
          float acc = row[j];
          for (int i = 0; i < p - pos; ++i) acc = __fsub_rn(acc, __fmul_rn(ag[i], hg[pos + i]));
          for (int i = p - pos; i < p; ++i) {
            acc = __fsub_rn(acc, __fmul_rn(ag[i], hg[pos + i - p]));
          }
          pos = pos == 0 ? p - 1 : pos - 1;
          hg[pos] = acc;
          row[j] = acc;
        }
      }
    }
    cur = nxt;
  }
  __syncthreads();
  if (y != nullptr) {
    const int64_t t0 = (nch - 1) * kChunk;
    io.store(y, sm + (cur == 0 ? kStages - 1 : cur - 1) * kStageFloats, t0,
              static_cast<int>(L - t0));
  }
  if (!live) return;
  if constexpr (P > 0) {
    // the last chunk ran cnt = L - t0 steps from the ring's order: h[i] = hr[(cnt - 1 - i) % P]
    const int cnt = static_cast<int>(L - (nch - 1) * kChunk);
#pragma unroll
    for (int m = 0; m < P; ++m) {
      int i = (cnt - 1 - m) % P;
      i += i < 0 ? P : 0;
      z[f * P + i] = hr[m];
    }
  } else {
    for (int i = 0; i < p; ++i) z[f * p + i] = hg[(pos + i) % p];
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, float*,
                        int64_t, int64_t, int, int, int);

template <int P>
static Kernel pick(int p) {
  if constexpr (P > kMaxUnrolled) {
    return lpc_kernel<0>;
  } else {
    return p == P ? lpc_kernel<P> : pick<P + 1>(p);
  }
}

static int allowed[kMaxUnrolled + 1][kMaxDevices] = {};

}  // namespace lpc
}  // namespace dsp

// B22. a, s0, z: (frames, p); e, y: (frames, L); y null for the end state
// alone; hist: frames x p floats of scratch when p > 32, else unused (may be
// null).
extern "C" int dsp_lpc_synth(const float* a, const float* s0, const float* e, float* y, float* z,
                             float* hist, int64_t frames, int64_t L, int64_t p, void* stream) {
  using namespace dsp::lpc;
  if (frames < 1 || L < 1 || p < 1 || p > 0x7fffffff || (p > kMaxUnrolled && hist == nullptr) ||
      (frames + kFrames - 1) / kFrames > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel k = pick<1>(static_cast<int>(p));
  const int slot = p > kMaxUnrolled ? 0 : static_cast<int>(p);
  cudaError_t err = dsp::allow_smem(k, allowed[slot], kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies where every row of e (of y) starts on the 16-byte grid
  const int evec = L % 4 == 0 && reinterpret_cast<uintptr_t>(e) % 16 == 0;
  const int yvec = L % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const auto blocks = static_cast<unsigned>((frames + kFrames - 1) / kFrames);
  k<<<blocks, kFrames, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      a, s0, e, y, z, hist, frames, L, static_cast<int>(p), evec, yvec);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave B22's kernel for order p: registers a thread, local
// bytes a thread, shared bytes a block, blocks an SM (4 int64 in out).
extern "C" int dsp_lpc_attrs(int64_t p, int64_t* out) {
  using namespace dsp::lpc;
  if (p < 1 || p > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel k = pick<1>(static_cast<int>(p));
  const int slot = p > kMaxUnrolled ? 0 : static_cast<int>(p);
  cudaError_t err = dsp::allow_smem(k, allowed[slot], kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, k)) != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kFrames, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = static_cast<int64_t>(attr.sharedSizeBytes) + kSmemBytes;
  out[3] = blocks;
  return 0;
}
