// The seeded all-pole recurrence of LPC synthesis over frames (B22):
//   y[t] = e[t] - sum_{i<p} a[i] h[i],  h <- (y[t], h[0], ..., h[p-2])
// for every frame at once, from a given entry state h (most recent output
// first), returning y and the state after the frame's last sample.
//
// Replaces digital_signal_processsing_tpu/ops/lpc.py:_lpc_synth_kernel, which
// puts the frames on the TPU's (8, 128) lanes and walks time as the ordered
// inner grid axis with the history in VMEM scratch. Here one thread walks one
// frame's L samples in order with its p coefficients and its p-deep history in
// registers: p is a template parameter for orders 1..32, and a runtime-p
// instance keeps the history as a circular row of a device-memory scratch
// (L1-cached, like local memory, but of any size), so no order is refused.
// Frames stay in the caller's (frames, L) layout: a block of kFrames frames
// stages kChunk samples of each through a padded shared buffer with coalesced
// loads and stores (a warp reads 32 consecutive samples of one frame), so no
// transpose to the reference's (L, frames) lane layout runs before or after.
// Each step subtracts the p products in the reference's order, each rounded
// apart (__fmul_rn/__fsub_rn, no contraction), so the kernel's outputs are
// bit for bit its plain PyTorch version's.
//
// What bounds it on the H100: memory bytes, 8 bytes a sample (e read once, y
// written once) plus 8p bytes a frame for a and the state, 0.040 ms a pass
// for 2^24 samples at 3.35 TB/s. The recurrence is sequential in time within
// a frame: each step's p dependent operations hold a thread, and enough
// frames (warps) in flight must cover that latency.

#include <cstdint>

#include <cuda_runtime.h>

namespace dsp {
namespace lpc {

constexpr int kFrames = 128;     // frames (threads) a block
constexpr int kChunk = 32;       // samples of each frame staged at once
constexpr int kPad = kChunk + 1; // a frame's row of the shared buffer
constexpr int kMaxUnrolled = 32; // orders with the history in registers

// Stage samples [t0, t0 + cnt) of the block's frames into buf (or back out).
static __device__ void stage_in(const float* e, float* buf, int64_t f0, int64_t frames,
                                int64_t L, int64_t t0, int cnt) {
  for (int k = threadIdx.x; k < kFrames * kChunk; k += kFrames) {
    const int fr = k / kChunk, j = k % kChunk;
    const int64_t g = f0 + fr;
    buf[fr * kPad + j] = (g < frames && j < cnt) ? e[g * L + t0 + j] : 0.0f;
  }
}

static __device__ void stage_out(float* y, const float* buf, int64_t f0, int64_t frames,
                                 int64_t L, int64_t t0, int cnt) {
  for (int k = threadIdx.x; k < kFrames * kChunk; k += kFrames) {
    const int fr = k / kChunk, j = k % kChunk;
    const int64_t g = f0 + fr;
    if (g < frames && j < cnt) y[g * L + t0 + j] = buf[fr * kPad + j];
  }
}

// P > 0: orders 1..32 with a and h in registers. P == 0: order p, h a
// circular row of `hist` (frames x p): h[i] at hist[(pos + i) % p].
template <int P>
__global__ void __launch_bounds__(kFrames)
lpc_kernel(const float* __restrict__ a, const float* __restrict__ s0,
           const float* __restrict__ e, float* __restrict__ y, float* __restrict__ z,
           float* __restrict__ hist, int64_t frames, int64_t L, int p) {
  __shared__ float buf[kFrames * kPad];
  const int tid = threadIdx.x;
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kFrames;
  const int64_t f = f0 + tid;
  const bool live = f < frames;
  constexpr int R = P > 0 ? P : 1;
  float ar[R], h[R];
  float* hg = nullptr;
  const float* ag = a + f * p;
  int pos = 0;
  if constexpr (P > 0) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      ar[i] = live ? ag[i] : 0.0f;
      h[i] = live ? s0[f * P + i] : 0.0f;
    }
  } else if (live) {
    hg = hist + f * p;
    for (int i = 0; i < p; ++i) hg[i] = s0[f * p + i];
  }
  float* row = buf + tid * kPad;
  for (int64_t t0 = 0; t0 < L; t0 += kChunk) {
    const int cnt = static_cast<int>(L - t0 < kChunk ? L - t0 : kChunk);
    stage_in(e, buf, f0, frames, L, t0, cnt);
    __syncthreads();
    if (live) {
      for (int j = 0; j < cnt; ++j) {
        float acc = row[j];
        if constexpr (P > 0) {
#pragma unroll
          for (int i = 0; i < P; ++i) acc = __fsub_rn(acc, __fmul_rn(ar[i], h[i]));
#pragma unroll
          for (int i = P - 1; i > 0; --i) h[i] = h[i - 1];
          h[0] = acc;
        } else {
          for (int i = 0; i < p - pos; ++i) acc = __fsub_rn(acc, __fmul_rn(ag[i], hg[pos + i]));
          for (int i = p - pos; i < p; ++i) {
            acc = __fsub_rn(acc, __fmul_rn(ag[i], hg[pos + i - p]));
          }
          pos = pos == 0 ? p - 1 : pos - 1;
          hg[pos] = acc;
        }
        row[j] = acc;
      }
    }
    __syncthreads();
    stage_out(y, buf, f0, frames, L, t0, cnt);
    __syncthreads();
  }
  if (!live) return;
  if constexpr (P > 0) {
#pragma unroll
    for (int i = 0; i < P; ++i) z[f * P + i] = h[i];
  } else {
    for (int i = 0; i < p; ++i) z[f * p + i] = hg[(pos + i) % p];
  }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*, float*,
                        int64_t, int64_t, int);

template <int P>
static Kernel pick(int p) {
  if constexpr (P > kMaxUnrolled) {
    return lpc_kernel<0>;
  } else {
    return p == P ? lpc_kernel<P> : pick<P + 1>(p);
  }
}

}  // namespace lpc
}  // namespace dsp

// B22. a, s0, z: (frames, p); e, y: (frames, L); hist: frames x p floats of
// scratch when p > 32, else unused (may be null).
extern "C" int dsp_lpc_synth(const float* a, const float* s0, const float* e, float* y, float* z,
                             float* hist, int64_t frames, int64_t L, int64_t p, void* stream) {
  using namespace dsp::lpc;
  if (frames < 1 || L < 1 || p < 1 || p > 0x7fffffff || (p > kMaxUnrolled && hist == nullptr) ||
      (frames + kFrames - 1) / kFrames > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel k = pick<1>(static_cast<int>(p));
  const auto blocks = static_cast<unsigned>((frames + kFrames - 1) / kFrames);
  k<<<blocks, kFrames, 0, static_cast<cudaStream_t>(stream)>>>(a, s0, e, y, z, hist, frames, L,
                                                               static_cast<int>(p));
  return static_cast<int>(cudaGetLastError());
}
