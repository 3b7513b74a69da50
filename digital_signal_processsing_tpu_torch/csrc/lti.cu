// S3: the discrete state-space recursion of dlsim in one launch.
//
//   y_t     = C x_t + D u_t
//   x_{t+1} = A x_t + B u_t          t = 0 .. T-1, x_0 given
//
// with y (T, q) and the states x_t (T, n) written out, x_t before its update.
//
// It replaces no Pallas kernel: digital_signal_processsing_tpu/ops/lti.py runs
// dlsim (:195) as one lax.scan (:217-222) that keeps the state on the device.
// Eager PyTorch would launch about three kernels a step for the same loop (the
// plain loops of chip_smoke.py take some 17 us a launch on an H100), so the
// recursion is one kernel here, and its plain per-step loop stays in
// ops/lti.py as the version it is held to.
//
// One block runs the whole recursion: one thread a state row i < n (and,
// where q > n, threads up to q for the outputs), n and q at most 1024. The
// state sits in shared memory, double-buffered: step t reads buffer t & 1 and
// writes buffer (t + 1) & 1, so one barrier a step separates a step's writes
// from the next step's reads, and no thread can overwrite a buffer another
// still reads. u arrives `chunk` steps at a time into a shared stage (two more
// barriers a chunk). A, B, C and D are passed transposed (column j of A as a
// row), so that the threads of a warp read consecutive words for the same j:
// no bank conflicts in shared memory, whole sectors in device memory. They
// sit in shared memory while they fit beside the state and the stage in 227
// KB, and are read from device memory (through L1 and L2) past that, in the
// same kernel.
//
// Every product and sum is rounded apart (__fmul_rn, __fadd_rn: no
// contraction), j and k ascending from 0, each sum started at 0:
//   ax = sum_j A[i][j] x[j];  bu = sum_k B[i][k] u[k];  x'[i] = ax + bu
//   cy = sum_j C[r][j] x[j];  du = sum_k D[r][k] u[k];  y[r]  = cy + du
// so the NumPy emulation of tests/test_torch_twod_lti.py gives the kernel's
// bits.
//
// What bounds it on the H100: not bytes (u, y and x once each) and not
// operations (2 (n + p)(n + q) a step on one SM). The step's chain does: n
// dependent multiply-adds, a barrier and the shared-memory reads between them,
// one step after another, the same at any batch.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {
namespace lti {

constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
dlsim_kernel(const float* __restrict__ at, const float* __restrict__ bt,
             const float* __restrict__ ct, const float* __restrict__ dt,
             const float* __restrict__ u, const float* __restrict__ x0, float* __restrict__ y,
             float* __restrict__ xs, int64_t steps, int n, int p, int q, int chunk,
             int shared_mats) {
  extern __shared__ float smem[];
  float* xbuf = smem;             // 2 n: the state, double-buffered
  float* us = xbuf + 2 * n;       // chunk p: the staged inputs
  float* mats = us + chunk * p;   // A^T, B^T, C^T, D^T when they fit
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* A = at;
  const float* B = bt;
  const float* C = ct;
  const float* D = dt;
  if (shared_mats) {
    const int na = n * n, nb = p * n, nc = n * q, nd = p * q;
    for (int k = tid; k < na; k += nt) mats[k] = at[k];
    for (int k = tid; k < nb; k += nt) mats[na + k] = bt[k];
    for (int k = tid; k < nc; k += nt) mats[na + nb + k] = ct[k];
    for (int k = tid; k < nd; k += nt) mats[na + nb + nc + k] = dt[k];
    A = mats;
    B = mats + na;
    C = mats + na + nb;
    D = mats + na + nb + nc;
  }
  for (int i = tid; i < n; i += nt) xbuf[i] = x0[i];
  int cur = 0;
  for (int64_t t0 = 0; t0 < steps; t0 += chunk) {
    const int cnt = steps - t0 < chunk ? static_cast<int>(steps - t0) : chunk;
    __syncthreads();  // the previous stage is read (and x_0, the matrices are in place)
    const float* ug = u + t0 * p;
    for (int k = tid; k < cnt * p; k += nt) us[k] = ug[k];
    __syncthreads();
    for (int s = 0; s < cnt; ++s) {
      const float* x = xbuf + cur * n;
      float* xn = xbuf + (cur ^ 1) * n;
      const float* ut = us + s * p;
      const int64_t t = t0 + s;
      if (tid < n) {
        float ax = 0.f, bu = 0.f;
        // unrolled so that the loads of A (device memory past shared) issue ahead of
        // the chain of adds, which stays in j order
#pragma unroll 8
        for (int j = 0; j < n; ++j) ax = __fadd_rn(ax, __fmul_rn(A[j * n + tid], x[j]));
        for (int k = 0; k < p; ++k) bu = __fadd_rn(bu, __fmul_rn(B[k * n + tid], ut[k]));
        xs[t * n + tid] = x[tid];
        xn[tid] = __fadd_rn(ax, bu);
      }
      if (tid < q) {
        float cy = 0.f, du = 0.f;
#pragma unroll 8
        for (int j = 0; j < n; ++j) cy = __fadd_rn(cy, __fmul_rn(C[j * q + tid], x[j]));
        for (int k = 0; k < p; ++k) du = __fadd_rn(du, __fmul_rn(D[k * q + tid], ut[k]));
        y[t * q + tid] = __fadd_rn(cy, du);
      }
      __syncthreads();  // x_{t+1} is written; x_t may be overwritten from now on
      cur ^= 1;
    }
  }
}

static int dlsim_allowed[kMaxDevices] = {};

}  // namespace lti
}  // namespace dsp

// S3. at (n x n), bt (p x n), ct (n x q), dt (p x q): A, B, C, D transposed,
// float32; u (steps, p); x0 (n); out y (steps, q), xs (steps, n). threads a
// multiple of 32 of at least max(n, q), at most 1024; chunk the steps a stage
// holds; shared_mats 1 where the matrices sit in shared memory; smem_bytes the
// block's dynamic shared memory, as ops/lti.dlsim_geometry computes them.
extern "C" int dsp_dlsim(const float* at, const float* bt, const float* ct, const float* dt,
                         const float* u, const float* x0, float* y, float* xs, int64_t steps,
                         int64_t n, int64_t p, int64_t q, int64_t chunk, int64_t shared_mats,
                         int64_t threads, int64_t smem_bytes, void* stream) {
  using namespace dsp::lti;
  if (steps < 0 || n < 0 || p < 0 || q < 0 || n > kMaxThreads || q > kMaxThreads ||
      p > 0x7fffffff / (chunk > 0 ? chunk : 1) || chunk < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 || threads < n || threads < q ||
      smem_bytes < 0 || smem_bytes > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (steps == 0) return 0;
  cudaError_t err = dsp::allow_smem(dlsim_kernel, dlsim_allowed, static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dlsim_kernel<<<1, static_cast<unsigned>(threads), static_cast<size_t>(smem_bytes),
                 static_cast<cudaStream_t>(stream)>>>(
      at, bt, ct, dt, u, x0, y, xs, steps, static_cast<int>(n), static_cast<int>(p),
      static_cast<int>(q), static_cast<int>(chunk), static_cast<int>(shared_mats));
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave S3: registers a thread, local bytes a thread, static
// shared bytes, most threads a block (4 int64 in out).
extern "C" int dsp_dlsim_attrs(int64_t* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, dsp::lti::dlsim_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = static_cast<int64_t>(attr.sharedSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}
