// S3: the discrete state-space recursion of dlsim in one launch.
//
//   y_t     = C x_t + D u_t
//   x_{t+1} = A x_t + B u_t          t = 0 .. T-1, x_0 given
//
// with y (T, q) and the states x_t (T, n) written out, x_t before its update.
//
// It replaces no Pallas kernel: digital_signal_processsing_tpu/ops/lti.py runs
// dlsim (:195) as one lax.scan (:217-222) that keeps the state on the device.
// Eager PyTorch would launch about three kernels a step for the same loop, so
// the recursion is one kernel here, and its plain per-step loop stays in
// ops/lti.py as the version it is held to.
//
// The matrices arrive as one row-major M = [[A B]; [C D]], (n + q) x (n + p):
// rows 0..n-1 are the state rows, rows n..n+q-1 the output rows. Two kernels,
// one entry point, the route chosen by ops/lti.dlsim_geometry:
//
// Warp (n <= 32, q <= 32, p <= 64): one warp. Lane i holds state row i of A
// and output row i of C in registers and a copy of the whole state; the two
// sums run side by side in the same thread, and each new x_i reaches every
// lane by a shuffle. No barrier on the chain: a chunk of steps at a time, B u
// and D u of every step are computed first into shared memory, and x_t and
// y_t go to shared stages that leave as contiguous rows after the chunk.
// Sums as before: j (and k) ascending from 0, x' = ax + bu, y = cy + du.
//
// Rows (any p and q, n up to about 14,000): a cluster of up to 16 CTAs on neighbouring SMs. CTA r
// holds rows [r * rows_cta, (r + 1) * rows_cta) of M in its shared memory (or,
// past the cluster's capacity, reads them from device memory: the last route,
// same kernel). Up to 512 states a warp keeps two rows and a lane its slots of
// x in registers, and sums both rows side by side; rows past those are walked
// one at a time. A row's A x (or C x) is split over lanes, partials over
// j = lane + 32 m with m ascending, then the fixed butterfly (xor 16, 8, 4, 2,
// 1); B u (or D u) is summed k ascending from 0, every row and step of a chunk
// at once, off the chain; x' = ax + bu. Each CTA writes its rows of x_{t+1}
// into its own buffer, meets at a named barrier, and sends the block to every
// peer as 16-byte st.async onto the peer's mbarrier (transaction bytes, no
// fence: a cluster barrier's release waited on every global store in flight,
// each step); the peers wait on that mbarrier. The state is triple-buffered, so a
// buffer read in step t is rewritten only in step t + 2, after every CTA has
// waited on x_{t+1}.
//
// Every product and sum is rounded apart (__fmul_rn, __fadd_rn: no
// contraction), so the NumPy emulations of tests/test_torch_twod_lti.py give
// the kernels' bits (emulate_s3 the warp route's, emulate_s3_rows the rows').
//
// What bounds it on the H100: not bytes (u, y and x once each) and not
// operations (2 (n + p)(n + q) a step). The step's chain does, one step after
// another: on the warp route n dependent adds and the shuffles; on the rows
// route ceil(n / 32) adds, the five-step butterfly, the named barrier and the
// hand-over between SMs.

#include <cstdint>

#include <cuda_runtime.h>

#include "block_prefix.cuh"

namespace dsp {
namespace lti {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
// the rows route with rows in registers: at most 512 threads, up to 128 registers a thread
// (__maxnreg__: ptxas spilled at 64 registers under __launch_bounds__(512))
constexpr int kRegThreads = 512;
constexpr int kMaxCluster = 16;  // past 8 the non-portable cluster sizes
constexpr int kWarpMaxInputs = 64;

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `addr` (this CTA's shared window) in CTA `rank` of the cluster
static __device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// v into a peer's shared memory (both addresses from peer_addr), completing 16
// bytes of the transaction on the peer's mbarrier: no fence on this side
static __device__ __forceinline__ void store_peer(uint32_t addr, float4 v, uint32_t mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
               "{%1, %2, %3, %4}, [%5];"
               ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(mbar) : "memory");
}

// the CTA's threads meet at named barrier 1 (barrier 0 is __syncthreads')
static __device__ __forceinline__ void cta_sync1(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

static __device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

static __device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

static __device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n\t"
               "fence.mbarrier_init.release.cluster;" ::"r"(mbar) : "memory");
}

// the one arrival of a phase, expecting `bytes` of transactions
static __device__ __forceinline__ void mbar_arm(uint32_t mbar, uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}"
               ::"r"(mbar), "r"(bytes) : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  }
}

// The warp route: NB register slots of state (n <= NB <= 32; slots past n hold
// zeros, so the sums run unguarded, adding +0 past n). A chunk of
// steps at a time: the warp stages u, computes every step's B u and D u of
// each lane's rows into shared memory (off the chain), runs the steps, whose
// x_t and y_t go to a shared stage, and stores both stages as contiguous rows.
template <int NB>
__global__ void __launch_bounds__(32)
dlsim_warp_kernel(const float* __restrict__ m, const float* __restrict__ u,
                  const float* __restrict__ x0, float* __restrict__ y, float* __restrict__ xs,
                  int64_t steps, int n, int p, int q, int chunk) {
  extern __shared__ float smem[];
  float* us = smem;                // chunk x p: the staged inputs
  float* bus = us + chunk * p;     // chunk x 33: B u of lane i's row at step s (33: no
  float* dus = bus + chunk * 33;   // chunk x 33: D u                bank conflicts)
  float* xst = dus + chunk * 33;   // chunk x n: x_t, as xs's rows
  float* yst = xst + chunk * n;    // chunk x q: y_t, as y's rows
  const int lane = threadIdx.x;
  const int ld = n + p;
  const bool srow = lane < n, orow = lane < q;
  float a[NB], c[NB], xr[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    a[j] = srow && j < n ? m[lane * ld + j] : 0.f;
    c[j] = orow && j < n ? m[(n + lane) * ld + j] : 0.f;
    xr[j] = j < n ? x0[j] : 0.f;
  }
  float xi = srow ? x0[lane] : 0.f;
  for (int64_t t0 = 0; t0 < steps; t0 += chunk) {
    const int cnt = steps - t0 < chunk ? static_cast<int>(steps - t0) : chunk;
    __syncwarp();  // the previous chunk's stages are stored
    const float* ug = u + t0 * p;
    for (int k = lane; k < cnt * p; k += 32) us[k] = ug[k];
    __syncwarp();
    for (int i = 0; i < (n > q ? n : q); ++i) {  // lanes over steps; k ascending from 0
      const float* brow = m + i * ld + n;
      const float* drow = m + (n + i) * ld + n;
      for (int s = lane; s < cnt; s += 32) {
        const float* ut = us + s * p;
        float bu = 0.f, du = 0.f;
        for (int k = 0; k < p; ++k) {
          const float uk = ut[k];
          if (i < n) bu = __fadd_rn(bu, __fmul_rn(brow[k], uk));
          if (i < q) du = __fadd_rn(du, __fmul_rn(drow[k], uk));
        }
        bus[s * 33 + i] = bu;
        dus[s * 33 + i] = du;
      }
    }
    __syncwarp();
    float bu = bus[lane], du = dus[lane];  // step s's, loaded a step ahead
    for (int s = 0; s < cnt; ++s) {
      const int sn = s + 1 < cnt ? s + 1 : s;
      const float bu_next = bus[sn * 33 + lane], du_next = dus[sn * 33 + lane];
      float ax = 0.f, cy = 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        ax = __fadd_rn(ax, __fmul_rn(a[j], xr[j]));
        cy = __fadd_rn(cy, __fmul_rn(c[j], xr[j]));
      }
      const float x_t = xi;
      xi = srow ? __fadd_rn(ax, bu) : 0.f;
#pragma unroll
      for (int j = 0; j < NB; ++j) xr[j] = __shfl_sync(kFull, xi, j);
      if (srow) xst[s * n + lane] = x_t;
      if (orow) yst[s * q + lane] = __fadd_rn(cy, du);
      bu = bu_next;
      du = du_next;
    }
    __syncwarp();
    for (int k = lane; k < cnt * n; k += 32) xs[t0 * n + k] = xst[k];
    for (int k = lane; k < cnt * q; k += 32) y[t0 * q + k] = yst[k];
  }
}

// One row's split sum of M[row][0..n-1] . x: partials over j = lane + 32 m, m
// ascending, then the butterfly. S > 0: x's slots in registers (S = ceil(n /
// 32) or a little more); S == 0: x read from shared memory.
template <int S>
static __device__ __forceinline__ float row_dot(const float* row, const float* x,
                                                const float (&xv)[S > 0 ? S : 1], int n,
                                                int lane) {
  float acc = 0.f;
  if constexpr (S > 0) {
#pragma unroll
    for (int mm = 0; mm < S; ++mm) {
      const int j = lane + 32 * mm;
      if (j < n) acc = __fadd_rn(acc, __fmul_rn(row[j], xv[mm]));
    }
  } else {
    for (int j = lane; j < n; j += 32) acc = __fadd_rn(acc, __fmul_rn(row[j], x[j]));
  }
  return warp_sum(acc);
}

// Both butterflies of two rows, interleaved
static __device__ __forceinline__ void warp_sum2(float& a, float& b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ua = __shfl_xor_sync(kFull, a, off), ub = __shfl_xor_sync(kFull, b, off);
    a = __fadd_rn(a, ua);
    b = __fadd_rn(b, ub);
  }
}

// The rows route: a cluster of cs CTAs, rows_cta rows of M each. S > 0 (n <= 32
// S): x's slots and the first two of a warp's rows in registers (local rows 2w
// and 2w + 1, summed side by side; slots past n hold zeros); rows past twice
// the warps walked from shared memory one at a time. S == 0: every row walked,
// x read from shared memory. DeviceRows reads M from device memory, else the
// CTA's rows sit in shared memory. x_t sits in buffer t % 3 of every CTA
// (stride n rounded up to 4; rows_cta is a multiple of 4, so a CTA's block of
// rows starts on 16 bytes). A warp writes its rows of x_{t+1} into its own
// CTA's buffer; after a named barrier the CTA's warps send its block to every
// peer as 16-byte st.async, and the peer's mbarrier phase t / 3 completes when
// all the peers' blocks have arrived (one arrival: the CTA's thread 0 arms it
// a step ahead with their bytes); x_0 is loaded, and phase 0 of buffer 0
// completed by hand. B u and D u of a
// chunk of steps are computed first, every row and step at once, behind one
// __syncthreads on each side.
template <int S, bool DeviceRows>
__global__ void __maxnreg__(S > 0 ? 65536 / kRegThreads : 65536 / kMaxThreads)
dlsim_rows_kernel(const float* __restrict__ m, const float* __restrict__ u,
                  const float* __restrict__ x0, float* __restrict__ y, float* __restrict__ xs,
                  int64_t steps, int n, int p, int q, int chunk, int rows_cta) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);  // 3 mbarriers (32 bytes kept)
  const int n4 = (n + 3) & ~3;
  float* xb = smem + 8;                 // 3 n4: the state, triple-buffered
  float* bus = xb + 3 * n4;             // rows_cta x chunk: B u (D u) of a row at step s
  float* rows = bus + rows_cta * chunk;  // rows_cta x ld: this CTA's rows of M
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, warps = nt >> 5;
  const int ld = n + p;
  const int cs = static_cast<int>(gridDim.x);  // one cluster of all the CTAs
  const int rank = static_cast<int>(cluster_rank());
  const int r0 = rank * rows_cta;
  const int nrows = max(min(r0 + rows_cta, n + q) - r0, 0);
  const int s1 = min(r0 + nrows, n);                    // this CTA's state rows: [r0, s1)
  const int blocks = s1 > r0 ? (s1 - r0 + 3) >> 2 : 0;  // ... as 16-byte blocks
  uint32_t expect = 0;                                  // bytes of x_{t+1} from the peers
  for (int c = 0; c < cs; ++c) {
    const int c0 = c * rows_cta, c1 = min(c0 + rows_cta, n);
    if (c != rank && c1 > c0) expect += 16u * static_cast<uint32_t>((c1 - c0 + 3) >> 2);
  }
  const uint32_t mbar_addr = smem_addr(mbar), xb_addr = smem_addr(xb);
  if (tid == 0) {
    for (int b = 0; b < 3; ++b) mbar_init(mbar_addr + 8u * b);
    mbar_arm(mbar_addr, 0u);  // x_0 is here: phase 0 of buffer 0
  }
  if constexpr (!DeviceRows) {
    const int64_t cnt = static_cast<int64_t>(nrows) * ld;
    const float* src = m + static_cast<int64_t>(r0) * ld;
    for (int64_t k = tid; k < cnt; k += nt) rows[k] = src[k];
  }
  for (int i = tid; i < n; i += nt) xb[i] = x0[i];
  if (steps > 0) {
    for (int i = r0 + tid; i < s1; i += nt) xs[i] = x0[i];
  }
  const float* mine = DeviceRows ? m + static_cast<int64_t>(r0) * ld : rows;  // local row 0
  cluster_sync();  // every CTA runs, its barriers, x_0 and rows in place
  // the warp's register rows: local la and la + 1
  const int la = 2 * warp;
  const bool has_a = S > 0 && la < nrows, has_b = S > 0 && la + 1 < nrows;
  float ra[S > 0 ? S : 1], rb[S > 0 ? S : 1];
  if constexpr (S > 0) {
#pragma unroll
    for (int mm = 0; mm < S; ++mm) {
      const int j = lane + 32 * mm;
      ra[mm] = has_a && j < n ? mine[static_cast<int64_t>(la) * ld + j] : 0.f;
      rb[mm] = has_b && j < n ? mine[static_cast<int64_t>(la + 1) * ld + j] : 0.f;
    }
  }
  const int first_walked = S > 0 ? 2 * warps : 0;  // local rows walked one at a time
  int cur = 0, s = 0;
  uint32_t parity = 0;  // (t / 3) & 1
  int64_t t0 = 0;       // first step of the current chunk
  for (int64_t t = 0; t < steps; ++t) {
    const int nxt = cur == 2 ? 0 : cur + 1;
    const bool last = t + 1 == steps;
    if (s == 0) {  // B u and D u of this chunk's steps, k ascending from 0
      const int cnt = steps - t0 < chunk ? static_cast<int>(steps - t0) : chunk;
      __syncthreads();  // the previous chunk's are read
      for (int lr = warp; lr < nrows; lr += warps) {
        const float* row = mine + static_cast<int64_t>(lr) * ld + n;
        for (int ss = lane; ss < cnt; ss += 32) {
          const float* ut = u + (t0 + ss) * p;
          float acc = 0.f;
          for (int k = 0; k < p; ++k) acc = __fadd_rn(acc, __fmul_rn(row[k], ut[k]));
          bus[lr * chunk + ss] = acc;
        }
      }
      __syncthreads();
    }
    const float bu_a = has_a ? bus[la * chunk + s] : 0.f;
    const float bu_b = has_b ? bus[(la + 1) * chunk + s] : 0.f;
    if (tid == 0 && !last) mbar_arm(mbar_addr + 8u * nxt, expect);
    mbar_wait(mbar_addr + 8u * cur, parity);  // x_t has arrived from every CTA
    const float* x = xb + cur * n4;
    float* xn = xb + nxt * n4;
    float xv[S > 0 ? S : 1];
    if constexpr (S > 0) {
#pragma unroll
      for (int mm = 0; mm < S; ++mm) {
        const int j = lane + 32 * mm;
        xv[mm] = j < n ? x[j] : 0.f;
      }
      if (has_a) {
        float acc_a = 0.f, acc_b = 0.f;
#pragma unroll
        for (int mm = 0; mm < S; ++mm) {
          acc_a = __fadd_rn(acc_a, __fmul_rn(ra[mm], xv[mm]));
          acc_b = __fadd_rn(acc_b, __fmul_rn(rb[mm], xv[mm]));
        }
        warp_sum2(acc_a, acc_b);
        const int r = r0 + la;
        const float va = __fadd_rn(acc_a, bu_a), vb = __fadd_rn(acc_b, bu_b);
        if (r < n) {
          if (!last && lane == 0) xn[r] = va;
          if (!last && lane == 31) xs[(t + 1) * n + r] = va;
        } else if (lane == 0) {
          y[t * q + (r - n)] = va;
        }
        if (has_b && r + 1 < n) {
          if (!last && lane == 0) xn[r + 1] = vb;
          if (!last && lane == 30) xs[(t + 1) * n + r + 1] = vb;
        } else if (has_b && lane == 0) {
          y[t * q + (r + 1 - n)] = vb;
        }
      }
    }
    for (int lr = first_walked + warp; lr < nrows; lr += warps) {
      const int r = r0 + lr;
      if (last && r < n) continue;
      const float* row = mine + static_cast<int64_t>(lr) * ld;
      const float v = __fadd_rn(row_dot<S>(row, x, xv, n, lane), bus[lr * chunk + s]);
      if (r < n) {
        if (lane == 0) xn[r] = v;
        if (lane == 31) xs[(t + 1) * n + r] = v;
      } else if (lane == 0) {
        y[t * q + (r - n)] = v;
      }
    }
    if (!last) {  // this CTA's block of x_{t+1} into every peer
      cta_sync1(nt);
      const uint32_t dst = xb_addr + 4u * static_cast<uint32_t>(nxt * n4 + r0);
      const uint32_t dst_bar = mbar_addr + 8u * nxt;
      for (int c = warp; c < cs; c += warps) {
        if (c == rank) continue;
        for (int k = lane; k < blocks; k += 32) {
          const float4 v = *reinterpret_cast<const float4*>(xn + r0 + 4 * k);
          store_peer(peer_addr(dst + 16u * k, c), v, peer_addr(dst_bar, c));
        }
      }
    }
    cur = nxt;
    if (cur == 0) parity ^= 1u;
    if (++s == chunk) {
      s = 0;
      t0 += chunk;
    }
  }
  cluster_sync();  // no CTA leaves while a store into it may be in flight
}

// the rows route's register slots of state: the smallest of these >= ceil(n / 32),
// or 0 (x read from shared memory) past 16
constexpr int kSlots[] = {1, 2, 3, 4, 6, 8, 10, 12, 16};
constexpr int kNumSlots = sizeof(kSlots) / sizeof(kSlots[0]);
constexpr int kWarpSlots[] = {2, 4, 8, 16, 32};
constexpr int kNumWarpSlots = sizeof(kWarpSlots) / sizeof(kWarpSlots[0]);

static int warp_allowed[kNumWarpSlots][kMaxDevices] = {};
static int rows_allowed[2][kNumSlots + 1][kMaxDevices] = {};
static int rows_cluster16[2][kNumSlots + 1][kMaxDevices] = {};

using WarpKernel = void (*)(const float*, const float*, const float*, float*, float*, int64_t,
                            int, int, int, int);
using RowsKernel = void (*)(const float*, const float*, const float*, float*, float*, int64_t,
                            int, int, int, int, int);

// index of `slots` in kWarpSlots, or -1
static int warp_index(int slots) {
  for (int i = 0; i < kNumWarpSlots; ++i) {
    if (kWarpSlots[i] == slots) return i;
  }
  return -1;
}

template <int I = 0>
static WarpKernel warp_kernel(int index) {
  if constexpr (I + 1 >= kNumWarpSlots) {
    return dlsim_warp_kernel<kWarpSlots[I]>;
  } else {
    return index == I ? dlsim_warp_kernel<kWarpSlots[I]> : warp_kernel<I + 1>(index);
  }
}

// index of `slots` in kSlots (0 for S == 0 reads x from shared memory: index kNumSlots), or -1
static int rows_index(int slots) {
  if (slots == 0) return kNumSlots;
  for (int i = 0; i < kNumSlots; ++i) {
    if (kSlots[i] == slots) return i;
  }
  return -1;
}

template <bool Device, int I = 0>
static RowsKernel rows_kernel(int index) {
  if constexpr (I >= kNumSlots) {
    return dlsim_rows_kernel<0, Device>;
  } else {
    return index == I ? dlsim_rows_kernel<kSlots[I], Device> : rows_kernel<Device, I + 1>(index);
  }
}

}  // namespace lti
}  // namespace dsp

// S3. m ((n + q) x (n + p), [[A B]; [C D]] row-major), u (steps, p), x0 (n),
// float32; out y (steps, q), xs (steps, n). route 0 the warp (slots 2, 4, 8, 16
// or 32, >= n; threads 32), 1 the rows in shared memory, 2 the rows in device
// memory (slots 1, 2, 3, 4, 6, 8, 10, 12 or 16 with n <= 32 slots, or 0; a
// cluster of 1 to 16 CTAs of threads each, rows_cta rows each); chunk the
// steps a stage holds; smem_bytes a CTA's dynamic shared memory, as
// ops/lti.dlsim_geometry computes them.
extern "C" int dsp_dlsim(const float* m, const float* u, const float* x0, float* y, float* xs,
                         int64_t steps, int64_t n, int64_t p, int64_t q, int64_t route,
                         int64_t cluster, int64_t rows_cta, int64_t slots, int64_t chunk,
                         int64_t threads, int64_t smem_bytes, void* stream) {
  using namespace dsp::lti;
  const bool bad_common = steps < 0 || n < 0 || p < 0 || q < 0 || n + q > 0x3fffffff ||
                          n + p > 0x3fffffff || chunk < 1 || p > 0x7fffffff / (3 * chunk) ||
                          smem_bytes < 0 || smem_bytes > 232448;
  if (bad_common || route < 0 || route > 2) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int ni = static_cast<int>(n), pi = static_cast<int>(p), qi = static_cast<int>(q);
  const int ci = static_cast<int>(chunk);
  if (route == 0) {
    const int wi = warp_index(static_cast<int>(slots));
    if (n > 32 || q > 32 || p > kWarpMaxInputs || wi < 0 || slots < n || threads != 32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (steps == 0) return 0;
    WarpKernel kern = warp_kernel(wi);
    cudaError_t err = dsp::allow_smem(kern, warp_allowed[wi], static_cast<int>(smem_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    kern<<<1, 32, static_cast<size_t>(smem_bytes), st>>>(m, u, x0, y, xs, steps, ni, pi, qi, ci);
    return static_cast<int>(cudaGetLastError());
  }
  const int ri = rows_index(static_cast<int>(slots));
  if (cluster < 1 || cluster > kMaxCluster || rows_cta < 1 || rows_cta % 4 != 0 ||
      rows_cta * cluster < n + q ||
      rows_cta > 0x7fffffff / (n + p > 0 ? n + p : 1) || ri < 0 ||
      (slots != 0 && n > 32 * slots) || 4 * n > 0xfffff || threads < 32 ||
      threads > (slots != 0 ? kRegThreads : kMaxThreads) || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (steps == 0) return 0;
  const bool device = route == 2;
  RowsKernel kern = device ? rows_kernel<true>(ri) : rows_kernel<false>(ri);
  cudaError_t err = dsp::allow_smem(kern, rows_allowed[device][ri], static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  if (cluster > 8 && cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < dsp::kMaxDevices &&
      !rows_cluster16[device][ri][dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    rows_cluster16[device][ri][dev] = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, m, u, x0, y, xs, steps, ni, pi, qi, ci,
                           static_cast<int>(rows_cta));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the compiler gave S3's kernel for route (0 warp, 1 rows in shared
// memory, 2 rows in device memory) and slots: registers a thread, local bytes
// a thread, static shared bytes, most threads a block (4 int64 in out).
extern "C" int dsp_dlsim_attrs(int64_t route, int64_t slots, int64_t* out) {
  using namespace dsp::lti;
  if (route < 0 || route > 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  const int wi = warp_index(static_cast<int>(slots)), ri = rows_index(static_cast<int>(slots));
  if ((route == 0 && wi < 0) || (route > 0 && ri < 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err =
      route == 0 ? cudaFuncGetAttributes(&attr, warp_kernel(wi))
                 : cudaFuncGetAttributes(&attr, route == 2 ? rows_kernel<true>(ri)
                                                           : rows_kernel<false>(ri));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = static_cast<int64_t>(attr.sharedSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}
