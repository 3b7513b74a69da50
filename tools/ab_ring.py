#!/usr/bin/env python3
"""The ring kernels (B6, B7) of two trees of the port, and their design variants, on one card.

    python3 tools/ab_ring.py OLD_ROOT [--out chiprun_out/ab_ring.json]

OLD_ROOT is a checkout of the design before (for example ``addfa4d``,
unpacked with ``git archive`` into a git-ignored directory). Each tree runs
in processes of its own, which import only that tree and load its kernels
(built once by the parent), in the order old, this, this, old:

- at world size 1 (one process, gloo): on a 16M-sample int16 shard (a quarter
  of the 64M stream, k=1024, C=2), B1 alone, B7, B6 and the put alone
  (``dsp_ring_put`` into a local buffer) beside ``Tensor.copy_``; for the old
  tree, B7 taken apart: B1 over the same tiles in its two launches, then with
  the side stream and the put, then the whole call (its interprocess events).
  Each as the device ms of 20 calls queued back to back behind a sleep kernel
  (the card's time), and without it (host-paced: the host's time to issue a
  call, where that is longer);
- in the ring of four processes on the card (gloo, a ``FileStore``): each
  rank's device ms a call (events on its stream; every call started
  together after a host barrier and a synchronisation, as ``chip_smoke.py``'s
  ``ring_timed``) and, for calls queued back to back, the device ms a call
  over 10; the slowest rank's host ms. For both trees ``host_barrier``
  alone, B6, B7 and ``sharded_moving_average`` with ``halo_impl`` in
  ``pallas_ring`` and ``fused_ring``. For this tree also B7 in one launch (the
  head block last, waiting for the left neighbour's put inside the kernel;
  its kernel built here against the tree's ``run_tile.cuh``), B7 composed of
  the port's other parts (B6's put of the tail, B1 over the interior, a
  stream wait, B1 seeded over the head: the put a launch of its own), and B6
  and B7 with every stream wait a spinning kernel instead of a stream memory
  operation (a one-thread acquire loop, built here).

Every output is held bit for bit against B1 (or the left neighbour's shard).
Needs a CUDA device and nvcc. ``tools/ab_end_to_end.py`` takes the ring's
sharded averager from here.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SHARD = 2**24  # samples a rank: a quarter of the 64M stream
WINDOW, CHANNELS = 1024, 2
REPS = 10
B2B = 10  # calls queued back to back

# B6 and B7 with every stream wait and signal a kernel: thread 0 spins with an
# acquire at system scope until the counter reaches the value, or stores it
# with a release.
SPIN_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__global__ void spin_wait_kernel(const unsigned long long* counter, unsigned long long value) {
  if (threadIdx.x != 0) return;
  unsigned long long v;
  do {
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(counter) : "memory");
    if (v >= value) break;
    __nanosleep(256);
  } while (true);
}

__global__ void spin_signal_kernel(unsigned long long* counter, unsigned long long value) {
  if (threadIdx.x == 0) {
    __threadfence_system();
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(counter), "l"(value) : "memory");
  }
}

extern "C" int dsp_spin_wait(void* counter, int64_t value, void* stream) {
  spin_wait_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(counter), static_cast<unsigned long long>(value));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsp_spin_signal(void* counter, int64_t value, void* stream) {
  spin_signal_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counter), static_cast<unsigned long long>(value));
  return static_cast<int>(cudaGetLastError());
}
"""

# B7 in one launch at C = 2: the port's ring_windowed_kernel<2> (the put in
# block 0, B1's spans over the interior, the head tiles in the last block),
# whose head block waits for the left neighbour's put inside the kernel (an
# acquire spin at system scope) instead of behind a stream wait and a second
# launch. Built against the tree's run_tile.cuh (RUN_TILE).
ONE_LAUNCH_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

#include RUN_TILE

namespace {

using dsp::runs::Args;

struct OneArgs {
  const int16_t* tail;
  int16_t* slot;
  unsigned long long* sent;
  const unsigned long long* arrived;
  unsigned long long* consumed;
  unsigned long long call;
  int interior_blocks;
  int head_tiles;
};

__device__ __forceinline__ void publish(unsigned long long* counter, unsigned long long value) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(counter), "l"(value) : "memory");
}

__device__ __forceinline__ unsigned long long acquire(const unsigned long long* counter) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(counter) : "memory");
  return v;
}

__global__ void __launch_bounds__(dsp::kThreads, 4) one_launch_kernel(Args a, OneArgs r) {
  if (blockIdx.x == 0 && r.tail != nullptr) {
    int from = 0;
    if ((reinterpret_cast<uintptr_t>(r.tail) & 15u) == 0) {
      from = a.halo / 8 * 8;
      for (int i = threadIdx.x; i < a.halo / 8; i += blockDim.x) {
        reinterpret_cast<uint4*>(r.slot)[i] = reinterpret_cast<const uint4*>(r.tail)[i];
      }
    }
    for (int i = from + threadIdx.x; i < a.halo; i += blockDim.x) r.slot[i] = r.tail[i];
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) publish(r.sent, r.call);
  }
  if (static_cast<int>(blockIdx.x) < r.interior_blocks) {
    dsp::runs::scan_span<dsp::runs::kHillisSteele, 2, true>(
        a, dsp::runs::span_of<true>(a, blockIdx.x));
    return;
  }
  if (r.head_tiles == 0) return;
  if (r.arrived != nullptr) {
    if (threadIdx.x == 0) {
      while (acquire(r.arrived) < r.call) __nanosleep(256);
    }
    __syncthreads();
  }
  dsp::runs::scan_span<dsp::runs::kHillisSteele, 2, true>(
      a, dsp::runs::Span<true>(a, 0, r.head_tiles));
  if (r.consumed != nullptr) {
    __syncthreads();  // every read of the slot is done
    if (threadIdx.x == 0) publish(r.consumed, r.call);
  }
}

}  // namespace

// As the port's dsp_ring_windowed at kernel_c = 2, with arrived: the head
// block's counter to wait on, or null.
extern "C" int dsp_one_launch_b7(const int16_t* x, int16_t* y, const int16_t* seed, int64_t n,
                                 int64_t window, int64_t nrun, int64_t interior_begin,
                                 int64_t interior_end, int64_t span_tiles, int64_t head_tiles,
                                 int64_t smem_bytes, const int16_t* tail, int16_t* slot,
                                 void* sent, const void* arrived, void* consumed, int64_t call,
                                 void* stream) {
  static int allowed[dsp::kMaxDevices] = {};
  const void* kernel = reinterpret_cast<const void*>(one_launch_kernel);
  Args a;
  int err = dsp::runs::runs_args(&a, x, y, seed, n, window, 2, 2, nrun, 0, -1, 1, smem_bytes);
  if (err != 0) return err;
  const int64_t range = interior_end - interior_begin;
  a.first_tile = interior_begin;
  a.end_tile = interior_end;
  a.span_tiles = static_cast<int>(range > 0 && span_tiles > range ? range : span_tiles);
  OneArgs r{tail, slot, static_cast<unsigned long long*>(sent),
            static_cast<const unsigned long long*>(arrived),
            static_cast<unsigned long long*>(consumed), static_cast<unsigned long long>(call),
            static_cast<int>(range > 0 ? (range + a.span_tiles - 1) / a.span_tiles : 0),
            static_cast<int>(head_tiles)};
  const int64_t blocks = r.interior_blocks + (head_tiles > 0 ? 1 : 0);
  cudaError_t e = dsp::allow_smem(kernel, allowed, static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a, &r};
  e = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(dsp::kThreads), args,
                       static_cast<size_t>(smem_bytes), static_cast<cudaStream_t>(stream));
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}
"""


# --- a worker (imports only the tree it is given) -------------------------------


def _events_ms(fn, calls: int = 1) -> float:
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / calls


def _queued_ms(fn, lead: bool, reps: int = 20) -> list[float]:
    """Device ms of each of ``reps`` calls queued back to back, an event after
    each; with ``lead``, behind a sleep kernel during which the host queues
    them all (the card's time for a call, not the host's to issue it)."""
    import torch

    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    if lead:
        torch.cuda._sleep(int(2e6 * 0.3 * reps))  # about 0.3 ms a call at 2 GHz
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def _ring_timed(fn, mesh, barrier) -> dict:
    """Device ms a call started together on every rank, device ms a call
    queued back to back, and host ms of each (medians)."""
    import torch

    fn()
    dev, wall, b2b, b2b_wall = [], [], [], []
    for _ in range(REPS):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev.append(_events_ms(fn))
        wall.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        barrier(mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b2b.append(_events_ms(fn, B2B))
        b2b_wall.append((time.perf_counter() - t0) * 1e3 / B2B)
    return {"device": statistics.median(dev), "host": statistics.median(wall),
            "b2b device": statistics.median(b2b), "b2b host": statistics.median(b2b_wall)}


def _one_launch_b7(rp, var, xs, y, mesh, stream):
    """B7 as one launch (``var``: ONE_LAUNCH_SOURCE built): the put and the
    interior, the head block last, waiting for the left neighbour's put
    inside the kernel."""
    from digital_signal_processsing_tpu_torch.ops.pallas_scan import _resident

    n, halo = xs.numel(), WINDOW * CHANNELS
    g, head, tiles = rp.fused_ring_split(n, WINDOW, CHANNELS)
    ring = rp._ring(mesh, 2 * halo)
    step = ring.next_step()
    left, right = ring.has_left, ring.has_right
    if right:
        ring.wait_reuse(step, stream)
    span = g.range_span(tiles - head, _resident(xs.device, g)) if head < tiles else 1
    err = var.dsp_one_launch_b7(
        xs.data_ptr(), y.data_ptr(), ring.received(step) if left else None, n, WINDOW, g.nrun,
        head, tiles, span, head, g.smem_bytes, xs[n - halo:].data_ptr() if right else None,
        ring.right_slot(step) if right else None, ring.right_sent(step) if right else None,
        ring.own_sent(step) if left else None, ring.own_consumed(step) if left else None,
        step.call, stream)
    if err:
        raise RuntimeError(f"dsp_one_launch_b7: CUDA error {err}")
    return y


def _composed_b7(rp, ps, xs, y, mesh, stream):
    """B7 from the parts the port already has, on one stream: B6's put of the
    tail (its last block publishes sent), B1 over the interior, the stream's
    wait for the left neighbour's put, B1 seeded from the slot over the head,
    the release of the slot; rank 0 runs B1 over the whole shard."""
    n, halo = xs.numel(), WINDOW * CHANNELS
    _, head, tiles = rp.fused_ring_split(n, WINDOW, CHANNELS)
    ring = rp._ring(mesh, 2 * halo)
    step = ring.next_step()

    def launch(begin, end, seed):
        err = ps.launch_windowed_range(xs, y, WINDOW, CHANNELS, seed, begin, end, stream)
        if err:
            raise RuntimeError(f"B1: CUDA error {err}")

    if ring.has_right:
        ring.put(xs[n - halo:].data_ptr(), step, stream)
    if not ring.has_left:
        launch(0, tiles, None)
        return y
    if head < tiles:
        launch(head, tiles, None)
    ring.wait_arrived(step, stream)
    launch(0, head, ring.received(step))
    ring.release_slot(step, stream)
    return y


def worker(mode: str, tree: str, rank: int, world: int, store: str, out: str, variants: str) -> None:
    """One rank. mode: "old" (the design before), "new" (this tree, with its
    variants) or "e2e" (either tree, the sharded averager only)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import _build, parallel as par
    from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
    from digital_signal_processsing_tpu_torch.ops.scan_xla import moving_average_xla
    from digital_signal_processsing_tpu_torch.parallel import ring_pallas as rp
    from digital_signal_processsing_tpu_torch.parallel.mesh import host_barrier, shift_right

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    mesh = par.make_time_mesh(device="cuda")
    lib = _build.library()
    rng = np.random.default_rng(0)
    whole = torch.from_numpy(rng.integers(-32768, 32768, size=world * SHARD, dtype=np.int16))
    xs = whole[rank * SHARD:(rank + 1) * SHARD].cuda()
    stream = torch.cuda.current_stream().cuda_stream
    halo = WINDOW * CHANNELS
    b1 = ps.windowed_averager(xs, WINDOW, CHANNELS)
    want = moving_average_xla(whole[max(0, rank * SHARD - halo):(rank + 1) * SHARD].cuda(),
                              WINDOW, CHANNELS)[-SHARD:]
    res: dict = {}

    def same(got, ref, what):
        if not torch.equal(got, ref):
            raise AssertionError(f"rank {rank} {mode} {what}: not bit-exact")

    b7 = lambda: par.fused_ring_windowed_shard(xs, WINDOW, CHANNELS, mesh)  # noqa: E731
    b6 = lambda: par.ring_shift_right_shard(xs, mesh)  # noqa: E731
    same(b7(), want, "B7")
    left = shift_right(xs, mesh)
    same(b6(), left, "B6")
    runs = {
        "host_barrier": lambda: host_barrier(mesh),
        "B6": b6,
        "B7": b7,
        "pallas_ring": lambda: par.sharded_moving_average(xs, WINDOW, CHANNELS, mesh=mesh,
                                                          halo_impl="pallas_ring"),
        "fused_ring": lambda: par.sharded_moving_average(xs, WINDOW, CHANNELS, mesh=mesh,
                                                         halo_impl="fused_ring"),
    }
    if mode == "e2e":  # tools/ab_end_to_end.py: the ring's sharded averager only
        runs = {k: runs[k] for k in ("pallas_ring", "fused_ring")}
    if mode == "new":
        import ctypes

        var = ctypes.CDLL(variants)
        P, I = ctypes.c_void_p, ctypes.c_int64  # noqa: E741
        signatures = {"dsp_spin_wait": (P, I, P), "dsp_spin_signal": (P, I, P),
                      "dsp_one_launch_b7": (P, P, P, *(I,) * 8, P, P, P, P, P, I, P)}
        for name, argtypes in signatures.items():
            getattr(var, name).argtypes, getattr(var, name).restype = argtypes, ctypes.c_int
        variants = {"B7 one launch": functools.partial(_one_launch_b7, rp, var),
                    "B7 composed": functools.partial(_composed_b7, rp, ps)}
        for name, variant in variants.items():
            run_variant = functools.partial(variant, xs, torch.empty_like(xs), mesh, stream)
            same(run_variant(), want, name)
            runs[name] = run_variant
        waits = (lib.dsp_ring_wait, lib.dsp_ring_signal)

        def spinning(fn):
            def call():
                lib.dsp_ring_wait, lib.dsp_ring_signal = var.dsp_spin_wait, var.dsp_spin_signal
                try:
                    return fn()
                finally:
                    lib.dsp_ring_wait, lib.dsp_ring_signal = waits

            return call

        same(spinning(b7)(), want, "B7 spin waits")
        same(spinning(b6)(), left, "B6 spin waits")
        runs["B6 spin waits"], runs["B7 spin waits"] = spinning(b6), spinning(b7)
    if world == 1:
        dst = torch.empty_like(xs)
        if mode == "new":
            put = lambda: lib.dsp_ring_put(xs.data_ptr(), dst.data_ptr(), 2 * SHARD, None, 0,  # noqa: E731
                                           None, stream)
        else:
            put = lambda: lib.dsp_ring_put(xs.data_ptr(), dst.data_ptr(), 2 * SHARD, stream)  # noqa: E731
        put()
        same(dst, xs, "the put alone")
        alone = {"B1": lambda: ps.windowed_averager(xs, WINDOW, CHANNELS), "B7": b7, "B6": b6,
                 "the put alone": put, "copy_": lambda: dst.copy_(xs)}
        if mode == "old":
            alone.update(_old_parts(rp, ps, lib, xs, mesh, stream, same, b1))
        got = {f"{k}{how}": [] for k in alone for how in ("", " (host-paced)")}
        for name in (*alone, *reversed(alone)):
            for _ in range(5):
                alone[name]()
            got[name] += _queued_ms(alone[name], True)
            got[f"{name} (host-paced)"] += _queued_ms(alone[name], False)
        res["alone"] = {k: statistics.median(v) for k, v in got.items()}
    else:
        got = {k: [] for k in runs}
        for name in (*runs, *reversed(runs)):
            got[name].append(_ring_timed(runs[name], mesh, host_barrier))
        res["ring"] = {k: {m: statistics.median(r[m] for r in v) for m in v[0]}
                       for k, v in got.items()}
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps(res))
    mesh.close()
    dist.destroy_process_group()


def _old_parts(rp, ps, lib, xs, mesh, stream, same, b1) -> dict:
    """The design before, taken apart at world size 1: B1's two launches; with
    the side stream and the put; the whole call adds its interprocess events."""
    import torch

    n = xs.numel()
    _, head, tiles = rp.fused_ring_split(n, WINDOW, CHANNELS)
    y = torch.empty_like(xs)
    ring = rp._ring(mesh, 2 * WINDOW * CHANNELS)
    tail = xs[n - WINDOW * CHANNELS:]
    compute = torch.cuda.current_stream()

    def two_launches():
        ps.launch_windowed_range(xs, y, WINDOW, CHANNELS, None, head, tiles, stream)
        ps.launch_windowed_range(xs, y, WINDOW, CHANNELS, None, 0, head, stream)

    def side_and_put():
        ring.side.wait_stream(compute)
        lib.dsp_ring_put(tail.data_ptr(), ring.right_base, tail.numel() * 2, ring.side.cuda_stream)
        ps.launch_windowed_range(xs, y, WINDOW, CHANNELS, None, head, tiles, stream)
        compute.wait_stream(ring.side)
        ps.launch_windowed_range(xs, y, WINDOW, CHANNELS, None, 0, head, stream)

    for fn in (two_launches, side_and_put):
        fn()
        same(y, b1, fn.__name__)
    return {"B1 in two launches": two_launches, "with the side stream and the put": side_and_put}


# --- the parent ----------------------------------------------------------------


def build_tree(tree: Path) -> None:
    """Build the tree's kernels once, before its workers load them."""
    subprocess.run([sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
                    "from digital_signal_processsing_tpu_torch import _build; _build.library()",
                    str(tree)], check=True)


def run(mode: str, tree: Path, world: int, tmp: Path, variants: Path) -> list[dict]:
    """Spawn ``world`` workers of ``tree``; every rank's results."""
    tag = f"{mode}.{world}.{time.monotonic_ns()}"
    store, outs = tmp / f"{tag}.store", [tmp / f"{tag}.{r}.json" for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", mode, str(tree), str(r),
                               str(world), str(store), str(outs[r]), str(variants)], env=env)
             for r in range(world)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(codes):
        raise RuntimeError(f"{mode} workers at world size {world} exited with {codes}")
    return [json.loads(o.read_text()) for o in outs]


def ring_rows(results: list[dict]) -> dict:
    """{run: {metric: (median over ranks, per rank...)}} of a ring's results; host
    ms as the slowest rank's."""
    rows = {}
    for name in results[0]["ring"]:
        per = [r["ring"][name] for r in results]
        rows[name] = {m: ([max(p[m] for p in per)] if "host" in m else
                          [statistics.median(p[m] for p in per)]) + [p[m] for p in per]
                      for m in per[0]}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_root", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "ab_ring.json")
    args = ap.parse_args()
    from _ab import build, card  # the parent imports this tree; the workers their own

    old, new = args.old_root.resolve(), ROOT
    for tree in (old, new):
        build_tree(tree)
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        run_tile = ROOT / "digital_signal_processsing_tpu_torch" / "csrc" / "run_tile.cuh"
        one = ONE_LAUNCH_SOURCE.replace("#include RUN_TILE", f'#include "{run_tile}"')
        (tmp / "variants.cu").write_text(SPIN_SOURCE + one)
        variants = build(tmp / "variants.cu", {}, tmp / "libvariants.so")
        report = {"card": card(), "world 1": {}, "ring": {}}
        for world in (1, WORLD):
            got = {"old": [], "new": []}
            for mode in ("old", "new", "new", "old"):
                got[mode].append(run(mode, old if mode == "old" else new, world, tmp, variants))
            for mode, rounds in got.items():
                if world == 1:
                    report["world 1"][mode] = {
                        k: statistics.median([r[0]["alone"][k] for r in rounds])
                        for k in rounds[0][0]["alone"]}
                else:
                    rows = [ring_rows(r) for r in rounds]
                    report["ring"][mode] = {
                        k: {m: [statistics.median(v) for v in zip(*(rw[k][m] for rw in rows))]
                            for m in rows[0][k]} for k in rows[0]}
    print(f"card: {report['card']}")
    for mode, row in report["world 1"].items():
        print(f"world 1, {mode} (device ms, medians of 40): "
              + "; ".join(f"{k} {v:.4f}" for k, v in row.items()))
    for mode, rows in report["ring"].items():
        print(f"ring of {WORLD}, {mode}: device ms a call (median over ranks; by rank), started "
              f"together / queued {B2B} back to back; host ms a call, the slowest rank:")
        for k, m in rows.items():
            print(f"  {k:16s} together {m['device'][0]:.4f} ("
                  + ", ".join(f"{v:.4f}" for v in m["device"][1:])
                  + f"); back to back {m['b2b device'][0]:.4f} ("
                  + ", ".join(f"{v:.4f}" for v in m["b2b device"][1:])
                  + f"); host {m['host'][0]:.4f}, back to back {m['b2b host'][0]:.4f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        a = sys.argv[2:]
        worker(a[0], a[1], int(a[2]), int(a[3]), a[4], a[5], a[6])
        sys.exit(0)
    sys.exit(main())
