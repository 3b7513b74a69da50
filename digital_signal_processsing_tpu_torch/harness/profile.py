"""Phase-split profiling harness (reference analog: benchmark.h:9-132).

Counterpart of ``digital_signal_processsing_tpu/harness/profile.py``. The
reference times four phases with cudaEvents, init (allocation), H2D,
kernel and D2H, averaged over 5 warm-up and 10 measured rounds
(gpu_utils.h:31-32). Here:

    init    = first host-to-device copy and first call (kernel build included)
    h2d     = host clock around a synchronised copy of the NumPy input
              (0 when the input stays resident on the card)
    compute = CUDA events around the call, on the current stream
    d2h     = host clock around the copy of the output back to NumPy

With ``sharding`` (a ``parallel.Sharding``; every rank of the mesh calls
:func:`time_phases` with the global host input), each phase ends when every
rank's part of it has: each round stages this rank's shard, times its own
call, fetches the global output through ``sharding.gather``, and the ranks
take the maximum of each phase over the mesh (one all-reduce a round,
outside the timed spans), the counterpart of the reference's ``put``
through a sharding and its wait on the global array. Every rank reports the
same numbers.

With ``chain=K > 1`` the compute phase is the reference's K-differential
cross-check: each round times K applications of ``fn`` (each on the last's
output) and then K // 4 of them, both queued back to back on the stream from
the same input, and takes the slope (:func:`k_differential`), which cancels
what a call costs once whatever its length. The events above are the primary
timer; the slope checks them.

Timing needs a card: on any other device :func:`time_phases` raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..parallel.mesh import world_max
from ..utils.device import resolve_device

WARMUP_ROUNDS = 5  # gpu_utils.h:31
MEASUREMENT_ROUNDS = 10  # gpu_utils.h:32


@dataclasses.dataclass
class ProfileResult:
    """Accumulated phase timings in milliseconds (benchmark.h:9-31 analog)."""

    initialization_ms: float = 0.0
    h2d_ms: float = 0.0
    compute_ms: float = 0.0
    d2h_ms: float = 0.0
    rounds: int = 0

    @property
    def total_ms(self) -> float:
        return self.h2d_ms + self.compute_ms + self.d2h_ms

    @property
    def cold_total_ms(self) -> float:
        return self.initialization_ms + self.total_ms

    def accumulate(self, h2d: float, compute: float, d2h: float) -> None:
        self.h2d_ms += h2d
        self.compute_ms += compute
        self.d2h_ms += d2h
        self.rounds += 1

    def averaged(self) -> "ProfileResult":
        n = max(self.rounds, 1)
        return ProfileResult(
            initialization_ms=self.initialization_ms,
            h2d_ms=self.h2d_ms / n,
            compute_ms=self.compute_ms / n,
            d2h_ms=self.d2h_ms / n,
            rounds=1,
        )

    # --- derived metrics (benchmark.h:56-67 analog) ---
    def bandwidth_gbs(self, num_samples: int, bytes_per_sample: int) -> float:
        """App-level GB/s: input+output traffic over total time."""
        if self.total_ms <= 0:
            return 0.0
        return num_samples * 2 * bytes_per_sample / (self.total_ms * 1e-3) / 1e9

    def throughput_msps(self, num_samples: int) -> float:
        if self.total_ms <= 0:
            return 0.0
        return num_samples / (self.total_ms * 1e-3) / 1e6

    def compute_throughput_msps(self, num_samples: int) -> float:
        if self.compute_ms <= 0:
            return 0.0
        return num_samples / (self.compute_ms * 1e-3) / 1e6

    def cold_throughput_msps(self, num_samples: int) -> float:
        if self.cold_total_ms <= 0:
            return 0.0
        return num_samples / (self.cold_total_ms * 1e-3) / 1e6

    def print_stats(self, num_samples: int, bytes_per_sample: int) -> None:
        r = self.averaged()
        print(
            f"  init (cold) : {r.initialization_ms:10.3f} ms\n"
            f"  host->device: {r.h2d_ms:10.3f} ms\n"
            f"  compute     : {r.compute_ms:10.3f} ms\n"
            f"  device->host: {r.d2h_ms:10.3f} ms\n"
            f"  total       : {r.total_ms:10.3f} ms\n"
            f"  bandwidth   : {r.bandwidth_gbs(num_samples, bytes_per_sample):10.3f} GB/s\n"
            f"  throughput  : {r.throughput_msps(num_samples):10.3f} MS/s "
            f"(kernel {r.compute_throughput_msps(num_samples):.3f}, "
            f"cold {r.cold_throughput_msps(num_samples):.3f})"
        )


def chain_lengths(chain: int) -> tuple[int, int]:
    """The two chain lengths of a K-differential round: (K, max(K // 4, 1))."""
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")
    return chain, max(chain // 4, 1)


def k_differential(big_ms: float, small_ms: float, chain: int) -> float:
    """Per-application ms from a round's two timed chains, the reference's slope:
    max((t_K - t_small) / (K - small), 0) with (K, small) from :func:`chain_lengths`."""
    big, small = chain_lengths(chain)
    return max((big_ms - small_ms) / (big - small), 0.0)


def chained(fn: Callable[[torch.Tensor], torch.Tensor], k: int):
    """``fn`` applied ``k`` times, each call on the last one's output; refuses an
    ``fn`` that does not keep its input's shape and dtype."""

    def run(x: torch.Tensor) -> torch.Tensor:
        y = x
        for _ in range(k):
            y = fn(y)
            if y.shape != x.shape or y.dtype != x.dtype:
                raise ValueError(
                    f"chain needs fn to keep shape and dtype: {x.dtype}{tuple(x.shape)} became "
                    f"{y.dtype}{tuple(y.shape)}"
                )
        return y

    return run


def time_phases(
    fn: Callable[[torch.Tensor], torch.Tensor],
    host_input: np.ndarray,
    *,
    device="cuda",
    warmup: int = WARMUP_ROUNDS,
    rounds: int = MEASUREMENT_ROUNDS,
    resident: bool = False,
    sharding=None,
    chain: int = 1,
) -> ProfileResult:
    """Warm-up-then-average phase-split benchmark (benchmark.h:116-132 analog).

    ``resident=False`` copies the host buffer to the card every round (the
    reference's Standard memory mode); ``resident=True`` copies it once,
    before the rounds, which then time only the compute and the fetch of
    the output, and ``h2d`` reads 0 (the serving steady state that the
    reference's Unified mode approximated, gpu_utils.h:26-65). The sweep
    logs both.

    ``sharding``: ``fn`` takes this rank's shard and returns this rank's
    output shard; the phases are the slowest rank's (module docstring), and
    ``device`` is the mesh's.

    ``chain > 1``: compute is the K-differential slope of each round (module
    docstring) and ``fn`` must keep shape and dtype; d2h fetches the long
    chain's output. ``chain=1`` times one call.
    """
    big, small = chain_lengths(chain)
    run_big = fn if chain == 1 else chained(fn, big)
    if sharding is not None:
        device = sharding.mesh.device
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"time_phases measures a CUDA device, got {dev}")
    res = ProfileResult()
    local = host_input if sharding is None else sharding.shard(host_input).numpy()

    def put() -> torch.Tensor:
        return torch.from_numpy(local).to(dev)

    def fetch(out: torch.Tensor) -> np.ndarray:
        if sharding is not None:
            out = sharding.gather(out)
        return out.cpu().numpy()

    def slowest(ms: list[float]) -> list[float]:
        if sharding is None:
            return ms
        return world_max(torch.tensor(ms, dtype=torch.float64, device=dev), sharding.mesh).tolist()

    t0 = time.perf_counter()
    x = put()
    run_big(x)
    torch.cuda.synchronize(dev)
    res.initialization_ms = (time.perf_counter() - t0) * 1e3

    for _ in range(warmup):
        fetch(run_big(x if resident else put()))

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed(run) -> tuple[torch.Tensor, float]:
        start.record()
        out = run(x)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    run_small = None if chain == 1 else chained(fn, small)
    for _ in range(rounds):
        t0 = time.perf_counter()
        if not resident:
            x = put()
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        out, compute_ms = timed(run_big)
        t2 = time.perf_counter()
        fetch(out)
        t3 = time.perf_counter()
        if run_small is not None:
            compute_ms = k_differential(compute_ms, timed(run_small)[1], chain)
        h2d_ms = 0.0 if resident else (t1 - t0) * 1e3
        res.accumulate(*slowest([h2d_ms, compute_ms, (t3 - t2) * 1e3]))
    res.initialization_ms = slowest([res.initialization_ms])[0]
    return res


def benchmark(
    fn: Callable[[], object],
    *,
    warmup: int = WARMUP_ROUNDS,
    rounds: int = MEASUREMENT_ROUNDS,
) -> float:
    """Plain warm-up-then-average wall timer of a host function; mean ms."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(rounds):
        fn()
    return (time.perf_counter() - t0) * 1e3 / rounds


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def trace(fn: Callable[[], object], trace_dir, *, warmup: int = 1) -> Path:
    """Write a ``torch.profiler`` trace of one synchronised call of ``fn``.

    The deep-profiling path, counterpart of the reference's
    ``jax.profiler.trace`` (the paper points at Nsight Systems). Warms up
    first, so the trace shows steady-state execution rather than kernel
    builds, then records the host and, where there is a card, the device.
    Returns the Chrome trace JSON written under ``trace_dir``
    (chrome://tracing or Perfetto open it).
    """
    for _ in range(warmup):
        fn()
        _sync()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        _sync()
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    return path


__all__ = [
    "ProfileResult", "time_phases", "chain_lengths", "k_differential", "chained", "benchmark",
    "trace", "WARMUP_ROUNDS", "MEASUREMENT_ROUNDS",
]
