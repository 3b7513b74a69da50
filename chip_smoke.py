#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build, check and drive it on one card.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; imports no JAX. Inputs
come from ``np.random.default_rng(0)``. Every phase prints a line, and any
failure exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the kernels compiled from ``digital_signal_processsing_tpu_torch/csrc``;
3. corners: each kernel (B1 windowed, B2 packed, B4 cumsum and the two-pass
   route) against its plain PyTorch version on the card, bit-exact, over
   k in {1, 16, 1024, 65535}, C in {1, 2, 3, 16}, frames in
   {1, 127, 129, 2^20+C}, all-INT16_MIN input, seeded calls and an int32
   wrap; B1 also against the NumPy golden model on a slice;
4. main path, through the entry points a user calls, with the kernels'
   launch counts reset just before and read just after:
   ``moving_average`` on a 64M-sample stereo stream at k=1024 (B1), the same
   stream as 16 channels at k=65535 (two-pass, B4), its int32 pair view
   (B2), ``stream_moving_average`` over two WAVs (~16M samples, the second
   of odd frame count) and the CLI; every output bit-exact against the
   plain version or the one-shot result;
5. times: each kernel against its plain version at the main path's shapes
   (CUDA events between back-to-back calls, median of 10 after 5 warm-ups,
   in turns plain, kernel, kernel, plain), with a device-to-device copy of
   the same bytes; then B1 against the two-pass route at halos on both
   sides of the bound that sends ``windowed`` to two-pass
   (``WINDOWED_SMEM_MAX``);
6. serving loop: wall time of three ``stream_moving_average`` runs over
   phase 4's WAVs and of decoding them alone, and the device time of one
   run under ``torch.profiler``, by kernel and copy.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from digital_signal_processsing_tpu_torch import _build
from digital_signal_processsing_tpu_torch.__main__ import main as cli_main
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.io import WavChunkLoader, write_wav
from digital_signal_processsing_tpu_torch.ops import moving_average
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_ref, moving_average_ref
from digital_signal_processsing_tpu_torch.serve import stream_moving_average
from digital_signal_processsing_tpu_torch.utils import last_choice

MAIN_SAMPLES = 64 * 2**20  # bench.py's headline stream: 64M stereo int16 samples
MAIN_WINDOW = 1024
TWO_PASS_WINDOW, TWO_PASS_CHANNELS = 65535, 16
SOURCE = "digital_signal_processsing_tpu_torch/csrc/"
REPLACES = "digital_signal_processsing_tpu/ops/pallas_scan.py:"


class Checker:
    """Bit-exact comparisons on the card, keeping the largest error per kernel."""

    def __init__(self) -> None:
        self.max_err = {"B1": 0, "B2": 0, "B4": 0}
        self.count = {"B1": 0, "B2": 0, "B4": 0}

    def same(self, kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{what}: got {got.dtype}{tuple(got.shape)}, want {want.dtype}{tuple(want.shape)}"
            )
        err = 0
        if got.numel():
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        self.max_err[kernel] = max(self.max_err[kernel], err)
        self.count[kernel] += 1
        if err != 0:
            raise AssertionError(f"{what}: max abs error {err}, want 0 (bit-exact)")


def time_pair(kernel_fn, plain_fn, warmup: int = 5, reps: int = 10) -> tuple[float, float]:
    """Median device ms of each, timed in turns plain, kernel, kernel, plain.

    A turn queues its calls back to back, warm-ups first, with an event
    after each, so an interval is the card's time for one call and not the
    host's time to issue it.
    """

    def run(fn) -> list[float]:
        for _ in range(warmup):
            fn()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        events[0].record()
        for ev in events[1:]:
            fn()
            ev.record()
        events[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(events, events[1:])]

    plain = run(plain_fn)
    kernel = run(kernel_fn) + run(kernel_fn)
    plain += run(plain_fn)
    return statistics.median(kernel), statistics.median(plain)


def phase_corners(rng, dev, check: Checker) -> None:
    def stream(frames: int, channels: int) -> torch.Tensor:
        n = frames * channels
        return torch.from_numpy(rng.integers(-32768, 32768, size=n, dtype=np.int16)).to(dev)

    def averagers(x: torch.Tensor, k: int, c: int, label: str) -> None:
        want = moving_average_ref(x, k, c)
        if ps.windowed_supported(k, c):
            check.same("B1", ps.windowed_averager(x, k, c), want, f"B1 {label}")
        else:
            check.same("B4", ps.moving_average_two_pass(x, k, c), want, f"two-pass {label}")
        xp = x if x.numel() % 2 == 0 else x[: x.numel() - c]  # whole frames, whole words
        if xp.numel() and ps.packed_supported(k, c):
            got = ps.windowed_averager_packed(xp.view(torch.int32), k, c).view(torch.int16)
            check.same("B2", got, moving_average_ref(xp, k, c), f"B2 {label}")

    for c in (1, 2, 3, 16):
        for frames in (1, 127, 129, 2**20 + c):
            x = stream(frames, c)
            check.same("B4", ps.cumsum(x, c), cumsum_ref(x, c), f"cumsum C={c} frames={frames}")
            for k in (1, 16, 1024, 65535):
                averagers(x, k, c, f"k={k} C={c} frames={frames}")
    for k, c in ((65535, 1), (1024, 16), (16, 3), (1, 2)):
        x = torch.full(((2**17 + 1) * c,), -32768, dtype=torch.int16, device=dev)
        averagers(x, k, c, f"INT16_MIN k={k} C={c}")
        check.same("B4", ps.cumsum(x, c), cumsum_ref(x, c), f"cumsum INT16_MIN C={c}")
    for k, c, frames in ((1024, 2, 129), (1024, 2, 2**20 + 2), (1024, 16, 4099), (7, 3, 1)):
        x, seed = stream(frames, c), stream(k, c)
        want = moving_average_ref(torch.cat([seed, x]), k, c)[k * c :]
        check.same("B1", ps.windowed_averager(x, k, c, seed=seed), want, f"B1 seeded k={k} C={c}")
    x = torch.full((2**21,), 32767, dtype=torch.int16, device=dev)  # sum reaches 2^36: wraps
    got = ps.cumsum(x, 1)
    check.same("B4", got, cumsum_ref(x, 1), "cumsum int32 wrap")
    wrapped = (np.arange(1, 2**21 + 1, dtype=np.int64) * 32767).astype(np.int32)  # mod 2^32
    if not np.array_equal(got.cpu().numpy(), wrapped):
        raise AssertionError("cumsum int32 wrap disagrees with NumPy's modular sum")
    x = stream(2**20 + 2, 2)
    got = ps.windowed_averager(x, 1024, 2)[: 1 << 18].cpu().numpy()
    want = moving_average_golden(x[: 1 << 18].cpu().numpy(), 1024, 2)
    if not np.array_equal(got, want):
        raise AssertionError("B1 disagrees with the NumPy golden model")
    print(
        "[3 corners] bit-exact: "
        + ", ".join(f"{k} {n} checks" for k, n in check.count.items())
        + "; B1 against golden on 262144 samples"
    )


def phase_halo_bound(x: torch.Tensor, check: Checker) -> None:
    """B1 against the two-pass route on both sides of the windowed route's bound, at 64M."""
    print(
        "[5 halo bound] B1 vs two-pass, 64M samples; `windowed` takes B1 while its buffer "
        f"is <= {ps.WINDOWED_SMEM_MAX} bytes (two blocks an SM):"
    )
    for c, ks in (
        (2, (4096, 8192, 8193, 10118, 10119, 16384, 24000)),
        (16, (512, 1024, 1025, 1070, 1071, 2048, 2800)),
    ):
        for k in ks:
            check.same(
                "B1", ps.launch_windowed(x, k, c), moving_average_ref(x, k, c),
                f"B1 halo {k * c} k={k} C={c}",
            )
            b1, two = time_pair(
                lambda: ps.launch_windowed(x, k, c),
                lambda: ps.moving_average_two_pass(x, k, c),
            )
            side = "inside" if ps.windowed_supported(k, c) else "beyond"
            print(
                f"  k={k} C={c} halo {k * c} ({side}): B1 {b1:.4f} ms, two-pass {two:.4f} ms, "
                f"B1/two-pass {b1 / two:.3f}"
            )


def phase_serve_profile(wav: np.ndarray, split: int) -> None:
    """Wall time of the serving loop over phase 4's two WAVs, and where its device time goes."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / "a.wav", Path(tmp) / "b.wav"]
        write_wav(paths[0], wav[:split], 48000, 2)
        write_wav(paths[1], wav[split:], 48000, 2)

        def serve() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream_moving_average(
                paths, Path(tmp) / "out.wav", MAIN_WINDOW, chunk_samples=1 << 20, device="cuda"
            )
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        chunks = sum(1 for _ in WavChunkLoader(paths, 1 << 20))
        decode_ms = (time.perf_counter() - t0) * 1e3
        walls = [serve() for _ in range(3)]
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            profiled_ms = serve()
    rows = sorted(  # device-side events only: the host ops that launch them repeat their time
        ((e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation),
        key=lambda r: -r[2],
    )
    device_ms = sum(r[2] for r in rows)
    print(
        f"[6 serve] {wav.size} samples in {chunks} chunks of 2^20, k={MAIN_WINDOW}: wall "
        + ", ".join(f"{w:.1f}" for w in walls)
        + f" ms; decode alone {decode_ms:.1f} ms"
    )
    if not rows:
        print("  profiler saw no device time: device split not measured")
        return
    print(
        f"  profiled: wall {profiled_ms:.1f} ms, device {device_ms:.3f} ms, "
        f"device idle {1 - device_ms / profiled_ms:.3f} of the wall time"
    )
    for key, count, ms in rows:
        print(f"  {ms:9.3f} ms  {count:4d} x  {key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(
        f"[1 device] {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}"
    )
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines() if "Used" in ln]
    print(f"[2 build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for ln in ptxas:
        print(f"  {ln}")

    # 3. corners
    check = Checker()
    phase_corners(rng, dev, check)

    # 4. main path
    x = torch.from_numpy(rng.integers(-32768, 32768, size=MAIN_SAMPLES, dtype=np.int16)).to(dev)
    x32 = x.view(torch.int32)
    frames_a, frames_b = 4 * 2**20, 4 * 2**20 - 1  # the second file has an odd frame count
    wav = rng.integers(-32768, 32768, size=2 * (frames_a + frames_b), dtype=np.int16)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_wav(tmp / "a.wav", wav[: 2 * frames_a], 48000, 2)
        write_wav(tmp / "b.wav", wav[2 * frames_a :], 48000, 2)
        write_wav(tmp / "ab.wav", wav, 48000, 2)
        torch.cuda.synchronize()

        ps.reset_launch_counts()
        y_main = moving_average(x, MAIN_WINDOW, 2)
        route_main = last_choice("moving_average")
        y_two = moving_average(x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS)
        route_two = last_choice("moving_average")
        y_packed = moving_average(x32, MAIN_WINDOW, 2)
        route_packed = last_choice("moving_average")
        written = stream_moving_average(
            [tmp / "a.wav", tmp / "b.wav"], tmp / "served.wav", MAIN_WINDOW,
            chunk_samples=1 << 20, device="cuda",
        )
        if cli_main([str(tmp / "ab.wav"), str(MAIN_WINDOW), "--out", str(tmp / "cli.wav")]) != 0:
            raise AssertionError("CLI exited non-zero")
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ps.KERNEL_WRAPPERS}

        print(f"[4 main path] routes {route_main!r}, {route_two!r}, {route_packed!r}; launches {launches}")
        want_routes = ["windowed", "windowed:two_pass_fallback", "windowed_packed"]
        if [route_main, route_two, route_packed] != want_routes:
            raise AssertionError(f"routes {route_main}, {route_two}, {route_packed}; want {want_routes}")
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the main path was never launched: {launches}")
        check.same("B1", y_main, moving_average_ref(x, MAIN_WINDOW, 2), "main 64M k=1024 C=2")
        check.same(
            "B4", y_two, moving_average_ref(x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS),
            "two-pass 64M k=65535 C=16",
        )
        check.same("B2", y_packed.view(torch.int16), y_main, "packed 64M k=1024 C=2")

        one_shot = moving_average(torch.from_numpy(wav).to(dev), MAIN_WINDOW, 2).cpu().numpy()
        write_wav(tmp / "one_shot.wav", one_shot, 48000, 2)
        expected = (tmp / "one_shot.wav").read_bytes()
        if written != wav.size or (tmp / "served.wav").read_bytes() != expected:
            raise AssertionError(f"served WAV differs from the one-shot result ({written} samples)")
        if (tmp / "cli.wav").read_bytes() != expected:
            raise AssertionError("CLI WAV differs from the one-shot result")
        print(
            f"[4 main path] bit-exact: 64M k=1024 C=2, 64M k=65535 C=16 (two-pass), packed 64M; "
            f"served {written} samples and the CLI WAV byte-identical to one shot"
        )

    # 5. times
    n = MAIN_SAMPLES
    copy_dst = torch.empty_like(x)
    copy_ms, _ = time_pair(lambda: copy_dst.copy_(x), lambda: copy_dst.copy_(x))
    b1_ms, b1_plain = time_pair(
        lambda: ps.windowed_averager(x, MAIN_WINDOW, 2),
        lambda: moving_average_ref(x, MAIN_WINDOW, 2),
    )
    b2_ms, b2_plain = time_pair(
        lambda: ps.windowed_averager_packed(x32, MAIN_WINDOW, 2),
        lambda: moving_average_ref(x32.view(torch.int16), MAIN_WINDOW, 2).view(torch.int32),
    )
    b4_ms, b4_plain = time_pair(
        lambda: ps.cumsum(x, TWO_PASS_CHANNELS), lambda: cumsum_ref(x, TWO_PASS_CHANNELS)
    )
    tp_ms, tp_plain = time_pair(
        lambda: ps.moving_average_two_pass(x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS),
        lambda: moving_average_ref(x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS),
    )

    def gss(ms: float) -> str:
        return f"{ms:.4f} ms = {n / ms / 1e6:.2f} GS/s"

    print(f"[5 times] on {smi}, 64M int16 samples, median of 10 after 5 warm-ups:")
    print(f"  copy d2d (same bytes)         {gss(copy_ms)}")
    print(f"  B1 windowed k=1024 C=2        {gss(b1_ms)}; plain {gss(b1_plain)}")
    print(f"  B2 packed k=1024 C=2          {gss(b2_ms)}; plain {gss(b2_plain)}")
    print(f"  B4 cumsum C=16                {gss(b4_ms)}; plain {gss(b4_plain)}")
    print(f"  two-pass k=65535 C=16         {gss(tp_ms)}; plain {gss(tp_plain)}")
    phase_halo_bound(x, check)

    # 6. serving loop
    phase_serve_profile(wav, 2 * frames_a)

    record = {
        "kernels": [
            {
                "name": "windowed_averager", "route": "cuda", "source": SOURCE + "windowed.cu",
                "replaces": REPLACES + "492", "launches": launches["windowed_averager"],
                "max_abs_err": check.max_err["B1"], "ms": b1_ms, "plain_ms": b1_plain,
            },
            {
                "name": "windowed_averager_packed", "route": "cuda",
                "source": SOURCE + "windowed.cu", "replaces": REPLACES + "530",
                "launches": launches["windowed_averager_packed"],
                "max_abs_err": check.max_err["B2"], "ms": b2_ms, "plain_ms": b2_plain,
            },
            {
                "name": "cumsum", "route": "cuda", "source": SOURCE + "cumsum.cu",
                "replaces": REPLACES + "971", "launches": launches["cumsum"],
                "max_abs_err": check.max_err["B4"], "ms": b4_ms, "plain_ms": b4_plain,
            },
        ]
    }
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
