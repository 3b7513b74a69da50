#!/usr/bin/env python3
"""The end-to-end paths of two trees of the port, in turns on one card.

    python3 tools/ab_end_to_end.py OTHER_ROOT

Times, for this checkout and for the checkout at OTHER_ROOT (for example the
parent commit, unpacked with ``git archive`` into a git-ignored directory),
the paths whose speed a change to a kernel could move: the flagship receiver
chain (``DspChain.forward_planar`` on 16 x 2^22 float32 I/Q), the wideband
receiver (64 channels, 2^26 samples), the averager's main path
(``moving_average`` on 64M int16 samples at k=1024, C=2, the B1 route), the
``scan*`` methods on the same stream (B3), ``fir_filter`` at 8194 taps on
16 x 2^22 (B9), the averager's serving loop (``stream_moving_average`` over
two stereo WAVs of 4M frames in chunks of 2^20 samples, B1 seeded a chunk)
the IIR main path (``sosfilt`` on 16 x 2^22 float32 through
butter(8, 0.1), B12, and with ``unroll_sections=True``, B13), the
averager's two-pass route (the 64M stream as 16 channels at k=65535, B4)
and ``lpc_synthesis`` by ``refine`` on 128 streams x 512 frames x 256 at
p = 12 (the vocoder's shape, B22 x 3); each timed as
the median host wall time of 10 synchronised calls after 3 warm-ups (the
serving loop 5 after 1). Then the kernels alone, as the median device time
of 20 calls after 5 warm-ups, by CUDA events: B1 (``windowed_averager``) and
B3 (``scan_averager``, every variant) on the same stream at k=1024, C=2,
Blelloch and Hillis-Steele at C = 3, 5, 6 (the generic kernel), each checked
bit-exact against the plain version; B12, B13 and B15 at the IIR main path;
B4 at C = 16 and C = 1 on the 64M stream and B22 on the vocoder's 65536
frames (a full pass), each checked bit for bit against its plain version; and
B1's and B3's registers, local bytes, shared bytes and blocks an SM in
each tree. Each tree runs in its own process, which
builds its own kernels, in the order other, this, this, other. Then the
sharded averager in the ring of four processes on the card
(``sharded_moving_average`` with ``halo_impl`` ``pallas_ring``, B6's halo
into B1, and ``fused_ring``, B7; 16M samples a rank, k=1024, C=2), by
``tools/ab_ring.py``'s workers in the same order: each rank's device ms a
call, started together and queued back to back, and the slowest rank's host
ms. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CHILD = r'''
import json, statistics, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from digital_signal_processsing_tpu_torch import _build
from digital_signal_processsing_tpu_torch.models import ChainConfig, DspChain, WidebandConfig, WidebandFmReceiver
from digital_signal_processsing_tpu_torch.io import write_wav
from digital_signal_processsing_tpu_torch.ops import fir, iir, lpc, moving_average
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.serve import stream_moving_average
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_ref, moving_average_xla

_build.build()
_build.library()
rng = np.random.default_rng(0)
dev = torch.device("cuda")


def wall(fn, warmup=3, reps=10):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def device(fn):
    for _ in range(5):
        fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(21)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    ev[-1].synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in zip(ev, ev[1:]))


i = torch.from_numpy(rng.standard_normal((16, 1 << 22), dtype=np.float32)).to(dev)
q = torch.from_numpy(rng.standard_normal((16, 1 << 22), dtype=np.float32)).to(dev)
chain = DspChain(ChainConfig(channels=16, decimation=8), device=dev)
wide = WidebandFmReceiver(WidebandConfig(n_channels=64), device=dev)
xw = torch.from_numpy(rng.standard_normal(1 << 26, dtype=np.float32)).to(dev)
x = torch.from_numpy(rng.integers(-32768, 32768, size=64 * 2**20, dtype=np.int16)).to(dev)
h9 = (rng.standard_normal(8194) / np.sqrt(8193)).astype(np.float32)
sos = iir.design_butterworth(8, 0.1)
wav = rng.integers(-32768, 32768, size=2 * (2 * 4 * 2**20 - 1), dtype=np.int16)
tmp = Path(tempfile.mkdtemp())
paths = [tmp / "a.wav", tmp / "b.wav"]
write_wav(paths[0], wav[: 8 * 2**20], 48000, 2)
write_wav(paths[1], wav[8 * 2**20 :], 48000, 2)
voice = torch.from_numpy(rng.standard_normal((128, 512 * 256), dtype=np.float32)).to(dev)
voice = torch.cumsum(voice, 1) * 0.05  # a red spectrum: well-conditioned order-12 fits
a_lpc, gain = lpc.lpc(voice, 12, 256)
ev = torch.from_numpy(rng.standard_normal((128, 512 * 256), dtype=np.float32)).to(dev)
res = {
    "flagship chain": wall(lambda: chain.forward_planar(i, q)),
    "wideband receiver": wall(lambda: wide(xw)),
    "averager main path": wall(lambda: moving_average(x, 1024, 2)),
    **{f"moving_average {m}": wall(lambda m=m: moving_average(x, 1024, 2, method=m))
       for m in ("scan", "scan_hillis", "scan_mxu")},
    "fir_filter 8194 taps": wall(lambda: fir.fir_filter(i, h9)),
    "averager serving loop": wall(lambda: stream_moving_average(
        paths, tmp / "out.wav", 1024, chunk_samples=1 << 20, device="cuda"), 1, 5),
    "IIR main path (sosfilt)": wall(lambda: iir.sosfilt(sos, i)),
    "sosfilt unroll_sections": wall(lambda: iir.sosfilt_pallas_fused(sos, i, unroll_sections=True)),
    "averager two-pass route k=65535 C=16": wall(lambda: moving_average(x, 65535, 16)),
    "lpc_synthesis refine 128 x 512 x 256": wall(
        lambda: lpc.lpc_synthesis(a_lpc, gain, ev, 256, method="refine")),
}
want = moving_average_xla(x, 1024, 2)
if not torch.equal(ps.windowed_averager(x, 1024, 2), want):
    raise AssertionError("B1 differs from plain")
res["B1 k=1024 C=2 (device)"] = device(lambda: ps.windowed_averager(x, 1024, 2))
for c in (2, 3, 5, 6):
    xc = x[: x.numel() // c * c]
    want = moving_average_xla(xc, 1024, c)
    for v in ("blelloch", "hillis_steele", "mxu") if c == 2 else ("blelloch", "hillis_steele"):
        if not torch.equal(ps.scan_averager(xc, 1024, c, variant=v), want):
            raise AssertionError(f"B3 {v} C={c} differs from plain")
        res[f"B3 {v} k=1024 C={c} (device)"] = device(lambda: ps.scan_averager(xc, 1024, c, variant=v))
    del want
rows = iir._sos_rows(sos)
res["B12 (device)"] = device(lambda: iir.sos_cascade(i, rows))
res["B13 (device)"] = device(lambda: iir.sos_cascade_unrolled(i, rows))
res["B15 (device)"] = device(lambda: iir.sos_sections(i, rows))
for c in (16, 1):
    if not torch.equal(ps.cumsum(x, c), cumsum_ref(x, c)):
        raise AssertionError(f"B4 C={c} differs from plain")
    res[f"B4 C={c} (device)"] = device(lambda c=c: ps.cumsum(x, c))
a_f = a_lpc[..., 1:].reshape(-1, 12).contiguous()
e_f = ev.reshape(-1, 256).contiguous()
s0 = torch.zeros_like(a_f)
y, z = lpc.lpc_synth_pass(a_f, s0, e_f)
yp, zp = lpc._lpc_pass_plain(a_f, s0, e_f)
if not (torch.equal(y, yp) and torch.equal(z, zp)):
    raise AssertionError("B22 differs from plain")
res["B22 pass (device)"] = device(lambda: lpc.lpc_synth_pass(a_f, s0, e_f))
attrs = {"B1 k=1024 C=2": ps.windowed_kernel_attrs(1024, 2),
         **{f"B3 {v} k=1024 C={c}": ps.scan_kernel_attrs(1024, c, v)
            for c in (2, 3) for v in ("blelloch", "hillis_steele", "mxu") if c == 2 or v != "mxu"}}
print("ATTRS " + json.dumps(attrs))
print("RESULT " + json.dumps(res))
'''


def run(root: Path) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD, str(root)], capture_output=True, text=True,
                         cwd=root)
    for line in out.stdout.splitlines():
        if line.startswith("ATTRS "):
            run.attrs[root] = line[len("ATTRS "):]
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"{root}: no result\n{out.stdout[-2000:]}\n{out.stderr[-4000:]}")


run.attrs = {}  # root -> the span kernels' (registers, local bytes, shared bytes, blocks an SM)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}; this {ROOT}; other {other}")
    runs = [("other", run(other)), ("this", run(ROOT)), ("this", run(ROOT)), ("other", run(other))]
    print("ms (host wall, or device where marked), in turns other, this, this, other:")
    for path in runs[0][1]:
        got = {"other": [], "this": []}
        for who, res in runs:
            got[who].append(res[path])
        print(f"  {path:36s} other {' '.join(f'{v:.3f}' for v in got['other'])}; "
              f"this {' '.join(f'{v:.3f}' for v in got['this'])}; this/other "
              f"{statistics.mean(got['this']) / statistics.mean(got['other']):.3f}")
    for who, root in (("other", other), ("this", ROOT)):
        print(f"  {who}: B1's and B3's (registers, local bytes, shared bytes, blocks an SM) "
              f"{run.attrs.get(root)}")
    ring_runs(other)
    return 0


def ring_runs(other: Path) -> None:
    """The ring's sharded averager of both trees, in turns."""
    import tempfile

    import ab_ring

    got = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        for who in ("other", "this", "this", "other"):
            tree = other if who == "other" else ROOT
            got[who].append(ab_ring.ring_rows(ab_ring.run("e2e", tree, ab_ring.WORLD, Path(tmp),
                                                          Path(tmp) / "none")))
    print(f"the ring of {ab_ring.WORLD} on the card, 16M samples a rank, k=1024 C=2 (ms a call; "
          "device: the median over ranks; host: the slowest rank), in turns other, this, this, "
          "other:")
    for path in ("pallas_ring", "fused_ring"):
        for metric in ("device", "b2b device", "host", "b2b host"):
            o = [r[path][metric][0] for r in got["other"]]
            s = [r[path][metric][0] for r in got["this"]]
            print(f"  {path:12s} {metric:11s} other {' '.join(f'{v:.4f}' for v in o)}; this "
                  f"{' '.join(f'{v:.4f}' for v in s)}; this/other "
                  f"{statistics.mean(s) / statistics.mean(o):.3f}")


if __name__ == "__main__":
    sys.exit(main())
