"""Feature tour: design -> filter -> resample -> envelope, with the routes taken.

Counterpart of ``examples/production_pipeline.py``:

- true-minimax FIR design (``design_remez``) through the auto crossover;
- the IIR cascade's auto dispatch (B12 on the card at production sizes);
- arbitrary-rate Farrow resampling (44.1 kHz from a 48 kHz stream);
- the Hilbert envelope;
- dispatch observability (which route did ``auto`` pick?).

The reference checks its route name ``pallas``/``pallas_fused``; the port
checks its own (``pallas_fused`` is B12, ``pallas`` B15), and on the card
that the hand kernel of that route launched. Sizes are the reference's
(trimmed for the CPU; 64M on a card):

    python -m digital_signal_processsing_tpu_torch.examples.production_pipeline [--device cpu]
"""

import sys

import numpy as np
import torch

from digital_signal_processsing_tpu_torch.examples import Anchors, device_of, parser
from digital_signal_processsing_tpu_torch.ops import fir, iir, launch_counts
from digital_signal_processsing_tpu_torch.ops.farrow import farrow_output_len, resample_farrow
from digital_signal_processsing_tpu_torch.ops.fft import envelope
from digital_signal_processsing_tpu_torch.utils.dispatch import choices

T = 1 << 17  # trimmed for the CPU; 64M on a card
SOSFILT_KERNELS = {"pallas_fused": "B12", "pallas": "B15"}


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    anchors = Anchors()
    rng = np.random.default_rng(0)
    t = np.arange(T)
    x_np = (
        np.sin(2 * np.pi * 0.01 * t)
        + 0.3 * np.sin(2 * np.pi * 0.23 * t)
        + 0.05 * rng.normal(size=T)
    ).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)

    # 1. equiripple channel filter, applied through the auto crossover
    h = fir.design_remez(201, [0, 0.05, 0.09, 1.0], [1, 0])
    y = fir.fir_filter(x, h)
    y_np = y.cpu().numpy()
    hf_in = np.abs(np.diff(x_np)).mean()
    hf_out = np.abs(np.diff(y_np)).mean()
    ok = hf_out < 0.3 * hf_in  # the passband tone keeps its own (small) slope
    print(f"remez lowpass: HF {hf_in:.4f} -> {hf_out:.4f} ({'PASS' if ok else 'MISS'})")
    anchors.check(ok, "remez lowpass")

    # 2. IIR cascade at production length: auto -> B12
    sos = iir.design_butterworth(4, 0.1)
    before = launch_counts()
    iir.sosfilt(sos, x)
    route = choices().get("sosfilt")
    kernel = SOSFILT_KERNELS.get(route)
    ok = kernel is not None
    if ok and dev.type == "cuda":
        torch.cuda.synchronize()
        ok = launch_counts()[kernel] > before[kernel]
    print(f"sosfilt dispatched: {route} ({'PASS' if ok else 'MISS'})")
    anchors.check(ok, "sosfilt's route")

    # 3. lock the stream to 44.1 kHz from 48 kHz (non-integer ratio)
    rate = (147, 160)
    y44 = resample_farrow(y, rate)
    want_len = farrow_output_len(T, rate)
    ok = y44.shape[0] == want_len
    print(f"farrow 48k->44.1k: {y44.shape[0]} samples ({'PASS' if ok else 'MISS'}), "
          f"method={choices().get('resample_farrow')}")
    anchors.check(ok, "farrow output length")

    # 4. envelope of the filtered narrowband signal
    env = envelope(y).cpu().numpy()
    mid = env[5000:-5000]
    ok = abs(float(np.median(mid)) - 1.0) < 0.1
    print(f"hilbert envelope median {np.median(mid):.3f} ({'PASS' if ok else 'MISS'})")
    anchors.check(ok, "hilbert envelope")

    print("dispatch table:", choices())
    print("done")
    return anchors.exit_code()


if __name__ == "__main__":
    sys.exit(main())
