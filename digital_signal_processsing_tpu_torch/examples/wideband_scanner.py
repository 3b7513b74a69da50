"""Scan a wideband capture: PFB channelize, demodulate everything at once.

Counterpart of ``examples/wideband_scanner.py`` (it prints and has no anchor):

    python -m digital_signal_processsing_tpu_torch.examples.wideband_scanner [--device cpu]
"""

import sys

import numpy as np
import torch

from digital_signal_processsing_tpu_torch.examples import device_of, parser
from digital_signal_processsing_tpu_torch.models import WidebandConfig, WidebandFmReceiver


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    n = 32  # channels across the captured band
    rx = WidebandFmReceiver(WidebandConfig(n_channels=n, audio_taps=33, squelch=0.2), device=dev)

    # synthesize a band with two active FM stations (channels 5 and 19)
    t = n * 4096
    idx = np.arange(t)
    x = 0.01 * np.random.default_rng(0).normal(size=t)
    for k, f_msg in [(5, 0.002), (19, 0.0035)]:
        msg = np.sin(2 * np.pi * f_msg * idx)
        x += np.cos(2 * np.pi * (k / n) * idx + 0.1 / n * 2 * np.pi * np.cumsum(msg))
    x = x.astype(np.float32)

    audio = rx(torch.from_numpy(x).to(dev)).cpu().numpy()
    power = np.mean(audio[:, 256:] ** 2, axis=1)
    live = np.nonzero(power > 1e-9)[0]
    print(f"wideband: {t} samples -> {audio.shape} audio; live channels: {live}")
    for k in live:
        a = audio[k, 256:] - audio[k, 256:].mean()
        spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
        print(f"  channel {k:2d}: strongest audio bin {int(np.argmax(spec))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
