"""Design filters, run them, and inspect the spectrum: the basic toolbox.

Counterpart of ``examples/filter_and_analyze.py`` (it prints and has no anchor):

    python -m digital_signal_processsing_tpu_torch.examples.filter_and_analyze [--device cpu]
"""

import sys

import numpy as np
import torch

from digital_signal_processsing_tpu_torch.examples import device_of, parser
from digital_signal_processsing_tpu_torch.ops import fft, fir, iir
from digital_signal_processsing_tpu_torch.ops.gain import dc_block


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    rng = np.random.default_rng(0)
    fs = 48_000.0
    t = np.arange(1 << 15)
    # 1 kHz tone + 9 kHz interferer + DC offset + noise
    x = (
        np.sin(2 * np.pi * 1000 / fs * t)
        + 0.5 * np.sin(2 * np.pi * 9000 / fs * t)
        + 0.3
        + 0.05 * rng.normal(size=t.size)
    ).astype(np.float32)

    x = dc_block(torch.from_numpy(x).to(dev))

    # FIR bandpass around the 1 kHz tone (Nyquist units: 1 kHz / 24 kHz)
    h = fir.design_bandpass(257, 0.03, 0.06)
    y_fir = fir.fir_filter(x, h)

    # 4th-order Butterworth lowpass below the interferer
    sos = iir.design_butterworth(4, 0.2)
    y_iir = iir.sosfilt(sos, x)

    for name, sig in [("input", x), ("fir bandpass", y_fir), ("butterworth", y_iir)]:
        psd = fft.welch(sig, nfft=1024, fs=fs).cpu().numpy()
        freqs = np.fft.rfftfreq(1024, 1 / fs)
        k1, k9 = np.argmin(np.abs(freqs - 1000)), np.argmin(np.abs(freqs - 9000))
        print(
            f"{name:14s}: P(1kHz)={10*np.log10(psd[k1]):7.1f} dB  "
            f"P(9kHz)={10*np.log10(psd[k9] + 1e-30):7.1f} dB"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
