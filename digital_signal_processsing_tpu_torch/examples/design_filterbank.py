"""Design a near-perfect-reconstruction filter bank by gradient descent.

Counterpart of ``examples/design_filterbank.py``: the 2x-oversampled PFB's
reconstruction error is a differentiable PyTorch function of its prototype,
so Adam optimises the filter through the bank itself (B20 forward and its
taps' gradient on the card):

    python -m digital_signal_processsing_tpu_torch.examples.design_filterbank [--device cpu]
"""

import sys

import numpy as np
import torch

from digital_signal_processsing_tpu_torch.examples import Anchors, device_of, parser
from digital_signal_processsing_tpu_torch.ops.fir import design_lowpass
from digital_signal_processsing_tpu_torch.ops.pfb_os import (
    design_pr_prototype,
    pfb_analyze_os,
    pfb_synthesize_os,
)


def roundtrip_snr(h, n, rng, dev):
    d = n // 2
    k = np.asarray(h).size
    x = rng.normal(size=d * 4096).astype(np.float32)
    taps = torch.from_numpy(np.asarray(h, np.float32)).to(dev)
    yi, yq = pfb_analyze_os(torch.from_numpy(x).to(dev), n, taps)
    rec = pfb_synthesize_os(yi, yq, n, taps * d).cpu().numpy()
    a = rec[k:]
    b = x[: a.size]
    g = 2 * k
    err = a[g:-g] - b[g:-g]
    return 10 * np.log10(np.sum(b[g:-g] ** 2) / np.sum(err**2))


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    anchors = Anchors()
    n, p = 8, 8
    rng = np.random.default_rng(0)

    h_sinc = design_lowpass(p * n, 1.0 / n)
    snr_sinc = roundtrip_snr(h_sinc, n, rng, dev)
    print(f"windowed-sinc prototype : full-band round trip {snr_sinc:5.1f} dB")

    h_opt = design_pr_prototype(n, p, steps=400, device=dev)
    snr_opt = roundtrip_snr(h_opt, n, rng, dev)
    print(f"gradient-designed        : full-band round trip {snr_opt:5.1f} dB")
    anchors.check(snr_opt > 40, "designer failed to converge")
    return anchors.exit_code()


if __name__ == "__main__":
    sys.exit(main())
