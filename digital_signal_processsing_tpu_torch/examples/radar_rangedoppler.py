"""Pulse-Doppler radar: compress a CPI, map range-Doppler, CFAR-detect.

Counterpart of ``examples/radar_rangedoppler.py``: a coherent processing
interval with three moving targets in noise through the full ``models.radar``
chain (matched filter, slow-time Doppler DFT, exact-edge CA-CFAR), printing
where the detector fired against the truth:

    python -m digital_signal_processsing_tpu_torch.examples.radar_rangedoppler [--device cpu]
"""

import sys

import numpy as np

from digital_signal_processsing_tpu_torch.examples import Anchors, device_of, parser
from digital_signal_processsing_tpu_torch.models import RadarConfig, radar


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    anchors = Anchors()
    cfg = RadarConfig(
        n_pulses=64,
        n_range=4096,
        pulse_len=256,
        guard=(2, 3),
        train=(4, 10),
        pfa=1e-6,
    )
    # (range bin, doppler in cycles/PRI, amplitude)
    targets = [(500, 0.20, 1.0), (1800, -0.31, 0.5), (3000, 0.05, 0.25)]
    i, q = radar.synthesize(cfg, targets, noise_power=0.05, seed=42)

    det, power, _thresh = radar.detect(cfg, i, q, device=dev)
    det = det.cpu().numpy()
    power = power.cpu().numpy()

    print(f"CPI {cfg.n_pulses}x{cfg.n_range} -> map {power.shape}, "
          f"{int(det.sum())} detection cells")
    for rbin, fd, amp in targets:
        row = cfg.n_pulses // 2 + round(fd * cfg.n_pulses)
        ok = bool(det[row, rbin])
        snr = 10 * np.log10(power[row, rbin] / np.median(power))
        print(f"  truth r={rbin:4d} fd={fd:+.2f} amp={amp:.2f}: "
              f"{'DETECTED' if ok else 'MISS'} (cell SNR {snr:.1f} dB)")
        anchors.check(ok, f"target at r={rbin}")

    # detections cluster around the truth cells
    rows, cols = np.nonzero(det)
    if rows.size:
        print(f"  detection extent: doppler rows {rows.min()}..{rows.max()}, "
              f"range bins {cols.min()}..{cols.max()}")
    return anchors.exit_code()


if __name__ == "__main__":
    sys.exit(main())
