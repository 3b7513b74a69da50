"""Direction finding on a ULA: Bartlett against MVDR against MUSIC.

Counterpart of ``examples/doa_scanner.py`` (it prints and has no anchor):
snapshots from an 8-element half-wavelength array with three sources (two 8
degrees apart, inside the conventional beamwidth) through all three spatial
spectra of ``models.beamform``, then two fully coherent sources, where
forward-backward averaging restores MUSIC:

    python -m digital_signal_processsing_tpu_torch.examples.doa_scanner [--device cpu]
"""

import sys

import numpy as np

from digital_signal_processsing_tpu_torch.examples import device_of, parser
from digital_signal_processsing_tpu_torch.models import ArrayConfig, beamform


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    cfg = ArrayConfig(n_sensors=8, spacing=0.5, n_grid=721)
    truth = np.array([-40.0, 12.0, 20.0])  # last two inside one beamwidth
    xi, xq = beamform.synthesize(cfg, truth, n_snapshots=512, snr_db=10.0, seed=3)

    print(f"ULA: {cfg.n_sensors} elements @ {cfg.spacing} wavelengths, "
          f"512 snapshots, 10 dB SNR")
    print(f"truth bearings: {truth}")
    for method in ("bartlett", "mvdr", "music"):
        est = beamform.estimate_doa(cfg, xi, xq, n_sources=3, method=method, device=dev)
        err = np.abs(est - truth).max()
        print(f"  {method:9s} -> {np.round(est, 2)}   (max error {err:.2f} deg)")

    # coherent multipath: the same waveform from two bearings collapses the
    # signal subspace to rank 1; persymmetric forward-backward averaging
    # restores the second dimension at zero extra snapshot cost
    truth2 = np.array([-30.0, 25.0])
    ci, cq = beamform.synthesize(cfg, truth2, n_snapshots=512, snr_db=20.0, seed=4, coherent=True)
    plain = beamform.estimate_doa(cfg, ci, cq, n_sources=2, method="music", device=dev)
    fb = beamform.estimate_doa(cfg, ci, cq, n_sources=2, method="music", forward_backward=True,
                               device=dev)
    print(f"coherent pair at {truth2}:")
    print(f"  music (plain)            -> {np.round(plain, 2)}")
    print(f"  music (forward-backward) -> {np.round(fb, 2)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
