"""Pulse-Doppler radar with a multi-target tracker over the CPI stream.

Counterpart of ``examples/radar_tracker.py``: 12 coherent processing
intervals with two targets whose ranges cross mid-stream go through the
detection chain (``models.radar``, batched over the stream) into the
batched-Kalman tracker (``models.tracking``: gated greedy association,
rank-matched spawning, M-of-N management). Prints the confirmed tracks and
checks that identities survived the crossing:

    python -m digital_signal_processsing_tpu_torch.examples.radar_tracker [--device cpu]
"""

import sys

import numpy as np

from digital_signal_processsing_tpu_torch.examples import Anchors, device_of, parser
from digital_signal_processsing_tpu_torch.models import (
    RadarConfig,
    TrackerConfig,
    radar,
    tracking,
)


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    anchors = Anchors()
    rcfg = RadarConfig(
        n_pulses=32,
        n_range=512,
        pulse_len=64,
        guard=(1, 2),
        train=(3, 6),
        pfa=1e-5,
    )
    # vel_scale=16 bins/CPI per cycle/PRI: doppler 0.125 -> +2 bins/CPI.
    tcfg = TrackerConfig(
        max_tracks=8,
        max_meas=8,
        vel_scale=16.0,
        sigma_r=0.7,
        sigma_v=0.3,
        gate=13.8,
        confirm_hits=3,
    )
    n_cpis = 12
    # Two targets crossing in range near CPI 6: (start, vel bins/CPI).
    truth = [(80.0, 2.0, 0.125, 1.0), (104.0, -2.0, -0.125, 0.8)]
    i = np.zeros((n_cpis, rcfg.n_pulses, rcfg.n_range), np.float32)
    q = np.zeros_like(i)
    for k in range(n_cpis):
        tgts = [(int(round(r0 + v * k)), fd, amp) for r0, v, fd, amp in truth]
        i[k], q[k] = radar.synthesize(rcfg, tgts, noise_power=0.05, seed=k)

    _state, hist = tracking.track_detections(rcfg, tcfg, i, q, device=dev)
    hist = {key: val.cpu().numpy() for key, val in hist.items()}
    confirmed = hist["confirmed"]
    xs = hist["x"]
    tids = hist["tid"]

    print(f"{n_cpis} CPIs of {rcfg.n_pulses}x{rcfg.n_range}; "
          f"confirmed per CPI: {confirmed.sum(axis=1).tolist()}")
    slots = np.flatnonzero(confirmed[-1])
    anchors.check(slots.size == len(truth), f"confirmed tracks {slots.tolist()}")
    k_last = n_cpis - 1
    matched = set()
    for s in slots:
        r_est, v_est = xs[-1, s]
        err, j = min(
            (abs(r_est - (r0 + v * k_last)) + abs(v_est - v), j)
            for j, (r0, v, _, _) in enumerate(truth)
        )
        r0, v, _, amp = truth[j]
        matched.add(j)
        ok = err < 1.5
        ids = tids[:, s][hist["active"][:, s]]
        stable = bool((ids == ids[-1]).all())
        print(f"  track id={tids[-1, s]}: r={r_est:7.2f} v={v_est:+5.2f} "
              f"vs truth r={r0 + v * k_last:5.1f} v={v:+.1f} "
              f"({'OK' if ok and stable else 'MISS'}, id "
              f"{'stable' if stable else 'SWAPPED'})")
        anchors.check(ok and stable, f"track id={tids[-1, s]}")
    anchors.check(matched == set(range(len(truth))), "every target tracked")
    if not anchors.missed:
        print("both identities held through the range crossing")
    return anchors.exit_code()


if __name__ == "__main__":
    sys.exit(main())
