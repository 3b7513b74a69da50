"""Control-loop design on the LTI surface: model, place poles, simulate.

Counterpart of ``examples/control_design.py``: a mass-spring-damper is
stabilised by full-state feedback, the continuous loop validated with
lsim/step, then the controller discretised and re-validated as the digital
loop a DSP deployment would ship (the simulations run S3 on the card):

    python -m digital_signal_processsing_tpu_torch.examples.control_design [--device cpu]
"""

import sys

import numpy as np

from digital_signal_processsing_tpu_torch.examples import Anchors, device_of, parser
from digital_signal_processsing_tpu_torch.ops import lti


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    anchors = Anchors()
    # plant: x'' = -0.2 x' - x + u  (lightly damped oscillator)
    A = np.array([[0.0, 1.0], [-1.0, -0.2]])
    B = np.array([[0.0], [1.0]])
    C = np.array([[1.0, 0.0]])
    D = np.array([[0.0]])

    # open loop rings for a long time
    T = np.linspace(0, 30, 1501)
    _, y_open = lti.step((A, B, C, D), T=T, device=dev)
    settle_open = T[np.nonzero(np.abs(np.asarray(y_open) - 1.0) > 0.05)[0][-1]]

    # place closed-loop poles at -2 +- 1j: fast, damped
    res = lti.place_poles(A, B, np.array([-2.0 + 1j, -2.0 - 1j]))
    K = res.gain_matrix
    Acl = A - B @ K
    print(f"gain K = {K.ravel()}, placed poles {np.round(res.computed_poles, 3)}")

    # closed loop with reference scaling for unit DC gain
    dc = float((C @ np.linalg.solve(-Acl, B))[0, 0])
    Bcl = B / dc
    _, y_closed = lti.step((Acl, Bcl, C, D), T=T, device=dev)
    y_closed = np.asarray(y_closed)
    settle_closed = T[np.nonzero(np.abs(y_closed - 1.0) > 0.05)[0][-1]]
    print(f"5% settling: open {settle_open:.1f}s -> closed {settle_closed:.1f}s")
    anchors.check(settle_closed < 0.2 * settle_open, "closed-loop settling")
    anchors.check(abs(y_closed[-1] - 1.0) < 0.01, "closed-loop final value")

    # ship it digital: discretize at 20 Hz and verify the digital loop
    Ad, Bd, Cd, Dd, dt = lti.cont2discrete((Acl, Bcl, C, D), 0.05, "zoh")
    _, yd = lti.dstep((Ad, Bd, Cd, Dd, dt), 600, device=dev)
    yd = yd.cpu().numpy()[:, 0]
    cont = np.interp(np.arange(600) * dt, T, y_closed)
    print(f"digital-vs-continuous step max dev: {np.max(np.abs(yd - cont)):.4f}")
    anchors.check(np.max(np.abs(yd - cont)) < 0.01, "digital loop against the continuous")

    # disturbance rejection with lsim
    U = np.zeros_like(T)
    U[500:520] = 5.0  # impulse-ish kick
    _, y_dist, _ = lti.lsim((Acl, Bcl, C, D), U, T, device=dev)
    y_dist = np.asarray(y_dist)
    print(f"kick recovered to <0.05 in {T[np.nonzero(np.abs(y_dist) > 0.05)[0][-1]] - 10:.1f}s")
    anchors.check(np.all(np.abs(y_dist[int(1500 * 14 / 30):]) < 0.05), "kick recovered")

    if not anchors.missed:
        print("control design OK")
    return anchors.exit_code()


if __name__ == "__main__":
    sys.exit(main())
