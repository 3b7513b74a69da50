"""Single-carrier QAM link: transmit a burst, impair it, recover the bits.

Counterpart of ``examples/qam_link.py``: a 16-QAM burst goes through RRC
pulse shaping, then a channel with delay, carrier offset, static multipath
and noise; ``models.modem``'s batched receiver (matched filter on B8 on the
card, Oerder-Meyr timing, 4th-power and phase-slope CFO, preamble sync,
ridge-LS equaliser, decision-directed phase tracking) recovers the payload:

    python -m digital_signal_processsing_tpu_torch.examples.qam_link [--device cpu]
"""

import sys

import numpy as np

from digital_signal_processsing_tpu_torch.examples import Anchors, device_of, parser
from digital_signal_processsing_tpu_torch.models import ModemConfig, modem


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    anchors = Anchors()
    cfg = ModemConfig(bits_per_symbol=4, sps=8, eq_taps=11)
    rng = np.random.default_rng(7)
    n_payload = 512  # symbols
    bits = rng.integers(0, 2, size=n_payload * cfg.bits_per_symbol)

    i, q = modem.transmit(cfg, bits, device=dev)
    ri, rq = modem.channel(
        i,
        q,
        delay=37,
        cfo=2.3e-4,
        phase=0.8,
        taps=[1.0, 0.0, 0.0, 0.18 - 0.12j],
        symbol_snr_db=24.0,
        seed=3,
    )

    got, diag = modem.receive(cfg, ri, rq, n_payload, device=dev)
    got = got.cpu().numpy()
    ber = float(np.mean(got != bits))
    cfo_sym = float(diag["cfo_coarse"]) + float(diag["cfo_fine_per_symbol"])
    print(
        f"16-QAM x{n_payload} symbols through delay+CFO+multipath+noise: "
        f"BER {ber:.4f} ({int((got != bits).sum())}/{bits.size} bits)"
    )
    print(
        f"  CFO estimate {cfo_sym / cfg.sps:.2e} cycles/sample "
        f"(truth 2.30e-04), frame start {int(diag['frame_start'])}, "
        f"preamble EVM {float(diag['evm']):.3f}"
    )
    anchors.check(ber < 0.01, f"ber={ber}")
    return anchors.exit_code()


if __name__ == "__main__":
    sys.exit(main())
