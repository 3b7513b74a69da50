"""Speech analysis and resynthesis in one pipeline.

Counterpart of ``examples/speech_pipeline.py``: synthesise a vowel-like
"voice", track its pitch cepstrally, extract the LPC envelope frame by frame,
resynthesise at a different pitch (the classic vocoder, B22 on the card), and
clean a frequency-wandering interferer with the block-adaptive tracking notch
(B18 on the card):

    python -m digital_signal_processsing_tpu_torch.examples.speech_pipeline [--device cpu]
"""

import sys

import numpy as np
import torch

from digital_signal_processsing_tpu_torch.examples import Anchors, device_of, parser
from digital_signal_processsing_tpu_torch.models import adaptive
from digital_signal_processsing_tpu_torch.ops import cepstrum, lpc


def make_voice(sr: int, n: int, f0: float) -> np.ndarray:
    """Pulse train through two formant resonators: a cartoon vowel."""
    from scipy.signal import lfilter  # synthesis only; the analysis is the port's

    pulses = np.zeros(n)
    pulses[:: int(sr / f0)] = 1.0
    formants = np.poly(
        [
            0.97 * np.exp(1j * 2 * np.pi * 700 / sr),
            0.97 * np.exp(-1j * 2 * np.pi * 700 / sr),
            0.95 * np.exp(1j * 2 * np.pi * 1800 / sr),
            0.95 * np.exp(-1j * 2 * np.pi * 1800 / sr),
        ]
    ).real
    return lfilter([1.0], formants, pulses).astype(np.float32)


def main(argv=None) -> int:
    dev = device_of(parser(__doc__).parse_args(argv))
    anchors = Anchors()
    sr, n = 16000, 48000
    voice = make_voice(sr, n, f0=120.0)
    voice_t = torch.from_numpy(voice).to(dev)

    # 1. cepstral pitch (Noll's method on the FFT path)
    f0 = float(cepstrum.cepstral_pitch(voice_t, fs=sr))
    print(f"cepstral pitch estimate: {f0:.1f} Hz (true 120)")
    anchors.check(abs(f0 - 120.0) < 5.0, "cepstral pitch")

    # 2. LPC envelope + pitch-shifted vocoder resynthesis
    order, frame = 12, 320
    a, gain = lpc.lpc(voice_t, order, frame)
    nf = a.shape[0]
    excitation = np.zeros(nf * frame, np.float32)
    excitation[:: int(sr / 180.0)] = np.sqrt(frame)  # new pitch: 180 Hz
    shifted_t = lpc.lpc_synthesis(a, gain / np.sqrt(frame), torch.from_numpy(excitation).to(dev),
                                  frame)
    shifted = shifted_t.cpu().numpy()
    f0_new = float(cepstrum.cepstral_pitch(shifted_t, fs=sr))
    print(f"vocoded pitch: {f0_new:.1f} Hz (target 180)")
    anchors.check(abs(f0_new - 180.0) < 8.0, "vocoded pitch")

    # 3. the formant envelope survived the pitch shift
    spec = np.abs(np.fft.rfft(shifted * np.hanning(shifted.size)))
    freqs = np.linspace(0, sr / 2, spec.size)
    floor = np.median(spec[freqs > 4000])
    for formant in (700.0, 1800.0):
        band = spec[(freqs > formant - 120) & (freqs < formant + 120)]
        print(f"formant {formant:.0f} Hz: {20*np.log10(band.max()/floor):.1f} dB above floor")
        anchors.check(band.max() > 10 * floor, f"formant {formant:.0f} Hz")

    # 4. frequency-tracking notch removes a swept interferer
    t = np.arange(n)
    sweep = 4.0 * np.sin(np.cumsum(np.pi * (0.12 + 0.2 * t / n)))
    corrupted = (voice + sweep).astype(np.float32)
    cleaned, track = adaptive.tracking_notch(torch.from_numpy(corrupted).to(dev), 512, q=30.0)
    cleaned, track = cleaned.cpu().numpy(), track.cpu().numpy()
    resid_in = np.mean((corrupted - voice) ** 2)
    resid_out = np.mean((cleaned[1024:] - voice[1024:]) ** 2)
    print(
        f"interferer suppression: {10*np.log10(resid_in/resid_out):.1f} dB "
        f"(tracked {track[0]:.3f} -> {track[-1]:.3f} Nyquist)"
    )
    anchors.check(resid_out < 0.12 * resid_in, "interferer suppression")

    if not anchors.missed:
        print("speech pipeline OK")
    return anchors.exit_code()


if __name__ == "__main__":
    sys.exit(main())
