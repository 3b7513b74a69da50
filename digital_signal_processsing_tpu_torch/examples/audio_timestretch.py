"""Time-stretch and pitch-shift a WAV through the phase vocoder.

Counterpart of ``examples/audio_timestretch.py`` (it prints and has no
anchor). Without a path it synthesises a two-tone test signal into the
temporary directory, then writes three outputs there through the WAV codec
and the STFT phase vocoder: 2x slower (same pitch), 2x faster (same pitch)
and up a fifth (same duration, Farrow-resampled, B21 on the card):

    python -m digital_signal_processsing_tpu_torch.examples.audio_timestretch [in.wav] [--device cpu]
"""

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from digital_signal_processsing_tpu_torch.examples import device_of, parser
from digital_signal_processsing_tpu_torch.io.wav import read_wav, write_wav
from digital_signal_processsing_tpu_torch.ops.phase_vocoder import pitch_shift, time_stretch


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("path", nargs="?", help="a 16-bit mono WAV (a two-tone test signal if none)")
    args = ap.parse_args(argv)
    dev = device_of(args)
    if args.path:
        path = args.path
    else:
        t = np.arange(2 * 44100)
        tone = 0.4 * np.sin(2 * np.pi * 440 / 44100 * t) + 0.2 * np.sin(
            2 * np.pi * 660 / 44100 * t
        )
        path = str(Path(tempfile.gettempdir()) / "vocoder_in.wav")
        write_wav(path, (tone * 32767).astype(np.int16), 44100, 1)
    header, samples = read_wav(path)
    x = torch.from_numpy(samples.astype(np.float32) / 32768.0).to(dev)
    print(f"in: {path} ({x.numel()} samples @ {header.sample_rate} Hz)")
    outdir = Path(tempfile.gettempdir())
    for name, y in (
        ("slow2x", time_stretch(x, 0.5)),
        ("fast2x", time_stretch(x, 2.0)),
        ("fifth_up", pitch_shift(x, 1.5)),
    ):
        y = y.cpu().numpy()
        out = outdir / f"vocoder_{name}.wav"
        write_wav(
            str(out),
            np.clip(y * 32767, -32768, 32767).astype(np.int16),
            header.sample_rate,
            1,
        )
        print(f"  {name}: {y.size} samples -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
