"""Command-line entry: filter a WAV with the moving averager on the card.

The reference's binaries take ``<wav_path> <grade>`` and write benchmark CSV
rows (e.g. profilable_sm_averager.cu:150-163). This CLI keeps that
contract, adds the method switch, and writes the filtered audio out:

    python -m digital_signal_processsing_tpu_torch input.wav 1024 --out smooth.wav
    python -m digital_signal_processsing_tpu_torch input.wav 1024 --bench --csv results.csv

It runs on ``--device`` (``cuda`` by default) and raises if that device is
missing; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import functools
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="digital_signal_processsing_tpu_torch", description=__doc__
    )
    p.add_argument("wav_path")
    p.add_argument("grade", type=int, help="moving-average window in frames")
    p.add_argument("--method", default="auto", help="averager route (auto, windowed, golden)")
    p.add_argument("--out", default=None, help="write filtered WAV here")
    p.add_argument("--bench", action="store_true", help="print phase timings")
    p.add_argument("--csv", default=None, help="append a CSV row here")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    from .io import read_wav, write_wav
    from .ops import moving_average
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    info, samples = read_wav(args.wav_path)
    fn = functools.partial(
        moving_average, window=args.grade, channels=info.num_channels, method=args.method
    )
    if args.bench or args.csv:
        from .harness import CsvLogger, time_phases

        res = time_phases(fn, samples, device=dev)
        print(f"--- {args.method} averager on {torch.cuda.get_device_name(dev)} ---")
        print(f"total samples: {samples.size}")
        print(f"window: {args.grade}")
        res.print_stats(samples.size, 2)
        if args.csv:
            CsvLogger(args.csv).log(
                args.method, "staged", samples.size, args.grade, 0, res, 2
            )
    out = fn(torch.from_numpy(samples).to(dev)).cpu().numpy()
    if args.out:
        write_wav(args.out, out, info.sample_rate, info.num_channels)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
