"""Command-line entry: filter a WAV with the moving averager on the card.

The reference's binaries take ``<wav_path> <grade> <block_size>`` and write
benchmark CSV rows (e.g. profilable_sm_averager.cu:150-163). This CLI keeps
that contract, adds the method switch, and writes the filtered audio out:

    python -m digital_signal_processsing_tpu_torch input.wav 1024 --out smooth.wav
    python -m digital_signal_processsing_tpu_torch input.wav 1024 64 --method scan \
        --bench --csv results.csv

``block_size`` is the reference package's tile rows (a multiple of 16): the
tiled methods (windowed, scan, scan_hillis, scan_mxu, direct) then run
their kernel with a tile of ``block_size * 128`` samples.

It runs on ``--device`` (``cuda`` by default) and raises if that device is
missing; ``--device cpu`` runs the plain PyTorch path.
"""

from __future__ import annotations

import argparse
import functools
import sys

from .ops.moving_average import TILED_METHODS, kernel_fn


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="digital_signal_processsing_tpu_torch", description=__doc__
    )
    p.add_argument("wav_path")
    p.add_argument("grade", type=int, help="moving-average window in frames")
    p.add_argument(
        "block_size",
        type=int,
        nargs="?",
        default=None,
        help="tile rows of 128 samples (the reference's CUDA block-size knob)",
    )
    p.add_argument("--method", default="auto", help="averager method (see ops.METHODS)")
    p.add_argument("--out", default=None, help="write filtered WAV here")
    p.add_argument("--bench", action="store_true", help="print phase timings")
    p.add_argument("--csv", default=None, help="append a CSV row here")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)

    tiled = bool(args.block_size) and args.method in TILED_METHODS
    if tiled and args.block_size % 16 != 0:
        print("Error: block size must be a multiple of 16", file=sys.stderr)
        return 1

    import torch

    from .io import read_wav, write_wav
    from .ops import moving_average
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    info, samples = read_wav(args.wav_path)
    if tiled:
        fn = kernel_fn(args.method, args.grade, info.num_channels, args.block_size)
    else:
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
                args.method, "staged", samples.size, args.grade,
                args.block_size if tiled else 0, res, 2,
            )
    out = fn(torch.from_numpy(samples).to(dev)).cpu().numpy()
    if args.out:
        write_wav(args.out, out, info.sample_rate, info.num_channels)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
