"""Serving: WAV files as one stream through the chunked averager or an SOS cascade.

Counterpart of ``stream_moving_average`` and ``run_chunks`` in
``digital_signal_processsing_tpu/serve.py``, and of ``stream_sosfilt``: decode on the host (the shared
NumPy loader), filter each chunk on the device with the state carried
across chunk and file boundaries, and write the result as it comes, so
memory stays bounded by the chunk size.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from .io import WavChunkLoader, WavWriter, read_wav_info
from .utils.device import resolve_device


def run_chunks(
    chunk_fn: Callable,
    state,
    chunks: Iterable[torch.Tensor],
) -> Iterator[np.ndarray]:
    """Drive any (state, chunk) -> (state, out) op over chunks; yield host arrays."""
    for chunk in chunks:
        state, out = chunk_fn(state, chunk)
        yield out.cpu().numpy()


def _stream_layout(paths) -> tuple[int, int, int]:
    """(channels, sample rate, decodable samples) of WAVs read as one stream.

    Raises if a file's channels or rate differ from the first file's. The
    decodable samples are each header's data size clamped to the body present.
    """
    infos = [read_wav_info(p) for p in paths]
    channels = infos[0].num_channels
    rate = infos[0].sample_rate
    for p, i in zip(paths, infos):
        if i.num_channels != channels:
            raise ValueError(
                f"{p}: {i.num_channels} channels != first file's {channels}"
            )
        if i.sample_rate != rate:
            raise ValueError(
                f"{p}: sample rate {i.sample_rate} != first file's {rate}"
            )
    total = sum(
        min(i.num_samples, max(Path(p).stat().st_size - 44, 0) // 2)
        for i, p in zip(infos, paths)
    )
    return channels, rate, total


def stream_moving_average(
    paths,
    out_path: str | Path,
    window: int,
    *,
    chunk_samples: int = 1 << 20,
    device="cuda",
) -> int:
    """Filter a list of WAVs as ONE stream into an output WAV, chunked.

    Bit-exact with the one-shot averager on the concatenated stream. The
    chunks are filtered on ``device``, which must exist: without a card,
    ``device="cuda"`` raises. Returns the samples written.
    """
    from .ops.streaming import moving_average_chunk, moving_average_init

    dev = resolve_device(device)
    paths = list(paths)
    channels, rate, total = _stream_layout(paths)
    chunk_samples -= chunk_samples % max(channels, 1)

    state = moving_average_init(window, channels, device=dev)
    written = 0
    loader = WavChunkLoader(paths, chunk_samples)
    with WavWriter(out_path, rate, channels) as sink:
        for chunk in loader:
            x = torch.from_numpy(chunk).to(dev)
            state, out = moving_average_chunk(state, x, window, channels)
            out = out.cpu().numpy()
            keep = min(out.size, total - written)  # drop the loader's tail padding
            if keep <= 0:
                break
            sink.append(out[:keep])
            written += keep
    return written


def stream_sosfilt(
    paths,
    out_path: str | Path,
    sos,
    *,
    chunk_samples: int = 1 << 20,
    device="cuda",
) -> int:
    """Run an SOS cascade over a list of WAVs as ONE stream into a WAV, chunked.

    Counterpart of the reference's ``stream_sosfilt``: each int16 interleaved
    chunk goes to ``device`` as planar float32, through ``sosfilt_chunk``
    (B12 seeded, at production chunk sizes) with the (sections, channels, 2)
    state kept on the device across chunk and file boundaries, and comes back
    rounded and clipped to int16. Matches one-shot ``sosfilt`` of the
    concatenated stream to float32 rounding (at most 1 LSB). Without a card,
    ``device="cuda"`` raises. Returns the samples written.
    """
    from .ops.iir import sosfilt_chunk, sosfilt_init

    dev = resolve_device(device)
    paths = list(paths)
    channels, rate, total = _stream_layout(paths)
    chunk_samples -= chunk_samples % max(channels, 1)
    sos_rows = np.asarray(sos, np.float32).reshape(-1, 6)
    state = sosfilt_init(sos_rows, (channels,), device=dev)
    written = 0
    with WavWriter(out_path, rate, channels) as sink:
        for chunk in WavChunkLoader(paths, chunk_samples):
            planar = np.ascontiguousarray(chunk.reshape(-1, channels).T, dtype=np.float32)
            state, y = sosfilt_chunk(state, sos_rows, torch.from_numpy(planar).to(dev))
            out = torch.round(y.T.reshape(-1)).clamp_(-32768, 32767).to(torch.int16)
            out = out.cpu().numpy()
            keep = min(out.size, total - written)  # drop the loader's tail padding
            if keep <= 0:
                break
            sink.append(out[:keep])
            written += keep
    return written


__all__ = ["run_chunks", "stream_moving_average", "stream_sosfilt"]
