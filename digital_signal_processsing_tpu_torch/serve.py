"""Serving: WAV files as one stream through a chunked op on the device.

Counterpart of ``run_chunks``, ``stream_moving_average``,
``stream_sosfilt``, ``stream_time_stretch`` and ``stream_mfcc`` in
``digital_signal_processsing_tpu/serve.py``: decode on the host (the shared
NumPy loader), process each chunk on the device with the state carried
across chunk and file boundaries, and write the result as it comes, so
memory stays bounded by the chunk size. The averager's loop also runs on the
native C++ executor (``io/native.py``), as the reference's does.
"""

from __future__ import annotations

import itertools
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
    use_native: bool | None = None,
    device="cuda",
) -> int:
    """Filter a list of WAVs as ONE stream into an output WAV, chunked.

    Bit-exact with the one-shot averager on the concatenated stream. The
    chunks are filtered on ``device``, which must exist: without a card,
    ``device="cuda"`` raises. Returns the samples written.

    ``use_native``: run the host side on the native C++ executor
    (``io.native.NativeChunkStream``'s decode ring and ``NativeWavSink``'s
    encode thread, both off the GIL, so host IO overlaps the device's work).
    ``None`` takes it where the library builds; the output is byte-identical
    either way. ``True`` raises where it cannot be built.
    """
    from .ops.streaming import moving_average_chunk, moving_average_init

    dev = resolve_device(device)
    paths = list(paths)
    channels, rate, total = _stream_layout(paths)
    chunk_samples -= chunk_samples % max(channels, 1)

    if use_native is None:
        from .io import native

        use_native = native.available()
    state = moving_average_init(window, channels, device=dev)
    if use_native:
        return _native_moving_average(
            paths, out_path, window, channels, rate, total, chunk_samples, state, dev
        )
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


NATIVE_SLOTS = 3  # pinned buffers in flight each way: decode, upload and download overlap


def _native_moving_average(paths, out_path, window, channels, rate, total, chunk_samples,
                           state, dev) -> int:
    """The native executor's loop: decode straight into pinned host buffers,
    upload without blocking, B1 seeded on the device, download into pinned
    buffers and hand each chunk to the encode thread one chunk late.

    A slot's input buffer is decoded into again only after its upload's event
    has completed, and its output buffer is written again only after the sink
    has copied it (the sink lags one chunk behind, with three slots).
    """
    from .io.native import NativeChunkStream, NativeWavSink
    from .ops.streaming import moving_average_chunk

    cuda = dev.type == "cuda"
    slots = [
        (torch.empty(chunk_samples, dtype=torch.int16, pin_memory=cuda),
         torch.empty(chunk_samples, dtype=torch.int16, pin_memory=cuda),
         torch.cuda.Event() if cuda else None, torch.cuda.Event() if cuda else None)
        for _ in range(NATIVE_SLOTS)
    ]
    pending: list[tuple[int, int]] = []  # (slot, samples) downloaded, not yet in the sink
    written = 0
    stream = NativeChunkStream(paths, chunk_samples)
    try:
        with NativeWavSink(out_path, rate, channels) as sink:

            def drain(keep_last: int) -> None:
                while len(pending) > keep_last:
                    s, k = pending.pop(0)
                    host, down = slots[s][1], slots[s][3]
                    if down is not None:
                        down.synchronize()
                    sink.append(host[:k])

            for i in itertools.count():
                s = i % NATIVE_SLOTS
                pin_in, pin_out, up, down = slots[s]
                if up is not None:
                    up.synchronize()  # this slot's last upload has read its buffer
                if stream.read_into(pin_in) == 0:
                    break
                x = pin_in.to(dev, non_blocking=True)
                if up is not None:
                    up.record()
                state, out = moving_average_chunk(state, x, window, channels)
                keep = min(out.numel(), total - written)  # drop the stream's tail padding
                if keep <= 0:
                    break
                pin_out[:keep].copy_(out[:keep], non_blocking=True)
                if down is not None:
                    down.record()
                pending.append((s, keep))
                written += keep
                drain(1)
            drain(0)
    finally:
        stream.close()
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


def _planar(chunk: np.ndarray, channels: int, dev: torch.device) -> torch.Tensor:
    """int16 interleaved -> (channels, frames) float32 in [-1, 1) on ``dev``."""
    x = torch.from_numpy(chunk).to(dev).reshape(-1, channels).T
    return x.to(torch.float32) / 32768.0


def stream_time_stretch(
    paths,
    out_path: str | Path,
    rate: float,
    *,
    nfft: int = 2048,
    chunk_samples: int = 1 << 20,
    device="cuda",
) -> int:
    """Phase-vocoder time stretch over a list of WAVs as ONE stream.

    Counterpart of the reference's ``stream_time_stretch``: int16
    interleaved chunks go to ``device`` as planar float, are buffered there
    to analysis-hop multiples and pushed through
    ``ops.phase_vocoder.time_stretch_chunk`` (STFT tail, phase chain and
    WOLA tail carried across chunk AND file boundaries), then come back
    re-interleaved as int16. As in the reference, the loader's zero-padded
    last chunk is processed as it comes, and any sub-hop remainder at the
    end is zero-padded into a final hop. Without a card, ``device="cuda"``
    raises. Returns samples written per channel.
    """
    from .ops import phase_vocoder as _pv

    dev = resolve_device(device)
    paths = list(paths)
    channels, srate, _ = _stream_layout(paths)
    ha = max(1, int(round(nfft // 4 * rate)))
    chunk_samples -= chunk_samples % max(channels, 1)
    state = _pv.time_stretch_init(rate, nfft=nfft, channels=channels, device=dev)
    buf = torch.zeros((channels, 0), dtype=torch.float32, device=dev)
    written = 0

    def emit(sink, y: torch.Tensor) -> None:
        nonlocal written
        out = torch.round(y * 32768.0).clamp_(-32768, 32767).to(torch.int16).T.reshape(-1)
        sink.append(out.cpu().numpy())
        written += out.numel() // channels

    with WavWriter(out_path, srate, channels) as sink:
        for chunk in WavChunkLoader(paths, chunk_samples):
            buf = torch.cat([buf, _planar(chunk, channels, dev)], dim=-1)
            use = buf.shape[-1] // ha * ha
            if use:
                state, y = _pv.time_stretch_chunk(state, buf[:, :use], rate=rate, nfft=nfft)
                buf = buf[:, use:]
                emit(sink, y)
        if buf.shape[-1]:
            state, y = _pv.time_stretch_chunk(
                state, torch.nn.functional.pad(buf, (0, ha - buf.shape[-1])), rate=rate, nfft=nfft
            )
            emit(sink, y)
        emit(sink, _pv.time_stretch_flush(state))
    return written


def stream_mfcc(
    paths,
    out_path: str | Path | None = None,
    *,
    n_mfcc: int = 13,
    nfft: int = 512,
    hop: int = 256,
    n_mels: int = 40,
    window: str = "hann",
    lifter: float = 0.0,
    chunk_samples: int = 1 << 20,
    device="cuda",
) -> np.ndarray:
    """MFCC features over a list of WAVs as ONE stream, chunked.

    Counterpart of the reference's ``stream_mfcc``: int16 interleaved
    chunks go to ``device`` as planar float, trimmed to the true stream
    length (the loader zero-pads its last chunk), buffered to hop multiples
    and pushed through ``ops.mel.mfcc_chunk`` (streaming-STFT tail carried
    across chunk AND file boundaries). The features stay on the device until
    the stream ends; the result is (channels, frames, n_mfcc) float32 on the
    host, saved as .npy with ``out_path``. It equals the one-shot
    ``ops.mel.mfcc`` of the zero-primed concatenated stream (any sub-hop
    tail zero-padded into the final hop). Without a card, ``device="cuda"``
    raises.
    """
    from .ops import mel as _mel

    dev = resolve_device(device)
    paths = list(paths)
    channels, rate, total = _stream_layout(paths)
    chunk_samples -= chunk_samples % max(channels, 1)
    remaining = total // channels
    state = _mel.mfcc_init(nfft, hop, channels, device=dev)
    buf = torch.zeros((channels, 0), dtype=torch.float32, device=dev)
    feats: list[torch.Tensor] = []

    def push(block: torch.Tensor) -> None:
        nonlocal state
        state, c = _mel.mfcc_chunk(
            state, block, sample_rate=float(rate), n_mfcc=n_mfcc, nfft=nfft, hop=hop,
            window=window, n_mels=n_mels, lifter=lifter,
        )
        feats.append(c)

    for chunk in WavChunkLoader(paths, chunk_samples):
        planar = _planar(chunk, channels, dev)[:, : max(0, remaining)]
        remaining -= planar.shape[-1]
        buf = torch.cat([buf, planar], dim=-1)
        use = buf.shape[-1] // hop * hop
        if use:
            push(buf[:, :use])
            buf = buf[:, use:]
    if buf.shape[-1]:
        push(torch.nn.functional.pad(buf, (0, hop - buf.shape[-1])))
    out = (
        torch.cat(feats, dim=1).cpu().numpy()
        if feats
        else np.zeros((channels, 0, n_mfcc), np.float32)
    )
    if out_path is not None:
        np.save(out_path, out)
    return out


__all__ = [
    "run_chunks",
    "stream_moving_average",
    "stream_sosfilt",
    "stream_time_stretch",
    "stream_mfcc",
]
