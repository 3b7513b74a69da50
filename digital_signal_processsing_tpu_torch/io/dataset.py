"""Streaming multi-file WAV loader with background prefetch.

The port's own copy of ``WavChunkLoader`` and ``prefetch`` from
``digital_signal_processsing_tpu/io/dataset.py``, which it does not import:
fixed-size interleaved chunks across a list of WAV files as one continuous
stream (file boundaries are seamless, matching how the streaming averager
carries its state), and :func:`device_chunks`, which stages them to the
device one chunk ahead. Decoding is NumPy only (``io/wav.py``); a file that
cannot be decoded raises. The native decode ring is ``io/native.py``'s
``NativeChunkStream``.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from ..utils.device import resolve_device
from .wav import read_wav, read_wav_info


class WavChunkLoader:
    """Iterate fixed-size chunks over a list of WAVs as one stream.

    Yields int16 arrays of exactly ``chunk_samples`` (interleaved); the
    final partial chunk is zero-padded unless ``drop_remainder``. All files
    must share the channel count; sample-rate mismatches raise unless
    ``allow_rate_mismatch``.

    ``packed=True`` yields the int32 little-endian pair view of each chunk
    instead (``chunk.view(np.int32)``, free on the host), which
    ``moving_average`` sends to B2 (B1's launch over the words' int16
    view on the card; the reference packs pairs for its TPU). Requires
    ``chunk_samples % 256 == 0``, as the reference package does.
    """

    def __init__(
        self,
        paths,
        chunk_samples: int,
        *,
        drop_remainder: bool = False,
        allow_rate_mismatch: bool = False,
        packed: bool = False,
    ):
        self.paths = [Path(p) for p in paths]
        if not self.paths:
            raise ValueError("no input files")
        if chunk_samples < 1:
            raise ValueError(f"chunk_samples must be >= 1, got {chunk_samples}")
        if packed and chunk_samples % 256 != 0:
            raise ValueError(
                f"packed chunks need chunk_samples % 256 == 0, got {chunk_samples}"
            )
        self.chunk_samples = chunk_samples
        self.drop_remainder = drop_remainder
        self.allow_rate_mismatch = allow_rate_mismatch
        self.packed = packed
        # header-only peek: decoding the first file here would read its
        # whole body twice (again at iteration)
        info = read_wav_info(self.paths[0])
        self.channels = info.num_channels
        self.sample_rate = info.sample_rate

    def _emit(self, chunk: np.ndarray) -> np.ndarray:
        if not self.packed:
            return chunk
        if not chunk.flags.c_contiguous:
            chunk = np.ascontiguousarray(chunk)
        return chunk.view(np.int32)  # free reinterpret, no copy

    def __iter__(self) -> Iterator[np.ndarray]:
        buf = np.empty(0, np.int16)
        for p in self.paths:
            info, data = read_wav(p)
            if info.num_channels != self.channels:
                raise ValueError(
                    f"{p}: {info.num_channels} channels != first file's {self.channels}"
                )
            if info.sample_rate != self.sample_rate and not self.allow_rate_mismatch:
                raise ValueError(
                    f"{p}: sample rate {info.sample_rate} != first file's {self.sample_rate}"
                )
            buf = np.concatenate([buf, data]) if buf.size else data
            while buf.size >= self.chunk_samples:
                yield self._emit(buf[: self.chunk_samples])
                buf = buf[self.chunk_samples :]
        if buf.size and not self.drop_remainder:
            out = np.zeros(self.chunk_samples, np.int16)
            out[: buf.size] = buf
            yield self._emit(out)


def prefetch(iterator, depth: int = 2):
    """Run an iterator on a background thread with a bounded queue."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def _pinned(chunks):
    for chunk in chunks:
        yield torch.from_numpy(np.ascontiguousarray(chunk)).pin_memory()


def device_chunks(loader, *, device="cuda", depth: int = 2, sharding=None):
    """Prefetched chunks staged to ``device`` (host IO overlaps device compute).

    The loader runs on :func:`prefetch`'s thread, which also copies each chunk
    into pinned host memory; the copy to the card is issued on a side stream
    one chunk ahead of the consumer. Each tensor handed out is ready on the
    consumer's current stream (which waits on its copy's event) and recorded
    there, so the caching allocator keeps it until that stream's work on it is
    done. On the CPU the chunks come as tensors over the loader's arrays.
    Without a card, ``device="cuda"`` raises.

    With ``sharding`` (a ``parallel.Sharding``, the counterpart of
    ``jax.device_put(chunk, sharding)``), each chunk becomes this rank's
    shard, ``sharding.shard(chunk)``, cut on the host and staged the same way
    to the mesh's device (``device`` is then the mesh's).
    """
    if sharding is not None:
        from ..parallel.mesh import Sharding

        if not isinstance(sharding, Sharding):
            raise TypeError(
                f"sharding must be a parallel.Sharding (time_sharding(mesh), ...), got "
                f"{type(sharding).__name__}"
            )
        device = sharding.mesh.device
        loader = (sharding.shard(chunk).numpy() for chunk in loader)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (torch.from_numpy(chunk) for chunk in prefetch(iter(loader), depth=depth))
    return _staged(loader, dev, depth)


def _staged(loader, dev: torch.device, depth: int):
    side = torch.cuda.Stream(dev)

    def upload(host: torch.Tensor):
        with torch.cuda.stream(side):
            x = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return x, done

    staged = None
    for host in prefetch(_pinned(loader), depth=depth):
        ahead = upload(host)
        if staged is not None:
            yield _ready(*staged, dev)
        staged = ahead
    if staged is not None:
        yield _ready(*staged, dev)


def _ready(x: torch.Tensor, done, dev) -> torch.Tensor:
    consumer = torch.cuda.current_stream(dev)
    consumer.wait_event(done)
    x.record_stream(consumer)
    return x


__all__ = ["WavChunkLoader", "prefetch", "device_chunks"]
