"""WAV codec and chunk loader, shared with the reference package.

``digital_signal_processsing_tpu.io.wav``, ``.native`` and ``.dataset`` are
NumPy-only and import no JAX, so the port re-exports them rather than
keeping a second copy of the codec.
"""

from digital_signal_processsing_tpu.io import dataset, native, wav  # noqa: F401
from digital_signal_processsing_tpu.io.dataset import WavChunkLoader  # noqa: F401
from digital_signal_processsing_tpu.io.wav import (  # noqa: F401
    WavInfo,
    WavWriter,
    read_wav,
    read_wav_info,
    write_wav,
)

__all__ = [
    "wav",
    "native",
    "dataset",
    "WavChunkLoader",
    "WavInfo",
    "WavWriter",
    "read_wav",
    "read_wav_info",
    "write_wav",
]
