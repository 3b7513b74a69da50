"""WAV codec and chunk loader: the port's own NumPy-only copies.

``wav`` and ``dataset`` are copies of the JAX package's ``io/wav.py`` and
``io/dataset.py`` (the loader and ``prefetch``), which the port does not
import. The native C++ codec and ``device_chunks`` are not ported.
"""

from . import dataset, wav  # noqa: F401
from .dataset import WavChunkLoader, prefetch  # noqa: F401
from .wav import (  # noqa: F401
    WavInfo,
    WavWriter,
    read_wav,
    read_wav_info,
    read_wav_widened,
    write_wav,
)

__all__ = [
    "wav",
    "dataset",
    "WavChunkLoader",
    "prefetch",
    "WavInfo",
    "WavWriter",
    "read_wav",
    "read_wav_info",
    "read_wav_widened",
    "write_wav",
]
