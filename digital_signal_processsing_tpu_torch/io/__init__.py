"""WAV codec and chunk loader: the port's own NumPy-only copies.

``wav``, ``dataset`` and ``native`` are copies of the JAX package's
``io/wav.py``, ``io/dataset.py`` and ``io/native.py``, which the port does not
import. ``native`` (the C++ codec, the serial CPU averager and the streaming
executor) builds its library at first use and is imported on demand.
"""

from . import dataset, wav  # noqa: F401
from .dataset import WavChunkLoader, device_chunks, prefetch  # noqa: F401
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
    "device_chunks",
    "WavInfo",
    "WavWriter",
    "read_wav",
    "read_wav_info",
    "read_wav_widened",
    "write_wav",
]
