"""ctypes bindings to the native host runtime (``native/dsp_native.cpp``).

The port's own copy of ``digital_signal_processsing_tpu/io/native.py``,
which it does not import: the C++ WAV codec, the reference's serial CPU
averager (profilable_moving_averager.cpp's semantics, the paper's CPU
baseline) and the streaming executor of the serving loop, a decode ring
(:class:`NativeChunkStream`) and an encode thread (:class:`NativeWavSink`)
that run off the GIL while the device computes.

The library is built at first use from the repo's ``native/dsp_native.cpp``
with ``g++ -O3 -march=native -std=c++17 -fPIC -shared -pthread`` into
``_build/`` next to this package, under a name keyed by the source, the flags
and the host CPU (a tree copied to another host builds its own library rather
than load one made for another CPU). Each build writes a temporary file and
renames it, so processes that build at once each see all of a library or
none. Nothing is written under ``native/``. If no compiler is found or the
build fails, :func:`load` raises :class:`NativeUnavailable` with the
compiler's output; nothing here falls back to the NumPy codec.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[2] / "native" / "dsp_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")

_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
# name -> (return type, argument types), as native/dsp_native.cpp declares them
_SIGNATURES = {
    "dsp_wav_info": (ctypes.c_int, (ctypes.c_char_p, _I32P, _I32P, _I64P)),
    "dsp_wav_read": (_I64, (ctypes.c_char_p, _I16P, _I64)),
    "dsp_wav_write": (ctypes.c_int, (ctypes.c_char_p, _I16P, _I64, _I32, _I32)),
    "dsp_wav_read_many": (
        ctypes.c_int, (ctypes.POINTER(ctypes.c_char_p), _I32, _I16P, _I64P, _I64P, _I32)
    ),
    "dsp_moving_average": (None, (_I16P, _I16P, _I64, _I32, _I32)),
    "dsp_bench_moving_average": (ctypes.c_double, (_I16P, _I16P, _I64, _I32, _I32, _I32, _I32)),
    "dsp_stream_open": (ctypes.c_void_p, (ctypes.POINTER(ctypes.c_char_p), _I32, _I64, _I32)),
    "dsp_stream_next": (_I64, (ctypes.c_void_p, ctypes.c_void_p)),
    "dsp_stream_close": (None, (ctypes.c_void_p,)),
    "dsp_sink_open": (ctypes.c_void_p, (ctypes.c_char_p, _I32, _I32, _I32)),
    "dsp_sink_append": (ctypes.c_int, (ctypes.c_void_p, ctypes.c_void_p, _I64)),
    "dsp_sink_close": (_I64, (ctypes.c_void_p,)),
}

_lib = None


class NativeUnavailable(RuntimeError):
    pass


def compiler() -> str:
    """The C++ compiler: ``$CXX`` or ``g++`` on the PATH; raises if neither exists."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise NativeUnavailable(f"no C++ compiler ({cxx!r} is not on the PATH)")
    return found


def compiler_version() -> str:
    """The first line of the compiler's ``--version``."""
    out = subprocess.run([compiler(), "--version"], capture_output=True, text=True, timeout=60)
    return out.stdout.splitlines()[0] if out.stdout else out.stderr.strip()


@functools.cache
def _host_cpu() -> str:
    """What ``-march=native`` compiles for: the CPU's model and flags, as /proc/cpuinfo
    gives them (the machine's name where there is no /proc)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine() + platform.processor()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(dict.fromkeys(keep))


def host_cpu_model() -> str:
    """The host CPU's model name: /proc/cpuinfo's, else ``lscpu``'s (marked so), else
    "unknown"."""
    for ln in _host_cpu().splitlines():
        if ln.startswith("model name"):
            return ln.split(":", 1)[1].strip()
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    for ln in out.splitlines():
        if ln.startswith("Model name:"):
            return ln.split(":", 1)[1].strip() + " (lscpu)"
    return "unknown"


def library_path() -> Path:
    """Where the library for this source, these flags and this CPU lives (built or not)."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu().encode())
    return BUILD_DIR / f"libdsp_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``native/dsp_native.cpp`` if no library for it exists; return its path."""
    if not SOURCE.is_file():
        raise NativeUnavailable(f"{SOURCE} not found")
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.so.tmp")
    try:
        r = subprocess.run(
            [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=300,
        )
        if r.returncode != 0:
            raise NativeUnavailable(
                f"building {SOURCE.name} failed (exit code {r.returncode}):\n{r.stdout}{r.stderr}"
            )
        os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load(auto_build: bool = True):
    """Load (building if needed) the native library; raises NativeUnavailable."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        if not auto_build:
            raise NativeUnavailable(f"{so} missing and auto_build is off")
        so = build()
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _i16ptr(a: np.ndarray):
    return a.ctypes.data_as(_I16P)


def _info(lib, path) -> tuple[int, int, int]:
    ch, rate, n = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int64()
    rc = lib.dsp_wav_info(str(path).encode(), ch, rate, n)
    if rc != 0:
        raise ValueError(f"{path}: native WAV parse failed (rc={rc})")
    return ch.value, rate.value, n.value


def wav_info_native(path) -> tuple[int, int, int]:
    """(channels, sample_rate, num_samples) from the header only (no body)."""
    return _info(load(), path)


def read_wav_native(path) -> tuple[int, int, np.ndarray]:
    """(channels, sample_rate, samples) via the C++ codec."""
    lib = load()
    ch, rate, n = _info(lib, path)
    out = np.empty(n, dtype=np.int16)
    got = lib.dsp_wav_read(str(path).encode(), _i16ptr(out), n)
    if got < 0:
        raise ValueError(f"{path}: native WAV read failed (rc={got})")
    return ch, rate, out[: int(got)]


def write_wav_native(path, samples: np.ndarray, sample_rate: int, channels: int) -> None:
    lib = load()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    rc = lib.dsp_wav_write(str(path).encode(), _i16ptr(samples), samples.size, sample_rate,
                           channels)
    if rc != 0:
        raise ValueError(f"{path}: native WAV write failed (rc={rc})")


def read_wavs_concat_native(paths, num_threads: int = 8) -> tuple[int, int, np.ndarray]:
    """Decode many WAVs concurrently into one concatenated stream.

    Returns (channels, sample_rate, samples) of the whole stream; all files
    must share the channel count and rate of the first.
    """
    lib = load()
    paths = [str(p) for p in paths]
    infos = [_info(lib, p) for p in paths]
    ch0, rate0 = infos[0][0], infos[0][1]
    for p, (ch, rate, _) in zip(paths, infos):
        if ch != ch0 or rate != rate0:
            raise ValueError(f"{p}: ({ch} ch, {rate} Hz) != first ({ch0}, {rate0})")
    counts = np.array([i[2] for i in infos], np.int64)
    offsets = np.zeros_like(counts)
    np.cumsum(counts[:-1], out=offsets[1:])
    out = np.empty(int(counts.sum()), np.int16)
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    ok = lib.dsp_wav_read_many(
        c_paths, len(paths), _i16ptr(out), offsets.ctypes.data_as(_I64P),
        counts.ctypes.data_as(_I64P), num_threads,
    )
    if ok != len(paths):
        raise ValueError(f"only {ok}/{len(paths)} files decoded cleanly")
    return ch0, rate0, out


def _validate_avg_args(n: int, window: int, channels: int) -> None:
    """Raise like the golden model: never feed C++ a division by zero."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if channels < 1:
        raise ValueError(f"channels must be >= 1, got {channels}")
    if n % channels != 0:
        raise ValueError(f"stream length {n} not a multiple of channels {channels}")


def moving_average_native(samples: np.ndarray, window: int, channels: int = 1) -> np.ndarray:
    """The C++ serial sliding-sum averager (golden's semantics, one host core)."""
    lib = load()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    _validate_avg_args(samples.size, window, channels)
    out = np.empty_like(samples)
    lib.dsp_moving_average(_i16ptr(samples), _i16ptr(out), samples.size, channels, window)
    return out


def bench_moving_average_native(
    samples: np.ndarray, window: int, channels: int = 1, warmup: int = 5, rounds: int = 10,
) -> float:
    """Mean milliseconds a round of the native averager (the CPU baseline row)."""
    lib = load()
    samples = np.ascontiguousarray(samples, dtype=np.int16)
    _validate_avg_args(samples.size, window, channels)
    out = np.empty_like(samples)
    return float(lib.dsp_bench_moving_average(
        _i16ptr(samples), _i16ptr(out), samples.size, channels, window, warmup, rounds,
    ))


class NativeChunkStream:
    """Iterator over fixed-size chunks of WAVs read as one stream, decoded by a
    native background thread (host decode runs off the GIL while the consumer
    drives the device).

    Yields (chunk, valid_count): chunk is always ``chunk_samples`` int16 (the
    last one zero-padded); ``valid_count`` says how many are real.
    :meth:`read_into` decodes the next chunk into a caller's buffer instead,
    such as a pinned host tensor that is then uploaded without blocking.
    """

    def __init__(self, paths, chunk_samples: int, *, depth: int = 4):
        lib = load()
        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("no input files")
        if chunk_samples < 1:
            raise ValueError(f"chunk_samples must be >= 1, got {chunk_samples}")
        self.chunk_samples = int(chunk_samples)
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._handle = lib.dsp_stream_open(arr, len(self.paths), self.chunk_samples, depth)
        if not self._handle:
            raise NativeUnavailable("dsp_stream_open failed")
        self._lib = lib

    def __iter__(self):
        return self

    def read_into(self, out) -> int:
        """Decode the next chunk into ``out`` (a C-contiguous int16 CPU tensor or
        array of ``chunk_samples``); return its valid count, 0 at the end."""
        if isinstance(out, torch.Tensor):
            ok = out.dtype == torch.int16 and out.device.type == "cpu" and out.is_contiguous()
            size, ptr = out.numel(), out.data_ptr()
        else:
            ok = out.dtype == np.int16 and out.flags.c_contiguous
            size, ptr = out.size, out.ctypes.data
        if not ok or size != self.chunk_samples:
            raise ValueError(f"read_into needs a contiguous int16 host buffer of "
                             f"{self.chunk_samples} samples")
        if self._handle is None:
            return 0
        got = self._lib.dsp_stream_next(self._handle, ptr)
        if got < 0:
            self.close()
            raise IOError(f"native stream decode error ({got})")
        if got == 0:
            self.close()
        return int(got)

    def __next__(self):
        out = np.empty(self.chunk_samples, np.int16)
        got = self.read_into(out)
        if got == 0:
            raise StopIteration
        return out, got

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dsp_stream_close(self._handle)
            self._handle = None

    def __del__(self):  # release the worker thread
        try:
            self.close()
        except Exception:
            pass


class NativeWavSink:
    """Streaming WAV writer with a native background encode thread.

    A drop-in for ``io.wav.WavWriter`` where throughput matters: ``append``
    copies into a bounded queue and returns (its source may be reused at
    once); the writes happen off the GIL. The header's sizes are patched on
    ``close``.
    """

    def __init__(self, path, sample_rate: int, num_channels: int, *, depth: int = 4):
        lib = load()
        if num_channels < 1:
            raise ValueError(f"channels must be >= 1, got {num_channels}")
        self.num_channels = num_channels
        self._handle = lib.dsp_sink_open(str(path).encode(), sample_rate, num_channels, depth)
        if not self._handle:
            raise NativeUnavailable(f"dsp_sink_open failed for {path}")
        self._lib = lib

    def append(self, samples) -> None:
        """Queue int16 samples (a NumPy array, or a contiguous int16 CPU tensor)."""
        if isinstance(samples, torch.Tensor):
            if samples.dtype != torch.int16 or samples.device.type != "cpu":
                raise ValueError("append expects int16 samples on the host")
            s = samples.reshape(-1).contiguous()
            size, ptr = s.numel(), s.data_ptr()
        else:
            s = np.ascontiguousarray(samples, dtype=np.int16).reshape(-1)
            size, ptr = s.size, s.ctypes.data
        if size % self.num_channels != 0:
            raise ValueError(f"append expects whole frames of {self.num_channels} channels")
        rc = self._lib.dsp_sink_append(self._handle, ptr, size)
        if rc != 0:
            raise IOError(f"native sink append failed ({rc})")

    def close(self) -> int:
        if self._handle is None:
            return 0
        total = int(self._lib.dsp_sink_close(self._handle))
        self._handle = None
        if total < 0:
            raise IOError("native sink write error")
        return total

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = [
    "NativeUnavailable",
    "NativeChunkStream",
    "NativeWavSink",
    "available",
    "bench_moving_average_native",
    "build",
    "compiler_version",
    "host_cpu_model",
    "library_path",
    "load",
    "moving_average_native",
    "read_wav_native",
    "read_wavs_concat_native",
    "wav_info_native",
    "write_wav_native",
]
