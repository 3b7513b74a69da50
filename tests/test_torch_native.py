"""The port's native host runtime (``io/native.py``) against the JAX package's.

The port builds ``native/dsp_native.cpp`` with g++ into its own ``_build/``
and binds it with its own ctypes signatures. Here, on the CPU: the codec's
files byte for byte against the JAX package's ``io.native`` and the port's
NumPy codec, ``moving_average_native`` bit-exact against golden and the JAX
package's, the argument errors, ``NativeChunkStream``'s chunks and valid
counts against the JAX package's stream, the sink, two builds started at once
in two processes, a failed build raising, and ``stream_moving_average``'s
native branch (``device="cpu"``, the plain B1) byte for byte against the JAX
package's native branch, also on a truncated file and a file whose data size
is 0xFFFFFFFF. Skipped only where there is no C++ compiler, as
``tests/test_native.py`` is.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu import serve as jax_serve
from digital_signal_processsing_tpu.io import native as jax_native
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.io import native, read_wav, write_wav
from digital_signal_processsing_tpu_torch.io.wav import WavWriter
from digital_signal_processsing_tpu_torch.serve import stream_moving_average
from tests.conftest import make_interleaved

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")

REPO = Path(__file__).resolve().parents[1]


def test_library_is_built_into_the_package():
    lib = native.load()
    so = native.library_path()
    assert so.is_file() and so.parent == native.BUILD_DIR
    assert so.parent.parent.name == "digital_signal_processsing_tpu_torch"
    assert native.SOURCE == REPO / "native" / "dsp_native.cpp"
    assert native.available() and native.load() is lib
    assert native.compiler_version()


def test_wav_roundtrip(tmp_path, rng):
    x = make_interleaved(rng, 5000, 2)
    native.write_wav_native(tmp_path / "n.wav", x, 44100, 2)
    ch, rate, got = native.read_wav_native(tmp_path / "n.wav")
    assert (ch, rate) == (2, 44100)
    np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("frames, channels, rate", [(3000, 2, 22050), (1, 1, 8000), (777, 5, 48000)])
def test_files_byte_identical_to_jax_and_the_python_codec(tmp_path, rng, frames, channels, rate):
    x = make_interleaved(rng, frames, channels)
    native.write_wav_native(tmp_path / "port.wav", x, rate, channels)
    jax_native.write_wav_native(tmp_path / "jax.wav", x, rate, channels)
    write_wav(tmp_path / "py.wav", x, rate, channels)
    port = (tmp_path / "port.wav").read_bytes()
    assert port == (tmp_path / "jax.wav").read_bytes() == (tmp_path / "py.wav").read_bytes()
    assert native.wav_info_native(tmp_path / "py.wav") == jax_native.wav_info_native(
        tmp_path / "py.wav") == (channels, rate, x.size)
    _, _, got = native.read_wav_native(tmp_path / "py.wav")
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(read_wav(tmp_path / "port.wav")[1], x)


def test_read_wavs_concat(tmp_path, rng):
    xs = [make_interleaved(rng, n, 2) for n in (1000, 1, 4097)]
    paths = []
    for i, x in enumerate(xs):
        paths.append(tmp_path / f"{i}.wav")
        write_wav(paths[-1], x, 16000, 2)
    got = native.read_wavs_concat_native(paths, num_threads=2)
    want = jax_native.read_wavs_concat_native(paths, num_threads=2)
    assert got[:2] == want[:2] == (2, 16000)
    np.testing.assert_array_equal(got[2], np.concatenate(xs))
    np.testing.assert_array_equal(got[2], want[2])
    write_wav(tmp_path / "mono.wav", xs[0], 16000, 1)
    with pytest.raises(ValueError, match="first"):
        native.read_wavs_concat_native([paths[0], tmp_path / "mono.wav"])


@pytest.mark.parametrize("window, channels", [(1, 1), (16, 2), (1000, 2), (65535, 3), (9000, 1)])
def test_moving_average_native_bit_exact(rng, window, channels):
    x = make_interleaved(rng, 5000, channels)
    got = native.moving_average_native(x, window, channels)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))
    np.testing.assert_array_equal(got, jax_native.moving_average_native(x, window, channels))


def test_moving_average_native_extremes():
    np.testing.assert_array_equal(
        native.moving_average_native(np.array([-3, 0, 0], np.int16), 2, 1), [-1, -1, 0])
    x = np.full(4096, -32768, np.int16)  # the most negative window sums
    for window in (1, 7, 1024):
        np.testing.assert_array_equal(native.moving_average_native(x, window, 2),
                                      moving_average_golden(x, window, 2))


@pytest.mark.parametrize("n, window, channels, match", [
    (10, 0, 1, "window"), (10, 4, 0, "channels"), (9, 4, 2, "multiple"),
])
def test_argument_errors(n, window, channels, match):
    x = np.zeros(n, np.int16)
    for fn in (native.moving_average_native, native.bench_moving_average_native):
        with pytest.raises(ValueError, match=match):
            fn(x, window, channels)


def test_bench_returns_a_time(rng):
    assert native.bench_moving_average_native(make_interleaved(rng, 50_000, 2), 16, 2,
                                              warmup=1, rounds=2) > 0


def write_stream(rng, tmp_path, frames=(1000, 333, 2048), channels=2):
    xs = [make_interleaved(rng, n, channels) for n in frames]
    paths = []
    for i, x in enumerate(xs):
        paths.append(tmp_path / f"in{i}.wav")
        write_wav(paths[-1], x, 44100, channels)
    return paths, np.concatenate(xs)


@pytest.mark.parametrize("chunk", [1, 999, 1000, 4096, 1 << 14])
def test_chunk_stream_equals_jax(rng, tmp_path, chunk):
    paths, full = write_stream(rng, tmp_path)
    got = list(native.NativeChunkStream(paths, chunk, depth=2))
    want = list(jax_native.NativeChunkStream(paths, chunk, depth=2))
    assert [v for _, v in got] == [v for _, v in want]
    assert sum(v for _, v in got) == full.size
    assert all(c.size == chunk for c, _ in got)
    for (c, _), (w, _) in zip(got, want):
        np.testing.assert_array_equal(c, w)
    stream = np.concatenate([c for c, _ in got])
    np.testing.assert_array_equal(stream[: full.size], full)
    assert not stream[full.size :].any()  # the last chunk's zero padding


def test_chunk_stream_read_into_and_refusals(rng, tmp_path):
    paths, full = write_stream(rng, tmp_path)
    stream = native.NativeChunkStream(paths, 4000)
    buf = torch.empty(4000, dtype=torch.int16)
    got, n = [], stream.read_into(buf)
    while n:
        got.append(buf[:n].clone())
        n = stream.read_into(buf)
    np.testing.assert_array_equal(torch.cat(got).numpy(), full)
    assert stream.read_into(buf) == 0  # closed at the end: stays at the end
    s2 = native.NativeChunkStream(paths, 4000)
    for bad in (torch.empty(3999, dtype=torch.int16), torch.empty(4000, dtype=torch.int32),
                torch.empty(8000, dtype=torch.int16)[::2]):
        with pytest.raises(ValueError, match="int16 host buffer"):
            s2.read_into(bad)
    s2.close()
    with pytest.raises(ValueError, match="no input files"):
        native.NativeChunkStream([], 16)
    with pytest.raises(ValueError, match="chunk_samples"):
        native.NativeChunkStream(paths, 0)
    (tmp_path / "bad.wav").write_bytes(b"RIFF" + bytes(60))
    with pytest.raises(IOError, match="decode error"):
        list(native.NativeChunkStream([tmp_path / "bad.wav"], 16))


def test_sink_byte_identical_to_the_python_writer(rng, tmp_path):
    x = make_interleaved(rng, 3001, 2)
    with native.NativeWavSink(tmp_path / "n.wav", 48000, 2, depth=2) as sink:
        sink.append(x[:1000])
        sink.append(torch.from_numpy(x[1000:4000]))
        sink.append(x[4000:])
    with WavWriter(tmp_path / "p.wav", 48000, 2) as w:
        w.append(x)
    assert (tmp_path / "n.wav").read_bytes() == (tmp_path / "p.wav").read_bytes()
    sink = native.NativeWavSink(tmp_path / "o.wav", 48000, 2)
    with pytest.raises(ValueError, match="whole frames"):
        sink.append(x[:3])
    assert sink.close() == 0 and sink.close() == 0
    with pytest.raises(ValueError, match="channels"):
        native.NativeWavSink(tmp_path / "z.wav", 48000, 0)


BUILD = """
import sys
from pathlib import Path
import numpy as np
from digital_signal_processsing_tpu_torch.io import native
native.BUILD_DIR = Path(sys.argv[1])
so = native.build()
x = np.arange(-50, 50, dtype=np.int16)
assert (native.moving_average_native(x, 4, 2) == native.moving_average_native(x, 4, 2)).all()
print(so)
"""


def test_two_builds_started_at_once(tmp_path):
    procs = [
        subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path / "build")], cwd=REPO,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert outs[0][0] == outs[1][0]
    assert [p.name for p in (tmp_path / "build").iterdir()] == [Path(outs[0][0].strip()).name]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
    with pytest.raises(native.NativeUnavailable, match="no-such-flag"):
        native.build()
    assert not list(tmp_path.iterdir())  # no half-written library left behind
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(native.NativeUnavailable, match="no C\\+\\+ compiler"):
        native.build()


def write_inputs(rng, tmp_path, frames=(4000, 2501), channels=2, rate=44100):
    paths, xs = [], []
    for i, n in enumerate(frames):
        xs.append(make_interleaved(rng, n, channels))
        paths.append(tmp_path / f"in{i}.wav")
        write_wav(paths[-1], xs[-1], rate, channels)
    return paths, np.concatenate(xs)


def serve_both(paths, tmp_path, window, chunk):
    written = stream_moving_average(paths, tmp_path / "port.wav", window, chunk_samples=chunk,
                                    use_native=True, device="cpu")
    jax_written = jax_serve.stream_moving_average(paths, tmp_path / "jax.wav", window,
                                                  chunk_samples=chunk, use_native=True)
    assert written == jax_written
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    return written


@pytest.mark.parametrize("window, chunk", [(257, 8192), (16, 1001), (5000, 4096), (1, 2), (3, 1 << 20)])
def test_native_serving_matches_jax_bytes(rng, tmp_path, window, chunk):
    paths, full = write_inputs(rng, tmp_path)
    assert serve_both(paths, tmp_path, window, chunk) == full.size
    np.testing.assert_array_equal(read_wav(tmp_path / "port.wav")[1],
                                  moving_average_golden(full, window, 2))
    stream_moving_average(paths, tmp_path / "py.wav", window, chunk_samples=chunk,
                          use_native=False, device="cpu")
    assert (tmp_path / "py.wav").read_bytes() == (tmp_path / "port.wav").read_bytes()


def test_native_serving_of_a_truncated_file(rng, tmp_path):
    paths, full = write_inputs(rng, tmp_path)
    raw = paths[0].read_bytes()
    paths[0].write_bytes(raw[: len(raw) - 2 * 1000])  # the header claims 500 frames more
    assert serve_both(paths, tmp_path, 64, 2048) == full.size - 1000
    kept = np.concatenate([full[: 8000 - 1000], full[8000:]])
    np.testing.assert_array_equal(read_wav(tmp_path / "port.wav")[1],
                                  moving_average_golden(kept, 64, 2))


def test_native_serving_of_a_streaming_capture_size(rng, tmp_path):
    paths, full = write_inputs(rng, tmp_path)
    raw = bytearray(paths[1].read_bytes())
    raw[40:44] = (0xFFFFFFFF).to_bytes(4, "little")  # a capture that never patched its size
    paths[1].write_bytes(bytes(raw))
    assert serve_both(paths, tmp_path, 100, 3000) == full.size
    np.testing.assert_array_equal(read_wav(tmp_path / "port.wav")[1],
                                  moving_average_golden(full, 100, 2))


@pytest.mark.parametrize("what", ["channels", "sample rate"])
def test_native_serving_refuses_mixed_inputs_as_jax(rng, tmp_path, what):
    write_wav(tmp_path / "a.wav", np.zeros(100, np.int16), 8000, 2)
    if what == "channels":
        write_wav(tmp_path / "b.wav", np.zeros(100, np.int16), 8000, 1)
    else:
        write_wav(tmp_path / "b.wav", np.zeros(100, np.int16), 16000, 2)
    paths = [tmp_path / "a.wav", tmp_path / "b.wav"]
    with pytest.raises(ValueError, match=what) as port_err:
        stream_moving_average(paths, tmp_path / "o.wav", 4, use_native=True, device="cpu")
    with pytest.raises(ValueError, match=what) as jax_err:
        jax_serve.stream_moving_average(paths, tmp_path / "j.wav", 4, use_native=True)
    assert str(port_err.value) == str(jax_err.value)
    assert not (tmp_path / "o.wav").exists()


def test_native_is_the_default_and_the_card_is_still_required(rng, tmp_path, monkeypatch):
    paths, full = write_inputs(rng, tmp_path, frames=(300,))
    calls = []
    real = native.NativeChunkStream
    monkeypatch.setattr(native, "NativeChunkStream", lambda *a, **k: calls.append(a) or real(*a, **k))
    assert stream_moving_average(paths, tmp_path / "o.wav", 8, device="cpu") == full.size
    assert len(calls) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stream_moving_average(paths, tmp_path / "o.wav", 8, use_native=True)
