"""The port's streaming averager and WAV serving against one shot and the JAX package.

Everything runs on the CPU (``device="cpu"``), where the kernel wrappers
take their plain PyTorch versions; the outputs must equal the one-shot
golden result and the JAX package's outputs byte for byte.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu import serve as jax_serve
from digital_signal_processsing_tpu.__main__ import main as jax_cli
from digital_signal_processsing_tpu.ops.streaming import (
    moving_average_chunk as jax_chunk,
)
from digital_signal_processsing_tpu.ops.streaming import (
    moving_average_init as jax_init,
)
from digital_signal_processsing_tpu_torch.__main__ import main as port_cli
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.io import read_wav, write_wav
from digital_signal_processsing_tpu_torch.ops import (
    moving_average_chunk,
    moving_average_init,
    state_from_jax,
)
from digital_signal_processsing_tpu_torch.serve import run_chunks, stream_moving_average
from tests.conftest import make_interleaved


def stream_chunks(x: np.ndarray, lengths, window: int, channels: int) -> np.ndarray:
    state = moving_average_init(window, channels, device="cpu")
    outs, i = [], 0
    for ln in lengths:
        state, y = moving_average_chunk(state, torch.from_numpy(x[i : i + ln]), window, channels)
        outs.append(y.numpy())
        i += ln
    assert i == x.size
    return np.concatenate(outs)


@pytest.mark.parametrize("window,channels", [(16, 2), (300, 2), (7, 1)])
def test_chunked_equals_one_shot(rng, window, channels):
    # uneven chunk sizes, including one smaller than the halo
    x = make_interleaved(rng, 5000, channels)
    bounds = [0, 100 * channels, 700 * channels, 1500 * channels, x.size]
    lengths = np.diff(bounds).tolist()
    np.testing.assert_array_equal(
        stream_chunks(x, lengths, window, channels), moving_average_golden(x, window, channels)
    )


def test_chunked_equal_chunks(rng):
    window, channels = 32, 2
    x = make_interleaved(rng, 4096, channels)
    np.testing.assert_array_equal(
        stream_chunks(x, [1024] * 8, window, channels),
        moving_average_golden(x, window, channels),
    )


def test_chunked_mixed_lengths(rng):
    window, channels = 100, 2
    lengths = [1280, 1000, 2560, 56, 128, 0, 2]
    x = make_interleaved(rng, sum(lengths) // channels, channels)
    np.testing.assert_array_equal(
        stream_chunks(x, lengths, window, channels), moving_average_golden(x, window, channels)
    )


def test_chunked_giant_halo(rng):
    # halo 8192*128 is beyond the windowed kernel: the two-pass branch
    c, w = 128, 8192
    x = make_interleaved(rng, 2**21 // c, c)
    np.testing.assert_array_equal(
        stream_chunks(x, [2**20, 2**20], w, c), moving_average_golden(x, w, c)
    )


@pytest.mark.parametrize("window,channels", [(64, 2), (5000, 16)])
def test_state_carried_over_from_jax(rng, window, channels):
    # the JAX package filters the first chunks; the port finishes the stream
    x = make_interleaved(rng, 6000, channels)
    cut = [0, 1024 * channels, 2048 * channels]
    jstate = jax_init(window, channels)
    outs = []
    for a, b in zip(cut[:-1], cut[1:]):
        jstate, y = jax_chunk(jstate, x[a:b], window, channels)
        outs.append(np.asarray(y))
    state = state_from_jax(np.asarray(jstate.tail), device="cpu")
    for a, b in [(cut[-1], 4000 * channels), (4000 * channels, x.size)]:
        state, y = moving_average_chunk(state, torch.from_numpy(x[a:b]), window, channels)
        outs.append(y.numpy())
    np.testing.assert_array_equal(
        np.concatenate(outs), moving_average_golden(x, window, channels)
    )


def test_state_must_match_the_window(rng):
    state = moving_average_init(8, 2, device="cpu")
    with pytest.raises(ValueError, match="window\\*channels"):
        moving_average_chunk(state, torch.zeros(64, dtype=torch.int16), 16, 2)
    with pytest.raises(ValueError, match="int16"):
        state_from_jax(np.zeros(8, np.int32), device="cpu")


def write_inputs(rng, tmp_path, channels=2, sizes=(30000, 17034)):
    xs = [rng.integers(-32768, 32768, size=n, dtype=np.int16) for n in sizes]
    paths = []
    for i, x in enumerate(xs):
        paths.append(tmp_path / f"in{i}.wav")
        write_wav(paths[-1], x, 44100, channels)
    return paths, np.concatenate(xs)


@pytest.mark.parametrize("window,chunk", [(257, 8192), (16, 1000), (5000, 4096)])
def test_stream_moving_average_matches_jax_bytes(rng, tmp_path, window, chunk):
    paths, full = write_inputs(rng, tmp_path)
    written = stream_moving_average(
        paths, tmp_path / "port.wav", window, chunk_samples=chunk, device="cpu"
    )
    jax_written = jax_serve.stream_moving_average(
        paths, tmp_path / "jax.wav", window, chunk_samples=chunk
    )
    assert written == jax_written == full.size
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    info, got = read_wav(tmp_path / "port.wav")
    assert info.num_channels == 2
    np.testing.assert_array_equal(got, moving_average_golden(full, window, 2))


def test_stream_rejects_mixed_channels(rng, tmp_path):
    write_wav(tmp_path / "a.wav", np.zeros(100, np.int16), 8000, 2)
    write_wav(tmp_path / "b.wav", np.zeros(100, np.int16), 8000, 1)
    with pytest.raises(ValueError, match="channels"):
        stream_moving_average(
            [tmp_path / "a.wav", tmp_path / "b.wav"], tmp_path / "o.wav", 4, device="cpu"
        )


def test_cli_round_trip(rng, tmp_path):
    x = rng.integers(-32768, 32768, size=20000, dtype=np.int16)
    write_wav(tmp_path / "in.wav", x, 8000, 2)
    assert port_cli([str(tmp_path / "in.wav"), "16", "--out", str(tmp_path / "port.wav"),
                     "--device", "cpu"]) == 0
    assert jax_cli([str(tmp_path / "in.wav"), "16", "--out", str(tmp_path / "jax.wav")]) == 0
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    info, got = read_wav(tmp_path / "port.wav")
    assert (info.num_channels, info.sample_rate) == (2, 8000)
    np.testing.assert_array_equal(got, moving_average_golden(x, 16, 2))


def test_run_chunks_generic(rng):
    x = make_interleaved(rng, 3000, 1)
    state = moving_average_init(40, 1, device="cpu")
    chunks = [torch.from_numpy(x[a:b]) for a, b in [(0, 1000), (1000, 1001), (1001, 3000)]]
    outs = list(run_chunks(lambda s, c: moving_average_chunk(s, c, 40, 1), state, chunks))
    np.testing.assert_array_equal(np.concatenate(outs), moving_average_golden(x, 40, 1))
