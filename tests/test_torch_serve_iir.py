"""The port's IIR serving loop (``stream_sosfilt``) against the JAX package and one shot.

Everything runs on the CPU (``device="cpu"``), where ``sosfilt_chunk`` takes
its plain version. The rule is the JAX package's own
(tests/test_serve.py:92-94): the chunked stream is within 1 LSB of the
one-shot ``sosfilt`` of the concatenated stream, on fewer than 0.2% of the
samples (float32 state hand-off moves the rounding of a few samples).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu import serve as jax_serve
from digital_signal_processsing_tpu_torch.io import read_wav, write_wav
from digital_signal_processsing_tpu_torch.ops import iir
from digital_signal_processsing_tpu_torch.serve import stream_sosfilt
from digital_signal_processsing_tpu_torch.utils import last_choice


def write_inputs(rng, tmp_path, channels, frames):
    paths, parts = [], []
    for i, f in enumerate(frames):
        x = (rng.standard_normal(f * channels) * 8000).astype(np.int16)
        paths.append(tmp_path / f"s{i}.wav")
        write_wav(paths[-1], x, 16000, channels)
        parts.append(x)
    return paths, np.concatenate(parts)


def one_shot(sos, full, channels):
    planar = torch.from_numpy(full.reshape(-1, channels).T.astype(np.float32))
    y = iir.sosfilt(sos, planar).numpy()
    return np.clip(np.rint(y.T.reshape(-1)), -32768, 32767).astype(np.int16)


def lsb_rule(got, want):
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 2e-3


@pytest.mark.parametrize(
    "channels,frames,chunk",
    [(2, (3000, 1700, 2501), 1 << 11), (1, (5000, 333), 1000), (3, (2048,), 4096)],
)
def test_stream_sosfilt_matches_jax_and_one_shot(rng, tmp_path, channels, frames, chunk):
    sos = iir.design_butterworth(6, 0.15)
    paths, full = write_inputs(rng, tmp_path, channels, frames)
    written = stream_sosfilt(paths, tmp_path / "port.wav", sos, chunk_samples=chunk, device="cpu")
    assert last_choice("sosfilt_chunk") in ("xla_scan", "pallas_fused")
    jax_written = jax_serve.stream_sosfilt(paths, tmp_path / "jax.wav", sos, chunk_samples=chunk)
    info, got = read_wav(tmp_path / "port.wav")
    _, jgot = read_wav(tmp_path / "jax.wav")
    assert written == jax_written == full.size == got.size
    assert (info.num_channels, info.sample_rate) == (channels, 16000)
    lsb_rule(got, one_shot(sos, full, channels))
    lsb_rule(got, jgot)


def test_stream_sosfilt_rejects_mixed_files(tmp_path):
    sos = iir.design_butterworth(2, 0.3)
    write_wav(tmp_path / "a.wav", np.zeros(100, np.int16), 8000, 1)
    write_wav(tmp_path / "b.wav", np.zeros(100, np.int16), 16000, 1)
    write_wav(tmp_path / "c.wav", np.zeros(100, np.int16), 8000, 2)
    for other in ("b.wav", "c.wav"):
        with pytest.raises(ValueError):
            stream_sosfilt([tmp_path / "a.wav", tmp_path / other], tmp_path / "o.wav", sos,
                           device="cpu")


def test_stream_sosfilt_needs_a_card_for_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_wav(tmp_path / "a.wav", np.zeros(100, np.int16), 8000, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_sosfilt([tmp_path / "a.wav"], tmp_path / "o.wav", iir.design_butterworth(2, 0.3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        iir.sosfilt_init(iir.design_butterworth(2, 0.3), (2,))
