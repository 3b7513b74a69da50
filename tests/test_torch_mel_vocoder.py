"""The port's mel features (``ops/mel.py``), phase vocoder
(``ops/phase_vocoder.py``) and their serving loops (``serve.stream_mfcc``,
``serve.stream_time_stretch``) against the JAX package.

The same seeded NumPy inputs (and the same WAV files) go through the JAX
package and the port on the CPU. The filterbank, the DCT and the mel scale
are NumPy copies: equal to the reference's bit for bit.

Tolerances (relative to max|want|):

- 1e-5 (``TOL``) for the mel spectrogram, the MFCCs and the deltas, and
  against float64 NumPy evaluations of the same formulas;
- the phase vocoder on tones: the synthesis phase is a running sum that
  grows to thousands of radians over a stream; the JAX package keeps it in
  float32, to about 1e-7 of that, and differs from a float64 evaluation of
  the same algorithm (``ts64``) by about 1e-4 of max|y| at these sizes.
  The port carries the phase chain in float64 and wraps it before the
  synthesis (about 1.5e-5 here). It is held to float64 and to the JAX
  package within twice the JAX package's own measured error against
  float64 (``vocoder_tol``); over a longer stream (2^17 samples at nfft
  2048, 254 frames) to float64 within 1e-4, where the JAX package's float32
  phase errs 2.2e-3 (``test_time_stretch_keeps_its_phase_over_long_streams``);
  and
  ``pitch_shift`` to the JAX package within the same bound at its stretch
  rate (the Farrow resampler adds about 1e-7). Its phase wrap
  (``_princarg``) rounds p / 2 pi to the nearest integer; where two
  implementations land on either side of a half, that bin's phase jumps by
  2 pi (the reference's own chunked-vs-one-shot test allows 2e-2 on tones
  for that reason, tests/test_phase_vocoder.py:69-99). So the inputs are
  tones on bin centres, the analysis hops odd multiples of a power of two
  away from a half, and noise is not compared;
- the served time stretch: int16, against the float64 evaluation of the
  stream the loop sees, within 1 LSB or twice the JAX loop's own largest
  error, whichever is larger; the served MFCCs within ``TOL``.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu import serve as jserve
from digital_signal_processsing_tpu.io import read_wav, write_wav
from digital_signal_processsing_tpu.ops import mel as jmel
from digital_signal_processsing_tpu.ops import phase_vocoder as jpv
from digital_signal_processsing_tpu_torch import serve as tserve
from digital_signal_processsing_tpu_torch.ops import mel as tmel
from digital_signal_processsing_tpu_torch.ops import phase_vocoder as tpv
from digital_signal_processsing_tpu_torch.ops import streaming as tstream

TOL = 1e-5
FS = 16000.0


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def audio():
    r = np.random.default_rng(1803)
    n = np.arange(12288)
    tone = 0.3 * np.sin(2 * np.pi * 440 * n / FS) + 0.2 * np.sin(2 * np.pi * 1330 * n / FS)
    return (tone[None] + 0.05 * r.standard_normal((2, n.size))).astype(np.float32)


def tones(channels: int, t: int, nfft: int) -> np.ndarray:
    """Sums of two tones on bin centres of ``nfft``, one pair a channel."""
    n = np.arange(t)
    rows = [0.4 * np.sin(2 * np.pi * (17 + 5 * c) * n / nfft) + 0.3 * np.cos(2 * np.pi * (60 + 3 * c) * n / nfft)
            for c in range(channels)]
    return np.stack(rows).astype(np.float32)


def ts64(x, rate: float, nfft: int) -> np.ndarray:
    """The phase vocoder's time stretch in float64 NumPy (the reference's
    algorithm, sample for sample)."""
    x = np.asarray(x, np.float64)
    hs = nfft // 4
    ha = max(1, int(round(hs * rate)))
    k = np.arange(nfft)
    w = np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * k / nfft))
    frames = (x.shape[-1] - nfft) // ha + 1
    s = np.fft.rfft(x[..., np.arange(frames)[:, None] * ha + k] * w, axis=-1)
    mag, ph = np.abs(s), np.angle(s)
    wk = 2 * np.pi * np.arange(nfft // 2 + 1) / nfft
    dph = ph[..., 1:, :] - ph[..., :-1, :] - wk * ha
    inst = wk + (dph - 2 * np.pi * np.round(dph / (2 * np.pi))) / ha
    phs = np.concatenate([ph[..., :1, :], ph[..., :1, :] + np.cumsum(hs * inst, axis=-2)], axis=-2)
    seg = np.fft.irfft(mag * np.exp(1j * phs), n=nfft, axis=-1) * w
    y = np.zeros(x.shape[:-1] + ((frames - 1) * hs + nfft,))
    for f in range(frames):
        y[..., f * hs : f * hs + nfft] += seg[..., f, :]
    return y * (2.0 * hs / nfft)


def vocoder_tol(jax_out, want64) -> float:
    return max(TOL, 2.0 * rel(jax_out, want64))


def test_host_designs_equal_the_reference():
    for htk in (False, True):
        f = np.array([0.0, 500.0, 1000.0, 4000.0, 8000.0])
        np.testing.assert_array_equal(tmel.hz_to_mel(f, htk=htk), jmel.hz_to_mel(f, htk=htk))
        np.testing.assert_array_equal(tmel.mel_to_hz(f / 100, htk=htk), jmel.mel_to_hz(f / 100, htk=htk))
        np.testing.assert_array_equal(tmel.mel_frequencies(12, fmax=7000.0, htk=htk),
                                      jmel.mel_frequencies(12, fmax=7000.0, htk=htk))
        for norm in ("slaney", None):
            np.testing.assert_array_equal(tmel.mel_filterbank(40, 512, FS, fmin=50.0, htk=htk, norm=norm),
                                          jmel.mel_filterbank(40, 512, FS, fmin=50.0, htk=htk, norm=norm))
    np.testing.assert_array_equal(tmel.dct_matrix(13, 40), jmel.dct_matrix(13, 40))


@pytest.mark.parametrize("lifter", [0.0, 22.0])
def test_mel_features_match_jax_and_float64(audio, lifter):
    kw = dict(sample_rate=FS, nfft=512, hop=256, n_mels=40)
    ms = tmel.melspectrogram(t_(audio), **kw)
    assert rel(ms, jmel.melspectrogram(audio, **kw)) < TOL
    n = (audio.shape[-1] - 512) // 256 + 1
    idx = np.arange(n)[:, None] * 256 + np.arange(512)[None, :]
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(512) / 512)
    p64 = np.abs(np.fft.rfft(audio.astype(np.float64)[..., idx] * w, axis=-1)) ** 2
    ms64 = p64 @ tmel.mel_filterbank(40, 512, FS).astype(np.float64).T
    assert rel(ms, ms64) < TOL
    lm = tmel.log_melspectrogram(t_(audio), **kw)
    assert rel(lm, jmel.log_melspectrogram(audio, **kw)) < TOL
    c = tmel.mfcc(t_(audio), n_mfcc=13, lifter=lifter, **kw)
    assert rel(c, jmel.mfcc(audio, n_mfcc=13, lifter=lifter, **kw)) < TOL
    c64 = np.log(np.maximum(ms64, 1e-10)) @ tmel.dct_matrix(13, 40).astype(np.float64).T
    if lifter:
        k = np.arange(13)
        c64 = c64 * (1 + lifter / 2 * np.sin(np.pi * (k + 1) / lifter))
    assert rel(c, c64) < TOL
    assert rel(tmel.delta(c), jmel.delta(np.asarray(jmel.mfcc(audio, n_mfcc=13, lifter=lifter, **kw)))) < TOL
    assert rel(tmel.delta(c, width=5), jmel.delta(c.numpy(), width=5)) < TOL
    assert rel(tmel.mfcc(t_(audio[0]), n_mfcc=13, lifter=lifter, **kw), c[0].numpy()) < TOL


def test_mfcc_chunks_match_primed_one_shot_and_jax(audio):
    kw = dict(sample_rate=FS, n_mfcc=13, nfft=512, hop=256, n_mels=40)
    st = tmel.mfcc_init(512, 256, 2, device="cpu")
    jst = jmel.mfcc_init(512, 256, 2)
    outs, jouts = [], []
    for a, b in ((0, 256), (256, 4096), (4096, 7936), (7936, 12288)):
        st, c = tmel.mfcc_chunk(st, t_(audio[:, a:b]), **kw)
        jst, jc = jmel.mfcc_chunk(jst, audio[:, a:b], **kw)
        outs.append(c)
        jouts.append(np.asarray(jc))
    got = torch.cat(outs, 1)
    primed = np.concatenate([np.zeros((2, 256), np.float32), audio], -1)
    one = tmel.mfcc(t_(primed), sample_rate=FS, n_mfcc=13, nfft=512, hop=256, n_mels=40)
    assert rel(got, one) < TOL
    assert rel(got, np.concatenate(jouts, 1)) < TOL
    # a JAX stream continues in the port (the MFCC state is the STFT state)
    jst = jmel.mfcc_init(512, 256, 2)
    jst, head = jmel.mfcc_chunk(jst, audio[:, :4096], **kw)
    pst = tstream.stft_state_from_jax(np.asarray(jst.tail), device="cpu")
    pst, rest = tmel.mfcc_chunk(pst, t_(audio[:, 4096:]), **kw)
    assert rel(torch.cat([t_(np.asarray(head)), rest], 1), one) < TOL


@pytest.mark.parametrize("rate", [1.25, 0.8])
def test_time_stretch_on_tones_matches_jax_and_float64(rate):
    x = tones(2, 16384, 1024)
    want64 = ts64(x, rate, 1024)
    j = jpv.time_stretch(x, rate, nfft=1024)
    tol = vocoder_tol(j, want64)
    got = tpv.time_stretch(t_(x), rate, nfft=1024)
    assert rel(got, want64) < tol and rel(got, j) < tol
    assert rel(tpv.time_stretch(t_(x[1]), rate, nfft=1024), got[1].numpy()) < TOL


def test_time_stretch_keeps_its_phase_over_long_streams():
    x = tones(2, 1 << 17, 2048)
    rate = 2 ** (-3 / 12)
    want64 = ts64(x, rate, 2048)
    assert rel(tpv.time_stretch(t_(x), rate), want64) < 1e-4
    st = tpv.time_stretch_init(rate, channels=2, device="cpu")
    ha = round(512 * rate)
    st, y = tpv.time_stretch_chunk(st, t_(x[:, : 100 * ha]), rate=rate)
    st, z = tpv.time_stretch_chunk(st, t_(x[:, 100 * ha : 250 * ha]), rate=rate)
    streamed = torch.cat([y, z, tpv.time_stretch_flush(st)], -1)
    assert rel(streamed, ts64(np.pad(x[:, : 250 * ha], ((0, 0), (2048 - ha, 0))), rate, 2048)) < 1e-4


def test_pitch_shift_on_tones_matches_jax():
    x = tones(2, 16384, 1024)
    factor = 2 ** (3 / 12)
    tol = vocoder_tol(jpv.time_stretch(x, 1 / factor, nfft=1024), ts64(x, 1 / factor, 1024))
    got = tpv.pitch_shift(t_(x), factor, nfft=1024)
    assert rel(got, jpv.pitch_shift(x, factor, nfft=1024)) < tol


def test_time_stretch_chunks_match_jax_and_continue_from_jax():
    x = tones(2, 16384, 1024)
    rate, nfft = 1.25, 1024
    ha = max(1, round(nfft // 4 * rate))
    cuts = (0, ha, 5 * ha, 20 * ha, 51 * ha)
    st = tpv.time_stretch_init(rate, nfft=nfft, channels=2, device="cpu")
    jst = jpv.time_stretch_init(rate, nfft=nfft, channels=2)
    outs, jouts = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        st, y = tpv.time_stretch_chunk(st, t_(x[:, a:b]), rate=rate, nfft=nfft)
        jst, jy = jpv.time_stretch_chunk(jst, x[:, a:b], rate=rate, nfft=nfft)
        outs.append(y)
        jouts.append(np.asarray(jy))
    got = torch.cat(outs + [tpv.time_stretch_flush(st)], -1)
    want = np.concatenate(jouts + [np.asarray(jpv.time_stretch_flush(jst))], -1)
    # the stream is the one shot of the input primed with nfft - ha zeros
    want64 = ts64(np.pad(x[:, : 51 * ha], ((0, 0), (nfft - ha, 0))), rate, nfft)
    tol = vocoder_tol(want, want64)
    assert rel(got, want64) < tol and rel(got, want) < tol
    # the JAX state carries over: the port continues the JAX stream
    jst = jpv.time_stretch_init(rate, nfft=nfft, channels=2)
    jst, head = jpv.time_stretch_chunk(jst, x[:, : 20 * ha], rate=rate, nfft=nfft)
    pst = tpv.time_stretch_state_from_jax(jst, device="cpu")
    assert pst.started
    pst, tail = tpv.time_stretch_chunk(pst, t_(x[:, 20 * ha : 51 * ha]), rate=rate, nfft=nfft)
    got = np.concatenate([np.asarray(head), tail.numpy(), tpv.time_stretch_flush(pst).numpy()], -1)
    assert rel(got, want64) < tol
    y1 = tpv.time_stretch_chunk(tpv.time_stretch_init(rate, nfft=nfft, device="cpu"), t_(x[0, :ha]),
                                rate=rate, nfft=nfft)[1]
    assert y1.shape == (nfft // 4,)


def test_spectral_subtract(audio):
    got = tpv.spectral_subtract(t_(audio), nfft=512)
    assert rel(got, jpv.spectral_subtract(audio, nfft=512)) < TOL
    noise = np.full(257, 0.5, np.float32)
    got = tpv.spectral_subtract(t_(audio[0]), nfft=512, noise_psd=noise, floor=0.1)
    assert rel(got, jpv.spectral_subtract(audio[0], nfft=512, noise_psd=noise, floor=0.1)) < TOL


def test_refusals(audio):
    x = t_(audio)
    cases = [
        lambda: tmel.mel_filterbank(0, 512, FS),
        lambda: tmel.mel_filterbank(40, 512, FS, fmin=9000.0),
        lambda: tmel.mel_filterbank(40, 512, FS, norm="area"),
        lambda: tmel.dct_matrix(13, 40, norm="none"),
        lambda: tmel.mfcc(x, sample_rate=FS, n_mfcc=50, n_mels=40),
        lambda: tmel.mfcc(x, sample_rate=FS, lifter=-1.0),
        lambda: tmel.mfcc_chunk(tmel.mfcc_init(512, 256, 2, device="cpu"), x[:, :256], sample_rate=FS,
                                n_mfcc=0, nfft=512, hop=256),
        lambda: tmel.mfcc_init(512, 200, device="cpu"),
        lambda: tmel.delta(torch.zeros(10, 3), width=4),
        lambda: tmel.delta(torch.zeros(10)),
        lambda: tpv.time_stretch(x, 0.0),
        lambda: tpv.time_stretch(x, 1.0, window="hann"),
        lambda: tpv.time_stretch(x[:, :1000], 1.0),
        lambda: tpv.pitch_shift(x, -1.0),
        lambda: tpv.time_stretch_init(0.0, device="cpu"),
        lambda: tpv.time_stretch_chunk(tpv.time_stretch_init(1.0, nfft=512, channels=2, device="cpu"),
                                       x[:, :100], rate=1.0, nfft=512),
        lambda: tpv.spectral_subtract(x, floor=1.0),
        lambda: tpv.spectral_subtract(x[:, :2048], nfft=512, noise_frames=8),
    ]
    for case in cases:
        with pytest.raises(ValueError):
            case()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """Two stereo WAVs as one stream, the second of odd frame count."""
    tmp = tmp_path_factory.mktemp("wavs")
    r = np.random.default_rng(1804)
    n = np.arange(30001)
    tone = 6000 * np.sin(2 * np.pi * 440 * n / FS)
    a = np.stack([tone[:20480], -tone[:20480]], 1) + r.normal(0, 300, (20480, 2))
    b = np.stack([tone[:9521], tone[:9521]], 1) + r.normal(0, 300, (9521, 2))
    write_wav(tmp / "a.wav", np.round(a).astype(np.int16).reshape(-1), int(FS), 2)
    write_wav(tmp / "b.wav", np.round(b).astype(np.int16).reshape(-1), int(FS), 2)
    return tmp, [tmp / "a.wav", tmp / "b.wav"]


def test_stream_mfcc_matches_the_jax_loop(wavs):
    tmp, paths = wavs
    got = tserve.stream_mfcc(paths, tmp / "port.npy", chunk_samples=6000, device="cpu")
    want = jserve.stream_mfcc(paths, chunk_samples=6000)
    assert got.shape == want.shape == (2, (30001 + 255) // 256, 13)
    assert rel(got, want) < TOL
    np.testing.assert_array_equal(np.load(tmp / "port.npy"), got)
    # one shot of the zero-primed, hop-padded stream
    pcm = np.concatenate([read_wav(p)[1].reshape(-1, 2).T for p in paths], -1) / 32768.0
    pcm = np.pad(pcm.astype(np.float32), ((0, 0), (256, (-30001) % 256)))
    one = tmel.mfcc(t_(pcm), sample_rate=FS, n_mfcc=13, nfft=512, hop=256, n_mels=40)
    assert rel(got, one) < TOL


def test_stream_time_stretch_on_tones_matches_the_jax_loop(tmp_path):
    """Two stereo WAVs of tones on bin centres (the second of odd frame
    count) through both loops and a float64 evaluation of the stream the
    loop sees: the loader's chunks (the last zero-padded), the remainder
    padded to a hop, primed with nfft - ha zeros."""
    nfft, rate, chunk = 1024, 1.25, 8192
    x = np.round(16000 * tones(2, 30001, nfft)).astype(np.int16)
    paths = [tmp_path / "a.wav", tmp_path / "b.wav"]
    write_wav(paths[0], x[:, :20480].T.reshape(-1), int(FS), 2)
    write_wav(paths[1], x[:, 20480:].T.reshape(-1), int(FS), 2)
    n = tserve.stream_time_stretch(paths, tmp_path / "port.wav", rate, nfft=nfft, chunk_samples=chunk,
                                   device="cpu")
    m = jserve.stream_time_stretch(paths, tmp_path / "jax.wav", rate, nfft=nfft, chunk_samples=chunk)
    got, want = read_wav(tmp_path / "port.wav")[1], read_wav(tmp_path / "jax.wav")[1]
    assert n == m and got.shape == want.shape == (2 * n,)
    ha = round(nfft // 4 * rate)
    frames = -(-2 * 30001 // chunk) * chunk // 2  # the loader's zero-padded chunks
    frames = -(-frames // ha) * ha
    seen = np.zeros((2, nfft - ha + frames))
    seen[:, nfft - ha : nfft - ha + 30001] = x / 32768.0
    y64 = np.clip(np.rint(ts64(seen, rate, nfft) * 32768.0), -32768, 32767).T.reshape(-1)
    assert y64.shape == got.shape
    bound = max(1.0, 2.0 * np.abs(want - y64).max())
    assert np.abs(got - y64).max() <= bound and np.abs(got.astype(np.int32) - want).max() <= bound


def test_serving_loops_refuse_a_missing_card(wavs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, paths = wavs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.stream_mfcc(paths)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.stream_time_stretch(paths, tmp / "x.wav", 1.25)
    for init in (lambda: tmel.mfcc_init(512, 256), lambda: tpv.time_stretch_init(1.25),
                 lambda: tstream.stft_init(512, 256), lambda: tstream.istft_init(512, 256)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init()
