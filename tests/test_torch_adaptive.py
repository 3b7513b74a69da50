"""The port's tracking notch (``models/adaptive.py``) against the JAX package.

The same NumPy signal (a swept tone in white noise, seeded) goes through the
JAX package's ``tracking_notch`` (its frames kernel in interpret mode on the
CPU) and through the port on the CPU, where ``sosfilt_tv_frames`` takes B18's
plain version. Tolerances: the frequency estimates within 1e-5 Nyquist units
(both take the same float32 rfft peak; the parabolic refinement rounds
apart), the cleaned signal within 1e-4 of max|y| (a frequency that differs by
1e-6 moves the notch's rows in their last bits, and the interferer is 20 dB
above the output), and the reference's own rules for the notch
(tests/test_lpc.py): mean frequency error < 0.004, >= 15 dB suppression after
lock, correlation with the noise > 0.8.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models import adaptive as jax_adaptive
from digital_signal_processsing_tpu_torch.models import adaptive
from digital_signal_processsing_tpu_torch.utils import last_choice

W_TOL = 1e-5
Y_TOL = 1e-4


def swept_tone(n, seed=2):
    rng = np.random.default_rng(seed)
    f_inst = 0.1 + 0.25 * np.arange(n) / n
    tone = 10.0 * np.sin(np.cumsum(np.pi * f_inst))
    noise = rng.standard_normal(n)
    return (tone + noise).astype(np.float32), tone, noise, f_inst


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def swept():
    n, fl = 64000, 512
    x, tone, noise, f_inst = swept_tone(n)
    yj, wj = jax_adaptive.tracking_notch(x, fl, q=30.0)
    return x, tone, noise, f_inst, fl, np.asarray(yj), np.asarray(wj)


def test_tracking_notch_matches_jax_and_the_reference_rules(swept):
    x, tone, noise, f_inst, fl, yj, wj = swept
    y, w0 = adaptive.tracking_notch(torch.from_numpy(x), fl, q=30.0)
    assert last_choice("sosfilt_tv_frames") == "frames"  # B18's route on the card
    y, w0 = y.numpy(), w0.numpy()
    assert w0.shape == wj.shape == (x.size // fl,)
    assert np.abs(w0 - wj).max() < W_TOL
    assert rel_err(y, yj) < Y_TOL
    centers = f_inst[fl // 2 :: fl][: w0.size]
    assert np.mean(np.abs(w0 - centers)) < 0.004
    assert np.mean((y - noise)[2 * fl :] ** 2) < 0.05 * np.mean(tone**2)
    assert np.corrcoef(y[2 * fl :], noise[2 * fl :])[0, 1] > 0.8


def test_estimate_and_rows_match_jax():
    x, _, _, _ = swept_tone(8192, seed=4)
    xb = np.stack([x, x[::-1].copy()])
    for nfft in (None, 1024):
        want = np.asarray(jax_adaptive.estimate_tone_frequency(xb, 256, nfft=nfft))
        got = adaptive.estimate_tone_frequency(torch.from_numpy(xb), 256, nfft=nfft).numpy()
        assert got.shape == want.shape == (2, 32)
        assert np.abs(got - want).max() < W_TOL
    w0 = np.linspace(0.01, 0.99, 50).astype(np.float32)
    for q in (5.0, 30.0):
        want = np.asarray(jax_adaptive.notch_rows(w0, q))
        got = adaptive.notch_rows(torch.from_numpy(w0), q).numpy()
        assert np.abs(got - want).max() < 1e-6


def test_ragged_tail_and_channels_match_jax():
    """A tail past the last whole frame takes the last frame's notch; a
    (C, T) signal tracks each channel on its own (per-channel rows)."""
    x, _, _, _ = swept_tone(3 * 4096 + 300, seed=6)
    xb = np.stack([x, 0.5 * x[::-1]]).astype(np.float32)
    fl = 1024
    yj, wj = jax_adaptive.tracking_notch(xb, fl, q=20.0)
    y, w0 = adaptive.tracking_notch(torch.from_numpy(xb), fl, q=20.0)
    assert y.shape == xb.shape and w0.shape == (2, xb.shape[1] // fl)
    assert np.abs(w0.numpy() - np.asarray(wj)).max() < W_TOL
    assert rel_err(y.numpy(), np.asarray(yj)) < Y_TOL


def test_short_signal_raises_like_jax():
    with pytest.raises(ValueError):
        jax_adaptive.tracking_notch(np.zeros(100, np.float32), 512)
    with pytest.raises(ValueError, match="shorter than one frame"):
        adaptive.tracking_notch(torch.zeros(100), 512)
