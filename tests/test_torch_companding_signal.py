"""Companding, the signal generators, the tone metrics and the numerics helpers of
the port against the JAX package on the same NumPy inputs (CPU).

Tolerances: companding bit-exact over every int16 value and every code; the
generators within 1e-6 of max|y| (float32 phases and sines, a few ulp of the
phase apart between XLA's and PyTorch's sin), ``sweep_poly`` within 4 ulp of
its largest phase where that is more; ``white_noise`` by its mean and
variance only (the port draws from a torch.Generator, the reference from
jax.random); the metrics within 1e-4 dB of the reference where its float32
sums resolve the noise, and within 1e-4 dB of float64 NumPy on an int16 tone,
where they do not (the port transforms and sums in float64); the numerics
helpers exact.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import companding as jcmp
from digital_signal_processsing_tpu.ops import metrics as jmet
from digital_signal_processsing_tpu.ops import signal as jsig
from digital_signal_processsing_tpu.utils import numerics as jnum
from digital_signal_processsing_tpu_torch.ops import companding as cmp
from digital_signal_processsing_tpu_torch.ops import metrics as met
from digital_signal_processsing_tpu_torch.ops import signal as sig
from digital_signal_processsing_tpu_torch.utils import numerics as num

ALL_INT16 = np.arange(-32768, 32768, dtype=np.int16)
ALL_CODES = np.arange(256, dtype=np.uint8)
GEN_RTOL = 1e-6
DB_TOL = 1e-4


@pytest.mark.parametrize("name", ["mulaw", "alaw"])
def test_codecs_bit_exact(name):
    enc, dec = getattr(cmp, f"{name}_encode"), getattr(cmp, f"{name}_decode")
    jenc, jdec = getattr(jcmp, f"{name}_encode"), getattr(jcmp, f"{name}_decode")
    got = enc(torch.from_numpy(ALL_INT16))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(jenc(ALL_INT16)))
    back = dec(torch.from_numpy(ALL_CODES))
    assert back.dtype == torch.int16
    np.testing.assert_array_equal(back.numpy(), np.asarray(jdec(ALL_CODES)))
    # encode(decode(c)) == c for every code but mu-law's negative zero
    again = enc(back).numpy()
    want = ALL_CODES.copy()
    if name == "mulaw":
        want[0x7F] = 0xFF
    np.testing.assert_array_equal(again, want)
    # NumPy input goes to the named device
    np.testing.assert_array_equal(enc(ALL_INT16[:7], device="cpu").numpy(), got[:7].numpy())


@pytest.mark.parametrize("mu", [255.0, 8.0])
def test_mu_compress_expand(mu, rng):
    x = rng.uniform(-1, 1, size=(3, 500)).astype(np.float32)
    y = _close_to(lambda: cmp.mu_compress(torch.from_numpy(x), mu=mu),
                  np.asarray(jcmp.mu_compress(x, mu=mu)))
    _close_to(lambda: cmp.mu_expand(y, mu=mu), np.asarray(jcmp.mu_expand(y.numpy(), mu=mu)))
    with pytest.raises(ValueError, match="mu must be > 0"):
        cmp.mu_compress(torch.zeros(3), mu=0.0)


def _close_to(fn, ref, rtol=GEN_RTOL):
    got = fn()
    assert got.shape == ref.shape and got.dtype == torch.float32
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert float(np.abs(got.numpy().astype(np.float64) - ref).max()) <= rtol * scale
    return got


GENERATORS = [
    ("tone", (0.013, 5000), dict(phase=0.3)),
    ("tone", (0.2371, 4096), dict(t0=123456, amplitude=2.0)),
    ("chirp", (0.01, 0.2, 5000), {}),
    ("chirp", (0.3, 0.05, 777), dict(amplitude=0.5)),
    ("square", (0.013, 5000), dict(duty=0.3)),
    ("square", (0.0501, 3000), dict(t0=99)),
    ("sawtooth", (0.013, 5000), dict(width=0.4)),
    ("sawtooth", (0.0071, 3000), dict(width=1.0, t0=7)),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS, ids=lambda v: str(v)[:24])
def test_generators_match_reference(name, args, kw):
    _close_to(lambda: getattr(sig, name)(*args, device="cpu", **kw),
              np.asarray(getattr(jsig, name)(*args, **kw)))


@pytest.mark.parametrize("case", ["gausspulse", "sweep_poly", "sweep_poly_phi"])
def test_time_generators_match_reference(case, rng):
    t = np.sort(rng.uniform(-2e-3, 2e-3, size=(2, 300))).astype(np.float32)
    if case == "gausspulse":
        _close_to(lambda: sig.gausspulse(torch.from_numpy(t), fc=3000.0, bw=0.3),
                  np.asarray(jsig.gausspulse(t, fc=3000.0, bw=0.3)))
    else:
        # the phase is a float32 polynomial, which XLA contracts into FMAs and
        # PyTorch rounds a step at a time: a few ulp of the phase theta apart, so
        # the tolerance is 4 ulp of max|theta| where that exceeds 1e-6
        tt, phi = t * 500, (30.0 if case == "sweep_poly_phi" else 0.0)
        poly = [1.0, -2.0, 3.0]
        theta = 2 * np.pi * np.abs(np.polyval(np.polyint(poly), tt.astype(np.float64))).max()
        _close_to(lambda: sig.sweep_poly(torch.from_numpy(tt), poly, phi),
                  np.asarray(jsig.sweep_poly(tt, poly, phi)),
                  max(GEN_RTOL, 4 * float(np.finfo(np.float32).eps) * theta))


@pytest.mark.parametrize("shape,idx", [(8, None), ((4, 5), "mid"), ((3, 6), (1, 4)), (9, 3)])
def test_unit_impulse(shape, idx):
    got = sig.unit_impulse(shape, idx, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsig.unit_impulse(shape, idx)))
    assert got.dtype == torch.float32
    assert sig.unit_impulse(5, dtype=float, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("nbits,kw", [(5, {}), (8, dict(length=100)), (4, dict(state=[1, 0, 0, 1])),
                                      (6, dict(taps=[5, 2]))])
def test_max_len_seq(nbits, kw):
    seq, st = sig.max_len_seq(nbits, **kw)
    jseq, jst = jsig.max_len_seq(nbits, **kw)
    np.testing.assert_array_equal(seq, jseq)
    np.testing.assert_array_equal(st, jst)


def test_white_noise_statistics():
    x = sig.white_noise(1 << 16, amplitude=2.0, seed=5, device="cpu")
    ref = np.asarray(jsig.white_noise(1 << 16, amplitude=2.0, seed=5))
    assert x.dtype == torch.float32 and x.shape == ref.shape
    # mean within 4 standard errors of 0 for both; variance within 2% of 4 for both
    for v in (x.numpy(), ref):
        assert abs(float(v.mean())) < 4 * 2.0 / np.sqrt(v.size)
        assert abs(float(v.var()) / 4.0 - 1.0) < 0.02
    torch.testing.assert_close(x, sig.white_noise(1 << 16, amplitude=2.0, seed=5, device="cpu"))
    assert not torch.equal(x, sig.white_noise(1 << 16, amplitude=2.0, seed=6, device="cpu"))


def _record(rng, n: int, noise: float, harm: float = 0.01, f0: float = 0.0123) -> np.ndarray:
    k = np.arange(n)
    return (0.5 * np.sin(2 * np.pi * f0 * k) + harm * np.sin(2 * np.pi * 3 * f0 * k)
            + noise * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("noise,window", [(0.05, "hann"), (0.1, "hamming"), (0.2, "hann")])
def test_tone_metrics_match_reference(noise, window, rng):
    x = _record(rng, 4096, noise)
    want = jmet.tone_metrics(x, window=window)
    got = met.tone_metrics(torch.from_numpy(x), window=window)
    assert set(got) == set(want)
    for key in got:
        assert got[key].dtype == torch.float32
        tol = 1e-7 if key == "f0" else DB_TOL / 6.02 if key == "enob" else DB_TOL
        assert abs(float(got[key]) - float(want[key])) <= tol, key
    for fn, key in ((met.thd, "thd_db"), (met.sinad, "sinad_db"), (met.snr_tone, "snr_db"),
                    (met.sfdr, "sfdr_db"), (met.enob, "enob")):
        assert fn(torch.from_numpy(x), window=window) == float(got[key])


def test_tone_metrics_of_an_int16_tone_against_float64(rng):
    """An int16-quantised tone on a bin (coherent, so the window leaks nothing past
    its line): the noise sits some 1e-10 below the total, past a float32 sum; the
    port's float64 transform and sums against NumPy's on the same record."""
    x = np.round(_record(rng, 1 << 14, 0.0, harm=1e-4, f0=201 / (1 << 14)) * 32767) / 32767
    x = x.astype(np.float32)
    got = met.tone_metrics(torch.from_numpy(x))
    from digital_signal_processsing_tpu_torch.ops.fft import spectral_window

    p = np.abs(np.fft.rfft((x * spectral_window("hann", x.size)).astype(np.float64))) ** 2
    bins = np.arange(p.size)
    guard = bins < 5
    k0 = int(np.argmax(np.where(guard, -np.inf, p)))
    fund = (np.abs(bins - k0) <= 3) & ~guard
    harm = np.zeros(p.size, bool)
    for h in range(2, 7):
        kh = h * k0 % x.size
        kh = x.size - kh if kh > x.size // 2 else kh
        harm |= (np.abs(bins - kh) <= 3) & ~guard
    harm &= ~fund
    total, pf, ph = p[~guard].sum(), p[fund].sum(), p[harm].sum()
    snr = 10 * np.log10(pf / (total - pf - ph))
    sinad = 10 * np.log10(pf / (total - pf))
    assert abs(float(got["snr_db"]) - snr) < 1e-4
    assert abs(float(got["sinad_db"]) - sinad) < 1e-4
    assert 85.0 < float(got["snr_db"]) < 110.0  # an int16 quantiser's, not rounding's


def test_numerics_helpers_exact(rng):
    assert num.exact_window_bound() == jnum.exact_window_bound() == 65535
    assert num.exact_window_bound(12) == jnum.exact_window_bound(12)
    wsum = rng.integers(-(2**31) + 1, 2**31 - 1, size=5000, dtype=np.int64).astype(np.int32)
    for window in (1, 3, 1000, 65535):
        got = num.float_reciprocal_quantize(torch.from_numpy(wsum), window)
        want = np.asarray(jnum.float_reciprocal_quantize(wsum, window))
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(got.numpy(), want)
        got32 = num.float_reciprocal_quantize(torch.from_numpy(wsum), window, torch.int32)
        import jax.numpy as jnp

        np.testing.assert_array_equal(got32.numpy(),
                                      np.asarray(jnum.float_reciprocal_quantize(wsum, window, jnp.int32)))
    ref = rng.normal(size=300)
    test = ref + 1e-3 * rng.normal(size=300)
    assert num.snr_db(ref, test) == jnum.snr_db(ref, test)
    assert num.snr_db(ref, ref) == jnum.snr_db(ref, ref) == float("inf")
    assert num.snr_db(np.zeros(3), np.ones(3)) == float("-inf")
