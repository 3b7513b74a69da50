"""The port's IIR path (B10, B12, B13, B15 and their callers) against the JAX package.

The same NumPy inputs go through the JAX package (its Pallas kernels in
interpret mode with ``tile_rows=8``, as tests/test_iir.py runs them, or its
XLA scan) and through the port on the CPU, where every kernel wrapper takes
its plain version. ``emulate_cascade`` and ``emulate_iir1`` do what the
blocks of ``csrc/iir.cu`` do, with the geometry the wrappers pass to the
launches: zero-state tile end states, the carry scan of one warp a channel
with the rounded M, and the seeded re-run; inside a tile the sub-tiles, each
thread's segment, the warp's Hillis-Steele steps with the table's powers,
thread 0's chain over the warps, the correction pass and the ragged end
state: B15's launches, one section at a time, and B10's. ``emulate_lookback``
does B12's single pass and B13's (the same pass with the sections fixed).
They are held against scipy.

Tolerance: 1e-5 of max|y| everywhere, against the JAX package and against
scipy's float64 filter run with the same float32 coefficients (a float32
recurrence differs from float64 by rounding of order 1e-6 of the output at
these poles; the JAX package's kernels measured 7e-7 to 2.5e-6 against scipy
at (3, 5000) with butter(8, 0.1)). Designers and host helpers: bit for bit.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import gain as jax_gain
from digital_signal_processsing_tpu.ops import iir as jax_iir
from digital_signal_processsing_tpu.ops import resample as jax_resample
from digital_signal_processsing_tpu.utils.dispatch import last_choice as jax_last_choice
from digital_signal_processsing_tpu_torch.ops import gain, iir
from digital_signal_processsing_tpu_torch.ops import resample
from digital_signal_processsing_tpu_torch.utils import last_choice

TOL = 1e-5
F32 = np.float32


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def sig(rng, shape):
    return rng.normal(size=shape).astype(F32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def scipy_sos(sos, x, zi=None):
    """scipy's float64 cascade with the float32 coefficients the filters use."""
    s64 = np.asarray(sos, F32).astype(np.float64)
    if zi is None:
        return sps.sosfilt(s64, np.asarray(x, np.float64), axis=-1)
    return sps.sosfilt(s64, np.asarray(x, np.float64), axis=-1, zi=zi)


SOS = {
    "butter8": iir.design_butterworth(8, 0.1),
    "butter4": iir.design_butterworth(4, 0.2),
    "biquad": iir.design_biquad_lowpass(0.2),
    "band": iir.design_butterworth_band(2, 0.2, 0.5),
}


# --- designers and host helpers: copies of the reference -------------------------


@pytest.mark.parametrize(
    "name,args",
    [
        ("design_biquad_lowpass", (0.3,)),
        ("design_biquad_highpass", (0.3, 1.2)),
        ("design_biquad_bandpass", (0.25,)),
        ("design_butterworth", (8, 0.1)),
        ("design_butterworth", (5, 0.3, "highpass")),
        ("design_butterworth_band", (3, 0.2, 0.5, "bandstop")),
        ("design_butterworth_band", (2, 0.1, 0.4)),
        ("design_chebyshev1", (8, 0.05, 0.2)),
        ("design_chebyshev1", (5, 1.0, 0.3, "highpass")),
        ("design_chebyshev1", (3, 1.0, [0.2, 0.5], "bandpass")),
        ("design_chebyshev2", (4, 40.0, 0.3)),
        ("design_chebyshev2", (5, 30.0, 0.2, "highpass")),
        ("design_chebyshev2", (2, 30.0, [0.2, 0.5], "bandstop")),
    ],
)
def test_designers_match_jax(name, args):
    got = getattr(iir, name)(*args)
    want = getattr(jax_iir, name)(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_designer_validation_matches_jax():
    for name, args in [
        ("design_biquad_lowpass", (1.5,)),
        ("design_butterworth", (0, 0.2)),
        ("design_butterworth_band", (2, 0.5, 0.2)),
        ("design_chebyshev1", (4, -1.0, 0.2)),
        ("design_chebyshev2", (4, 40.0, 0.3, "comb")),
    ]:
        with pytest.raises(ValueError):
            getattr(jax_iir, name)(*args)
        with pytest.raises(ValueError):
            getattr(iir, name)(*args)


@pytest.mark.parametrize(
    "b,a",
    [
        sps.butter(4, 0.2),
        sps.cheby1(5, 1.0, 0.3),
        (np.array([0.0, 0.0, 3.0]), np.array([1.0, -0.5, 0.25, 0.1])),
        (np.array([0.5, 0.3]), np.array([1.0, -0.2])),
    ],
)
def test_host_helpers_match_jax(b, a):
    np.testing.assert_array_equal(iir.ba_to_sos(b, a), jax_iir.ba_to_sos(b, a))
    np.testing.assert_array_equal(iir.lfilter_zi(b, a), jax_iir.lfilter_zi(b, a))
    np.testing.assert_array_equal(iir.lfiltic(b, a, [1.0, -2.0, 0.5], [0.3]),
                                  jax_iir.lfiltic(b, a, [1.0, -2.0, 0.5], [0.3]))
    for fn in ("freqz", "group_delay"):
        for got, want in zip(getattr(iir, fn)(b, a, 256), getattr(jax_iir, fn)(b, a, 256)):
            np.testing.assert_array_equal(got, want)
    sos = iir.ba_to_sos(b, a)
    np.testing.assert_array_equal(iir.sosfilt_zi(sos), jax_iir.sosfilt_zi(sos))
    for fn in ("sosfreqz", "sos_group_delay"):
        for got, want in zip(getattr(iir, fn)(sos, 128), getattr(jax_iir, fn)(sos, 128)):
            np.testing.assert_array_equal(got, want)


# --- sosfilt, every method ---------------------------------------------------------


JAX_SOSFILT = {
    "xla_scan": lambda sos, x: jax_iir.sosfilt(sos, x, method="xla_scan"),
    "pallas": lambda sos, x: jax_iir.sosfilt_pallas(sos, x, tile_rows=8),
    "pallas_fused": lambda sos, x: jax_iir.sosfilt_pallas_fused(sos, x, tile_rows=8),
    "auto": lambda sos, x: jax_iir.sosfilt(sos, x),
}


@pytest.mark.parametrize("method", list(JAX_SOSFILT))
@pytest.mark.parametrize("sos_name", ["butter8", "band"])
def test_sosfilt_methods_match_jax_and_scipy(rng, method, sos_name):
    sos = SOS[sos_name]
    x = sig(rng, (3, 3000))
    want = np.asarray(JAX_SOSFILT[method](sos, x))
    got = iir.sosfilt(sos, t(x), method=method)
    assert got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < TOL
    assert rel_err(got.numpy(), scipy_sos(sos, x)) < TOL


def test_unrolled_sections_match_jax(rng):
    sos = SOS["butter4"]
    x = sig(rng, (2, 2500))
    want = np.asarray(jax_iir.sosfilt_pallas_fused(sos, x, tile_rows=8, unroll_sections=True))
    got = iir.sosfilt_pallas_fused(sos, t(x), unroll_sections=True).numpy()
    assert rel_err(got, want) < TOL
    assert rel_err(got, scipy_sos(sos, x)) < TOL


# --- any section count: groups of the kernels' largest instance -------------------
#
# The wrappers of B12, B13 and B14 chain groups of at most MAX_SECTIONS (B12,
# B14) or MAX_UNROLLED (B13) sections, each from its slice of the state. At 17
# and 24 sections of butter(34, 0.1) and butter(48, 0.1) any float32 cascade
# lies further than TOL from float64 (scipy's own float32 filter 3.0e-5 and
# 2.9e-4 of max|y| on these inputs; the JAX package's 1.5e-5 to 1.9e-4): the
# tolerance is the 4-section cases' TOL, widened where float32 itself is
# further off to HIGHQ_FACTOR x scipy's float32 error (the high-Q rule of the
# 16-section cases below), against float64 and against the JAX package.

HIGH_ORDER = {17: iir.design_butterworth(34, 0.1), 24: iir.design_butterworth(48, 0.1)}


def high_order_tol(sos, x, filtfilt=False):
    """TOL, or HIGHQ_FACTOR x scipy's float32 filter's own error against float64."""
    fn = sps.sosfiltfilt if filtfilt else sps.sosfilt
    s32 = np.asarray(sos, F32)
    err32 = rel_err(fn(s32, x.astype(F32), axis=-1), fn(s32.astype(np.float64), x.astype(np.float64), axis=-1))
    return max(TOL, HIGHQ_FACTOR * err32)


HIGH_ORDER_SPELLINGS = {"fused": {}, "unrolled": {"unroll_sections": True}, "mxu": {"lane_pass": "mxu"}}


@pytest.fixture(scope="module")
def high_order_jax():
    """Per section count: the input and the JAX package's sosfilt auto, each
    spelling of sosfilt_pallas_fused (its kernels in interpret mode) and
    sosfiltfilt on it, computed once."""
    out = {}
    for sections, sos in HIGH_ORDER.items():
        x = sig(np.random.default_rng(sections), (2, 1500))
        runs = {"auto": np.asarray(jax_iir.sosfilt(sos, x)),
                "filtfilt": np.asarray(jax_iir.sosfiltfilt(sos, x))}
        for name, kw in HIGH_ORDER_SPELLINGS.items():
            runs[name] = np.asarray(jax_iir.sosfilt_pallas_fused(sos, x, tile_rows=8, **kw))
        out[sections] = x, runs
    return out


@pytest.mark.parametrize("sections", [17, 24])
@pytest.mark.parametrize("spelling", ["auto", "fused", "unrolled", "mxu"])
def test_high_order_sosfilt_matches_jax(high_order_jax, sections, spelling):
    sos = HIGH_ORDER[sections]
    x, jax_runs = high_order_jax[sections]
    if spelling == "auto":
        got = iir.sosfilt(sos, t(x)).numpy()
    else:
        got = iir.sosfilt_pallas_fused(sos, t(x), **HIGH_ORDER_SPELLINGS[spelling]).numpy()
    tol = high_order_tol(sos, x)
    assert rel_err(got, jax_runs[spelling]) < tol
    assert rel_err(got, scipy_sos(sos, x)) < tol


@pytest.mark.parametrize("sections", [17, 24])
def test_high_order_sosfiltfilt_and_decimate(high_order_jax, sections):
    sos = HIGH_ORDER[sections]
    x, jax_runs = high_order_jax[sections]
    got = iir.sosfiltfilt(sos, t(x)).numpy()
    tol = high_order_tol(sos, x, filtfilt=True)
    assert rel_err(got, jax_runs["filtfilt"]) < tol
    assert rel_err(got, sps.sosfiltfilt(np.asarray(sos, F32).astype(np.float64),
                                        x.astype(np.float64))) < tol
    # decimate's Chebyshev I of order 34: 17 sections (at order 48 its 0.05 dB
    # design is unstable in float32 itself, scipy's own float32 filter included)
    design = iir.design_chebyshev1(34, 0.05, 0.2)
    assert design.shape[0] == 17
    got = iir.decimate_iir(t(x), 4, order=34).numpy()
    want = sps.sosfiltfilt(design.astype(np.float64), x.astype(np.float64))[..., ::4]
    assert rel_err(got, want) < high_order_tol(design, x, filtfilt=True)


@pytest.mark.parametrize("sections", [17, 24])
def test_high_order_chunks_match_one_shot(high_order_jax, sections):
    sos = HIGH_ORDER[sections]
    x, jax_runs = high_order_jax[sections]
    st = iir.sosfilt_init(sos, (2,), device="cpu")
    ys = []
    for a, b in ((0, 400), (400, 1031), (1031, 1500)):
        st, y = iir.sosfilt_chunk(st, sos, t(x[:, a:b]))
        ys.append(y.numpy())
    got = np.concatenate(ys, axis=1)
    tol = high_order_tol(sos, x)
    assert rel_err(got, iir.sosfilt(sos, t(x)).numpy()) < tol
    assert rel_err(got, jax_runs["auto"]) < tol
    zf = scipy_sos(sos, x, zi=np.zeros((sections, 2, 2)))[1]
    assert np.abs(st.numpy() - zf).max() < tol * np.abs(scipy_sos(sos, x)).max()


def test_unrolled_groups_match_jax(rng):
    # B13 past its largest instance at 9 sections, groups of MAX_UNROLLED
    # sections (17 in test_high_order_sosfilt_matches_jax)
    sos = iir.design_butterworth(18, 0.1)
    x = sig(rng, (2, 1500))
    got = iir.sosfilt_pallas_fused(sos, t(x), unroll_sections=True).numpy()
    want = np.asarray(jax_iir.sosfilt_pallas_fused(sos, x, tile_rows=8, unroll_sections=True))
    tol = high_order_tol(sos, x)
    assert rel_err(got, want) < tol
    assert rel_err(got, scipy_sos(sos, x)) < tol


def test_section_groups_launch_once_each(monkeypatch, rng):
    """One launch a group, each from its slice of the state: the wrappers taken
    through their CUDA branch with the launches replaced by the plain version."""
    assert iir.section_groups(17, 16) == [(0, 16), (16, 17)]
    assert iir.section_groups(24, 8) == [(0, 8), (8, 16), (16, 24)]
    assert iir.section_groups(8, 8) == [(0, 8)]
    sos = HIGH_ORDER[17]
    x = t(sig(rng, (2, 1500)))
    state = t((0.1 * rng.normal(size=(17, 2, 2))).astype(F32))
    want_y, want_end = iir.sos_cascade(x, sos, state)  # the plain version, grouped alike
    want_b13 = iir.sos_cascade_unrolled(x, sos)
    calls = []

    def plain_launch(y, rows, st, tile_rows):
        calls.append(rows.shape[0])
        return iir._sos_plain(y, rows, st)

    monkeypatch.setattr(iir, "_on_cuda", lambda x: True)
    monkeypatch.setattr(iir, "_launch_lookback", plain_launch)
    monkeypatch.setattr(iir, "_launch_unrolled", lambda y, rows, tr: plain_launch(y, rows, None, tr)[0])
    monkeypatch.setattr(iir, "_launch_mxu", lambda y, rows, tr: plain_launch(y, rows, None, tr)[0])
    before = (iir.sos_cascade.launches, iir.sos_cascade_unrolled.launches,
              iir.sos_cascade_mxu.launches)
    y, end = iir.sos_cascade(x, sos, state)
    assert calls == [16, 1] and torch.equal(y, want_y) and torch.equal(end, want_end)
    calls.clear()
    assert torch.equal(iir.sos_cascade_unrolled(x, sos), want_b13) and calls == [8, 8, 1]
    calls.clear()
    iir.sos_cascade_mxu(x, sos)
    assert calls == [16, 1]
    after = (iir.sos_cascade.launches, iir.sos_cascade_unrolled.launches,
             iir.sos_cascade_mxu.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 3, 2]


@pytest.mark.parametrize("shape", [(700,), (2, 3, 700), (1, 1)])
def test_sosfilt_batch_shapes(rng, shape):
    sos = SOS["butter4"]
    x = sig(rng, shape)
    got = iir.sosfilt(sos, t(x)).numpy()
    assert got.shape == shape
    assert rel_err(got, np.asarray(jax_iir.sosfilt(sos, x))) < TOL


def test_empty_stream(rng):
    sos = SOS["butter4"]
    assert iir.sosfilt(sos, torch.zeros(3, 0)).shape == (3, 0)
    st = iir.sosfilt_init(sos, (3,), device="cpu") + 1.0
    for method in ("pallas_fused", "pallas", "xla_scan"):
        st2, y = iir.sosfilt_chunk(st, sos, torch.zeros(3, 0), method=method)
        assert y.shape == (3, 0) and torch.equal(st2, st)


# --- streaming: seeded chunks and the state carried over --------------------------


CUTS = [0, 1, 512, 513, 1800, 3001]


@pytest.fixture(scope="module")
def jax_chunks():
    """The JAX package on one stream: (x, its one-shot output, its end state
    after the stream as one chunk)."""
    sos = SOS["butter8"]
    x = sig(np.random.default_rng(7), (2, CUTS[-1]))
    jst, jy = jax_iir.sosfilt_chunk(jax_iir.sosfilt_init(sos, (2,)), sos, x, method="xla_scan")
    return x, np.asarray(jy), np.asarray(jst)


@pytest.mark.parametrize("method", ["pallas_fused", "pallas", "xla_scan"])
def test_sosfilt_chunk_continues_the_stream(jax_chunks, method):
    sos = SOS["butter8"]
    x, jy, jst = jax_chunks
    st = iir.sosfilt_init(sos, (2,), device="cpu")
    outs = []
    for a, b in zip(CUTS[:-1], CUTS[1:]):
        st, y = iir.sosfilt_chunk(st, sos, t(x[:, a:b]), method=method)
        assert last_choice("sosfilt_chunk") == method
        outs.append(y.numpy())
    got = np.concatenate(outs, -1)
    want_y, want_st = scipy_sos(sos, x, zi=np.zeros((4, 2, 2)))
    scale = np.abs(want_y).max()
    assert rel_err(got, want_y) < TOL
    assert np.abs(st.numpy() - want_st).max() < TOL * scale
    assert rel_err(got, jy) < TOL
    assert np.abs(st.numpy() - jst).max() < TOL * scale


def test_jax_seeded_kernel_chunks_match_the_port(rng):
    sos = SOS["butter4"]
    x = sig(rng, (2, 2 * 1024 + 333))
    jst = jax_iir.sosfilt_init(sos, (2,))
    jst, jy = jax_iir.sosfilt_chunk_pallas_fused(jst, sos, x, tile_rows=8)
    st, y = iir.sosfilt_chunk_pallas_fused(iir.sosfilt_init(sos, (2,), device="cpu"), sos, t(x))
    assert rel_err(y.numpy(), np.asarray(jy)) < TOL
    assert np.abs(st.numpy() - np.asarray(jst)).max() < TOL * np.abs(np.asarray(jy)).max()


def test_state_carried_over_from_jax(rng):
    # the JAX package filters the first chunk; the port finishes the stream
    sos = SOS["butter8"]
    x = sig(rng, (3, 1500))
    jst, jy = jax_iir.sosfilt_chunk(jax_iir.sosfilt_init(sos, (3,)), sos, x[..., :700])
    st = iir.sos_state_from_jax(np.asarray(jst), device="cpu")
    assert st.shape == (4, 3, 2) and st.dtype == torch.float32
    outs = [np.asarray(jy)]
    for a, b in [(700, 1200), (1200, 1500)]:
        st, y = iir.sosfilt_chunk(st, sos, t(x[..., a:b]))
        outs.append(y.numpy())
    assert rel_err(np.concatenate(outs, -1), scipy_sos(sos, x)) < TOL
    with pytest.raises(ValueError, match="float32"):
        iir.sos_state_from_jax(np.zeros((4, 2), np.float64), device="cpu")


def test_chunk_state_must_fit(rng):
    sos = SOS["butter4"]
    with pytest.raises(ValueError, match="state"):
        iir.sosfilt_chunk(torch.zeros(3, 2, 2), sos, torch.zeros(2, 100))
    with pytest.raises(ValueError, match="state"):
        iir.sosfilt_chunk(torch.zeros(2, 3, 2), sos, torch.zeros(2, 100))


# --- the first-order recurrence ----------------------------------------------------


@pytest.mark.parametrize("a", [0.5, -0.3, 0.99, 0.9999])
@pytest.mark.parametrize("method", ["pallas", "xla_scan"])
def test_iir_first_order_matches_jax_and_scipy(rng, a, method):
    x = sig(rng, (2, 3000))
    got = iir.iir_first_order(t(x), a, 0.7, method=method).numpy()
    if method == "pallas":
        want = np.asarray(jax_iir.iir_first_order_pallas(x, a, 0.7, tile_rows=8))
    else:
        want = np.asarray(jax_iir.iir_first_order(x, a, 0.7, method="xla_scan"))
    ref = sps.lfilter([float(F32(0.7))], [1.0, -float(F32(a))], x.astype(np.float64), axis=-1)
    assert rel_err(got, ref) < TOL
    # the JAX package's own associative scan is off by 5e-6 at a = 0.9999
    assert rel_err(got, want) < (1e-5 if a != 0.9999 else 2e-5)


# --- the scipy-compatible surface ----------------------------------------------------


@pytest.mark.parametrize(
    "b,a",
    [
        sps.butter(4, 0.2),
        sps.cheby1(3, 1.0, 0.3),
        (np.array([0.5, 0.3, 0.1]), np.array([1.0])),  # pure FIR: fir_filter
        (np.array([0.0, 2.0]), np.array([1.0, -0.5])),  # a pure delay is kept
    ],
)
def test_lfilter_matches_jax_and_scipy(rng, b, a):
    x = sig(rng, 3000)
    got = iir.lfilter(b, a, t(x)).numpy()
    assert rel_err(got, np.asarray(jax_iir.lfilter(b, a, x))) < TOL
    assert rel_err(got, sps.lfilter(b, a, x.astype(np.float64))) < 1e-4  # the sos are float32


def test_sosfiltfilt_and_filtfilt_match_jax_and_scipy(rng):
    sos = sps.butter(4, 0.2, output="sos")
    x = sig(rng, (2, 3000))
    got = iir.sosfiltfilt(sos, t(x)).numpy()
    assert rel_err(got, np.asarray(jax_iir.sosfiltfilt(sos, x))) < TOL
    assert rel_err(got, sps.sosfiltfilt(sos, x.astype(np.float64), axis=-1)) < TOL
    b, a = sps.butter(3, 0.25)
    got = iir.filtfilt(b, a, t(x[0])).numpy()
    assert rel_err(got, np.asarray(jax_iir.filtfilt(b, a, x[0]))) < TOL
    with pytest.raises(ValueError, match="padding"):
        iir.sosfiltfilt(sos, torch.zeros(10))


@pytest.mark.parametrize("factor", [1, 2, 5])
def test_decimate_iir_matches_jax_and_scipy(rng, factor):
    x = sig(rng, (2, 4001))
    got = resample.decimate(t(x), factor, ftype="iir").numpy()
    assert rel_err(got, np.asarray(jax_resample.decimate(x, factor, ftype="iir"))) < TOL
    if factor > 1:
        assert rel_err(got, sps.decimate(x.astype(np.float64), factor, axis=-1)) < TOL
    with pytest.raises(ValueError, match="taps"):
        resample.decimate(t(x), 2, ftype="iir", taps=np.ones(3, F32))


# --- gain.py --------------------------------------------------------------------


@pytest.mark.parametrize("pole", [0.995, 0.9])
def test_dc_block_matches_jax(rng, pole):
    x = sig(rng, (2, 3000)) + 3.0
    got = gain.dc_block(t(x), pole).numpy()
    assert rel_err(got, np.asarray(jax_gain.dc_block(x, pole))) < TOL
    assert abs(got[:, 2000:].mean()) < 0.1  # the DC is gone


def test_agc_matches_jax(rng):
    x = sig(rng, (2, 3000)) * np.linspace(0.01, 2.0, 3000, dtype=F32)
    for kw in ({}, {"target": 0.2, "attack": 0.05}):
        got = gain.agc(t(x), **kw).numpy()
        assert rel_err(got, np.asarray(jax_gain.agc(x, **kw))) < TOL
    with pytest.raises(ValueError, match="attack"):
        gain.agc(t(x), attack=1.5)


def test_elementwise_gain_ops_match_jax(rng):
    x = sig(rng, (2, 999)) * 3.0
    x[0, :5] = 0.0
    np.testing.assert_allclose(gain.soft_clip(t(x), 2.0).numpy(), np.asarray(jax_gain.soft_clip(x, 2.0)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gain.db(t(x)).numpy(), np.asarray(jax_gain.db(x)), rtol=1e-6)
    for kind in ("linear", "constant"):
        got = gain.detrend(t(x + np.arange(999, dtype=F32)), type=kind).numpy()
        want = np.asarray(jax_gain.detrend(x + np.arange(999, dtype=F32), type=kind))
        np.testing.assert_allclose(got, want, atol=2e-3)


# --- dispatch names and refusals ---------------------------------------------------


def test_record_choice_names(rng):
    long = iir.PALLAS_IIR_MIN_T
    sos = SOS["biquad"]
    for n, route in ((max(long - 1, 0), "xla_scan"), (long, "pallas_fused")):
        iir.sosfilt(sos, torch.zeros(n))
        assert last_choice("sosfilt") == route
        iir.sosfilt_chunk(iir.sosfilt_init(sos, device="cpu"), sos, torch.zeros(n))
        assert last_choice("sosfilt_chunk") == route
        iir.iir_first_order(torch.zeros(n), 0.9)
        assert last_choice("iir_first_order") == ("pallas" if route == "pallas_fused" else "xla_scan")
    # the names are the JAX package's
    jax_iir.sosfilt(sos, np.zeros(16, F32), method="pallas")
    iir.sosfilt(sos, torch.zeros(16), method="pallas")
    assert jax_last_choice("sosfilt") == last_choice("sosfilt") == "pallas"
    jax_iir.iir_first_order(np.zeros(16, F32), 0.5)
    iir.iir_first_order(torch.zeros(16), 0.5, method="xla_scan")
    assert jax_last_choice("iir_first_order") == last_choice("iir_first_order") == "xla_scan"


def test_fused_and_first_order_refusals_raise_by_name(rng):
    x = torch.zeros(2, 100)
    sos = SOS["butter4"]
    with pytest.raises(ValueError, match="compact"):
        iir.sosfilt_pallas_fused(sos, x, tile_rows=64, row_pass="compact")
    with pytest.raises(ValueError, match="compact"):
        iir.iir_first_order_pallas(x, 0.9, tile_rows=64, row_pass="compact")
    with pytest.raises(ValueError, match="unroll_sections"):
        iir.sosfilt_pallas_fused(sos, x, tile_rows=128, unroll_sections=True, row_pass="compact")
    with pytest.raises(ValueError, match="B13"):  # no section (10 take two groups, F2)
        iir.sosfilt_pallas_fused(np.zeros((0, 6), F32), x, unroll_sections=True)
    with pytest.raises(ValueError, match="method"):
        iir.sosfilt(sos, x, method="nope")
    with pytest.raises(ValueError, match="kernel"):
        iir.iir_first_order_pallas(x, 0.9, kernel="nope")
    # per-sample coefficients take the plain scan (the reference's XLA scan), B10 refuses them
    ones = torch.ones(2, 100)
    y = iir.iir_first_order(ones, np.full(100, 0.9, F32))
    assert torch.allclose(y, iir.iir_first_order(ones, 0.9, method="xla_scan"), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="scalar"):
        iir.iir_first_order(x, np.full(100, 0.9, F32), method="pallas")
    with pytest.raises(ValueError, match="tile_rows"):
        iir.sosfilt_pallas_fused(sos, x, tile_rows=8)


def test_compact_row_pass_runs_the_same_kernel(rng):
    sos = SOS["butter4"]
    x = t(sig(rng, (2, 1500)))
    want = iir.sosfilt_pallas_fused(sos, x)
    assert torch.equal(iir.sosfilt_pallas_fused(sos, x, row_pass="compact", tile_rows=128), want)
    st = iir.sosfilt_init(sos, (2,), device="cpu")
    assert torch.equal(iir.sosfilt_chunk_pallas_fused(st, sos, x, row_pass="compact")[1], want)
    y1 = iir.iir_first_order_pallas(x, 0.9)
    assert torch.equal(iir.iir_first_order_pallas(x, 0.9, row_pass="compact", tile_rows=256), y1)


@pytest.mark.parametrize(
    "channels,t,tile_rows,want",
    [
        (16, 1 << 22, None, 3 * iir.SUB_TILE),  # 16384 sub-tiles: three a tile
        (1, 1 << 22, None, iir.SUB_TILE),  # too few to group
        (1, 1, None, iir.SUB_TILE),
        (4000, 1 << 20, None, iir.MAX_TILE_SUBS * iir.SUB_TILE),  # capped
        (3, 100, 64, 64 * 128),
    ],
)
def test_pick_tile(channels, t, tile_rows, want):
    assert iir.pick_tile(channels, t, tile_rows) == want


# --- NumPy emulation of csrc/iir.cu --------------------------------------------------


def _warp_scan(z, step):
    """The warp's Hillis-Steele steps: z (threads, 2), step(d) the 2x2 power."""
    lane = np.arange(z.shape[0]) % 32
    w = z.copy()
    for d in (1, 2, 4, 8, 16):
        u = np.roll(w, d, axis=0)  # lane >= d reads lane - d of its own warp
        w = np.where((lane >= d)[:, None], w + u @ step(d).T, w)
    e = np.roll(w, 1, axis=0)
    e[lane == 0] = 0.0
    return w, e


def _section_pass(seg, tab_k, car, jlast):
    """One section over a sub-tile, as section_pass() does; returns the end
    state at ``jlast`` (thread, index) or None."""
    b0, b1, b2, a1, a2 = tab_k[:5]
    pw = tab_k[8 : 8 + 4 * 33].reshape(33, 2, 2)
    s1 = np.zeros(iir.THREADS, F32)
    s2 = np.zeros(iir.THREADS, F32)
    p = None
    for j in range(iir.SEG):
        xv = seg[:, j].copy()
        yv = b0 * xv + s1
        s1, s2 = b1 * xv - a1 * yv + s2, b2 * xv - a2 * yv
        seg[:, j] = yv
        if jlast is not None and j == jlast[1]:
            p = np.array([s1[jlast[0]], s2[jlast[0]]], F32)
    w, e = _warp_scan(np.stack([s1, s2], 1), lambda d: pw[d])
    wtot = w[np.arange(iir.THREADS) % 32 == 31]
    wbeg = []
    c = car.copy()
    for q in range(iir.THREADS // 32):
        wbeg.append(c)
        c = pw[32] @ c + wtot[q]
    car[:] = c
    lane = np.arange(iir.THREADS) % 32
    v = np.einsum("tij,tj->ti", pw[lane], np.array(wbeg)[np.arange(iir.THREADS) // 32]) + e
    end = None
    for j in range(iir.SEG):
        seg[:, j] += v[:, 0]
        v = np.stack([-a1 * v[:, 0] + v[:, 1], -a2 * v[:, 0]], 1).astype(F32)
        if jlast is not None and j == jlast[1]:
            end = v[jlast[0]] + p
    return end


def _tile(xc, t_idx, tile, n, ntiles, tab, car, want_state):
    """One block of sos_tile_kernel: returns y of the tile and the end state."""
    t0, t1 = t_idx * tile, min(t_idx * tile + tile, n)
    ys, ends = [], None
    for s0 in range(t0, t1, iir.SUB_TILE):
        count = min(iir.SUB_TILE, t1 - s0)
        buf = np.zeros(iir.SUB_TILE, F32)
        buf[:count] = xc[s0 : s0 + count]
        seg = buf.reshape(iir.THREADS, iir.SEG)
        jlast = None
        if want_state and t_idx == ntiles - 1 and n - 1 - s0 < iir.SUB_TILE:
            p = n - 1 - s0
            jlast = (p // iir.SEG, p % iir.SEG)
        got = [_section_pass(seg, tab[k], car[k], jlast) for k in range(tab.shape[0])]
        if jlast is not None:
            ends = np.stack(got)
        ys.append(buf[:count])
    return np.concatenate(ys), ends


def emulate_cascade(x, sos, state=None, tile_rows=None):
    """dsp_sos_sections (B15) on (C, n) float32: each section's three launches
    of sos_tile_kernel<1> on the previous section's output, seeded from its
    slice of the state: (y, end state)."""
    rows = np.asarray(sos, F32).reshape(-1, 6)
    ys, ends = x, []
    for k in range(rows.shape[0]):
        st = None if state is None else state[k : k + 1]
        ys, end = _emulate_section_launches(ys, rows[k : k + 1], st, tile_rows)
        ends.append(end)
    return ys, np.concatenate(ends)


def _emulate_section_launches(x, rows, state, tile_rows):
    """sos_tile_kernel's three launches of one section, M its own Phi^tile."""
    s = rows.shape[0]
    c, n = x.shape
    tile = iir.pick_tile(c, n, tile_rows)
    ntiles = -(-n // tile)
    tab = iir.section_table(rows)
    m = np.linalg.matrix_power(iir.cascade_transition(rows), tile).astype(F32)
    y = np.zeros_like(x)
    end = np.zeros((s, c, 2), F32)
    for ch in range(c):
        # 1. tiles 0..ntiles-2 from zero state
        z = [_tile_end(x[ch], ti, tile, n, ntiles, tab) for ti in range(ntiles - 1)]
        # 2. one warp walks the tiles
        st = np.zeros(2 * s, F32) if state is None else state[:, ch, :].reshape(-1).astype(F32)
        starts = []
        for ti in range(ntiles):
            starts.append(st)
            if ti < ntiles - 1:
                st = (m @ st + z[ti]).astype(F32)
        # 3. every tile from its state
        for ti in range(ntiles):
            car = starts[ti].reshape(s, 2).copy()
            yt, e = _tile(x[ch], ti, tile, n, ntiles, tab, car, True)
            y[ch, ti * tile : ti * tile + yt.size] = yt
            if e is not None:
                end[:, ch] = e
    return y, end


def _tile_end(xc, ti, tile, n, ntiles, tab):
    car = np.zeros((tab.shape[0], 2), F32)
    _tile(xc, ti, tile, n, ntiles, tab, car, False)
    return car.reshape(-1)


def emulate_iir1(x, a, b, tile_rows=None):
    """The three launches of dsp_iir1 on (C, n) float32."""
    c, n = x.shape
    tile = iir.pick_tile(c, n, tile_rows)
    ntiles = -(-n // tile)
    tab = iir.iir1_table(a, b)
    a, b, ap = tab[0], tab[1], tab[4 : 4 + 33]
    m = F32(tab[0].astype(np.float64) ** tile)
    lane = np.arange(iir.THREADS) % 32
    warp = np.arange(iir.THREADS) // 32

    def run(xc, ti, carry):
        t0, t1 = ti * tile, min(ti * tile + tile, n)
        ys = []
        for s0 in range(t0, t1, iir.SUB_TILE):
            count = min(iir.SUB_TILE, t1 - s0)
            buf = np.zeros(iir.SUB_TILE, F32)
            buf[:count] = xc[s0 : s0 + count]
            seg = buf.reshape(iir.THREADS, iir.SEG)
            s = np.zeros(iir.THREADS, F32)
            for j in range(iir.SEG):
                s = a * s + b * seg[:, j]
                seg[:, j] = s
            w, e = _warp_scan(np.stack([s, np.zeros_like(s)], 1),
                              lambda d: np.array([[ap[d], 0], [0, 0]], F32))
            wbeg, cv = [], carry
            for q in range(iir.THREADS // 32):
                wbeg.append(cv)
                cv = ap[32] * cv + w[q * 32 + 31, 0]
            carry = cv
            v = ap[lane] * np.array(wbeg, F32)[warp] + e[:, 0]
            for j in range(iir.SEG):
                v = a * v
                seg[:, j] += v
            ys.append(buf[:count])
        return np.concatenate(ys), carry

    y = np.zeros_like(x)
    for ch in range(c):
        z = [run(x[ch], ti, F32(0))[1] for ti in range(ntiles - 1)]
        st = F32(0)
        for ti in range(ntiles):
            yt, _ = run(x[ch], ti, st)
            y[ch, ti * tile : ti * tile + yt.size] = yt
            if ti < ntiles - 1:
                st = F32(m * st + z[ti])
    return y


# lengths around the sub-tile (4096) and tile edges; tile_rows 32 = one
# sub-tile a tile (many tiles to chain), 64 = two
EMU_CASES = [
    (1, 32), (iir.SUB_TILE - 1, 32), (iir.SUB_TILE, 32), (iir.SUB_TILE + 1, 32),
    (3 * iir.SUB_TILE + 77, 32), (3 * iir.SUB_TILE + 77, 64), (2 * iir.SUB_TILE, 64),
]


@pytest.mark.parametrize("n,tile_rows", EMU_CASES)
@pytest.mark.parametrize("sos_name", ["butter8", "biquad"])
def test_emulated_cascade_matches_scipy(rng, n, tile_rows, sos_name):
    sos = SOS[sos_name]
    x = sig(rng, (2, n))
    state = (0.3 * rng.normal(size=(sos.shape[0], 2, 2))).astype(F32)
    y, end = emulate_cascade(x, sos, state, tile_rows)
    want_y, want_end = scipy_sos(sos, x, zi=state.astype(np.float64))
    scale = np.abs(want_y).max()
    assert rel_err(y, want_y) < TOL
    assert np.abs(end - want_end).max() < TOL * scale
    # the plain version is the same function
    got, got_end = iir.sos_cascade(t(x), sos, t(state))
    assert rel_err(got.numpy(), y) < TOL and np.abs(got_end.numpy() - end).max() < TOL * scale


def test_emulated_cascade_impulse_and_zeros():
    sos = SOS["butter8"]
    n = 2 * iir.SUB_TILE + 5
    x = np.zeros((3, n), F32)
    for ch, p in enumerate((0, iir.SUB_TILE - 1, iir.SUB_TILE + 16)):
        x[ch, p] = 1.0
    y, _ = emulate_cascade(x, sos, None, 32)
    assert rel_err(y, scipy_sos(sos, x)) < TOL
    assert np.all(y[1, : iir.SUB_TILE - 1] == 0.0)  # causal: nothing before the impulse
    y0, end0 = emulate_cascade(np.zeros((1, n), F32), sos, None, 32)
    assert not y0.any() and not end0.any()


@pytest.mark.parametrize("a", [0.5, -0.3, 0.99, 0.9999])
@pytest.mark.parametrize("n,tile_rows", [(iir.SUB_TILE + 1, 32), (3 * iir.SUB_TILE + 77, 64)])
def test_emulated_iir1_matches_scipy(rng, a, n, tile_rows):
    x = sig(rng, (2, n))
    y = emulate_iir1(x, a, 0.7, tile_rows)
    want = sps.lfilter([float(F32(0.7))], [1.0, -float(F32(a))], x.astype(np.float64), axis=-1)
    assert rel_err(y, want) < TOL
    assert rel_err(iir.iir1_block_scan(t(x), a, 0.7).numpy(), y) < TOL


def test_tables_hold_the_powers():
    rows = SOS["butter4"]
    tab = iir.section_table(rows)
    for k, r in enumerate(rows.astype(np.float64)):
        phi = np.array([[-r[4], 1.0], [-r[5], 0.0]])
        for m in (0, 1, 7, 32):
            want = np.linalg.matrix_power(phi, iir.SEG * m)
            np.testing.assert_allclose(tab[k, 8 + 4 * m : 12 + 4 * m], want.ravel(), rtol=1e-6,
                                       atol=1e-30)
    # M is block lower triangular: a section's state never moves an earlier one
    g = iir.cascade_transition(rows)
    for k in range(rows.shape[0]):
        assert not g[2 * k : 2 * k + 2, 2 * k + 2 :].any()
    # and one sample of the cascade from a unit state is column r of G
    x = np.zeros((1, 1), F32)
    for r in range(2 * rows.shape[0]):
        zi = np.zeros((rows.shape[0], 1, 2))
        zi.reshape(-1, 2)[r // 2, r % 2] = 1.0
        _, zf = scipy_sos(rows, x, zi=zi)
        np.testing.assert_allclose(zf.reshape(-1), g[:, r], atol=1e-12)


def test_sections_and_cascade_plain_versions_agree(rng):
    sos = SOS["butter8"]
    x = t(sig(rng, (2, 2000)))
    st = t((0.1 * rng.normal(size=(4, 2, 2))).astype(F32))
    y12, e12 = iir.sos_cascade(x, sos, st)
    y15, e15 = iir.sos_sections(x, sos, st)
    assert rel_err(y15.numpy(), y12.numpy()) < TOL
    assert np.abs(e15.numpy() - e12.numpy()).max() < TOL * np.abs(y12.numpy()).max()


# --- NumPy emulation of B12's single pass (csrc/iir.cu sos_lookback_kernel) ----------
#
# Every step at the wrapper's geometry, in float32: the staged slots (the
# swizzled rows, the held and the streamed sub-tiles), the tile's end state as
# a linear map (each lane's dot product with W, the butterfly sum, a warp's
# Horner chain over its groups by M_sub, the weight M_warp^e, the warps' sums
# in order), the fixed-depth look-back resolved by blocks that take tickets in
# order and advance in a shuffled order, and the cascade once from s_t (the
# warp scan, every warp's chain of the warps' totals, the correction) with the
# end-state thread. B13 is this pass with the section count fixed
# (``unrolled``); the three launches above (emulate_cascade) are B15's.


def _mv(m, v, init):
    """init + m @ v in float32, one term at a time in the kernel's order."""
    out = np.asarray(init, F32).copy()
    for q in range(v.shape[0]):
        out = (out + m[:, q] * v[q]).astype(F32)
    return out


def _lb_tables(rows, tile):
    d = 2 * rows.shape[0]
    depth = iir.lookback_depth(rows.shape[0])
    mats = iir.lookback_mats(rows, tile)
    nw = d * iir.LB_SEG * 32
    w = mats[:nw].reshape(d, iir.LB_SEG // 4, 32, 4).transpose(2, 0, 1, 3).reshape(32, d, -1)
    rest = mats[nw:].reshape(-1, d, d).swapaxes(1, 2)  # stored [q][r]: back to [r][q]
    assert rest.shape[0] == 1 + 8 + depth + 1
    return iir.lookback_table(rows), w, rest[0], rest[1:9], rest[9:], depth


def _lb_swizzle(row):
    return (row // (32 // iir.LB_SEG)) & (iir.LB_SEG // 4 - 1)


def _lb_slot(k):
    """Where sample k of a sub-tile sits in a slot (lb_slot)."""
    row, p = k // iir.LB_SEG, k % iir.LB_SEG
    return row * iir.LB_SEG + 4 * ((p >> 2) ^ _lb_swizzle(row)) + (p & 3)


def _lb_rows(slot):
    """(THREADS, LB_SEG): each thread's samples as lb_row reads them."""
    row = np.arange(iir.LB_THREADS)[:, None]
    p = np.arange(iir.LB_SEG)[None, :]
    idx = row * iir.LB_SEG + 4 * ((p >> 2) ^ _lb_swizzle(row)) + (p & 3)
    return slot[idx].copy()


def _lb_put_rows(slot, v):
    row = np.arange(iir.LB_THREADS)[:, None]
    p = np.arange(iir.LB_SEG)[None, :]
    slot[row * iir.LB_SEG + 4 * ((p >> 2) ^ _lb_swizzle(row)) + (p & 3)] = v


def _lb_load(slot, xs, count):
    k = np.arange(iir.LB_SUB)
    slot[_lb_slot(k)] = np.where(k < count, np.pad(xs[:count], (0, iir.LB_SUB - count)), 0)


def _warp_components(p):
    """warp_components: (32 lanes, D) partial sums -> the DP components' sums (DP >= D
    a power of two, at least 4). Halves of each lane's values go to its partner
    while the lanes' bits last, then plain steps; lane l holds component
    l / (32 / DP), alike in the lanes sharing it."""
    lane = np.arange(32)
    dp = max(4, 1 << (p.shape[1] - 1).bit_length())
    p = np.pad(p, ((0, 0), (0, dp - p.shape[1])))
    h, dd = dp // 2, 16
    while h >= 1:
        up = ((lane & dd) != 0)[:, None]
        send = np.where(up, p[:, :h], p[:, h : 2 * h])
        keep = np.where(up, p[:, h : 2 * h], p[:, :h])
        p = (keep + send[lane ^ dd]).astype(F32)
        h, dd = h // 2, dd // 2
    v = p[:, 0]
    while dd >= 1:
        v = (v + v[lane ^ dd]).astype(F32)
        dd //= 2
    group = 32 // dp
    held = v.reshape(dp, group)
    assert (held == held[:, :1]).all()
    return held[:, 0]


def _lb_end(rows_of, subs, w, msub, qw, groups_in_tile):
    """B: the tile's end state from zero state; rows_of(j) the slot rows of sub-tile j."""
    d = w.shape[1]
    nw = iir.LB_THREADS // 32
    zpart = np.zeros((nw, d), F32)
    for warp in range(nw):
        acc, groups = None, 0
        for j in range(subs):
            if nw * j + warp >= groups_in_tile:
                continue
            xv = rows_of(j)[32 * warp : 32 * warp + 32]
            p0 = np.zeros((32, d), F32)
            p1 = np.zeros((32, d), F32)
            for i in range(0, iir.LB_SEG, 2):
                p0 = (p0 + w[:, :, i] * xv[:, i, None]).astype(F32)
                p1 = (p1 + w[:, :, i + 1] * xv[:, i + 1, None]).astype(F32)
            u = _warp_components((p0 + p1).astype(F32))[:d]
            acc = u if groups == 0 else _mv(msub, acc, u)
            groups += 1
        if groups:
            zpart[warp] = _mv(qw[groups_in_tile - 1 - (nw * (groups - 1) + warp)], acc, np.zeros(d))
    z = zpart[0]
    for warp in range(1, nw):
        z = (z + zpart[warp]).astype(F32)
    return z


def _lb_section(v, tb, car):
    """lb_section over a sub-tile's 256 threads, v (THREADS, LB_SEG) in place;
    car (2,) the carry, left at the sub-tile's end. Returns the threads' start
    states (THREADS, 2)."""
    b0, b1, b2, a1, a2 = tb[:5]
    lp = tb[8 : 8 + 4 * 33].reshape(33, 2, 2)
    wp = tb[iir._LB_WARP_POW : iir._LB_WARP_POW + 36].reshape(9, 2, 2)
    lane = np.arange(iir.LB_THREADS) % 32
    warp = np.arange(iir.LB_THREADS) // 32
    s1 = np.zeros(iir.LB_THREADS, F32)
    s2 = np.zeros(iir.LB_THREADS, F32)
    for j in range(iir.LB_SEG):
        xv = v[:, j].copy()
        yv = (b0 * xv + s1).astype(F32)
        s1, s2 = (b1 * xv + (-a1 * yv + s2)).astype(F32), (b2 * xv - a2 * yv).astype(F32)
        v[:, j] = yv
    w, e = _warp_scan(np.stack([s1, s2], 1), lambda d: lp[d])
    tot = w[lane == 31]  # (warps, 2) the warps' totals
    nw = tot.shape[0]
    idx = np.arange(nw)
    d = 1
    while d < nw:  # lanes 0 .. warps - 1 of every warp
        tot = np.where((idx >= d)[:, None], tot + np.roll(tot, d, 0) @ wp[d].T, tot).astype(F32)
        d *= 2
    excl = np.concatenate([np.zeros((1, 2), F32), tot[:-1]])
    g = (np.einsum("wij,j->wi", wp[:nw], car) + excl).astype(F32)  # the state entering each warp
    car[:] = wp[nw] @ car + tot[nw - 1]
    r = (np.einsum("tij,tj->ti", lp[lane], g[warp]) + e).astype(F32)
    q = r.copy()
    for j in range(iir.LB_SEG):
        v[:, j] += q[:, 0]
        q = np.stack([-a1 * q[:, 0] + q[:, 1], -a2 * q[:, 0]], 1).astype(F32)
    return r


def emulate_lookback(x, sos, state=None, tile_rows=None, order=0, resident=5, unrolled=False):
    """B12's one launch on (C, n) float32: (y, end state or None); B13's with
    ``unrolled``.

    ``order`` seeds the shuffled order in which the resident blocks (each with
    a ticket, taken in order) advance; a block waiting on a record it cannot
    read yet does not advance. B13 is the same kernel with NS = S sections
    fixed at compile time (1..MAX_UNROLLED, zero state): D = 2 NS and the
    butterfly's DP follow from NS, every D-term sum and the sections unroll
    with their terms in B12's order, so each float operation is B12's.
    """
    rows = np.asarray(sos, F32).reshape(-1, 6)
    s = rows.shape[0]
    if unrolled:
        assert 1 <= s <= iir.MAX_UNROLLED and state is None
    c, n = x.shape
    tile = iir.lookback_tile(c, n, tile_rows)
    ntiles = -(-n // tile)
    tab, w, msub, qw, mp, depth = _lb_tables(rows, tile)
    subs_full = -(-tile // iir.LB_SUB)
    hold = min(subs_full, iir.LB_HOLD_SUBS)
    groups_in_tile = tile // (32 * iir.LB_SEG)
    y = np.full_like(x, np.nan)
    end = None if state is None else np.full((s, c, 2), np.nan, F32)
    zrec, srec = {}, {}

    def run_tile(tk):
        """A generator: yields while it waits on a record, returns when done."""
        t, ch = divmod(tk, c)
        t0, t1 = t * tile, min(t * tile + tile, n)
        subs = -(-(t1 - t0) // iir.LB_SUB)
        keep = hold - 1 if subs > hold else subs
        slots = np.full((hold, iir.LB_SUB), np.nan, F32)

        def count(j):
            return min(iir.LB_SUB, t1 - t0 - j * iir.LB_SUB)

        def rows_of(j):
            if j >= keep:  # the streaming slot, read again from x
                _lb_load(slots[keep], x[ch, t0 + j * iir.LB_SUB :], count(j))
            return _lb_rows(slots[min(j, keep)])

        for j in range(keep):
            _lb_load(slots[j], x[ch, t0 + j * iir.LB_SUB :], count(j))
        last = t == ntiles - 1
        if not last:
            zrec[t, ch] = _lb_end(rows_of, subs, w, msub, qw, groups_in_tile)
        yield
        terms = min(t, depth)
        while not all((t - 1 - m, ch) in zrec for m in range(terms)):
            yield
        st = np.zeros(2 * s, F32)
        for m in range(terms):
            st = _mv(mp[m], zrec[t - 1 - m, ch], st)
        if t >= depth:
            while (t - depth, ch) not in srec:
                yield
            base = srec[t - depth, ch]
        else:
            base = np.zeros(2 * s, F32) if state is None else state[:, ch].reshape(-1)
        st = _mv(mp[terms], base, st)
        if t + depth < ntiles:
            srec[t, ch] = st
        yield
        car = st.reshape(s, 2).copy()
        for j in range(subs):
            v = rows_of(j)
            slot = slots[min(j, keep)]
            p = n - 1 - t0 - j * iir.LB_SUB
            mine = p // iir.LB_SEG if end is not None and last and 0 <= p < iir.LB_SUB else None
            saved = []
            for k in range(s):
                inp = None if mine is None else v[mine].copy()
                r = _lb_section(v, tab[k], car[k])
                saved.append((inp, None if mine is None else r[mine]))
            _lb_put_rows(slot, v)
            cnt = count(j)
            k_idx = np.arange(cnt)
            y[ch, t0 + j * iir.LB_SUB : t0 + j * iir.LB_SUB + cnt] = slot[_lb_slot(k_idx)]
            if mine is not None:  # the end-state thread, a section at a time
                for k, (inp, r0) in enumerate(saved):
                    b0, b1, b2, a1, a2 = tab[k, :5]
                    s1, s2 = r0
                    for i in range(p % iir.LB_SEG + 1):
                        yv = F32(b0 * inp[i] + s1)
                        s1, s2 = F32(b1 * inp[i] + (-a1 * yv + s2)), F32(b2 * inp[i] - a2 * yv)
                    end[k, ch] = s1, s2

    rng = np.random.default_rng(order)
    total, nxt, live = ntiles * c, 0, []
    while nxt < total or live:
        while len(live) < resident and nxt < total:  # a block takes the next ticket
            live.append(run_tile(nxt))
            nxt += 1
        moved = False
        for i in rng.permutation(len(live)):
            try:
                next(live[i])
                moved = True
                break
            except StopIteration:
                live.pop(i)
                moved = True
                break
        assert moved, "every resident block waits: the look-back deadlocked"
    assert not np.isnan(y).any()
    return y, end


def _lb_case(rng, s, n, channels=2, seeded=True):
    sos = iir.design_butterworth(2 * s, 0.1)
    x = sig(rng, (channels, n))
    state = (0.3 * rng.normal(size=(s, channels, 2))).astype(F32) if seeded else None
    return sos, x, state


# (sections, n, tile_rows, seeded): every section count, ragged T, tiles below,
# at and above the depth L (8 up to 8 sections, 4 at 16), the held and the
# streamed sub-tiles (tile_rows 32..160: 1..5 sub-tiles, a block holds 4)
LB_CASES = [
    (1, 1, 32, True), (1, 5 * iir.LB_SUB + 3, 32, False), (2, 9 * iir.LB_SUB + 1, 32, True),
    (2, 3 * iir.LB_SUB + 77, 64, True), (4, 8 * iir.LB_SUB, 32, True),
    (4, 7 * iir.LB_SUB + 5, 32, False), (4, 11 * iir.LB_SUB - 9, 32, True),
    (4, 5 * iir.LB_SUB + 77, 96, True), (4, 9 * iir.LB_SUB + 1, 128, False),
    (4, 11 * iir.LB_SUB + 77, 160, True), (4, 3 * iir.LB_SUB + 77, None, True),
    (8, 10 * iir.LB_SUB + 3, 32, True), (8, 2 * iir.LB_SUB - 1, 64, False),
    (16, 3 * iir.LB_SUB + 7, 32, True), (16, 4 * iir.LB_SUB, 32, False),
    (16, 6 * iir.LB_SUB + 1, 32, True), (16, 2 * iir.LB_SUB + 5, 160, True),
]


# At 16 sections of butter(32, 0.1) (poles at radius up to 0.985) any float32
# recurrence lies 1e-5 or more from float64: the plain version 1.0e-5 to
# 1.6e-5 on these cases, the three launches' emulation 1.3e-5 to 2.2e-5. There
# a block is held to float64 within HIGHQ_FACTOR x plain's own error, the rule
# chip_smoke.py's high-Q checks follow; below it, within TOL of float64 and of
# plain.
HIGHQ_FACTOR = 2.0
HIGHQ_SECTIONS = 16


@pytest.mark.parametrize("s,n,tile_rows,seeded", LB_CASES)
def test_lookback_block_algorithm(rng, s, n, tile_rows, seeded):
    sos, x, state = _lb_case(rng, s, n, seeded=seeded)
    y, end = emulate_lookback(x, sos, state, tile_rows, order=s * n)
    zi = np.zeros((s, 2, 2)) if state is None else state.astype(np.float64)
    want_y, want_end = scipy_sos(sos, x, zi=zi)
    scale = np.abs(want_y).max()
    got, got_end = iir.sos_cascade(t(x), sos, None if state is None else t(state))
    bound = TOL
    if s >= HIGHQ_SECTIONS:
        bound = max(TOL, HIGHQ_FACTOR * rel_err(got.numpy(), want_y))
    assert rel_err(y, want_y) < bound
    if seeded:
        assert np.abs(end - want_end).max() < bound * scale
    if s < HIGHQ_SECTIONS:  # the plain version is the same function
        assert rel_err(got.numpy(), y) < TOL
        if seeded:
            assert np.abs(got_end.numpy() - end).max() < TOL * scale


@pytest.mark.parametrize("s,n,tile_rows", [(4, 3 * iir.LB_SUB + 77, 32), (8, 2 * iir.LB_SUB + 5, 32)])
def test_lookback_block_matches_jax(rng, s, n, tile_rows):
    sos, x, state = _lb_case(rng, s, n)
    y, end = emulate_lookback(x, sos, state, tile_rows)
    jst, jy = jax_iir.sosfilt_chunk(state, sos, x, method="xla_scan")
    scale = np.abs(np.asarray(jy)).max()
    assert rel_err(y, np.asarray(jy)) < TOL
    assert np.abs(end - np.asarray(jst)).max() < TOL * scale


@pytest.mark.parametrize("s,n,tile_rows", [(1, 5 * iir.LB_SUB + 3, 32), (4, 9 * iir.LB_SUB + 77, 32),
                                           (4, 3 * iir.LB_SUB + 77, None), (8, 10 * iir.LB_SUB + 3, 64)])
def test_unrolled_block_algorithm(rng, s, n, tile_rows):
    """B13: B12's pass with the sections fixed, from zero state, against scipy's
    float64 filter and the JAX package's sosfilt_pallas_fused(unroll_sections=True)
    within TOL of max|y|, and bit-identical over completion orders."""
    sos, x, _ = _lb_case(rng, s, n, seeded=False)
    y, end = emulate_lookback(x, sos, None, tile_rows, order=s, unrolled=True)
    assert end is None
    assert rel_err(y, scipy_sos(sos, x)) < TOL
    want = np.asarray(jax_iir.sosfilt_pallas_fused(sos, x, tile_rows=8, unroll_sections=True))
    assert rel_err(y, want) < TOL
    assert rel_err(iir.sos_cascade_unrolled(t(x), sos, tile_rows=tile_rows).numpy(), y) < TOL
    y2, _ = emulate_lookback(x, sos, None, tile_rows, order=s + 7, resident=9, unrolled=True)
    assert np.array_equal(y, y2)


@pytest.mark.parametrize("s", [4, 16])
def test_lookback_is_deterministic_in_any_order(rng, s):
    # the fixed depth sums the same terms in the same order whichever tiles
    # publish first: y is bit-identical over completion orders and residencies
    sos, x, state = _lb_case(rng, s, 12 * iir.LB_SUB + 5, channels=3)
    y0, end0 = emulate_lookback(x, sos, state, 32, order=0, resident=1)
    for order, resident in ((1, 4), (2, 9), (3, 40)):
        y, end = emulate_lookback(x, sos, state, 32, order=order, resident=resident)
        assert np.array_equal(y, y0) and np.array_equal(end, end0)


def test_lookback_impulse_and_zeros():
    sos = SOS["butter8"]
    n = 9 * iir.LB_SUB + 5
    x = np.zeros((4, n), F32)
    for ch, p in enumerate((0, iir.LB_SUB - 1, 8 * iir.LB_SUB, n - 1)):  # at sub-tile and tile edges
        x[ch, p] = 1.0
    y, _ = emulate_lookback(x, sos, None, 32)
    assert rel_err(y, scipy_sos(sos, x)) < TOL
    assert np.all(y[2, : 8 * iir.LB_SUB] == 0.0)  # causal
    y0, end0 = emulate_lookback(np.zeros((1, n), F32), sos, np.zeros((4, 1, 2), F32), 32)
    assert not y0.any() and not end0.any()


@pytest.mark.parametrize("s", [1, 4, 5, 16])
def test_lookback_tables_hold_the_maps(s):
    rows = iir.design_butterworth(2 * s, 0.1)
    tile = 3 * iir.LB_SUB
    mt = iir.lookback_matrices(rows, tile)
    g = iir.cascade_transition(rows)
    # K x is the state after a segment from zero state, as scipy runs it
    rng = np.random.default_rng(s)
    xs = rng.normal(size=iir.LB_SEG)
    _, zf = scipy_sos(rows, xs[None], zi=np.zeros((s, 1, 2)))
    np.testing.assert_allclose(mt["K"] @ xs, zf.reshape(-1), rtol=1e-9, atol=1e-12)
    # a lane's weights carry its segment to the end of its warp's group
    lane = 5
    mseg = np.linalg.matrix_power(g, iir.LB_SEG)
    np.testing.assert_allclose(
        mt["W"][lane], np.linalg.matrix_power(mseg, 31 - lane) @ mt["K"], atol=1e-12)
    np.testing.assert_allclose(mt["tile"][1], np.linalg.matrix_power(g, tile), atol=1e-12)
    assert mt["tile"].shape[0] == iir.lookback_depth(s) + 1
    tab = iir.lookback_table(rows)
    for k, r in enumerate(rows.astype(np.float64)):
        phi = np.array([[-r[4], 1.0], [-r[5], 0.0]])
        for m in (1, 8):
            want = np.linalg.matrix_power(phi, 32 * iir.LB_SEG * m).ravel()
            got = tab[k, iir._LB_WARP_POW + 4 * m : iir._LB_WARP_POW + 4 * m + 4]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)


def test_lookback_rows_fall_on_distinct_banks():
    # a quarter warp's 16-byte reads of one chunk of their rows hit 8 distinct
    # 16-byte bank groups (lb_row), and the swizzle is a permutation of the slot
    k = np.arange(iir.LB_SUB)
    assert np.array_equal(np.sort(_lb_slot(k)), k)
    for q in range(iir.LB_SEG // 4):
        for first in range(0, iir.LB_THREADS, 8):
            row = np.arange(first, first + 8)
            word = row * iir.LB_SEG + 4 * (q ^ _lb_swizzle(row))
            assert len(set((word // 4) % 8)) == 8
