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
state. They are held against scipy.

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
    with pytest.raises(ValueError, match="B13"):
        iir.sosfilt_pallas_fused(np.tile(sos, (5, 1)), x, unroll_sections=True)  # 10 sections
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
    """The warp's Hillis-Steele steps: z (THREADS, 2), step(d) the 2x2 power."""
    lane = np.arange(iir.THREADS) % 32
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
    """The three launches of dsp_sos_cascade on (C, n) float32: (y, end state)."""
    rows = np.asarray(sos, F32).reshape(-1, 6)
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
