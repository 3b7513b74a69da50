"""The reference's IIR anchors B11 and B14 against the JAX package, scipy, and
NumPy emulations of their CUDA blocks.

``iir_first_order_pallas(kernel="tile")`` (B11, ``_iir1_kernel``) and
``sosfilt_pallas_fused(lane_pass="mxu")`` (B14, ``_biquad_fused_mxu_kernel``)
run through the JAX package (its Pallas kernels in interpret mode, with
``tile_rows=8`` as tests/test_iir.py runs them, 128 for the compact row
pass) and through the port on the CPU, where the wrappers take B10's and
B12's plain versions. ``emulate_b11`` and ``emulate_b14`` do what the blocks
of ``csrc/iir.cu`` do, with the wrappers' geometry and tables: B11's
per-sample maps composed by a thread, a warp's shuffle steps and thread 0's
chain, alpha in float64 and beta in float32, the launch-2 compose of the
tiles' maps; B14's c in float64, the segment times T summed in float64 and
rounded once to float32 (the FP64 tensor-core product), B12's row scan in
float32 and the three launches.

Tolerances, relative to max|y|: 1e-5 against the JAX package and against
the emulations (float32 recurrences that sum in other orders; the port's
bound for its IIR kernels), 1e-5 against scipy's float64 filter with the
same float32 coefficients (the emulations and plain versions measure 1e-7 to
3e-6 here), and 1e-4 for the JAX package's own kernels against scipy, its
own tests' bound (tests/test_iir.py: its tile kernel composes alpha in
float32).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import iir as jax_iir
from digital_signal_processsing_tpu_torch.ops import iir, iir_design, launch_counts, reset_launch_counts

TOL, JAX64_TOL = 1e-5, 1e-4
F32 = np.float32
SUB = iir.SUB_TILE


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def sig(rng, shape):
    return rng.normal(size=shape).astype(F32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def scipy_sos(sos, x):
    return sps.sosfilt(np.asarray(sos, F32).astype(np.float64), np.asarray(x, np.float64), axis=-1)


def scipy_iir1(x, a, b):
    return sps.lfilter([float(F32(b))], [1.0, -float(F32(a))], np.asarray(x, np.float64), axis=-1)


def ellip_design():
    """An elliptic lowpass by order selection: 0.1 passband, 0.15 stopband."""
    order, wn = iir_design.ellipord(0.1, 0.15, 0.5, 60.0)
    return iir_design.iirdesign(0.1, 0.15, 0.5, 60.0, ftype="ellip"), order, wn


DESIGNS = {
    "butter": lambda: iir_design.iirfilter(8, 0.1),
    "cheby2": lambda: iir_design.iirfilter(6, 0.2, ftype="cheby2", rs=50.0),
    "ellip": lambda: ellip_design()[0],
}


def f32rows(sos):
    return np.asarray(sos, F32).reshape(-1, 6)


# --- against the JAX package and scipy ---------------------------------------------


@pytest.mark.parametrize("a", [0.5, -0.3, 0.99, 0.9999])
def test_b11_matches_jax_and_scipy(rng, a):
    x = sig(rng, (2, 3000))
    got = iir.iir_first_order_pallas(t(x), a, 0.7, kernel="tile").numpy()
    want_jax = np.asarray(jax_iir.iir_first_order_pallas(x, a, 0.7, kernel="tile", tile_rows=8))
    want64 = scipy_iir1(x, a, 0.7)
    assert rel_err(got, want_jax) < TOL
    assert rel_err(got, want64) < TOL
    assert rel_err(want_jax, want64) < JAX64_TOL


@pytest.mark.parametrize("design", sorted(DESIGNS))
@pytest.mark.parametrize("row_pass,tile_rows", [("bcast", 8), ("compact", 128)])
def test_b14_matches_jax_and_scipy(rng, design, row_pass, tile_rows):
    sos = f32rows(DESIGNS[design]())
    x = sig(rng, (2, 3000))
    got = iir.sosfilt_pallas_fused(sos, t(x), lane_pass="mxu", row_pass=row_pass).numpy()
    want_jax = np.asarray(jax_iir.sosfilt_pallas_fused(
        sos, x, tile_rows=tile_rows, lane_pass="mxu", row_pass=row_pass))
    want64 = scipy_sos(sos, x)
    assert rel_err(got, want_jax) < TOL
    assert rel_err(got, want64) < TOL
    assert rel_err(want_jax, want64) < JAX64_TOL


def test_elliptic_design_by_order_selection():
    sos, order, wn = ellip_design()
    want_order, want_wn = sps.ellipord(0.1, 0.15, 0.5, 60.0)
    assert (order, wn) == (want_order, pytest.approx(want_wn, rel=1e-12))
    w, h = sps.sosfreqz(sos.astype(np.float64), 4096)
    f = w / np.pi
    mag = 20 * np.log10(np.abs(h) + 1e-300)
    # the specification, to 1e-3 dB (the ripple lands on its edge to 1e-5 dB)
    assert mag[f <= 0.1].min() > -0.5 - 1e-3 and mag[f >= 0.15].max() < -60.0 + 1e-3


def test_anchors_take_the_plain_versions_on_the_cpu(rng):
    x = t(sig(rng, (3, 2 * SUB + 9)))
    sos = f32rows(DESIGNS["butter"]())
    reset_launch_counts()
    y11 = iir.iir_first_order_pallas(x, 0.95, 0.5, kernel="tile")
    y14 = iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu", row_pass="compact")
    assert torch.equal(y11, iir._iir1_plain(x, 0.95, 0.5))
    assert torch.equal(y14, iir._sos_plain(x, sos, None)[0])
    assert launch_counts()["B11"] == launch_counts()["B14"] == 0
    # any leading axes are streams, as for the other entry points
    x3 = t(sig(rng, (2, 3, 700)))
    assert iir.iir_first_order_pallas(x3, 0.9, kernel="tile").shape == (2, 3, 700)
    assert iir.sosfilt_pallas_fused(sos, x3, lane_pass="mxu").shape == (2, 3, 700)


def test_anchor_refusals(rng):
    x = torch.zeros(2, 100)
    sos = f32rows(DESIGNS["butter"]())
    with pytest.raises(ValueError, match="kernel='tile' supports row_pass='bcast' only"):
        iir.iir_first_order_pallas(x, 0.9, kernel="tile", row_pass="compact")
    with pytest.raises(ValueError, match="unknown kernel 'nope'"):
        iir.iir_first_order_pallas(x, 0.9, kernel="nope")
    with pytest.raises(ValueError, match="unknown lane_pass 'tpu'"):
        iir.sosfilt_pallas_fused(sos, x, lane_pass="tpu")
    with pytest.raises(ValueError, match="unknown row_pass 'rows'"):
        iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu", row_pass="rows")
    with pytest.raises(ValueError, match="compact"):
        iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu", row_pass="compact", tile_rows=64)
    with pytest.raises(ValueError, match="B14"):
        iir.sosfilt_pallas_fused(np.tile(sos, (5, 1)), x, lane_pass="mxu")  # 20 sections
    with pytest.raises(ValueError, match="tile_rows"):
        iir.iir_first_order_pallas(x, 0.9, kernel="tile", tile_rows=8)
    # as the reference, lane_pass='mxu' ignores unroll_sections
    y = iir.sosfilt_pallas_fused(sos, x + 1.0, lane_pass="mxu", unroll_sections=True,
                                 row_pass="compact")
    assert torch.equal(y, iir.sosfilt_pallas_fused(sos, x + 1.0))


# --- NumPy emulation of B11 --------------------------------------------------------


def _fma(a, b, c):
    """fmaf: the product and sum in float64, one rounding to float32."""
    return (np.float64(a) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(F32)


def _compose_warp(ma, mb):
    """A warp's inclusive Hillis-Steele compose of per-lane maps, then the
    exclusive maps (identity at lane 0); ma float64, mb float32."""
    lane = np.arange(ma.size) % 32
    for d in (1, 2, 4, 8, 16):
        ua, ub = np.roll(ma, d), np.roll(mb, d)
        on = lane >= d
        mb = np.where(on, _fma(1.0, ma.astype(F32) * ub.astype(np.float64), mb), mb).astype(F32)
        ma = np.where(on, ma * ua, ma)
    ea, eb = np.roll(ma, 1), np.roll(mb, 1)
    ea[lane == 0], eb[lane == 0] = 1.0, 0.0
    return ma, mb, ea, eb


def emulate_b11(x, a, b, tile_rows=None):
    """The three launches of dsp_iir1_affine on (C, n) float32."""
    c, n = x.shape
    tile = iir.pick_tile(c, n, tile_rows)
    ntiles = -(-n // tile)
    a32, b32 = F32(a), F32(b)
    lane = np.arange(iir.THREADS) % 32
    warp = np.arange(iir.THREADS) // 32

    def run(xc, ti, state):
        """One block: (y of the tile, its composed map (alpha, beta))."""
        t0, t1 = ti * tile, min(ti * tile + tile, n)
        ra, rb = 1.0, F32(state)
        ys = []
        for s0 in range(t0, t1, SUB):
            count = min(SUB, t1 - s0)
            buf = np.zeros(SUB, F32)
            buf[:count] = xc[s0 : s0 + count]
            seg = buf.reshape(iir.THREADS, iir.SEG)
            ma = np.ones(iir.THREADS)
            mb = np.zeros(iir.THREADS, F32)
            beta = np.empty_like(seg)
            for j in range(iir.SEG):
                mb = _fma(a32, mb, b32 * seg[:, j])
                ma = ma * np.float64(a32)
                beta[:, j] = mb
            ma, mb, ea, eb = _compose_warp(ma, mb)
            wbeg = []
            for q in range(iir.THREADS // 32):
                wbeg.append(rb)
                rb = _fma(F32(ma[32 * q + 31]), rb, mb[32 * q + 31])
                ra *= ma[32 * q + 31]
            v = _fma(1.0, ea.astype(F32) * np.array(wbeg, F32)[warp].astype(np.float64), eb)
            for j in range(iir.SEG):
                v = (v * a32).astype(F32)
                seg[:, j] = beta[:, j] + v
            ys.append(buf[:count])
        return np.concatenate(ys), (F32(ra), rb)

    y = np.zeros_like(x)
    for ch in range(c):
        # 1. every tile but the last from zero state: its map
        maps = [run(x[ch], ti, 0.0)[1] for ti in range(ntiles - 1)] + [(F32(1), F32(0))]
        # 2. one warp composes the maps 32 tiles at a time
        starts, s = [], F32(0)
        for t0 in range(0, ntiles, 32):
            chunk = maps[t0 : t0 + 32] + [(F32(1), F32(0))] * (32 - len(maps[t0 : t0 + 32]))
            ma = np.array([m[0] for m in chunk], np.float64)
            mb = np.array([m[1] for m in chunk], F32)
            ma, mb, ea, eb = _compose_warp(ma, mb)
            starts += list(_fma(1.0, ea.astype(F32) * np.float64(s), eb))
            s = _fma(F32(ma[31]), s, mb[31])
        # 3. every tile from its state
        for ti in range(ntiles):
            yt, _ = run(x[ch], ti, starts[ti])
            y[ch, ti * tile : ti * tile + yt.size] = yt
    return y


B11_CASES = [(1, 32), (SUB - 1, 32), (SUB + 1, 32), (3 * SUB + 77, 32), (3 * SUB + 77, 64)]


@pytest.mark.parametrize("a", [0.5, -0.3, 0.9999])
@pytest.mark.parametrize("n,tile_rows", B11_CASES)
def test_emulated_b11_matches_scipy_and_plain(rng, a, n, tile_rows):
    x = sig(rng, (2, n))
    y = emulate_b11(x, a, 0.7, tile_rows)
    assert rel_err(y, scipy_iir1(x, a, 0.7)) < TOL
    assert rel_err(iir._iir1_plain(t(x), a, 0.7).numpy(), y) < TOL


def test_emulated_b11_many_tiles_at_a_slow_pole(rng):
    """40 tiles of one sub-tile: launch 2 composes past one warp's 32 maps."""
    x = sig(rng, (1, 40 * SUB - 5))
    y = emulate_b11(x, 0.9999, 0.3, 32)
    assert rel_err(y, scipy_iir1(x, 0.9999, 0.3)) < TOL


def test_emulated_b11_impulse_and_zeros():
    n = 2 * SUB + 5
    x = np.zeros((3, n), F32)
    for ch, p in enumerate((0, SUB - 1, SUB + 16)):
        x[ch, p] = 1.0
    y = emulate_b11(x, 0.99, 1.0, 32)
    assert rel_err(y, scipy_iir1(x, 0.99, 1.0)) < TOL
    assert np.all(y[1, : SUB - 1] == 0.0)
    assert not emulate_b11(np.zeros((1, n), F32), 0.9999, 1.0, 32).any()


# --- NumPy emulation of B14 --------------------------------------------------------


def _mxu_section(yb, tab, tmat, car):
    """One section over a sub-tile as sos_mxu_tile_kernel runs it: yb (MXU_SUB,)
    and car (2,) float32, both in place."""
    seg = iir.MXU_SEG
    rows = yb.reshape(-1, seg).astype(np.float64)
    c = np.concatenate([rows * np.float64(tab[5]), rows * np.float64(tab[6])], 1)
    d = (c @ tmat).astype(F32)  # FP64 products and sums, rounded once
    pw = tab[8 : 8 + 4 * 33].reshape(33, 2, 2)
    lane = np.arange(32)
    w = d[:, seg : seg + 2].copy()
    for step in (1, 2, 4, 8, 16):
        u = np.roll(w, step, axis=0)
        w = np.where((lane >= step)[:, None], (w + u @ pw[step].T).astype(F32), w)
    e = np.roll(w, 1, axis=0)
    e[0] = 0.0
    entry = (np.einsum("rij,j->ri", pw[:32], car) + e).astype(F32)
    car[:] = (pw[32] @ car + w[31]).astype(F32)
    pl = tab[8 + 4 * 33 : 8 + 4 * 33 + 4 * seg].reshape(seg, 2, 2)
    s1 = d[:, :seg] + pl[None, :, 0, 0] * entry[:, :1] + pl[None, :, 0, 1] * entry[:, 1:]
    yb[:] = (np.float64(tab[0]) * yb + s1.reshape(-1)).astype(F32)


def emulate_b14(x, sos, tile_rows=None):
    """The three launches of dsp_sos_cascade_mxu on (C, n) float32."""
    rows = f32rows(sos)
    s = rows.shape[0]
    c, n = x.shape
    tile = iir.pick_tile(c, n, tile_rows)
    ntiles = -(-n // tile)
    tab, tmat = iir.mxu_tables(rows)
    m = np.linalg.matrix_power(iir.cascade_transition(rows), tile).astype(F32)

    def run(xc, ti, car, out):
        t0, t1 = ti * tile, min(ti * tile + tile, n)
        for s0 in range(t0, t1, iir.MXU_SUB):
            count = min(iir.MXU_SUB, t1 - s0)
            yb = np.zeros(iir.MXU_SUB, F32)
            yb[:count] = xc[s0 : s0 + count]
            for k in range(s):
                _mxu_section(yb, tab[k], tmat[k], car[k])
            if out is not None:
                out[s0 : s0 + count] = yb[:count]

    y = np.zeros_like(x)
    for ch in range(c):
        ends = []
        for ti in range(ntiles - 1):
            car = np.zeros((s, 2), F32)
            run(x[ch], ti, car, None)
            ends.append(car.reshape(-1))
        st = np.zeros(2 * s, F32)
        for ti in range(ntiles):
            run(x[ch], ti, st.reshape(s, 2).copy(), y[ch])
            if ti < ntiles - 1:
                st = (m @ st + ends[ti]).astype(F32)
    return y


B14_CASES = [(1, 32), (iir.MXU_SUB + 1, 32), (SUB + 1, 32), (3 * SUB + 77, 32), (2 * SUB, 64)]


@pytest.mark.parametrize("n,tile_rows", B14_CASES)
@pytest.mark.parametrize("design", sorted(DESIGNS))
def test_emulated_b14_matches_scipy_and_plain(rng, n, tile_rows, design):
    sos = f32rows(DESIGNS[design]())
    x = sig(rng, (2, n))
    y = emulate_b14(x, sos, tile_rows)
    assert rel_err(y, scipy_sos(sos, x)) < TOL
    assert rel_err(iir._sos_plain(t(x), sos, None)[0].numpy(), y) < TOL


def test_emulated_b14_impulses_across_segment_and_tile_edges():
    sos = f32rows(DESIGNS["ellip"]())
    n = 2 * SUB + 5
    x = np.zeros((4, n), F32)
    for ch, p in enumerate((0, iir.MXU_SEG - 1, iir.MXU_SUB, SUB + 16)):
        x[ch, p] = 1.0
    y = emulate_b14(x, sos, 32)
    assert rel_err(y, scipy_sos(sos, x)) < TOL
    assert np.all(y[2, : iir.MXU_SUB] == 0.0)  # causal: nothing before the impulse
    assert not emulate_b14(np.zeros((1, n), F32), sos, 32).any()


def test_mxu_tables_are_the_lane_pass(rng):
    """c times T is the section's zero-state recurrence over a segment: s_ex1 of
    every lane and the end state, to float64 rounding; the table's powers."""
    rows = f32rows(DESIGNS["ellip"]())
    tab, tmat = iir.mxu_tables(rows)
    assert tab.shape == (rows.shape[0], iir.TAB_MXU) and tab.dtype == F32
    assert tmat.shape == (rows.shape[0], iir.MXU_K, iir.MXU_N) and tmat.dtype == np.float64
    for k, r in enumerate(rows.astype(np.float64)):
        a_mat = np.array([[-r[4], 1.0], [-r[5], 0.0]])
        c = rng.normal(size=(iir.MXU_SEG, 2))
        s, s_ex = np.zeros(2), []
        for j in range(iir.MXU_SEG):
            s_ex.append(s[0])
            s = a_mat @ s + c[j]
        got = np.concatenate([c[:, 0], c[:, 1]]) @ tmat[k]
        np.testing.assert_allclose(got[: iir.MXU_SEG], s_ex, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got[iir.MXU_SEG : iir.MXU_SEG + 2], s, rtol=1e-12, atol=1e-12)
        assert not got[iir.MXU_SEG + 2 :].any()
        np.testing.assert_allclose(tab[k, 5:7], [r[1] - r[4] * r[0], r[2] - r[5] * r[0]],
                                   rtol=1e-6)
        for m in (0, 1, 32):
            want = np.linalg.matrix_power(a_mat, iir.MXU_SEG * m).ravel()
            np.testing.assert_allclose(tab[k, 8 + 4 * m : 12 + 4 * m], want, rtol=1e-6,
                                       atol=1e-30)
        for lane in (0, 5, 31):
            want = np.linalg.matrix_power(a_mat, lane).ravel()
            got = tab[k, 8 + 4 * 33 + 4 * lane : 12 + 4 * 33 + 4 * lane]
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
