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
tiles' maps; B14's warp tasks, each a (channel, tile) sharing the block's
fragments of T, its m16n8k8 fragments built from the samples in the lanes'
layout, the zero blocks of T skipped, the products summed in float64 and
rounded once to float32 (the FP64 tensor-core product), the end state one
float64 step from the accumulators, B12's row scan in float32 and the three
launches.

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
    with pytest.raises(ValueError, match="B14"):  # no section (20 take two groups, F2)
        iir.sosfilt_pallas_fused(np.zeros((0, 6), np.float32), x, lane_pass="mxu")
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

LANE = np.arange(32)
G, TQ = LANE >> 2, LANE & 3  # a lane's row (segment of its m-tile) and column group


def _dmma(acc, a, b):
    """acc (2, 32, 2), m-tiles m and m + 1, += one m16n8k8 FP64 product, the
    fragments as the lanes hold them: a (4, 32) is a0 A[g, tq], a1 A[g + 8, tq],
    a2 A[g, tq + 4], a3 A[g + 8, tq + 4]; b (2, 32) is b0 B[tq, g], b1
    B[tq + 4, g]; acc[0][lane, i] is D[g, 2 tq + i], acc[1] the row g + 8
    (g = lane // 4, tq = lane % 4)."""
    amat = np.zeros((16, 8))
    amat[G, TQ], amat[G + 8, TQ], amat[G, TQ + 4], amat[G + 8, TQ + 4] = a
    bmat = np.zeros((8, 8))
    bmat[TQ, G], bmat[TQ + 4, G] = b
    d = amat @ bmat
    cols = 2 * TQ[:, None] + np.arange(2)[None, :]
    acc[0] += d[G[:, None], cols]
    acc[1] += d[G[:, None] + 8, cols]


def _mxu_products(rows, frag):
    """s_ex1 of a warp's sub-tile as the lanes hold it, (m-tile, n-tile, lane, i)
    float64: for each pair k2 of k-steps and n-tile q >= k2 (the pairs k2 > q
    meet zero blocks of T), one m16n8k8 product a pair of m-tiles."""
    seg = 8 * np.arange(4)[:, None] + G[None, :]  # (m-tile, lane) -> its segment
    acc = np.zeros((4, 4, 32, 2))
    products = 0
    for k2 in range(4):
        lo = rows[seg, 8 * k2 + TQ].astype(np.float64)  # the samples are the A values
        hi = rows[seg, 8 * k2 + 4 + TQ].astype(np.float64)
        for q in range(k2, 4):
            b = [frag[32 * iir.MXU_BLOCKS.index((q, kk)) + LANE] for kk in (2 * k2, 2 * k2 + 1)]
            for m in (0, 2):
                _dmma(acc[m : m + 2, q], (lo[m], lo[m + 1], hi[m], hi[m + 1]), b)
                products += 1
    assert products * 16 * 8 * 8 == 32 * iir.MXU_MACS  # 20 DMMA of 16 x 8 x 8 a sub-tile
    return acc


def _mxu_section(rows, frag, tab, car):
    """One section over a warp's sub-tile as mxu_section runs it: rows (32, 32)
    float32 (segments x samples) and car (2,) float32, both in place."""
    seg = 8 * np.arange(4)[:, None] + G[None, :]
    acc = _mxu_products(rows, frag)
    a1, a2, k1, k2 = frag[-4:]
    # end states from lane tq = 3 (s_ex1 at 30, 31), one float64 step, rounded once
    s30, s31 = acc[:, 3, :, 0], acc[:, 3, :, 1]
    u30, u31 = rows[seg, 30].astype(np.float64), rows[seg, 31].astype(np.float64)
    ends = np.stack([-a1 * s31 - a2 * s30 + k2 * u30 + k1 * u31, -a2 * s31 + k2 * u31], -1)
    ends = ends.astype(F32)
    w = ends[LANE >> 3, 4 * (LANE & 7) + 3]  # lane r gathers segment r's
    pw = tab[8 : 8 + 4 * 33].reshape(33, 2, 2)
    for step in (1, 2, 4, 8, 16):
        u = np.roll(w, step, axis=0)
        w = np.where((LANE >= step)[:, None], (w + u @ pw[step].T).astype(F32), w)
    e = np.roll(w, 1, axis=0)
    e[0] = 0.0
    entry = (np.einsum("rij,j->ri", pw[:32], car) + e).astype(F32)
    car[:] = (pw[32] @ car + w[31]).astype(F32)
    pl = tab[8 + 4 * 33 : 8 + 4 * 33 + 4 * iir.MXU_SEG].reshape(iir.MXU_SEG, 2, 2)
    s_r = entry[seg]  # (m-tile, lane, 2): the state entering the lane's segment
    for q in range(4):
        for i in range(2):
            lane_of = 8 * q + 2 * TQ + i  # the column this accumulator holds
            s1 = (acc[:, q, :, i].astype(F32) + pl[lane_of, 0, 0] * s_r[..., 0]
                  + pl[lane_of, 0, 1] * s_r[..., 1])
            rows[seg, lane_of] = (tab[0] * rows[seg, lane_of] + s1).astype(F32)


def emulate_b14(x, sos, tile_rows=None):
    """The three launches of dsp_sos_cascade_mxu on (C, n) float32: warp w of
    block b runs task 8b + w, a (channel, tile) of its launch, every section
    over each of its sub-tiles with the block's staged fragments."""
    rows = f32rows(sos)
    s = rows.shape[0]
    c, n = x.shape
    tile = iir.pick_tile(c, n, tile_rows)
    ntiles = -(-n // tile)
    tab, _, frags = iir.mxu_tables(rows)
    m = np.linalg.matrix_power(iir.cascade_transition(rows), tile).astype(F32)

    def launch(per, carry, y):
        tasks, seen = c * per, []
        for block in range(-(-tasks // iir.MXU_WARPS)):
            for warp in range(iir.MXU_WARPS):
                task = block * iir.MXU_WARPS + warp
                if task >= tasks:
                    continue
                ch, ti = divmod(task, per)
                seen.append((ch, ti))
                car = carry[ch, ti].reshape(s, 2).copy() if y is not None else np.zeros((s, 2), F32)
                t0, t1 = ti * tile, min(ti * tile + tile, n)
                for s0 in range(t0, t1, iir.MXU_SUB):
                    count = min(iir.MXU_SUB, t1 - s0)
                    sub = np.zeros(iir.MXU_SUB, F32)
                    sub[:count] = x[ch, s0 : s0 + count]
                    sub = sub.reshape(32, iir.MXU_SEG)
                    for k in range(s):
                        _mxu_section(sub, frags[k], tab[k], car[k])
                    if y is not None:
                        y[ch, s0 : s0 + count] = sub.reshape(-1)[:count]
                if y is None:
                    carry[ch, ti] = car.reshape(-1)
        assert sorted(seen) == [(ch, ti) for ch in range(c) for ti in range(per)]

    carry = np.zeros((c, ntiles, 2 * s), F32)
    if ntiles > 1:
        launch(ntiles - 1, carry, None)
    entry = np.zeros_like(carry)  # launch 2: B12's carry warp
    for ch in range(c):
        st = np.zeros(2 * s, F32)
        for ti in range(ntiles):
            entry[ch, ti] = st
            st = (m @ st + carry[ch, ti]).astype(F32)
    y = np.zeros_like(x)
    launch(ntiles, entry, y)
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


@pytest.mark.parametrize("sections", [8, iir.MAX_SECTIONS])
def test_emulated_b14_many_sections_at_high_q(rng, sections):
    """butter(2S, 0.1), poles up to radius 0.985 at 16 sections: held to plain
    within 1e-5 plus plain's own error against float64, and to float64 within
    the larger of 1e-5 and plain's error, as the card's check holds it; nine
    warp tasks, so a block's last warps idle."""
    sos = f32rows(iir.design_butterworth(2 * sections, 0.1))
    x = sig(rng, (3, 3 * SUB + 77))
    y = emulate_b14(x, sos, 32)
    want = scipy_sos(sos, x)
    plain = iir._sos_plain(t(x), sos, None)[0].numpy()
    e_plain = rel_err(plain, want)
    assert rel_err(y, plain) < TOL + e_plain
    assert rel_err(y, want) < max(TOL, 1.01 * e_plain)


def test_mxu_tables_are_the_lane_pass(rng):
    """u times T is the section's zero-state recurrence over a segment, s_ex1 of
    every lane, to float64 rounding; the end state one step from s_ex1 at 30
    and 31; the table's powers."""
    rows = f32rows(DESIGNS["ellip"]())
    tab, tmat, frags = iir.mxu_tables(rows)
    assert tab.shape == (rows.shape[0], iir.TAB_MXU) and tab.dtype == F32
    assert tmat.shape == (rows.shape[0], iir.MXU_SEG, iir.MXU_SEG) and tmat.dtype == np.float64
    assert frags.shape == (rows.shape[0], iir.MXU_SEC) and frags.dtype == np.float64
    for k, r in enumerate(rows.astype(np.float64)):
        a_mat = np.array([[-r[4], 1.0], [-r[5], 0.0]])
        k1, k2 = r[1] - r[4] * r[0], r[2] - r[5] * r[0]
        u = rng.normal(size=iir.MXU_SEG)
        s, s_ex = np.zeros(2), []
        for j in range(iir.MXU_SEG):
            s_ex.append(s[0])
            s = a_mat @ s + u[j] * np.array([k1, k2])
        got = u @ tmat[k]
        np.testing.assert_allclose(got, s_ex, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(frags[k, -4:], [r[4], r[5], k1, k2], rtol=0, atol=0)
        end = [-r[4] * got[31] - r[5] * got[30] + k2 * u[30] + k1 * u[31],
               -r[5] * got[31] + k2 * u[31]]
        np.testing.assert_allclose(end, s, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tab[k, 5:7], [k1, k2], rtol=1e-6)
        for m in (0, 1, 32):
            want = np.linalg.matrix_power(a_mat, iir.MXU_SEG * m).ravel()
            np.testing.assert_allclose(tab[k, 8 + 4 * m : 12 + 4 * m], want, rtol=1e-6,
                                       atol=1e-30)
        for lane in (0, 5, 31):
            want = np.linalg.matrix_power(a_mat, lane).ravel()
            got_p = tab[k, 8 + 4 * 33 + 4 * lane : 12 + 4 * 33 + 4 * lane]
            np.testing.assert_allclose(got_p, want, rtol=1e-6, atol=1e-30)


def test_mxu_fragments_skip_only_zero_blocks(rng):
    """The blocks (n-tile q, k-step kk) left out, kk >= 2q + 2, are zeros of T;
    the kept ones hold T in the lanes' B order; the m16n8k8 products over the
    kept blocks give u @ T for 32 segments, 640 multiply-adds a segment."""
    rows = f32rows(DESIGNS["butter"]())
    _, tmat, frags = iir.mxu_tables(rows)
    assert len(iir.MXU_BLOCKS) == 20 and iir.MXU_MACS == 640
    for k in range(rows.shape[0]):
        for q in range(4):
            for kk in range(8):
                block = tmat[k, 4 * kk : 4 * kk + 4, 8 * q : 8 * q + 8]
                if (q, kk) in iir.MXU_BLOCKS:
                    i = iir.MXU_BLOCKS.index((q, kk))
                    np.testing.assert_array_equal(frags[k, 32 * i + LANE], block[TQ, G])
                else:
                    assert not block.any(), (q, kk)
        u = rng.normal(size=(32, iir.MXU_SEG)).astype(F32)
        seg = 8 * np.arange(4)[:, None] + G[None, :]
        acc = _mxu_products(u, frags[k])
        got = np.zeros((32, iir.MXU_SEG))
        for q in range(4):
            for i in range(2):
                got[seg, 8 * q + 2 * TQ + i] = acc[:, q, :, i]
        np.testing.assert_allclose(got, u.astype(np.float64) @ tmat[k], rtol=1e-12, atol=1e-12)
