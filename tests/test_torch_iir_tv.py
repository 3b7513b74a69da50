"""The port's time-varying IIR family (B16, B17, B18 and their callers) against the JAX package.

The same NumPy inputs go through the JAX package (its Pallas kernels in
interpret mode: ``tile_rows=2`` for ``sosfilt_tv``, 128 for the frames kernel,
as tests/test_iir_tv.py runs them, or its XLA sample scan) and through the
port on the CPU, where every kernel wrapper takes its plain version. Both are
held against a float64 NumPy sample loop with the same float32 rows.
``emulate_tv`` does what the blocks of ``csrc/iir_tv.cu`` do, with the
geometry the wrapper passes to the launches: groups of MAX_TV_GROUP sections,
each tile's zero-state end state and its transition from the unit columns,
launch 2's float64 chain, and the seeded re-run. Inside a tile, a column at a
time (the kernel runs a block's columns in lockstep, the same arithmetic for
each): the sub-tiles; on the rows and compose routes the staged planes (rows
divided by a0 through one reciprocal; the compose route one entry a frame,
zero past the last live frame), each thread's segment run from rest with the
product of its Phis and the warp's six-component Hillis-Steele scan; on the
state route (``iir.tv_frames_route``: frames of whole warp spans) one table
entry a warp, the powers Psi^(2^p) of Psi = Phi^SEG squared in float64 and the
scan of the state alone; then warp 0's scan of the warp totals in lanes of
eight from the carry, the entry state (the inclusive map shifted up a lane, or
Psi^lane by the lane's bits plus the exclusive sum), all in float64, the
float32 re-run from it and the ragged end state.
``emulate_b22`` (tests/test_torch_lpc.py) does B22's block: frames staged in
chunks through a ring of stages, a thread a frame, the history unrolled.

Tolerance: 1e-5 of max|y| for the IIR family, against the JAX package and
against float64 (the JAX package's own bound for these kernels,
tests/test_iir_tv.py); B22's emulation bit for bit against its plain version.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import iir as jax_iir
from digital_signal_processsing_tpu.utils.dispatch import last_choice as jax_last_choice
from digital_signal_processsing_tpu_torch.ops import iir, lpc
from digital_signal_processsing_tpu_torch.utils import last_choice
from tests.test_torch_lpc import emulate_b22

TOL = 1e-5
F32 = np.float32
THREADS, SEG = iir.THREADS, iir.TV_SEG
SUBT = THREADS * SEG
WARPS = THREADS // 32


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def tv_ref(rows, x, frame_len=1, state=None):
    """Float64 sample loop: rows (S, n_rows, 6) shared or (S, C, n_rows, 6); x (n,) or (C, n)."""
    x2 = np.atleast_2d(np.asarray(x, np.float64))
    r = np.asarray(rows, np.float64)
    if r.ndim == 3:
        r = r[:, None]
    c, n = x2.shape
    s = r.shape[0]
    st = np.zeros((s, c, 2)) if state is None else np.array(state, np.float64).reshape(s, c, 2)
    y = np.empty_like(x2)
    for j in range(n):
        u = x2[:, j]
        for k in range(s):
            b0, b1, b2, a0, a1, a2 = np.moveaxis(r[k, :, j // frame_len], -1, 0)
            b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
            yo = b0 * u + st[k, :, 0]
            st[k, :, 0], st[k, :, 1] = b1 * u - a1 * yo + st[k, :, 1], b2 * u - a2 * yo
            u = yo
        y[:, j] = u
    return y.reshape(np.shape(x)), st


def make_schedule(n, seed):
    """Smoothly swept stable biquad rows, a0 != 1 (tests/test_iir_tv.py's)."""
    r = 0.5 + 0.4 * np.sin(np.linspace(0, 3, n) + seed)
    th = 0.3 + 0.2 * np.cos(np.linspace(0, 2, n) + seed)
    return np.stack([np.full(n, 0.3), 0.1 * np.sin(np.linspace(0, 5, n)), np.full(n, 0.05),
                     np.full(n, 1.0 + 0.1 * seed), -2 * r * np.cos(th), r**2], -1)


def frame_schedule(n_frames, seed):
    """Stable per-frame biquad rows, a0 != 1 (tests/test_iir_tv.py's)."""
    f = np.linspace(0, 3, n_frames)
    r = 0.5 + 0.4 * np.sin(f + seed)
    th = 0.3 + 0.2 * np.cos(2 * f + seed)
    return np.stack([np.full(n_frames, 0.3), 0.1 * np.sin(5 * f), np.full(n_frames, 0.05),
                     np.full(n_frames, 1.0 + 0.1 * seed), -2 * r * np.cos(th), r**2],
                    -1).astype(F32)


@pytest.fixture(scope="module")
def swept():
    rng = np.random.default_rng(7)
    n = 1000
    x = rng.standard_normal(n).astype(F32)
    sos_t = np.stack([make_schedule(n, 0), make_schedule(n, 1)], 0).astype(F32)
    return x, sos_t


@pytest.fixture(scope="module")
def jax_fused(swept):
    x, sos_t = swept
    y = np.asarray(jax_iir.sosfilt_tv(sos_t, x, tile_rows=2))
    return y, jax_last_choice("sosfilt_tv")


# --- the port against the JAX package and float64 -----------------------------------


@pytest.mark.parametrize("method", ["auto", "fused", "scan"])
def test_sosfilt_tv_matches_jax_and_float64(swept, jax_fused, method):
    x, sos_t = swept
    want, route = jax_fused
    got = iir.sosfilt_tv(t(sos_t), t(x), tile_rows=2, method=method).numpy()
    assert rel_err(got, want) < TOL
    assert rel_err(got, tv_ref(sos_t, x)[0]) < TOL
    assert last_choice("sosfilt_tv") == ("scan" if method == "scan" else route)


def test_sosfilt_tv_fused_spelling(swept, jax_fused):
    x, sos_t = swept
    got = iir.sosfilt_tv_fused(t(sos_t), t(x), tile_rows=2).numpy()
    assert rel_err(got, jax_fused[0]) < TOL
    # NumPy rows and a NumPy signal's tensor take the same path
    assert np.array_equal(iir.sosfilt_tv_fused(sos_t, t(x)).numpy(), got)


def test_single_section_takes_scan(swept):
    x, sos_t = swept
    y = iir.sosfilt_tv(t(sos_t[0]), t(x))
    assert last_choice("sosfilt_tv") == "scan"
    want = np.asarray(jax_iir._sosfilt_tv_chunk_xla(np.zeros((1, 2), F32), sos_t[:1], x)[1])
    assert rel_err(y.numpy(), want) < TOL
    assert rel_err(y.numpy(), tv_ref(sos_t[:1], x)[0]) < TOL


def test_per_channel_schedules_match_jax(swept):
    x, _ = swept
    rng = np.random.default_rng(3)
    xb = rng.standard_normal((3, x.size)).astype(F32)
    sos_b = np.stack([np.stack([make_schedule(x.size, i + 3) for i in range(3)], 0)], 0).astype(F32)
    want = np.asarray(jax_iir.sosfilt_tv(sos_b, xb, tile_rows=2))
    for method in ("auto", "scan"):
        got = iir.sosfilt_tv(t(sos_b), t(xb), method=method).numpy()
        assert rel_err(got, want) < TOL
        assert rel_err(got, tv_ref(sos_b, xb)[0]) < TOL


@pytest.mark.parametrize("shared", [True, False])
def test_batch_shapes(shared):
    rng = np.random.default_rng(4)
    n = 700
    x = rng.standard_normal((2, 3, n)).astype(F32)
    if shared:
        rows = np.stack([make_schedule(n, 0), make_schedule(n, 2)]).astype(F32)
    else:
        rows = np.stack([[[make_schedule(n, i + j) for j in range(3)] for i in range(2)]] * 3)
        rows = rows.astype(F32)  # (3 sections, 2, 3, n, 6)
    got = iir.sosfilt_tv(t(rows), t(x)).numpy()
    assert got.shape == x.shape
    ref_rows = rows if shared else rows.reshape(rows.shape[0], 6, n, 6)
    assert rel_err(got.reshape(6, n), tv_ref(ref_rows, x.reshape(6, n))[0]) < TOL


def test_chunks_continue_a_jax_stream(swept, jax_fused):
    """A stream begun by the JAX package's chunk call continues in the port
    (``sos_state_from_jax``): B17's plain version runs each whole chunk seeded."""
    x, sos_t = swept
    st = np.zeros((2, 2), F32)
    parts = []
    for lo in (0, 300):  # the JAX package's XLA sample scan (chunks under one tile)
        st, yp = jax_iir.sosfilt_tv_chunk(st, sos_t[:, lo : lo + 300], x[lo : lo + 300])
        parts.append(np.asarray(yp))
    state = iir.sos_state_from_jax(np.asarray(st), device="cpu")
    for lo in (600, 900):  # whole chunks; tile_rows changes nothing in the port
        hi = min(x.size, lo + 300)
        state, yp = iir.sosfilt_tv_chunk(state, t(sos_t[:, lo:hi]), t(x[lo:hi]), tile_rows=2)
        parts.append(yp.numpy())
    assert state.shape == (2, 2)
    got = np.concatenate(parts)
    assert rel_err(got, jax_fused[0]) < TOL
    want, zf = tv_ref(sos_t, x)
    assert rel_err(got, want) < TOL
    assert np.abs(state.numpy() - zf[:, 0]).max() < TOL * np.abs(want).max()


def test_frames_expand_route_matches_jax(swept):
    x, sos_t = swept
    fl = 100
    sos_fr = sos_t[:, ::fl, :]
    want = np.asarray(jax_iir.sosfilt_tv_frames(sos_fr, x, fl, tile_rows=2))
    got = iir.sosfilt_tv_frames(t(sos_fr), t(x), fl, tile_rows=2)
    assert last_choice("sosfilt_tv_frames") == "expand"
    assert rel_err(got.numpy(), want) < TOL
    assert rel_err(got.numpy(), tv_ref(np.repeat(sos_fr, fl, axis=1), x)[0]) < TOL


def test_frames_kernel_tiles_per_frame_matches_jax():
    """H1: one frame spans two reference tiles (frame_len = 128 * 256 at
    tile_rows=128). The JAX package's frames kernel runs it in interpret
    mode here (Mosaic cannot lower it on the TPU); B18 takes any frame_len."""
    rng = np.random.default_rng(0)
    n, fl, tr = 128 * 128 * 5 + 99, 128 * 256, 128
    x = rng.standard_normal(n).astype(F32)
    sos_fr = np.stack([frame_schedule(-(-n // fl), s) for s in range(2)], 0)
    assert iir._tv_frames_envelope_ok(fl, tr) and jax_iir._tv_frames_envelope_ok(fl, tr)
    want = np.asarray(jax_iir.sosfilt_tv_frames(sos_fr, x, fl, tile_rows=tr, method="frames"))
    got = iir.sosfilt_tv_frames(t(sos_fr), t(x), fl, tile_rows=tr)
    assert last_choice("sosfilt_tv_frames") == "frames"
    assert rel_err(got.numpy(), want) < TOL
    expand = iir.sosfilt_tv_frames(t(sos_fr), t(x), fl, tile_rows=tr, method="expand").numpy()
    assert rel_err(got.numpy(), expand) < TOL


@pytest.mark.parametrize("n, fl, batch", [(128 * 128 * 2 + 777, 256, None), (40000, 512, 3),
                                          (30000, 1024, None)])
def test_frames_per_tile_against_expand_and_float64(n, fl, batch):
    rng = np.random.default_rng(fl)
    x = rng.standard_normal((n,) if batch is None else (batch, n)).astype(F32)
    nf = -(-n // fl)
    sos_fr = np.stack([frame_schedule(nf, s) for s in range(2)], 0)
    got = iir.sosfilt_tv_frames(t(sos_fr), t(x), fl, tile_rows=128, method="frames").numpy()
    want = iir.sosfilt_tv_frames(t(sos_fr), t(x), fl, tile_rows=128, method="expand").numpy()
    assert rel_err(got, want) < TOL
    # float64 over a prefix of the first channel (the filters are causal)
    x0, g0 = (x, got) if batch is None else (x[0], got[0])
    pre = 4000
    ref = tv_ref(np.repeat(sos_fr, fl, axis=1)[:, :pre], x0[:pre])[0]
    assert rel_err(g0[:pre], ref) < TOL


def test_frames_chunks_continue_a_jax_stream():
    """sosfilt_tv_frames_chunk picks up the JAX package's chunk state; the
    port's chunks run whole through B18's plain version seeded, then the
    expand route (outside the envelope at tile_rows=2)."""
    rng = np.random.default_rng(5)
    n, fl = 40960, 512
    x = rng.standard_normal((2, n)).astype(F32)
    sos_fr = np.stack([frame_schedule(n // fl, s) for s in range(2)], 0)
    first = 4096  # under one reference tile: the JAX package's XLA sample scan
    st, y0 = jax_iir.sosfilt_tv_frames_chunk(np.zeros((2, 2, 2), F32), sos_fr[:, : first // fl],
                                             x[:, :first], fl)
    state = iir.sos_state_from_jax(np.asarray(st), device="cpu")
    parts = [np.asarray(y0)]
    for lo, hi, tile_rows in ((first, first + 16384 + 2 * fl, 128), (first + 16384 + 2 * fl, n, 2)):
        state, yp = iir.sosfilt_tv_frames_chunk(state, t(sos_fr[:, lo // fl :]), t(x[:, lo:hi]),
                                                fl, tile_rows=tile_rows)
        parts.append(yp.numpy())
    got = np.concatenate(parts, 1)
    want, zf = tv_ref(np.repeat(sos_fr, fl, axis=1), x)
    assert rel_err(got, want) < TOL
    assert np.abs(state.numpy() - zf).max() < TOL * np.abs(want).max()
    one = iir.sosfilt_tv_frames(t(sos_fr), t(x), fl).numpy()
    assert rel_err(got, one) < TOL


REFUSALS = [
    ("sosfilt_tv", lambda m, x, s: m.sosfilt_tv(s[:, :-1, :], x)),
    ("sosfilt_tv", lambda m, x, s: m.sosfilt_tv(s, x, method="warp")),
    ("sosfilt_tv_frames", lambda m, x, s: m.sosfilt_tv_frames(s[:, :3, :], x, 10)),
    ("sosfilt_tv_frames", lambda m, x, s: m.sosfilt_tv_frames(s[:, ::100, :], x, 100,
                                                              method="frames")),
    ("sosfilt_tv_frames", lambda m, x, s: m.sosfilt_tv_frames(s[:, ::100, :], x, 100,
                                                              method="both")),
    ("sosfilt_tv_fused", lambda m, x, s: m.sosfilt_tv_fused(s, x, tile_rows=8,
                                                             row_pass="compact")),
    ("sosfilt_tv_fused", lambda m, x, s: m.sosfilt_tv_fused(s, x, tile_rows=32768,
                                                            row_pass="compact")),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_refusals_match_jax(swept, case):
    x, sos_t = swept
    _, call = REFUSALS[case]
    with pytest.raises(ValueError):
        call(jax_iir, x, sos_t)
    with pytest.raises(ValueError):
        call(iir, t(x), t(sos_t))


def test_port_refusals():
    x = torch.zeros(2, 100)
    rows = torch.zeros(1, 3, 100, 6)
    with pytest.raises(ValueError, match="batch dims"):
        iir.sosfilt_tv(rows, x)
    with pytest.raises(ValueError, match="one section"):
        iir.tv_section(x, torch.ones(2, 1, 100, 6))
    with pytest.raises(ValueError, match="rows x"):
        iir.tv_cascade(x, torch.ones(1, 1, 99, 6))
    with pytest.raises(ValueError, match="rows for 3 channels"):
        iir.tv_cascade(x, torch.ones(1, 3, 100, 6))
    with pytest.raises(ValueError, match="state must be"):
        iir.tv_cascade(x, torch.ones(1, 1, 100, 6), torch.zeros(2, 2, 2))


def test_record_choice_names(swept):
    x, sos_t = swept
    iir.sosfilt_tv(t(sos_t), t(x))
    assert last_choice("sosfilt_tv") == "fused"
    iir.sosfilt_tv(t(sos_t[:1]), t(x))
    assert last_choice("sosfilt_tv") == "scan"
    fr = np.stack([frame_schedule(8, 0)])
    iir.sosfilt_tv_frames(t(fr), t(x), 128)
    assert last_choice("sosfilt_tv_frames") == "frames"
    iir.sosfilt_tv_frames(t(fr), t(x), 128, tile_rows=100)
    assert last_choice("sosfilt_tv_frames") == "expand"


@pytest.mark.parametrize("shape, a_shape, b", [((1000,), (1000,), 1.0), ((3, 500), (3, 500), 0.5),
                                               ((3, 500), (500,), "array"), ((2, 4), (), "array")])
def test_iir_first_order_array_coefficients_match_jax(shape, a_shape, b):
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(F32)
    a = rng.uniform(-0.95, 0.95, a_shape).astype(F32)
    bb = rng.uniform(0.5, 1.5, shape).astype(F32) if b == "array" else b
    want = np.asarray(jax_iir.iir_first_order(x, a, bb))
    assert jax_last_choice("iir_first_order") == "xla_scan"
    got = iir.iir_first_order(t(x), t(a) if a.ndim else float(a), t(bb) if b == "array" else bb)
    assert last_choice("iir_first_order") == "xla_scan"
    assert rel_err(got.numpy(), want) < TOL
    ref = np.zeros(shape[:-1])
    a_b = np.broadcast_to(a, shape)
    b_b = np.broadcast_to(bb, shape)
    out = np.empty(shape)
    for j in range(shape[-1]):
        ref = a_b[..., j] * ref + b_b[..., j] * x[..., j]
        out[..., j] = ref
    assert rel_err(got.numpy(), out) < TOL


def test_iir_first_order_pallas_takes_scalars_only():
    x = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="scalar"):
        iir.iir_first_order(x, np.full(64, 0.5, F32), method="pallas")


# --- the plain versions against each other --------------------------------------------


def test_plain_versions_agree():
    """The cascade at once, a section at a time (the scan route, B17's plain
    version) and the float64 sample loop agree, output and end state."""
    rng = np.random.default_rng(12)
    n = 1500
    x = t(rng.standard_normal((3, n)).astype(F32))
    rows = t(np.stack([[make_schedule(n, k + c) for c in range(3)] for k in range(3)]).astype(F32))
    st = t((0.3 * rng.standard_normal((3, 3, 2))).astype(F32))
    y, end = iir._tv_plain(x, rows, 1, st)
    ys, ends = tv_ref(rows.numpy(), x.numpy(), 1, st.numpy())
    yk, endk = x, []
    for k in range(3):  # the scan route: B17's plain version a section at a time
        yk, e = iir._tv_plain(yk, rows[k : k + 1], 1, st[k : k + 1])
        endk.append(e)
    endk = torch.cat(endk)
    assert rel_err(y.numpy(), ys) < TOL and rel_err(yk.numpy(), ys) < TOL
    scale = np.abs(ys).max()
    assert np.abs(end.numpy() - ends).max() < TOL * scale
    assert np.abs(endk.numpy() - ends).max() < TOL * scale


@pytest.mark.parametrize("lengths", [(1, 299, 700), (256, 1, 743), (1000,)])
def test_chunk_calls_take_any_length(swept, lengths):
    """Chunks of any length, one sample and under one reference tile among
    them, run whole through the kernels' plain versions and continue the
    stream: output and end state against the float64 loop."""
    x, sos_t = swept
    st, parts, lo = t(np.zeros((2, 2), F32)), [], 0
    for n in lengths:
        st, yp = iir.sosfilt_tv_chunk(st, t(sos_t[:, lo : lo + n]), t(x[lo : lo + n]))
        parts.append(yp.numpy())
        lo += n
    want, zf = tv_ref(sos_t, x)
    assert rel_err(np.concatenate(parts), want) < TOL
    assert np.abs(st.numpy() - zf[:, 0]).max() < TOL * np.abs(want).max()
    # frame_len 128: inside the frames envelope, so B18's route; chunks of
    # whole frames but the last
    fr = sos_t[:, ::128].copy()
    sf, fparts, lo = t(np.zeros((2, 2), F32)), [], 0
    for n in (128 * max(1, k // 128) for k in lengths[:-1]):
        sf, yp = iir.sosfilt_tv_frames_chunk(sf, t(fr[:, lo // 128 :]), t(x[lo : lo + n]), 128)
        fparts.append(yp.numpy())
        lo += n
    sf, yp = iir.sosfilt_tv_frames_chunk(sf, t(fr[:, lo // 128 :]), t(x[lo:]), 128)
    fparts.append(yp.numpy())
    want, zf = tv_ref(np.repeat(fr, 128, axis=1)[:, : x.size], x)
    assert np.abs(sf.numpy() - zf[:, 0]).max() < TOL * np.abs(want).max()
    assert rel_err(np.concatenate(fparts), want) < TOL


# --- B16/B17/B18 emulated block by block ----------------------------------------------

SPAN = iir.TV_SPAN
LANE = np.arange(THREADS) % 32
WARP = np.arange(THREADS) // 32


def fma(a, b, c):
    return (np.asarray(a, np.float64) * b + c).astype(F32)


def mul(a, b):
    return (np.asarray(a, F32) * np.asarray(b, F32)).astype(F32)


def fma64(a, b, c):
    return np.asarray(a, np.float64) * b + c


def divided(r):
    """Rows (..., 6) -> (..., 5) b0 b1 b2 a1 a2 as a kernel divides them: one
    float32 reciprocal of a0, then five products."""
    inv = (F32(1) / r[..., 3]).astype(F32)
    return np.stack([mul(r[..., i], inv) for i in (0, 1, 2, 4, 5)], -1)


def emu_stage(rows_k, route, frame_len, s0, count):
    """The five planes a section's pass reads, as (5, THREADS, SEG) per thread and
    sample. rows: each sample's row, zero from ``count`` on; compose: each sample's
    frame, zero past the last frame with a live sample."""
    k = np.arange(SUBT)
    idx = s0 + k if route == "rows" else (s0 + k) // frame_len
    live = k < count if route == "rows" else idx <= (s0 + count - 1) // frame_len
    p = np.where(live[:, None], divided(rows_k[np.minimum(idx, rows_k.shape[0] - 1)]), F32(0))
    return p.T.reshape(5, THREADS, SEG)


def square(m):
    """(..., 2, 2) -> its square, as the kernel's square()."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    bc, t = b * c, a + d
    return np.stack([np.stack([a * a + bc, b * t], -1), np.stack([c * t, d * d + bc], -1)], -2)


def emu_table(rows_k, frame_len, s0, t1):
    """The state route's entries of one section, a warp each: the float32
    (b0 b1 b2 -a1 -a2) of the frame of the warp's first sample (zero at or past
    t1), and the powers Psi^(2^p), p = 0..5, of Psi = Phi^SEG in float64."""
    g = s0 + np.arange(WARPS) * SPAN
    c = np.where((g < t1)[:, None],
                 divided(rows_k[np.minimum(g // frame_len, rows_k.shape[0] - 1)]), F32(0))
    f = np.stack([c[:, 0], c[:, 1], c[:, 2], -c[:, 3], -c[:, 4]], -1)
    m = np.zeros((WARPS, 2, 2))
    m[:, 0, 0], m[:, 0, 1], m[:, 1, 0] = -c[:, 3].astype(np.float64), 1.0, -c[:, 4]
    for _ in range(3):  # Phi^SEG
        m = square(m)
    q = [m]
    for _ in range(5):
        q.append(square(q[-1]))
    return f, np.stack(q)


def shift_up(v, d):
    w = v.reshape(WARPS, 32)
    out = w.copy()
    out[:, d:] = w[:, :-d]
    return out.reshape(-1)


def emu_block_scan(a, z, car):
    """Step c: the warp totals, maps a (WARPS, 4) and states z (WARPS, 2), scanned in
    lanes of eight from the carry folded into warp 0's. (The state entering each
    warp (WARPS, 2), the state leaving the sub-tile.)"""
    a11, a12, a21, a22 = (a[:, i].copy() for i in range(4))
    z1, z2 = z[:, 0].copy(), z[:, 1].copy()
    k1, k2 = car
    z1[0], z2[0] = (fma64(a11[0], k1, fma64(a12[0], k2, z1[0])),
                    fma64(a21[0], k1, fma64(a22[0], k2, z2[0])))
    u = np.arange(WARPS)
    d = 1
    while d < WARPS:
        e11, e12, e21, e22, f1, f2 = (np.concatenate([q[:d], q[:-d]])
                                      for q in (a11, a12, a21, a22, z1, z2))
        on = u >= d
        n1, n2 = fma64(a11, f1, fma64(a12, f2, z1)), fma64(a21, f1, fma64(a22, f2, z2))
        m = (fma64(a11, e11, a12 * e21), fma64(a11, e12, a12 * e22),
             fma64(a21, e11, a22 * e21), fma64(a21, e12, a22 * e22))
        z1, z2 = np.where(on, n1, z1), np.where(on, n2, z2)
        a11, a12, a21, a22 = (np.where(on, new, old) for new, old in zip(m, (a11, a12, a21, a22)))
        d *= 2
    entry = np.stack([np.concatenate([[k1], z1[:-1]]), np.concatenate([[k2], z2[:-1]])], -1)
    return entry, np.array([z1[-1], z2[-1]])


def emu_run32(v, coefs, s1, s2, jlast):
    """Step d's float32 run in place in v (THREADS, SEG); the end state at
    (thread, j) = jlast, or None. coefs: b0 b1 b2 -a1 -a2, each (THREADS, SEG)."""
    b0, b1, b2, ma1, ma2 = coefs
    end = None
    for j in range(SEG):
        xv = v[:, j].copy()
        yv = fma(b0[:, j], xv, s1)
        n1 = fma(ma1[:, j], yv, fma(b1[:, j], xv, s2))
        s2 = fma(ma2[:, j], yv, mul(b2[:, j], xv))
        s1 = n1
        v[:, j] = yv
        if jlast is not None and j == jlast[1]:
            end = np.array([s1[jlast[0]], s2[jlast[0]]], F32)
    return end


def emu_compose_pass(v, pl, car, jlast):
    """One pass of the rows or compose route over the sub-tile: v in place; (end
    state or None, the carry out). The segment's map from rest, the warp's
    six-component scan, the block scan and the entry state in float64; the re-run
    from the entry state in float32."""
    b0, b1, b2, a1, a2 = pl
    z1 = z2 = np.zeros(THREADS)
    p11, p12, p21, p22 = (np.full(THREADS, float(f)) for f in (1, 0, 0, 1))
    for j in range(SEG):
        xv = v[:, j]
        yv = fma64(b0[:, j], xv, z1)
        n1 = fma64(-a1[:, j], yv, fma64(b1[:, j], xv, z2))
        z2 = fma64(-a2[:, j], yv, b2[:, j] * xv)
        z1 = n1
        m11, m12 = fma64(-a1[:, j], p11, p21), fma64(-a1[:, j], p12, p22)
        p21, p22 = -a2[:, j] * p11, -a2[:, j] * p12
        p11, p12 = m11, m12
    m = [p11, p12, p21, p22, z1, z2]
    for d in (1, 2, 4, 8, 16):
        e11, e12, e21, e22, f1, f2 = (shift_up(q, d) for q in m)
        q11, q12, q21, q22, w1, w2 = m
        new = [fma64(q11, e11, q12 * e21), fma64(q11, e12, q12 * e22),
               fma64(q21, e11, q22 * e21), fma64(q21, e12, q22 * e22),
               fma64(q11, f1, fma64(q12, f2, w1)), fma64(q21, f1, fma64(q22, f2, w2))]
        m = [np.where(LANE >= d, a, b) for a, b in zip(new, m)]
    tot = np.stack([q[31::32] for q in m], -1)
    entry, nxt = emu_block_scan(tot[:, :4], tot[:, 4:], car)
    c1, c2 = entry[WARP, 0], entry[WARP, 1]
    o1 = fma64(m[0], c1, fma64(m[1], c2, m[4]))
    o2 = fma64(m[2], c1, fma64(m[3], c2, m[5]))
    s1 = np.where(LANE == 0, c1, shift_up(o1, 1)).astype(F32)
    s2 = np.where(LANE == 0, c2, shift_up(o2, 1)).astype(F32)
    return emu_run32(v, (b0, b1, b2, -a1, -a2), s1, s2, jlast), nxt


def emu_state_pass(v, f, q, car, jlast):
    """One pass of the state route: each warp's section time-invariant. The state
    alone from rest, its warp scan with the powers Psi^d, the block scan with the
    warps' Psi^32, the entry state as Psi^lane by the lane's bits plus the
    exclusive sum, all float64; the re-run in float32."""
    cw, qq = f[WARP], q[:, WARP]
    b0, b1, b2, ma1, ma2 = (cw[:, i].astype(np.float64) for i in range(5))
    z1 = z2 = np.zeros(THREADS)
    for j in range(SEG):
        xv = v[:, j].astype(np.float64)
        yv = fma64(b0, xv, z1)
        n1 = fma64(ma1, yv, fma64(b1, xv, z2))
        z2 = fma64(ma2, yv, b2 * xv)
        z1 = n1
    for p in range(5):
        d = 1 << p
        f1, f2, pw = shift_up(z1, d), shift_up(z2, d), qq[p]
        on = LANE >= d
        n1 = fma64(pw[:, 0, 0], f1, fma64(pw[:, 0, 1], f2, z1))
        n2 = fma64(pw[:, 1, 0], f1, fma64(pw[:, 1, 1], f2, z2))
        z1, z2 = np.where(on, n1, z1), np.where(on, n2, z2)
    entry, nxt = emu_block_scan(q[5].reshape(WARPS, 4), np.stack([z1[31::32], z2[31::32]], -1),
                                car)
    c1, c2 = entry[WARP, 0], entry[WARP, 1]
    for p in range(5):
        pw, on = qq[p], (LANE >> p) & 1 == 1
        n1 = fma64(pw[:, 0, 0], c1, pw[:, 0, 1] * c2)
        n2 = fma64(pw[:, 1, 0], c1, pw[:, 1, 1] * c2)
        c1, c2 = np.where(on, n1, c1), np.where(on, n2, c2)
    s1 = (c1 + np.where(LANE == 0, 0.0, shift_up(z1, 1))).astype(F32)
    s2 = (c2 + np.where(LANE == 0, 0.0, shift_up(z2, 1))).astype(F32)
    coefs = [np.repeat(cw[:, i : i + 1], SEG, 1) for i in range(5)]
    return emu_run32(v, coefs, s1, s2, jlast), nxt


def emu_tile(xc, rows_c, frame_len, n, tile, ti, car, route, first=0, want_end=False):
    """A tile kernel block over tile ti of one column: (y, end states or None).
    rows_c: (S, F, 6) of the block's coefficient channel; car: (S, 2) float64,
    the sections' carry, left at the tile's end."""
    t0, t1 = ti * tile, min(ti * tile + tile, n)
    ys, end = [], None
    for s0 in range(t0, t1, SUBT):
        count = min(SUBT, t1 - s0)
        buf = np.zeros(SUBT, F32)
        if xc is not None:
            buf[:count] = xc[s0 : s0 + count]
        v = buf.reshape(THREADS, SEG)
        jlast = None
        if want_end and n - 1 - s0 < SUBT:
            jlast = divmod(n - 1 - s0, SEG)
        ends = []
        for k in range(first, rows_c.shape[0]):
            if route == "state":
                e, car[k] = emu_state_pass(v, *emu_table(rows_c[k], frame_len, s0, t1), car[k],
                                           jlast)
            else:
                pl = emu_stage(rows_c[k], route, frame_len, s0, count)
                e, car[k] = emu_compose_pass(v, pl, car[k], jlast)
            ends.append(e)
        if jlast is not None:
            end = np.stack(ends)
        ys.append(v.reshape(-1)[:count].copy())
    return np.concatenate(ys), end


def emulate_tv(x, rows4, frame_len=1, state=None, tile_rows=None):
    """The launches of dsp_tv_cascade on (C, n) float32: (y, end state (S, C, 2)).
    The rows route at frame_len 1 (B16, B17), else B18's, iir.tv_frames_route."""
    x = np.asarray(x, F32)
    rows4 = np.asarray(rows4, F32)
    route = "rows" if frame_len == 1 else iir.tv_frames_route(frame_len)
    c, n = x.shape
    s_all, cc = rows4.shape[:2]
    tile = iir.pick_tile(c, n, tile_rows)
    ntiles = -(-n // tile)
    y = x.copy()
    end_all = np.zeros((s_all, c, 2), F32)
    for g in range(0, s_all, iir.MAX_TV_GROUP):
        rows = rows4[g : g + iir.MAX_TV_GROUP]
        s = rows.shape[0]
        d = 2 * s
        inp = y.copy()
        seed = np.zeros((s, c, 2), F32) if state is None else np.asarray(state, F32)[g : g + s]
        # 1. each tile but the last: the signal from rest, the unit columns
        z, m = {}, {}
        for ti in range(ntiles - 1):
            for ch in range(c):
                car = np.zeros((s, 2))
                emu_tile(inp[ch], rows[:, ch if cc > 1 else 0], frame_len, n, tile, ti, car, route)
                z[ch, ti] = car.astype(F32).reshape(-1)
            for k_c in range(cc):
                mt = np.zeros((d, d), F32)
                for u in range(d):
                    car = np.zeros((s, 2))
                    car.reshape(-1)[u] = 1
                    emu_tile(None, rows[:, k_c], frame_len, n, tile, ti, car, route,
                             first=u // 2)
                    mt[:, u] = car.astype(F32).reshape(-1)
                m[k_c, ti] = mt
        # 2. a warp a channel chains the tiles in float64; 3. the seeded re-run
        for ch in range(c):
            st = seed[:, ch].reshape(-1).astype(np.float64)
            for ti in range(ntiles):
                car = st.astype(F32).astype(np.float64).reshape(s, 2)
                yt, e = emu_tile(inp[ch], rows[:, ch if cc > 1 else 0], frame_len, n, tile, ti,
                                 car, route, want_end=ti == ntiles - 1)
                y[ch, ti * tile : ti * tile + yt.size] = yt
                if e is not None:
                    end_all[g : g + s, ch] = e
                if ti < ntiles - 1:
                    st = m[ch if cc > 1 else 0, ti].astype(np.float64) @ st + z[ch, ti]
    return y, end_all


EMU_CASES = [
    # (channels, n, sections, shared, frame_len, tile_rows)
    (2, 3 * 4096 + 77, 2, True, 1, None),  # four tiles of one 4096 sub-tile pair
    (1, SUBT - 1, 3, False, 1, None),  # one ragged sub-tile
    (2, 2 * 4096 + 5, 2, False, 1, 64),  # a tile of 8192, a ragged second
    (1, 2 * 4096 + 3, 17, True, 1, None),  # two groups: 16 sections, then 1
    (2, 3 * 4096 + 77, 2, True, 5000, None),  # B18: frames spanning tiles
    (1, 2 * 4096 + 9, 1, False, 100, None),  # B18: many frames a sub-tile
]


@pytest.mark.parametrize("case", EMU_CASES)
def test_emulated_kernels_match_plain_and_float64(case):
    c, n, s, shared, fl, tile_rows = case
    rng = np.random.default_rng(n + s)
    x = rng.standard_normal((c, n)).astype(F32)
    nrows = -(-n // fl)
    rows = np.stack([[frame_schedule(nrows, k + 2 * ch) * F32(1.25)
                      for ch in range(1 if shared else c)] for k in range(s)])
    st = (0.3 * rng.standard_normal((s, c, 2))).astype(F32)
    y, end = emulate_tv(x, rows, fl, st, tile_rows)
    yp, endp = iir._tv_plain(t(x), t(rows), fl, t(st))
    want, zf = tv_ref(rows if not shared else rows[:, 0], x, fl, st)
    assert rel_err(y, yp.numpy()) < TOL and rel_err(y, want) < TOL
    scale = np.abs(want).max()
    assert np.abs(end - endp.numpy()).max() < TOL * scale
    assert np.abs(end - zf).max() < TOL * scale
    # the wrapper's plain path is what the CPU runs for each kernel
    kernel = iir.tv_cascade if fl == 1 else (lambda x, r, s: iir.tv_frames_cascade(x, r, fl, s))
    yk, endk = kernel(t(x), t(rows), t(st))
    assert np.array_equal(yk.numpy(), yp.numpy()) and np.array_equal(endk.numpy(), endp.numpy())


# B18 on both sides of the state route's condition (frame_len a multiple of the
# warp span SPAN = 256): whole spans, spans but not sub-tiles (frame edges inside
# sub-tiles), a frame over tiles; and frame lengths off it, edges inside warps
FRAME_CASES = [
    # (channels, n, sections, shared, frame_len, route)
    (2, 2 * 4096 + 123, 2, True, SPAN, "state"),
    (1, 3 * 4096 + 77, 3, False, 3 * SPAN, "state"),  # 768: edges inside sub-tiles
    (2, 2 * 4096 + 5, 2, True, 2 * 4096, "state"),  # a frame a tile: edges at tile edges
    (1, 3 * 4096 + 77, 2, True, 1000, "compose"),
    (2, 2 * 4096 + 123, 3, False, 300, "compose"),  # edges inside warps
]


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
@pytest.mark.parametrize("case", FRAME_CASES)
def test_emulated_frames_routes_match_plain_and_float64(case, seeded):
    c, n, s, shared, fl, route = case
    assert iir.tv_frames_route(fl) == route
    rng = np.random.default_rng(n + fl)
    x = rng.standard_normal((c, n)).astype(F32)
    rows = np.stack([[frame_schedule(-(-n // fl), k + 2 * ch) * F32(1.25)
                      for ch in range(1 if shared else c)] for k in range(s)])
    st = (0.3 * rng.standard_normal((s, c, 2))).astype(F32) if seeded else None
    y, end = emulate_tv(x, rows, fl, st)
    yp, endp = iir._tv_plain(t(x), t(rows), fl, None if st is None else t(st))
    want, zf = tv_ref(rows if not shared else rows[:, 0], x, fl, st)
    assert rel_err(y, yp.numpy()) < TOL and rel_err(y, want) < TOL
    scale = np.abs(want).max()
    assert np.abs(end - endp.numpy()).max() < TOL * scale
    assert np.abs(end - zf).max() < TOL * scale


def test_frames_route_rule():
    """B18 scans the state alone exactly where every warp's span lies in one frame."""
    for fl in (SPAN, 3 * SPAN, 4 * SPAN, 65536):
        assert iir.tv_frames_route(fl) == "state"
    for fl in (1, 100, SPAN // 2, SPAN + 1, 1000):
        assert iir.tv_frames_route(fl) == "compose"


def test_emulated_kernel_at_high_q_stays_near_plain():
    """Resonant rows (pole radius 0.95, angles 0.1 and 0.2 rad): the composed
    maps grow to about 1/sin(angle) while the state stays the size of y, so
    the kernel runs its segments and composes them in float64. Its error
    against float64 stays within 2x the plain version's (a float32 compose
    reads 3x and more)."""
    rng = np.random.default_rng(21)
    n, r = 3 * 4096 + 5, 0.95
    g = (1 - r * r) / 2
    rows = np.stack([np.tile(np.array([g, 0.2 * g, -g, 1.0, -2 * r * np.cos(th), r * r], F32)
                             * F32(1.25), (1, n, 1)) for th in (0.1, 0.2)])
    x = rng.standard_normal((1, n)).astype(F32)
    want = tv_ref(rows[:, 0], x)[0]
    y, _ = emulate_tv(x, rows)
    yp, _ = iir._tv_plain(t(x), t(rows), 1, None)
    assert rel_err(y, want) <= 2 * rel_err(yp.numpy(), want)


@pytest.mark.parametrize("frame_len", [1024, 1000])
def test_emulated_frames_at_high_q_stay_near_plain(frame_len):
    """The same resonant sections a frame at a time on both B18 routes, the
    state route's powers Psi^(2^p) squared in float64 (Psi^32 = Phi^256 at
    pole radius 0.995 still near 0.28): within 2x the plain version's error."""
    rng = np.random.default_rng(22)
    n, r = 3 * 4096 + 5, 0.995
    g = (1 - r * r) / 2
    nf = -(-n // frame_len)
    th = np.linspace(0.1, 0.2, nf)
    rows = np.stack([np.stack([g + 0 * th, 0.2 * g + 0 * th, -g + 0 * th, 1 + 0 * th,
                               -2 * r * np.cos(th + dt), r * r + 0 * th], -1) * 1.25
                     for dt in (0.0, 0.05)]).astype(F32)[:, None]
    x = rng.standard_normal((1, n)).astype(F32)
    want = tv_ref(rows[:, 0], x, frame_len)[0]
    y, _ = emulate_tv(x, rows, frame_len)
    yp, _ = iir._tv_plain(t(x), t(rows), frame_len, None)
    assert rel_err(y, want) <= 2 * rel_err(yp.numpy(), want)


def test_emulated_unit_columns_give_the_tile_transition():
    """Launch 1's unit columns: M_t maps any entry state to the zero-input exit."""
    rng = np.random.default_rng(1)
    n, s = 4096, 3
    rows = np.stack([[make_schedule(n, k)] for k in range(s)]).astype(F32)
    d = 2 * s
    mt = np.zeros((d, d), F32)
    for u in range(d):
        car = np.zeros((s, 2))
        car.reshape(-1)[u] = 1
        emu_tile(None, rows[:, 0], 1, n, n, 0, car, "rows", first=u // 2)
        mt[:, u] = car.astype(F32).reshape(-1)
    s0 = (0.5 * rng.standard_normal((s, 1, 2))).astype(F32)
    _, zf = tv_ref(rows[:, 0], np.zeros(n, F32), 1, s0)
    assert np.abs(mt.astype(np.float64) @ s0.reshape(-1) - zf.reshape(-1)).max() < 1e-5


# --- B22 emulated block by block (emulate_b22: tests/test_torch_lpc.py) -----------------


@pytest.mark.parametrize("p, length, frames", [(1, 8, 3), (12, 40, 129), (33, 33, 5), (2, 64, 128)])
def test_emulated_b22_matches_plain_bit_for_bit(p, length, frames):
    rng = np.random.default_rng(p)
    a_f = (0.5 / p * rng.standard_normal((frames, p))).astype(F32)
    s0 = rng.standard_normal((frames, p)).astype(F32)
    e = rng.standard_normal((frames, length)).astype(F32)
    y, z = emulate_b22(a_f, s0, e)
    yp, zp = lpc.lpc_synth_pass(t(a_f), t(s0), t(e))
    assert np.array_equal(y, yp.numpy()) and np.array_equal(z, zp.numpy())
