"""The 2-D filters, ``spline_filter`` and the LTI surface of the port against the
JAX package on the same NumPy inputs (CPU), and kernel S3's two orders (the
warp route's and the rows route's) emulated in NumPy against its plain loop.

Tolerances: convolve2d, correlate2d, sepfir2d and spline_filter within 1e-5 of
max|y| (float32 conv2d against XLA's convolution); medfilt2d equal; every LTI
design function within 1e-10 (host float64 in both); dlsim, lsim, dimpulse and
dstep within 1e-5 of max|y| at T <= 4096 (float32 recursions summed in
another order); S3's emulations within 1e-5 of max|y| of the plain loop (which
sums as PyTorch's matrix-vector product does) and the warp route's bit for bit
where A and C hold a single entry a row.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import lti as jlti
from digital_signal_processsing_tpu.ops import splines as jspl
from digital_signal_processsing_tpu.ops import twod as jtd
from digital_signal_processsing_tpu_torch.ops import lti
from digital_signal_processsing_tpu_torch.ops import splines
from digital_signal_processsing_tpu_torch.ops import twod as td

TWOD_RTOL = 1e-5
DESIGN_TOL = 1e-10
SIM_RTOL = 1e-5


def _rel(got, want) -> float:
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert g.shape == want.shape, (g.shape, want.shape)
    return float(np.abs(g.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("kshape", [(3, 5), (4, 2), (1, 1), (6, 3)])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
def test_convolve2d_correlate2d(kshape, mode, boundary, rng):
    x = rng.normal(size=(2, 13, 17)).astype(np.float32)
    k = rng.normal(size=kshape).astype(np.float32)
    for port, ref in ((td.convolve2d, jtd.convolve2d), (td.correlate2d, jtd.correlate2d)):
        got = port(torch.from_numpy(x), torch.from_numpy(k), mode, boundary, 0.5)
        assert _rel(got, ref(x, k, mode, boundary, 0.5)) <= TWOD_RTOL
    got = td.convolve2d(x[0], k, mode, boundary, device="cpu")
    assert _rel(got, sps.convolve2d(x[0].astype(np.float64), k, mode, boundary)) <= TWOD_RTOL


def test_twod_refusals():
    x = torch.zeros(5, 5)
    with pytest.raises(ValueError, match="boundary"):
        td.convolve2d(x, torch.ones(2, 2), "same", "mirror")
    with pytest.raises(ValueError, match="mode"):
        td.correlate2d(x, torch.ones(2, 2), "middle")
    with pytest.raises(ValueError, match="odd"):
        td.medfilt2d(x, 4)
    with pytest.raises(ValueError, match="odd-length"):
        td.sepfir2d(x, torch.ones(2), torch.ones(3))


@pytest.mark.parametrize("ks", [3, (3, 5), (1, 7)])
def test_medfilt2d_equal(ks, rng):
    x = rng.normal(size=(2, 19, 23)).astype(np.float32)
    x[:, ::4, ::3] = 0.0
    np.testing.assert_array_equal(td.medfilt2d(torch.from_numpy(x), ks).numpy(),
                                  np.asarray(jtd.medfilt2d(x, ks)))


@pytest.mark.parametrize("hr,hc", [([1, 4, 1], [1, 4, 1]), ([1, 2, 3, 2, 1], [0.5, 1, 0.25]),
                                   ([2.0], [1, 2, 3, 4, 5, 6, 7])])
def test_sepfir2d(hr, hc, rng):
    x = rng.normal(size=(3, 11, 9)).astype(np.float32)
    got = td.sepfir2d(torch.from_numpy(x), torch.tensor(hr, dtype=torch.float32),
                      torch.tensor(hc, dtype=torch.float32))
    assert _rel(got, jtd.sepfir2d(x, np.asarray(hr, np.float32), np.asarray(hc, np.float32))) <= TWOD_RTOL


@pytest.mark.parametrize("shape,lmbda", [((40, 50), 5.0), ((63, 48), 0.5), ((20, 20), 0.0)])
def test_spline_filter(shape, lmbda, rng):
    img = rng.normal(size=shape)
    got = splines.spline_filter(img, lmbda, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert _rel(got, jspl.spline_filter(img, lmbda)) <= TWOD_RTOL


# --- the LTI design functions: host float64 in both packages -----------------------


def _close(got, want, tol=DESIGN_TOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    if isinstance(want, (int, float, complex)) or np.ndim(want) == 0:
        assert abs(complex(got) - complex(want)) <= tol * max(1.0, abs(complex(want)))
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if g.size:
        assert np.abs(g - w).max() <= tol * max(1.0, float(np.abs(w).max()))


B_BA, A_BA = [1.0, 0.5, 0.25], [1.0, -1.2, 0.7, -0.1]
CONT = ([1.0, 3.0], [1.0, 0.6, 2.0, 0.5])
ZPK = (np.array([-1.0]), np.array([-0.5 + 1j, -0.5 - 1j, -2.0]), 3.0)


def _ss(rng, n=3, p=2, q=2):
    a = rng.normal(size=(n, n))
    a -= (np.max(np.real(np.linalg.eigvals(a))) + 0.5) * np.eye(n)
    return a, rng.normal(size=(n, p)), rng.normal(size=(q, n)), rng.normal(size=(q, p))


DESIGN_CASES = {
    "tf2ss": lambda m, rng: m.tf2ss(B_BA, A_BA),
    "tf2ss static": lambda m, rng: m.tf2ss([2.0], [4.0]),
    "ss2tf": lambda m, rng: m.ss2tf(*_ss(rng), input=1),
    "zpk2ss": lambda m, rng: m.zpk2ss(*ZPK),
    "ss2zpk": lambda m, rng: m.ss2zpk(*_ss(rng, 3, 1, 1)),
    "abcd_normalize": lambda m, rng: m.abcd_normalize(A=np.eye(2), B=[[1.0], [2.0]], C=[[1.0, 0.0]]),
    "cont2discrete zoh": lambda m, rng: m.cont2discrete(_ss(rng), 0.1),
    "cont2discrete foh": lambda m, rng: m.cont2discrete(_ss(rng), 0.1, method="foh"),
    "cont2discrete bilinear": lambda m, rng: m.cont2discrete(CONT, 0.05, method="bilinear"),
    "cont2discrete gbt": lambda m, rng: m.cont2discrete(ZPK, 0.05, method="gbt", alpha=0.3),
    "cont2discrete euler": lambda m, rng: m.cont2discrete(_ss(rng), 0.1, method="euler"),
    "cont2discrete impulse": lambda m, rng: m.cont2discrete(
        (*_ss(rng)[:3], np.zeros((2, 2))), 0.1, method="impulse"),
    "unique_roots": lambda m, rng: m.unique_roots([1.0, 1.0005, 2.0, 3.0, 2.0001], rtype="avg"),
    "residue": lambda m, rng: m.residue([1.0, 2.0], [1.0, 3.0, 2.0]),
    "residue repeated": lambda m, rng: m.residue([1.0, 0.0, 1.0], [1.0, 2.0, 1.0, 0.0]),
    "residuez": lambda m, rng: m.residuez(B_BA, A_BA),
    "invres": lambda m, rng: m.invres([1.0, -1.0], [-1.0, -2.0], [1.0]),
    "invresz": lambda m, rng: m.invresz([0.5, 0.25], [0.5, -0.3], []),
    "freqz_zpk": lambda m, rng: m.freqz_zpk(*ZPK, worN=64),
    "freqresp": lambda m, rng: m.freqresp(CONT, n=50),
    "freqresp zpk": lambda m, rng: m.freqresp(ZPK, w=np.linspace(0.1, 5, 20)),
    "freqresp ss": lambda m, rng: m.freqresp(_ss(rng, 3, 1, 1), n=40),
    "bode": lambda m, rng: m.bode(CONT, n=40),
    "dfreqresp": lambda m, rng: m.dfreqresp((B_BA, A_BA, 0.1), n=32),
    "dfreqresp zpk": lambda m, rng: m.dfreqresp((*ZPK, 0.1), n=32, whole=True),
    "dbode": lambda m, rng: m.dbode((B_BA, A_BA, 0.5), n=32),
    "place_poles": lambda m, rng: m.place_poles(np.array([[0.0, 1.0], [-2.0, -3.0]]),
                                                np.array([[0.0], [1.0]]), [-4.0, -5.0]).gain_matrix,
    "place_poles mimo": lambda m, rng: np.sort_complex(m.place_poles(
        np.array([[0.0, 1, 0], [0, 0, 1], [-1, -2, -3.0]]), np.array([[0, 0], [1, 0], [0, 1.0]]),
        [-1.0, -2.0, -3.0]).computed_poles),
    "lti poles": lambda m, rng: np.sort_complex(m.lti(*CONT).poles),
    "dlti zeros": lambda m, rng: np.sort_complex(m.dlti(B_BA, A_BA, dt=0.1).zeros),
    "lti to_ss": lambda m, rng: tuple(getattr(m.lti(*ZPK).to_ss(), k) for k in "ABCD"),
    "StateSpace to_tf": lambda m, rng: (m.StateSpace(*_ss(rng, 2, 1, 1)).to_tf().num,
                                        m.StateSpace(*_ss(rng, 2, 1, 1)).to_tf().den),
    "dcgain": lambda m, rng: (m.lti(*CONT).dcgain(), m.dlti(B_BA, A_BA).dcgain()),
    "lti bode": lambda m, rng: m.TransferFunction(*CONT).bode(n=20),
    "dlti freqresp": lambda m, rng: m.dlti(B_BA, A_BA, dt=0.2).freqresp(n=16),
}


@pytest.mark.parametrize("case", list(DESIGN_CASES))
def test_lti_design_functions(case):
    got = DESIGN_CASES[case](lti, np.random.default_rng(7))
    want = DESIGN_CASES[case](jlti, np.random.default_rng(7))
    _close(got, want)


# --- simulation: the port's dlsim (S3's plain loop here) against lax.scan -----------


def _discrete(rng, n: int, p: int, q: int, radius: float = 0.9):
    a = rng.normal(size=(n, n)) if n else np.zeros((0, 0))
    if n:
        a *= radius / np.max(np.abs(np.linalg.eigvals(a)))
    return a, rng.normal(size=(n, p)), rng.normal(size=(q, n)), rng.normal(size=(q, p))


@pytest.mark.parametrize("n,p,q,t", [(3, 1, 1, 200), (5, 2, 3, 300), (1, 1, 1, 1), (4, 1, 2, 0),
                                     (6, 3, 1, 4096)])
def test_dlsim_matches_reference(n, p, q, t, rng):
    sys4 = _discrete(rng, n, p, q)
    u = rng.normal(size=(t, p)).astype(np.float32)
    x0 = rng.normal(size=n)
    y, xs = lti.dlsim(sys4 + (0.5,), u, x0=x0, device="cpu")
    jy, jx = jlti.dlsim(sys4 + (0.5,), u, x0=x0)
    assert y.shape == (t, q) and xs.shape == (t, n) and y.dtype == torch.float32
    if t:
        assert _rel(y, jy) <= SIM_RTOL and _rel(xs, jx) <= SIM_RTOL


def test_dlsim_shapes_as_the_reference():
    b, a = [1.0, 0.5], [1.0, -1.2, 0.5]
    sys4 = lti.tf2ss(b, a)
    for u in (np.arange(7.0), np.arange(1.0), np.zeros(0), np.ones((5, 1))):  # the p = 1 reshape
        y, xs = lti.dlsim(sys4, u, device="cpu")
        jy, jx = jlti.dlsim(sys4, u)
        assert tuple(y.shape) == np.asarray(jy).shape and tuple(xs.shape) == np.asarray(jx).shape
    with pytest.raises(ValueError, match="x0 has 3 entries"):
        lti.dlsim(sys4, np.ones(4), x0=[1.0, 2.0, 3.0], device="cpu")


def test_dlsim_unstable_relative_to_max_y(rng):
    sys4 = _discrete(rng, 4, 1, 2, radius=1.08)
    u = rng.normal(size=(150, 1)).astype(np.float32)
    y, _ = lti.dlsim(sys4, u, device="cpu")
    jy, _ = jlti.dlsim(sys4, u)
    assert np.abs(np.asarray(jy)).max() > 1e3  # it grows
    assert _rel(y, jy) <= SIM_RTOL


@pytest.mark.parametrize("fn", ["dimpulse", "dstep"])
@pytest.mark.parametrize("system", ["ba", "ba dt", "ss", "zpk dt"])
def test_dimpulse_dstep(fn, system):
    sys_ = {
        "ba": ([1.0, 0.5], [1.0, -1.2, 0.5]),
        "ba dt": ([1.0, 0.5], [1.0, -1.2, 0.5], 0.1),
        "ss": lti.tf2ss([1.0, 0.5], [1.0, -1.2, 0.5]),
        "zpk dt": (np.array([0.5]), np.array([0.6, -0.3]), 2.0, 0.25),
    }[system]
    t, y = getattr(lti, fn)(sys_, 64, device="cpu")
    jt, jy = getattr(jlti, fn)(sys_, 64)
    np.testing.assert_array_equal(t, jt)
    assert _rel(y, jy) <= SIM_RTOL


@pytest.mark.parametrize("interp", [True, False])
@pytest.mark.parametrize("x0", [None, [0.3, -0.1, 0.2]])
def test_lsim_impulse_step(interp, x0, rng):
    sysc = ([1.0, 3.0], [1.0, 0.6, 2.0, 0.5])
    t = np.linspace(0, 8, 400)
    u = np.sin(t)
    got = lti.lsim(sysc, u, t, X0=x0, interp=interp, device="cpu")
    want = jlti.lsim(sysc, u, t, X0=x0, interp=interp)
    assert all(isinstance(v, np.ndarray) for v in got)
    np.testing.assert_array_equal(got[0], want[0])
    assert _rel(got[1], want[1]) <= SIM_RTOL and _rel(got[2], want[2]) <= SIM_RTOL
    for fn in ("impulse", "step"):
        g = getattr(lti, fn)(sysc, X0=x0, N=120, device="cpu")
        w = getattr(jlti, fn)(sysc, X0=x0, N=120)
        np.testing.assert_array_equal(g[0], w[0])
        assert _rel(g[1], w[1]) <= SIM_RTOL
    # the classes: continuous and discrete responses
    s = lti.lti(*sysc)
    assert _rel(s.output(u, t, device="cpu")[1], jlti.lti(*sysc).output(u, t)[1]) <= SIM_RTOL
    d = lti.dlti([1.0, 0.5], [1.0, -1.2, 0.5], dt=0.1)
    jd = jlti.dlti([1.0, 0.5], [1.0, -1.2, 0.5], dt=0.1)
    assert _rel(d.step(N=50, device="cpu")[1], jd.step(N=50)[1]) <= SIM_RTOL
    assert _rel(d.impulse(N=50, device="cpu")[1], jd.impulse(N=50)[1]) <= SIM_RTOL
    out = d.output(u[:60], t[:60], device="cpu")
    assert _rel(out[1], jd.output(u[:60], t[:60])[1]) <= SIM_RTOL


# --- S3's orders in NumPy -------------------------------------------------------------

LANES = np.arange(32)


def emulate_s3(a, b, c, d, u, x0):
    """S3's warp route (csrc/lti.cu) in NumPy float32: lane i's rows summed j (and
    k) ascending from 0, each product and sum rounded apart, ``ax + bu`` and
    ``cy + du`` added last, a step at a time. ``np.add.accumulate`` sums
    sequentially in float32, the kernel's order."""
    f32 = np.float32
    a, b, c, d, u, x = (np.asarray(v, f32) for v in (a, b, c, d, u, x0))
    t, n, p, q = u.shape[0], a.shape[0], b.shape[1], c.shape[0]
    ys, xs = np.empty((t, q), f32), np.empty((t, n), f32)

    def rows(m, v):  # (rows, k) . (k,): each row's sum, k ascending, from 0
        if m.shape[1] == 0:
            return np.zeros(m.shape[0], f32)
        return np.add.accumulate(m * v[None, :], axis=1, dtype=f32)[:, -1]

    for k in range(t):
        xs[k] = x
        ys[k] = rows(c, x) + rows(d, u[k])
        x = rows(a, x) + rows(b, u[k])
    return ys, xs


def split_rows(m, x):
    """The rows route's A x (or C x): a lane's partial over j = lane + 32 m, m
    ascending from 0, then the butterfly of five xor steps (16, 8, 4, 2, 1)."""
    f32 = np.float32
    r, n = m.shape
    slots = -(-n // 32)
    prod = np.zeros((r, 32 * slots), f32)
    prod[:, :n] = m * x[None, :]
    acc = np.zeros((r, 32), f32)
    for k in range(slots):
        acc = acc + prod[:, 32 * k : 32 * (k + 1)]
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[:, LANES ^ off]
    return acc[:, 0]


def emulate_s3_rows(a, b, c, d, u, x0):
    """S3's rows route in NumPy float32: ``ax`` and ``cy`` by :func:`split_rows`,
    ``bu`` and ``du`` k ascending from 0, then ``ax + bu`` and ``cy + du``."""
    f32 = np.float32
    a, b, c, d, u, x = (np.asarray(v, f32) for v in (a, b, c, d, u, x0))
    t, n, q = u.shape[0], a.shape[0], c.shape[0]
    ys, xs = np.empty((t, q), f32), np.empty((t, n), f32)

    def seq(m, v):
        if m.shape[1] == 0:
            return np.zeros(m.shape[0], f32)
        return np.add.accumulate(m * v[None, :], axis=1, dtype=f32)[:, -1]

    for k in range(t):
        xs[k] = x
        ys[k] = split_rows(c, x) + seq(d, u[k])
        x = split_rows(a, x) + seq(b, u[k])
    return ys, xs


@pytest.mark.parametrize("n", [1, 3, 32, 33, 300])
@pytest.mark.parametrize("t", [0, 1, 4096])
@pytest.mark.parametrize("pq", [(1, 1), (2, 3)])
def test_s3_emulation_against_plain(n, t, pq, rng):
    p, q = pq
    if n == 300 and t == 4096 and pq == (2, 3):
        t = 1024  # the emulation's cost at the largest state; (1, 1) takes 4096
    mats = [m.astype(np.float32) for m in _discrete(rng, n, p, q, radius=0.95)]
    u = rng.normal(size=(t, p)).astype(np.float32)
    x0 = rng.normal(size=n).astype(np.float32)
    warp = lti.dlsim_geometry(n, p, q).route == 0
    ey, ex = (emulate_s3 if warp else emulate_s3_rows)(*mats, u, x0)
    tm = [torch.from_numpy(m) for m in mats]
    py, px = lti.dlsim_scan(*tm, torch.from_numpy(u), torch.from_numpy(x0))
    assert py.shape == (t, q) and px.shape == (t, n)
    if t:
        assert _rel(py, ey) <= SIM_RTOL and _rel(px, ex) <= SIM_RTOL
        assert np.array_equal(px[0].numpy(), x0) and np.array_equal(ex[0], x0)


def test_s3_emulation_is_exact_on_diagonal_systems(rng):
    """One entry a row: every sum is one product, so plain and S3 agree bit for bit."""
    n = 5
    a = np.diag(rng.uniform(-0.9, 0.9, n)).astype(np.float32)
    b = np.zeros((n, 1), np.float32)
    b[0] = 1.0
    c = np.zeros((1, n), np.float32)
    c[0, 2] = 0.5
    d = np.zeros((1, 1), np.float32)
    u = rng.normal(size=(300, 1)).astype(np.float32)
    x0 = rng.normal(size=n).astype(np.float32)
    ey, ex = emulate_s3(a, b, c, d, u, x0)
    py, px = lti.dlsim_scan(*(torch.from_numpy(v) for v in (a, b, c, d, u, x0)))
    np.testing.assert_array_equal(px.numpy(), ex)
    np.testing.assert_array_equal(py.numpy(), ey)


@pytest.mark.parametrize("n, p, q, t", [(33, 1, 1, 600), (40, 3, 40, 300), (3, 1, 40, 300),
                                        (70, 2, 1, 200), (0, 2, 35, 50)])
def test_s3_rows_emulation_against_plain(n, p, q, t, rng):
    """The rows route (more than 32 states or outputs, or more than 64 inputs)."""
    assert lti.dlsim_geometry(n, p, q).route in (1, 2)
    mats = [m.astype(np.float32) for m in _discrete(rng, n, p, q, radius=0.95)]
    u = rng.normal(size=(t, p)).astype(np.float32)
    x0 = rng.normal(size=n).astype(np.float32)
    ey, ex = emulate_s3_rows(*mats, u, x0)
    py, px = lti.dlsim_scan(*(torch.from_numpy(v) for v in mats), torch.from_numpy(u),
                            torch.from_numpy(x0))
    assert _rel(py, ey) <= SIM_RTOL
    if n:
        assert _rel(px, ex) <= SIM_RTOL


def test_s3_geometry_and_refusals():
    """The warp route up to 32 states and outputs (and 64 inputs); past it the
    rows of M = [[A B]; [C D]] over a cluster of up to 16 CTAs, a multiple of 4
    rows a CTA, two rows a warp in registers while n <= 512, in shared memory
    while a CTA's share fits, read from device memory past that. No cap on p or
    q; n up to 14,079, where three copies of the state and a chunk of B u fill
    shared memory."""
    g = lti.dlsim_geometry(8, 1, 1)
    assert (g.route, g.threads, g.chunk, g.slots, g.name) == (0, 32, 256, 8, "warp")
    assert g.smem_bytes == 4 * 256 * (1 + 2 * 33 + 8 + 1) <= lti.SMEM_MAX
    assert lti.dlsim_geometry(32, 64, 32).smem_bytes <= lti.SMEM_MAX
    assert lti.dlsim_geometry(32, 64, 32).route == 0 and lti.dlsim_geometry(32, 64, 32).slots == 32
    assert [lti.dlsim_geometry(n, 1, 1).slots for n in (0, 2, 3, 9, 17)] == [2, 2, 4, 16, 32]
    assert lti.dlsim_geometry(32, 65, 32).route == 1
    g = lti.dlsim_geometry(300, 2, 3)  # 303 rows: 20 a CTA over 16, all in registers
    assert (g.route, g.cluster, g.rows_cta, g.slots, g.threads) == (1, 16, 20, 10, 320)
    assert g.smem_bytes == 32 + 4 * (3 * 300 + 20 * g.chunk + 20 * 302) <= lti.SMEM_MAX
    g = lti.dlsim_geometry(300, 2, 300)  # 600 rows: 40 a CTA over 16, 8 walked a CTA
    assert (g.route, g.cluster, g.rows_cta, g.slots, g.threads) == (1, 16, 40, 10, 512)
    g = lti.dlsim_geometry(64, 4096, 1)  # state registers, rows read from device memory
    assert (g.route, g.cluster, g.rows_cta, g.slots) == (2, 4, 20, 2)
    g = lti.dlsim_geometry(33, 1, 1)
    assert (g.route, g.cluster, g.rows_cta, g.slots, g.threads) == (1, 2, 20, 2, 320)
    for n, q in ((1100, 1), (1, 1100), (1100, 1100), (5000, 3)):
        g = lti.dlsim_geometry(n, 1, q)
        assert g.rows_cta * g.cluster >= n + q and g.rows_cta % 4 == 0
        assert g.smem_bytes <= lti.SMEM_MAX
        assert g.threads % 32 == 0 and 32 <= g.threads <= 1024
        rows_bytes = 4 * g.rows_cta * (n + 1)
        assert g.route == (2 if g.smem_bytes + rows_bytes > lti.SMEM_MAX + (rows_bytes if g.route == 1 else 0)
                           else 1)
    g = lti.dlsim_geometry(1100, 1, 1)
    assert (g.name, g.cluster, g.slots) == ("rows in device memory", 16, 0)  # x in shared memory
    assert lti.dlsim_geometry(4, 100000, 1).route == 2  # any number of inputs
    assert lti.dlsim_geometry(14079, 1, 1).route == 2
    for n in (14080, 60000):
        with pytest.raises(ValueError, match="shared memory"):
            lti.dlsim_geometry(n, 1, 1)
    z = torch.zeros
    with pytest.raises(ValueError, match="dlsim_scan"):
        lti.dlsim_scan(z(3, 3), z(3, 1), z(1, 3), z(1, 1), z(10, 2), z(3))
    with pytest.raises(ValueError, match="dlsim_scan"):
        lti.dlsim_scan(z(3, 3), z(3, 1), z(1, 3), z(1, 1), z(10, 1), z(4))
