"""The port's NLMS and RLS (``models/adaptive.py``) against the JAX package, a NumPy
golden loop, and NumPy emulations of their kernels S1 and S2.

The same seeded NumPy streams go through the JAX package's ``nlms``/``rls``
(one ``lax.scan`` each) and the port on the CPU, where ``nlms_scan`` and
``rls_scan`` take their plain per-sample loops. Tolerances: the port within
1e-5 of max|y| of the JAX package over the whole output and taps (float32 in
both, the sums in another order; RLS on runs of at most 2000 samples, where
its float32 P does not yet amplify rounding); the reference's own anchors
(tests/test_models.py:209-272) on the golden loop and on a 32000-sample RLS
run, which is held to them rather than trajectory for trajectory.

``emulate_s1`` and ``emulate_s2`` walk the kernels of ``csrc/adaptive.cu`` in
NumPy float32: S1's exact block recursion (group B's correlation tables, each
entry a sum of its own window's products as core, head and tail, or direct
for p < L; group A's folds of g into the taps, sample by sample, and its rows
W.u by chunks and butterflies; the chain warp's walk of the triangle and its
sums over the next block's cross terms), held on white and AR(1) inputs, at
ragged and short n, p = 1 and p < L < n, and silence
after a burst, where the tables read exact zeros; S2's two routes: the warp route's sums over j as four partials (j mod 4) and its
taps updated at once, the block route's rows of P u as lane partials and
butterflies and its deferred taps update; both update P by pairs,
((P_ij - k_i pu_j) + (P_ij - k_j pu_i)) * (0.5 * (1 / forget)), which keeps
it bitwise symmetric. Each is held to the plain loop within 1e-5 of max|y|
(the same operations summed in another order, the reference's two divisions
an entry a product with one reciprocal).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models import adaptive as jax_adaptive
from digital_signal_processsing_tpu_torch.models import adaptive

F32 = np.float32
LANES = np.arange(32)
TOL = 1e-5


def sysid(rng, n=4000, p=8, streams=None, noise=0.01):
    """The reference's identification case (tests/test_models.py:212-220)."""
    h = rng.standard_normal(p) * np.exp(-0.3 * np.arange(p))
    shape = (n,) if streams is None else (streams, n)
    x = rng.standard_normal(shape).astype(F32)
    conv = np.apply_along_axis(lambda r: np.convolve(r, h)[:n], -1, x)
    d = (conv + noise * rng.standard_normal(shape)).astype(F32)
    return h, x, d, p


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def port(algo, x, d, p, **kw):
    y, e, w = getattr(adaptive, algo)(torch.from_numpy(x), torch.from_numpy(d), p, **kw)
    return y.numpy(), e.numpy(), w.numpy()


# --- against the JAX package and the golden loop --------------------------------


@pytest.mark.parametrize("algo", ["nlms", "rls"])
@pytest.mark.parametrize("shape", ["1d", "batched", "three_axes"])
def test_matches_jax(algo, shape, rng):
    streams = {"1d": None, "batched": 3, "three_axes": 6}[shape]
    h, x, d, p = sysid(rng, n=1500, streams=streams)
    if shape == "three_axes":  # the port takes any leading axes as streams
        x, d = x.reshape(2, 3, -1), d.reshape(2, 3, -1)
    y, e, w = port(algo, x, d, p)
    jx, jd = (x, d) if shape != "three_axes" else (x.reshape(6, -1), d.reshape(6, -1))
    jy, je, jw = (np.asarray(a) for a in getattr(jax_adaptive, algo)(jx, jd, p))
    want_w_shape = x.shape[:-1] + (p,) if x.ndim > 1 else (p,)
    assert y.shape == e.shape == x.shape and w.shape == want_w_shape
    assert y.dtype == e.dtype == w.dtype == np.float32
    assert rel(y.reshape(jy.shape), jy) < TOL
    assert rel(e.reshape(je.shape), je) < TOL
    assert rel(w.reshape(jw.shape), jw) < TOL


@pytest.mark.parametrize("algo", ["nlms", "rls"])
@pytest.mark.parametrize("n, p", [(0, 4), (3, 8), (1, 1), (40, 40)])
def test_edges_match_jax(algo, n, p, rng):
    """An empty stream, fewer samples than taps, one tap."""
    for x, d in ((rng.standard_normal(n).astype(F32), rng.standard_normal(n).astype(F32)),
                 (rng.standard_normal((2, n)).astype(F32), rng.standard_normal((2, n)).astype(F32))):
        y, e, w = port(algo, x, d, p)
        jy, je, jw = (np.asarray(a) for a in getattr(jax_adaptive, algo)(x, d, p))
        assert y.shape == jy.shape and e.shape == je.shape and w.shape == jw.shape
        for got, want in ((y, jy), (e, je), (w, jw)):
            assert rel(got, want) < TOL


def test_nlms_golden_loop_and_identification(rng):
    h, x, d, p = sysid(rng)
    w_ref, u = np.zeros(p), np.zeros(p)
    for t in range(x.size):  # tests/test_models.py:225-230
        u = np.concatenate([[x[t]], u[:-1]])
        e = d[t] - w_ref @ u
        w_ref = w_ref + 0.5 * e / (1e-6 + u @ u) * u
    _, _, w = port("nlms", x, d, p)
    assert np.max(np.abs(w - w_ref)) < 1e-3
    assert np.max(np.abs(w - h)) < 0.05


def test_rls_converges_fast(rng):
    h, x, d, p = sysid(rng)
    _, e, w = port("rls", x, d, p, forget=0.999)
    assert np.max(np.abs(w - h)) < 5e-3
    assert float(np.mean(e[100:300] ** 2)) < 1e-3


def test_batched_streams_identify(rng):
    h, x, _, p = sysid(rng)
    xb = rng.standard_normal((3, x.size)).astype(F32)
    db = np.stack([np.convolve(r, h)[: x.size] for r in xb]).astype(F32)
    for algo in ("nlms", "rls"):
        _, _, w = port(algo, xb, db, p)
        assert w.shape == (3, p) and np.max(np.abs(w - h)) < 0.05


def test_rls_stable_on_long_runs(rng):
    """The one long plain run: 32000 samples, held to the reference's anchors."""
    h, _, _, p = sysid(rng)
    n = 32000
    x = rng.standard_normal(n).astype(F32)
    d = (np.convolve(x, h)[:n] + 0.003 * rng.standard_normal(n)).astype(F32)
    _, e, w = port("rls", x, d, p, forget=0.999)
    assert float(np.mean(e[-4000:] ** 2)) < 1e-4
    assert np.max(np.abs(w - h)) < 5e-3


def test_refusals():
    z = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="one shape"):
        adaptive.nlms(z, z[:1], 4)
    with pytest.raises(ValueError, match="num_taps"):
        adaptive.rls(z, z, 0)
    with pytest.raises(ValueError, match="one shape"):
        adaptive.nlms_scan(z[0], z[0], 4)


# --- NumPy emulations of S1 and S2 ------------------------------------------------


def warp_sum(v):
    """The butterfly of five xor shuffles over the last axis (32 lanes), float32."""
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., LANES ^ off]
    return v[..., 0]


def lane_partials(prod):
    """Each lane's partial over j = lane + 32 m, m in order: (..., p) -> (..., 32)."""
    p = prod.shape[-1]
    m = -(-p // 32)
    pad = np.zeros(prod.shape[:-1] + (32 * m - p,), F32)
    parts = np.concatenate([prod, pad], -1).reshape(prod.shape[:-1] + (m, 32))
    acc = np.zeros(prod.shape[:-1] + (32,), F32)
    for i in range(m):
        acc = acc + parts[..., i, :]
    return acc


def xat(x, t):
    """x[:, t] for an array of times t, zero before the start and past the end."""
    n = x.shape[1]
    t = np.asarray(t)
    return np.where((t >= 0) & (t < n), x[:, np.clip(t, 0, n - 1)], F32(0)).astype(F32)


def seq_sum(terms):
    """Sum over the last axis one term at a time from 0, float32."""
    acc = np.zeros(terms.shape[:-1], F32)
    for r in range(terms.shape[-1]):
        acc = acc + terms[..., r]
    return acc


def group_sum(v):
    """The xor butterfly over the last axis (G lanes), float32: every lane's total."""
    g = v.shape[-1]
    idx = np.arange(g)
    off = g // 2
    while off:
        v = v + v[..., idx ^ off]
        off //= 2
    return v[..., 0]


def lane_sums(terms):
    """Lane q's sum over its contiguous chunk q K .. q K + K - 1 of the last axis (K
    odd, 32 K >= the terms), in order, then the butterfly over the 32 lanes."""
    size = terms.shape[-1]
    k = ((size + 31) // 32) | 1
    pad = np.zeros(terms.shape[:-1] + (32 * k - size,), F32)
    return group_sum(seq_sum(np.concatenate([terms, pad], -1).reshape(terms.shape[:-1] + (32, k))))


def s1_table(x, t0, p, L, eps):
    """Group B's table of block rows t0 + i: C[:, i, m] = u_i.u_{i-m}, m < 2L, and
    eps + u_i.u_i at m = 0. For p >= L: (core + head) + tail, the core's lane
    sums, head and tail over H lanes a lag of L / H rows each (H = 32 over the
    lags of a warp: 2L over group B's 8 warps), their blocks' sums passed on in
    order."""
    b = x.shape[0]
    m = np.arange(2 * L)

    def prods(s):  # (b, 2L, len(s)): x[t0 + s] x[t0 + s - m]
        s = np.asarray(s)
        return (xat(x, t0 + s)[:, None, :] * xat(x, (t0 + s)[None, :] - m[:, None])).astype(F32)

    C = np.zeros((b, L, 2 * L), F32)
    if p >= L:
        core = lane_sums(prods(np.arange(L - p, 1)))
        lanes = 32 // (2 * L // 8)  # a lag's lanes
        rpl = L // lanes
        head_f = lambda s: prods([s])[..., 0]  # noqa: E731
        tail_f = lambda u: prods([u - p + 1])[..., 0]  # noqa: E731
        hl, tl, tot = [], [], []
        for h in range(lanes):
            rows = [np.zeros((b, 2 * L), F32)]
            for k in range(1, rpl):
                rows.append(rows[-1] + head_f(h * rpl + k))
            hl.append(rows)
            tot.append(rows[-1] + head_f((h + 1) * rpl) if h < lanes - 1 else None)
            t, rows = np.zeros((b, 2 * L), F32), [None] * rpl
            for k in range(rpl - 1, -1, -1):
                if h * rpl + k <= L - 2:
                    t = t + tail_f(h * rpl + k)
                rows[k] = t
            tl.append(rows)
        for h in range(lanes):
            ph, sh = np.zeros((b, 2 * L), F32), np.zeros((b, 2 * L), F32)
            for hh in range(h):
                ph = ph + tot[hh]
            for hh in range(lanes - 1, h, -1):
                sh = sh + tl[hh][0]
            for k in range(rpl):
                C[:, h * rpl + k] = (core + (ph + hl[h][k])) + (tl[h][k] + sh)
    else:
        for i in range(L):
            C[:, i] = seq_sum(prods(np.arange(i - p + 1, i + 1)))
    C[:, :, 0] = F32(eps) + C[:, :, 0]
    return C


def emulate_s1(x, d, p, step=0.5, eps=1e-6):
    """S1's exact block recursion in its order: group B's tables, group A's folds
    and rows W.u (lane sums and butterflies), the chain warp's walk of the
    triangle and its sums over Q; rows past n take g = 0."""
    b, n = x.shape
    L = adaptive.NLMS_BLOCK
    step = F32(step)
    nb = -(-n // L)
    W = np.zeros((b, p), F32)
    c = np.arange(p)
    y, e = np.zeros((b, n), F32), np.zeros((b, n), F32)
    tables = {}
    gs = {}

    def table(k):
        if k not in tables:
            tables[k] = s1_table(x, k * L, p, L, eps)
        return tables[k]

    def fold(W, k):
        t0 = k * L
        for j in range(L):
            W = W + gs[k][:, j : j + 1] * xat(x, t0 + j - c)
        return W

    yhat = np.zeros((b, L), F32)
    rows = np.arange(L)
    for k in range(nb):
        if k >= 2:
            W = fold(W, k - 2)
        t0 = k * L
        P = lane_sums(W[:, None, :] * xat(x, t0 + rows[:, None] - c[None, :]).reshape(b, L, p))
        C = table(k)
        yv = P + yhat
        dv = xat(d, t0 + rows)
        acc = np.zeros((b, L), F32)
        Q = None
        if k + 1 < nb:  # Q[:, i, j] = u_j.u_i, rows j of block k, i of block k + 1
            Cn = table(k + 1)
            Q = Cn[:, rows[:, None], L + rows[:, None] - rows[None, :]]
        g = np.zeros((b, L), F32)
        for j in range(L):
            ej = dv[:, j] - yv[:, j]
            gj = step * (ej / C[:, j, 0])
            if j + 1 < L:
                m = rows[j + 1 :]
                yv[:, j + 1 :] = yv[:, j + 1 :] + gj[:, None] * C[:, m, m - j]
            if Q is not None:
                acc = acc + gj[:, None] * Q[:, :, j]
            if t0 + j < n:
                y[:, t0 + j], e[:, t0 + j], g[:, j] = yv[:, j], ej, gj
        gs[k] = g
        yhat = acc
    for k in (nb - 2, nb - 1):
        if k >= 0:
            W = fold(W, k)
    return y, e, W


def quad_sum(prod):
    """S2's warp route: four partials over j = c mod 4, each ascending from 0,
    then (s0 + s1) + (s2 + s3)."""
    acc = [np.zeros(prod.shape[:-1], F32) for _ in range(4)]
    for j in range(prod.shape[-1]):
        acc[j % 4] = acc[j % 4] + prod[..., j]
    return (acc[0] + acc[1]) + (acc[2] + acc[3])


def emulate_s2(x, d, p, forget=0.99, delta=1e2, route="block"):
    """S2 (``route`` "warp" or "block"): P u, u.pu and w.u by four partials on
    the warp route and by lane partials and butterflies on the block route (which
    defers the taps update to the next sample); P updated by pairs, both halves
    from the same two terms."""
    b, n = x.shape
    forget = F32(forget)
    h = F32(0.5) * (F32(1) / forget)
    P = np.zeros((b, p, p), F32)
    P[:, np.arange(p), np.arange(p)] = F32(delta)
    w, u, kv = (np.zeros((b, p), F32) for _ in range(3))
    e_prev = np.zeros(b, F32)
    y, e = np.zeros((b, n), F32), np.zeros((b, n), F32)
    dot = quad_sum if route == "warp" else (lambda v: warp_sum(lane_partials(v)))
    for t in range(n):
        u = np.concatenate([x[:, t : t + 1], u[:, :-1]], 1)
        if route == "block" and t > 0:
            w = w + kv * e_prev[:, None]
        pu = dot(P * u[:, None, :])
        denom = forget + dot(u * pu)
        kv = pu / denom[:, None]
        y[:, t] = dot(w * u)
        e[:, t] = d[:, t] - y[:, t]
        if route == "warp":
            w = w + kv * e[:, t][:, None]
        P = ((P - kv[:, :, None] * pu[:, None, :]) + (P - kv[:, None, :] * pu[:, :, None])) * h
        e_prev = e[:, t]
    if route == "block" and n:
        w = w + kv * e_prev[:, None]
    return y, e, w


def held_to_plain(x, d, p, **kw):
    got = emulate_s1(x, d, p, **kw)
    want = adaptive._nlms_plain(torch.from_numpy(x), torch.from_numpy(d), p, 0.5, 1e-6)
    for g, w in zip(got, want):
        assert rel(g, w.numpy()) < TOL


def ar1(rng, streams, n, p, rho=0.95, noise=0.01):
    """x_t = rho x_{t-1} + white: the correlations far from diagonal; d through a
    decaying p-tap path."""
    w = rng.standard_normal((streams, n))
    x = np.zeros((streams, n))
    for t in range(n):
        x[:, t] = w[:, t] + (rho * x[:, t - 1] if t else 0.0)
    h = rng.standard_normal(p) * np.exp(-np.arange(p) / max(p / 4, 2))
    d = np.stack([np.convolve(r, h)[:n] for r in x]) + noise * rng.standard_normal((streams, n))
    return x.astype(F32), d.astype(F32)


@pytest.mark.parametrize("p, n", [(1, 300), (8, 1500), (31, 600), (33, 600), (70, 300)])
def test_s1_emulation_matches_plain(p, n, rng):
    _, x, d, _ = sysid(rng, n=n, p=p, streams=3)
    held_to_plain(x, d, p)


def test_s1_emulation_past_the_register_taps(rng):
    """p = 1030, past the 1024 taps the design before kept in registers: the same
    block recursion, its taps still in shared memory."""
    p = 1030
    _, x, d, _ = sysid(rng, n=1200, p=16, streams=2)
    held_to_plain(x, d, p)


@pytest.mark.parametrize("case, p, n", [
    ("ar1", 64, 700), ("ar1", 256, 600), ("ragged n", 40, 301), ("n < L", 12, 10),
    ("p = 1", 1, 257), ("p < L < n", 5, 100), ("p < L < n", 15, 150),
    ("ragged n", 16, 333), ("ar1", 70, 333), ("silence after a burst", 24, 400),
])
def test_s1_block_emulation_matches_plain(case, p, n, rng):
    """The block recursion where its sums are tested hardest: correlated input,
    blocks cut by n, fewer taps than a block, and a window that falls silent
    (plain reads u = 0 there; the tables' sums of their own products give exact
    zeros, where a sliding difference would leave rounding residue over nu = eps)."""
    if case.startswith("ar1"):
        x, d = ar1(rng, 2, n, p)
    else:
        _, x, d, _ = sysid(rng, n=n, p=min(p, 8), streams=2)
    if case.startswith("silence"):
        x[:, 200:] = 0.0
        x[:, 150:200] *= 1000.0
    held_to_plain(x, d, p)


def test_s1_division_is_ieee():
    """The chain warp's e / nu: q0 = e r from r = RN(1 / nu), then two corrections
    by the residual, each an FMA rounded once (emulated through 80-bit products,
    exact here), gives IEEE's quotient, so the emulation's e / nu is the kernel's."""
    rng = np.random.default_rng(7)
    m = 100000
    e = (rng.standard_normal(m) * 10.0 ** (rng.random(m) * 10 - 6)).astype(F32)
    nu = (1e-6 + 10.0 ** (rng.random(m) * 11 - 6)).astype(F32)
    ld = np.longdouble

    def fma(a, b, c):
        return (a.astype(ld) * b.astype(ld) + c.astype(ld)).astype(F32)

    r = F32(1) / nu
    q0 = e * r
    q1 = fma(fma(-nu, q0, e), r, q0)
    q = fma(fma(-nu, q1, e), r, q1)
    assert np.array_equal(q, e / nu) and not np.array_equal(q0, e / nu)


@pytest.mark.parametrize("p, streams, shared", [
    (1, 1, True), (256, 64, True), (256, 300, True), (1030, 2, True),
    (16304, 1, True), (16305, 1, False), (60000, 3, False), (8, 5, True),
])
def test_nlms_geometry(p, streams, shared):
    """One CTA of 416 threads a stream (more streams than SMs queue); three tables of
    2L^2 (L = 16), d, 1 / nu and nu thrice, W u and g twice, then the mirrored ring of x
    (a power of two R >= p + 5L, 2R floats) and the taps while they fit in 227 KB: up
    to 16304 taps, a device-memory scratch of 2R + p floats a stream past that."""
    g = adaptive.nlms_geometry(p, streams)
    L = adaptive.NLMS_BLOCK
    assert L == 16 and adaptive.NLMS_THREADS == 416 and g.ctas == streams and g.taps == p
    assert g.ring & (g.ring - 1) == 0 and p + 5 * L <= g.ring < 2 * (p + 5 * L)
    tables = 6 * L * L + 13 * L
    assert g.shared == shared
    assert g.smem_bytes == 4 * (tables + (2 * g.ring + p if shared else 0)) <= 232448
    assert g.scratch_floats == (0 if shared else 2 * g.ring + p)
    assert adaptive.NLMS_SHARED_MAX_TAPS == 16304


def test_nlms_geometry_refusals():
    with pytest.raises(ValueError, match="num_taps"):
        adaptive.nlms_geometry(0)
    with pytest.raises(ValueError, match="streams"):
        adaptive.nlms_geometry(8, 2**31)


@pytest.mark.parametrize("p, n, route", [
    (1, 200, "warp"), (8, 1200, "warp"), (32, 400, "warp"), (32, 2048, "warp"),
    (33, 300, "block"), (45, 300, "block"), (70, 200, "block"),
])
def test_s2_emulation_matches_plain(p, n, route, rng):
    _, x, d, _ = sysid(rng, n=n, p=min(p, 8), streams=2)
    got = emulate_s2(x, d, p, forget=0.999, route=route)
    want = adaptive._rls_plain(torch.from_numpy(x), torch.from_numpy(d), p, 0.999, 1e2)
    for g, w in zip(got, want):
        assert rel(g, w.numpy()) < TOL


def test_s2_emulation_keeps_p_symmetric(rng):
    """The pair update gives P_ij and P_ji the same bits, so the block route may
    keep the upper triangle alone."""
    _, x, d, _ = sysid(rng, n=200, p=8, streams=1)
    p, forget = 12, F32(0.999)
    h = F32(0.5) * (F32(1) / forget)
    P = np.eye(p, dtype=F32) * F32(100)
    u = np.zeros(p, F32)
    for t in range(x.shape[1]):
        u = np.concatenate([x[0, t : t + 1], u[:-1]])
        pu = warp_sum(lane_partials(P * u[None, :]))
        k = pu / (forget + warp_sum(lane_partials(u * pu)))
        P = ((P - k[:, None] * pu[None, :]) + (P - k[None, :] * pu[:, None])) * h
        assert np.array_equal(P, P.T)


@pytest.mark.parametrize("p", [1, 2, 8, 32, 33, 100, 236, 240, 332, 333, 400, 1000])
def test_s2_route_by_taps(p):
    """A warp a stream up to RLS_WARP_TAPS (32) taps; past it a block a stream,
    P's packed upper triangle in shared memory up to RLS_SHARED_MAX_TAPS (332)
    and in a device-memory scratch past it; the ring a power of two that holds
    p - 1 samples of history beside a chunk, everything within 227 KB."""
    g = adaptive.rls_geometry(p)
    assert adaptive.RLS_SHARED_MAX_TAPS == 332
    if p <= 32:
        assert g.route == 0 and g.smem_bytes == 0 and g.name == "warp"
        return
    assert g.route == 1 and g.shared_tri == (p <= 332)
    assert g.ring & (g.ring - 1) == 0 and g.ring >= p - 1 + adaptive.RLS_CHUNK
    vectors = g.ring + 3 * adaptive.RLS_CHUNK + 3 * p
    tri = p * (p + 1) // 2
    assert g.smem_bytes == 4 * ((tri if g.shared_tri else 0) + vectors) <= 232448
    assert 32 <= g.threads <= 1024 and g.threads == 32 * g.warps
    assert g.name.endswith("shared memory" if g.shared_tri else "device memory")


@pytest.mark.parametrize("streams, warps", [(1, 1), (64, 1), (132, 1), (133, 2), (300, 3),
                                            (528, 4), (100000, 4)])
def test_s2_warp_route_spreads_streams(streams, warps):
    """The warp route packs as many streams a block as spread them over 132 SMs."""
    assert adaptive.rls_geometry(8, streams).warps == warps


def test_s2_refuses_taps_past_its_staging():
    with pytest.raises(ValueError, match="shared memory"):
        adaptive.rls_geometry(20000)
