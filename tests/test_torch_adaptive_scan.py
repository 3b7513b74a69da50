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
NumPy float32: S1's lane layout (tap j in slot j // 32 of lane j % 32), its
shift by a rotation of each register with lane 0 taking the register before,
each lane's partial over its slots and the butterfly of five xor steps; S2's
two routes: the warp route's sums over j as four partials (j mod 4) and its
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


def emulate_s1(x, d, p, step=0.5, eps=1e-6):
    """S1: a warp a stream, tap j in slot j // 32 of lane j % 32 (the register
    instances, and the generic one past 1024 taps in the same order)."""
    b, n = x.shape
    slots = -(-p // 32)
    valid = (LANES[:, None] + 32 * np.arange(slots)[None, :]) < p
    w = np.zeros((b, 32, slots), F32)
    u = np.zeros((b, 32, slots), F32)
    y, e = np.zeros((b, n), F32), np.zeros((b, n), F32)
    step, eps = F32(step), F32(eps)
    for t in range(n):
        rot = np.roll(u, 1, axis=1)  # lane l takes lane l-1's entry
        new = rot.copy()
        new[:, 0, 0] = x[:, t]
        new[:, 0, 1:] = rot[:, 0, :-1]  # lane 0 takes lane 31's entry of the slot before
        u = np.where(valid, new, F32(0))
        acc = np.zeros((b, 32), F32)
        nrm = np.zeros((b, 32), F32)
        for r in range(slots):
            acc = acc + w[:, :, r] * u[:, :, r]
            nrm = nrm + u[:, :, r] * u[:, :, r]
        y[:, t] = warp_sum(acc)
        e[:, t] = d[:, t] - y[:, t]
        g = step * (e[:, t] / (eps + warp_sum(nrm)))
        w = w + g[:, None, None] * u
    return y, e, w.transpose(0, 2, 1).reshape(b, 32 * slots)[:, :p]


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


@pytest.mark.parametrize("p, n", [(1, 300), (8, 1500), (31, 600), (33, 600), (70, 300)])
def test_s1_emulation_matches_plain(p, n, rng):
    _, x, d, _ = sysid(rng, n=n, p=p, streams=3)
    got = emulate_s1(x, d, p)
    want = adaptive._nlms_plain(torch.from_numpy(x), torch.from_numpy(d), p, 0.5, 1e-6)
    for g, w in zip(got, want):
        assert rel(g, w.numpy()) < TOL


def test_s1_emulation_past_the_register_taps(rng):
    """p > 1024 takes the generic instance: the same lane order, held here at 1030."""
    p = 1030
    _, x, d, _ = sysid(rng, n=1200, p=16, streams=2)
    got = emulate_s1(x, d, p)
    want = adaptive._nlms_plain(torch.from_numpy(x), torch.from_numpy(d), p, 0.5, 1e-6)
    for g, w in zip(got, want):
        assert rel(g, w.numpy()) < TOL


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
