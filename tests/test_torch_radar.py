"""The port's radar chain, Kalman filter and tracker (``models/radar.py``,
``models/kalman.py``, ``models/tracking.py``) against the JAX package.

The same seeded NumPy echoes go through both packages on the CPU (the port's
matched filter is ``conv1d`` in IEEE float32, its Doppler DFT and CFAR band
sums IEEE float32 products, as the reference's ``Precision.HIGHEST``).

Tolerances:

- maps (``pulse_compress``, ``doppler_map`` at both routes, ``ca_cfar``'s
  threshold, ``ambiguity``, ``detect``'s power and threshold): 1e-5 of
  max|want| (``TOL``);
- detections (ROADMAP H5): equal at every cell outside a relative margin of
  ``MARGIN`` = 1e-4 around the threshold, where float32 rounding of the
  power or the threshold may decide ``p > thresh`` either way; the cells
  inside it are counted and printed;
- ``kalman_filter``/``rts_smoother``: 1e-5 of max|want| against the JAX
  package, and the reference's own bounds against a float64 NumPy filter;
  the smoothed covariance, whose update cancels (P_next - Pp), within
  1e-5 or twice the JAX package's own error against a float64 smoother,
  whichever is larger (on this CPU the port 3.1e-5, the JAX package
  1.7e-4);
- the tracker: track ids, active flags and hits equal, positions within
  1e-5 (``TRACK_TOL``, bins) over 5 CPIs.
"""

import jax
import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models import kalman as jkal
from digital_signal_processsing_tpu.models import radar as jrad
from digital_signal_processsing_tpu.models import tracking as jtrk
from digital_signal_processsing_tpu_torch.models import kalman, radar, tracking

TOL = 1e-5
MARGIN = 1e-4
TRACK_TOL = 1e-5


def _cfg(**kw):
    base = dict(n_pulses=32, n_range=512, pulse_len=64, guard=(1, 2), train=(3, 6), pfa=1e-4)
    base.update(kw)
    return radar.RadarConfig(**base)


def _jcfg(cfg):
    return jrad.RadarConfig(**{f.name: getattr(cfg, f.name) for f in cfg.__dataclass_fields__.values()})


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.complex128) - want).max() / max(np.abs(want).max(), 1e-30))


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def same_detections(det, want_det, power, thresh) -> int:
    """Detections equal outside the H5 margin; returns the cells inside it."""
    det = det.numpy() if isinstance(det, torch.Tensor) else np.asarray(det)
    p, th = np.asarray(power, np.float64), np.asarray(thresh, np.float64)
    inside = np.abs(p - th) <= MARGIN * np.abs(th)
    np.testing.assert_array_equal(det[~inside], np.asarray(want_det)[~inside])
    print(f"cells inside the {MARGIN} margin: {int(inside.sum())} of {inside.size}")
    return int(inside.sum())


TARGETS = [(100, 0.25, 0.9), (230, -0.125, 0.6), (231, 0.0, 0.5), (400, 0.0625, 0.3)]


@pytest.fixture(scope="module")
def echoes():
    cfg = _cfg()
    i, q = radar.synthesize(cfg, TARGETS, noise_power=0.02, seed=3)
    return cfg, i, q


def test_host_helpers_are_the_reference():
    cfg = _cfg()
    for a, b in zip(radar.lfm_pulse(cfg), jrad.lfm_pulse(_jcfg(cfg))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(radar.synthesize(cfg, TARGETS, noise_power=0.1, seed=5),
                    jrad.synthesize(_jcfg(cfg), TARGETS, noise_power=0.1, seed=5)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(radar._count1d_window(600, 63, 449, 8),
                                  jrad._count1d_window(600, 63, 449, 8))
    with pytest.raises(ValueError):
        _cfg(pulse_len=1024)


def test_pulse_compress_matches_jax(echoes):
    cfg, i, q = echoes
    got = radar.pulse_compress(cfg, t_(i), t_(q))
    want = np.asarray(jrad.pulse_compress(_jcfg(cfg), i, q))
    assert got.dtype == torch.complex64 and rel(got, want) < TOL


@pytest.mark.parametrize("n_pulses", [32, radar.DFT_MAX_PULSES + 8])
def test_doppler_map_both_routes_match_jax(n_pulses):
    cfg = _cfg(n_pulses=n_pulses, n_range=96, pulse_len=16)
    i, q = radar.synthesize(cfg, [(10, 0.25, 1.0), (40, -0.1, 0.5)], noise_power=0.1, seed=7)
    rc = radar.pulse_compress(cfg, t_(i), t_(q))
    got = radar.doppler_map(cfg, rc)
    want = np.asarray(jrad.doppler_map(_jcfg(cfg), rc.numpy()))
    assert rel(got, want) < TOL


def test_ca_cfar_matches_jax():
    r = np.random.default_rng(11)
    p = r.exponential(1.0, (32, 300)).astype(np.float32)
    p[5, 40] = p[20, 200] = 60.0
    kw = dict(guard=(1, 2), train=(3, 6), pfa=1e-3)
    det, th = radar.ca_cfar(t_(p), **kw)
    jdet, jth = (np.asarray(a) for a in jrad.ca_cfar(p, **kw))
    assert rel(th, jth) < TOL
    same_detections(det, jdet, p, jth)
    assert det[5, 40] and det[20, 200]
    with pytest.raises(ValueError):
        radar.ca_cfar(t_(p), guard=(1, 1), train=(0, 2), pfa=1e-3)


def test_ambiguity_matches_jax():
    cfg = _cfg(pulse_len=48)
    pi_, pq_ = radar.lfm_pulse(cfg)
    d, f, amb = radar.ambiguity(t_(pi_), t_(pq_), n_doppler=17)
    jd, jf, jamb = jrad.ambiguity(pi_, pq_, n_doppler=17)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(f, jf)
    assert rel(amb, np.asarray(jamb)) < TOL
    assert float(amb[8, 47]) == pytest.approx(1.0, rel=1e-5)


@pytest.fixture(scope="module")
def jax_detect(echoes):
    cfg, i, q = echoes
    return [np.asarray(a) for a in jrad.detect(_jcfg(cfg), i, q)]


def test_detect_matches_jax(echoes, jax_detect):
    cfg, i, q = echoes
    det, power, thresh = radar.detect(cfg, t_(i), t_(q))
    jdet, jpower, jthresh = jax_detect
    assert det.dtype == torch.bool and det.shape == (cfg.n_pulses, cfg.n_bins)
    assert rel(power, jpower) < TOL
    assert rel(thresh, jthresh) < TOL
    same_detections(det, jdet, jpower, jthresh)
    for rbin, fd, _ in TARGETS[:2]:
        assert det[cfg.n_pulses // 2 + round(fd * cfg.n_pulses), rbin]


def test_detect_batch_equals_detect_per_cpi(echoes):
    cfg, i, q = echoes
    cpis = [radar.synthesize(cfg, TARGETS, noise_power=0.02, seed=s) for s in (3, 4, 5)]
    ib = t_(np.stack([c[0] for c in cpis]))
    qb = t_(np.stack([c[1] for c in cpis]))
    det_b, power_b, thresh_b = radar.detect_batch(cfg, ib, qb)
    assert det_b.shape == (3, cfg.n_pulses, cfg.n_bins)
    for k in range(3):
        det, power, thresh = radar.detect(cfg, ib[k], qb[k])
        assert rel(power_b[k], power.numpy()) < TOL
        assert rel(thresh_b[k], thresh.numpy()) < TOL
        same_detections(det_b[k], det, power, thresh)


def test_batches_refuse_a_mesh(echoes, tmp_path):
    """The dp steps refuse a mesh that is not a ``parallel.Mesh``; over a world
    of one (gloo, in this process) they are the one-card calls, bit for bit.
    The four-process meshes are ``tests/test_torch_multichip.py``'s."""
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import parallel
    from digital_signal_processsing_tpu_torch.models import beamform

    cfg, i, q = echoes
    with pytest.raises(TypeError, match="parallel.Mesh"):
        radar.detect_batch(cfg, t_(i[None]), t_(q[None]), mesh=object())
    bi, bq = t_(i[None, :8]), t_(q[None, :8])
    with pytest.raises(TypeError, match="parallel.Mesh"):
        beamform.spectrum_batch(beamform.ArrayConfig(), bi, bq, mesh=object())
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh(device="cpu")
        for got, want in zip(radar.detect_batch(cfg, i[None], q[None], mesh=mesh),
                             radar.detect_batch(cfg, t_(i[None]), t_(q[None]))):
            assert torch.equal(got, want)
        got = beamform.spectrum_batch(beamform.ArrayConfig(), bi, bq, method="mvdr", mesh=mesh)
        assert torch.equal(got, beamform.spectrum_batch(beamform.ArrayConfig(), bi, bq,
                                                        method="mvdr"))
    finally:
        dist.destroy_process_group()


# --- Kalman -----------------------------------------------------------------


def _cv_setup(rng):
    dt = 0.1
    F = np.array([[1, dt], [0, 1]])
    H = np.array([[1.0, 0.0]])
    Q = np.array([[dt**3 / 3, dt**2 / 2], [dt**2 / 2, dt]]) * 0.1
    R = np.array([[4.0]])
    T = 300
    true_x = np.zeros((T, 2))
    v, pos = 1.0, 0.0
    for t in range(T):
        pos += v * dt + rng.normal(0, 0.05)
        v += rng.normal(0, 0.1)
        true_x[t] = [pos, v]
    z = true_x[:, :1] + rng.normal(0, 2.0, (T, 1))
    return F, H, Q, R, z, true_x


def _kf64(F, H, Q, R, z):
    """The filter in float64 NumPy, the reference's steps."""
    x, P = np.zeros(2), np.eye(2) * 1e3
    xs, Ps = [], []
    for t in range(len(z)):
        x = F @ x
        P = F @ P @ F.T + Q
        K = np.linalg.solve(H @ P @ H.T + R, H @ P).T
        x = x + K @ (z[t] - H @ x)
        P = (np.eye(2) - K @ H) @ P
        P = 0.5 * (P + P.T)
        xs.append(x)
        Ps.append(P)
    return np.array(xs), np.array(Ps)


def _rts64(F, Q, xf, Pf):
    """The RTS smoother in float64 NumPy."""
    xn, Pn = xf[-1], Pf[-1]
    xs, Ps = [xn], [Pn]
    for t in range(len(xf) - 2, -1, -1):
        Pp = F @ Pf[t] @ F.T + Q
        G = np.linalg.solve(Pp, F @ Pf[t]).T
        xn = xf[t] + (xn - F @ xf[t]) @ G.T
        Pn = Pf[t] + G @ (Pn - Pp) @ G.T
        xs.append(xn)
        Ps.append(Pn)
    return np.array(xs[::-1]), np.array(Ps[::-1])


def test_kalman_filter_matches_jax_and_float64(rng):
    F, H, Q, R, z, _ = _cv_setup(rng)
    x0, P0 = np.zeros(2), np.eye(2) * 1e3
    x, P = x0.copy(), P0.copy()
    xs, Ps = [], []
    for t in range(len(z)):
        x = F @ x
        P = F @ P @ F.T + Q
        K = P @ H.T @ np.linalg.inv(H @ P @ H.T + R)
        x = x + K @ (z[t] - H @ x)
        P = (np.eye(2) - K @ H) @ P
        xs.append(x.copy())
        Ps.append(P.copy())
    xg, Pg = kalman.kalman_filter(F, H, Q, R, t_(z), x0=x0, P0=P0)
    jx, jP = (np.asarray(a) for a in jkal.kalman_filter(F, H, Q, R, z, x0=x0, P0=P0))
    assert rel(xg, jx) < TOL and rel(Pg, jP) < TOL
    assert np.max(np.abs(xg.numpy() - np.array(xs))) < 1e-2
    assert np.max(np.abs(Pg.numpy() - np.array(Ps))) < 5e-3


def test_kalman_batched_and_smoother_match_jax(rng):
    F, H, Q, R, z, true_x = _cv_setup(rng)
    zb = np.stack([z, z + 1.0, 0.5 * z], 0).astype(np.float32)
    xg, Pg = kalman.kalman_filter(F, H, Q, R, t_(zb))
    jx, jP = jkal.kalman_filter(F, H, Q, R, zb)
    assert xg.shape == (3, len(z), 2) and rel(xg, np.asarray(jx)) < TOL
    xs, Ps = kalman.rts_smoother(F, Q, xg, Pg)
    jxs, jPs = jkal.rts_smoother(F, Q, jx, jP)
    assert rel(xs, np.asarray(jxs)) < TOL
    # the smoothed covariance cancels (P_next - Pp): both packages against float64
    _, Ps64 = _rts64(F, Q, *_kf64(F, H, Q, R, z))
    assert rel(Ps, Ps64) < max(TOL, 2 * rel(np.asarray(jPs), Ps64))
    x1, P1 = kalman.kalman_filter(F, H, Q, R, t_(z[:, 0]))  # one scalar stream, (T,)
    xs1, _ = kalman.rts_smoother(F, Q, x1, P1)
    jxs1, _ = jkal.rts_smoother(F, Q, *jkal.kalman_filter(F, H, Q, R, z[:, 0]))
    assert xs1.shape == (len(z), 2) and rel(xs1, np.asarray(jxs1)) < TOL
    ef = np.mean((x1.numpy()[50:, 0] - true_x[50:, 0]) ** 2)
    es = np.mean((xs1.numpy()[50:, 0] - true_x[50:, 0]) ** 2)
    assert es < 0.5 * ef


# --- tracking ---------------------------------------------------------------


def test_extract_measurements_matches_jax(jax_detect):
    jdet, jpower, _ = jax_detect
    z, valid = tracking.extract_measurements(t_(jdet), t_(jpower), max_meas=6, vel_scale=16.0)
    jz, jvalid = jtrk.extract_measurements(jdet, jpower, max_meas=6, vel_scale=16.0)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    zb, vb = tracking.extract_measurements(t_(np.stack([jdet] * 2)), t_(np.stack([jpower] * 2)),
                                           max_meas=6, vel_scale=16.0)
    assert torch.equal(zb[1], z) and torch.equal(vb[0], valid)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_assign_matches_jax(seed):
    r = np.random.default_rng(seed)
    cost = r.uniform(0, 10, (6, 5)).astype(np.float32)
    cost[r.uniform(size=cost.shape) < 0.4] = np.inf
    assign, used = tracking._greedy_assign(t_(cost), 5)
    ja, ju = jtrk._greedy_assign(cost, 5)
    np.testing.assert_array_equal(assign.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(used.numpy(), np.asarray(ju))


def _track_scene(n_cpis, seed0=100):
    rcfg = _cfg(n_pulses=32, n_range=256, pulse_len=32, pfa=1e-5)
    tcfg = tracking.TrackerConfig(max_tracks=8, max_meas=8, vel_scale=16.0, sigma_r=0.7,
                                  sigma_v=0.3, confirm_hits=3, gate=13.8)
    i = np.zeros((n_cpis, rcfg.n_pulses, rcfg.n_range), np.float32)
    q = np.zeros_like(i)
    for k in range(n_cpis):
        i[k], q[k] = radar.synthesize(
            rcfg, [(50 + 2 * k, 0.125, 1.0), (180 - k, -0.0625, 0.8)], noise_power=0.05, seed=seed0 + k
        )
    jt = jtrk.TrackerConfig(**dataclass_dict(tcfg))
    return rcfg, tcfg, jt, i, q


def dataclass_dict(cfg):
    return {f: getattr(cfg, f) for f in cfg.__dataclass_fields__}


def same_tracks(state, jstate):
    for name in ("active", "hits", "misses", "tid", "next_id"):
        np.testing.assert_array_equal(getattr(state, name).numpy(), np.asarray(getattr(jstate, name)))
    act = np.asarray(jstate.active)
    assert np.abs(state.x.numpy()[act] - np.asarray(jstate.x)[act]).max(initial=0.0) < TRACK_TOL
    assert np.abs(state.cov.numpy()[act] - np.asarray(jstate.cov)[act]).max(initial=0.0) < TRACK_TOL


@pytest.fixture(scope="module")
def track_scene():
    rcfg, tcfg, jt, i, q = _track_scene(5)
    jstate, jhist = jtrk.track_detections(_jcfg(rcfg), jt, i, q)
    return rcfg, tcfg, jt, i, q, jstate, jhist


def test_track_detections_matches_jax(track_scene):
    rcfg, tcfg, jt, i, q, jstate, jhist = track_scene
    state, hist = tracking.track_detections(rcfg, tcfg, t_(i), t_(q))
    same_tracks(state, jstate)
    for key in ("active", "confirmed", "tid"):
        np.testing.assert_array_equal(hist[key].numpy(), np.asarray(jhist[key]))
    act = np.asarray(jhist["active"])
    assert np.abs(hist["x"].numpy()[act] - np.asarray(jhist["x"])[act]).max() < TRACK_TOL
    assert int(hist["confirmed"][-1].sum()) == 2


def test_jax_tracker_state_continues_in_the_port(track_scene):
    """Three CPIs in the JAX package, the state carried across, two more in
    the port: the same tracks as five CPIs in the JAX package."""
    rcfg, tcfg, jt, i, q, jstate, _ = track_scene
    jcfg = _jcfg(rcfg)
    det, power, _ = jrad.detect_batch(jcfg, i, q)
    zs, valids = (np.asarray(a) for a in jax.vmap(
        lambda d, p: jtrk.extract_measurements(d, p, max_meas=jt.max_meas, vel_scale=jt.vel_scale)
    )(det, power))
    head, _ = jtrk.track_cpis(jt, zs[:3], valids[:3])
    carried = tracking.tracker_state_from_jax(tuple(np.asarray(f) for f in head), device="cpu")
    assert carried.hits.dtype == torch.int32 and carried.active.dtype == torch.bool
    state, hist = tracking.track_cpis(tcfg, t_(zs[3:]), t_(valids[3:]), state=carried)
    assert hist["x"].shape == (2, tcfg.max_tracks, 2)
    same_tracks(state, jstate)


def test_tracker_init_matches_jax():
    cfg = tracking.TrackerConfig(max_tracks=5)
    st = tracking.tracker_init(cfg, device="cpu")
    jst = jtrk.tracker_init(jtrk.TrackerConfig(max_tracks=5))
    same_tracks(st, jst)
    for got, want in zip(st, jst):
        assert got.shape == np.asarray(want).shape
