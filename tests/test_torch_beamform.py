"""The port's array processing (``models/beamform.py``) against the JAX
package and float64 NumPy.

The same seeded NumPy snapshots go through both packages on the CPU.

Tolerances:

- covariances (plain, forward-backward, spatially smoothed), Bartlett and
  MVDR spectra and wideband MUSIC: 1e-5 of max|want| (``TOL``);
- MVDR weights against a 40 dB interferer, whose loaded covariance is
  ill-conditioned (the two packages' float32 solves differ by 1.3e-3 of
  max|w| on this CPU): within 1e-5 or twice the JAX package's own error
  against the float64 solve of the same covariance, whichever is larger;
- the narrowband MUSIC spectrum: ``MUSIC_TOL`` = 2e-4 of max|want|, against
  the JAX package and against a float64 complex-eigh MUSIC of the same
  covariance. Its peaks are 1/||E_n^H a||^2 near a null, where float32
  eigenvectors from two LAPACK calls differ (on this CPU the port 5.3e-5
  from the JAX package); eigenvectors themselves are never compared, only
  spectra and bearings;
- bearings (``estimate_doa`` by every method, ESPRIT, root-MUSIC, wideband
  MUSIC): within ``DOA_TOL`` = 1e-3 degrees of the JAX package's (the grid
  step is 0.5 degrees; on this CPU at most 7e-5), and within the
  reference tests' bounds of the truth.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models import beamform as jbf
from digital_signal_processsing_tpu_torch.models import beamform as bf

TOL = 1e-5
MUSIC_TOL = 2e-4
DOA_TOL = 1e-3


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


CFG = bf.ArrayConfig()
JCFG = jbf.ArrayConfig()
TRUTH = np.array([-24.0, 33.0])


@pytest.fixture(scope="module")
def snaps():
    return bf.synthesize(CFG, TRUTH, 512, snr_db=15.0, seed=4)


def test_host_helpers_are_the_reference():
    np.testing.assert_array_equal(bf.scan_angles(CFG), jbf.scan_angles(JCFG))
    for a, b in zip(bf.steering(CFG, [-10.0, 70.0]), jbf.steering(JCFG, [-10.0, 70.0])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(bf.synthesize(CFG, TRUTH, 64, seed=2, coherent=True),
                    jbf.synthesize(JCFG, TRUTH, 64, seed=2, coherent=True)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(bf.synthesize_wideband(CFG, [10.0], 256, spacing_samples=1.5),
                                  jbf.synthesize_wideband(JCFG, [10.0], 256, spacing_samples=1.5))
    with pytest.raises(ValueError):
        bf.ArrayConfig(spacing=0.7)


@pytest.mark.parametrize("fb", [False, True])
def test_sample_covariance_matches_jax(snaps, fb):
    xi, xq = snaps
    rr, ri = bf.sample_covariance(t_(xi), t_(xq), forward_backward=fb)
    jr, ji = jbf.sample_covariance(xi, xq, forward_backward=fb)
    assert rel(rr, jr) < TOL and rel(ri, ji) < TOL


def test_smoothed_covariance_matches_jax():
    cfg = bf.ArrayConfig(n_sensors=10)
    xi, xq = bf.synthesize(cfg, [5.0, -20.0], 128, seed=12)
    for fb in (False, True):
        rr, ri = bf.smoothed_covariance(t_(xi), t_(xq), subarray=6, forward_backward=fb)
        jr, ji = jbf.smoothed_covariance(xi, xq, subarray=6, forward_backward=fb)
        assert rr.shape == (6, 6) and rel(rr, jr) < TOL and rel(ri, ji) < TOL
    with pytest.raises(ValueError):
        bf.smoothed_covariance(t_(xi), t_(xq), subarray=1)


def _music64(rr, ri, ai, aq, k):
    """MUSIC in float64 from a complex eigh of the same covariance."""
    r = np.asarray(rr, np.float64) + 1j * np.asarray(ri, np.float64)
    _, v = np.linalg.eigh(r)
    en = v[:, : r.shape[0] - k]
    a = ai.astype(np.float64) + 1j * aq.astype(np.float64)
    return r.shape[0] / np.sum(np.abs(en.conj().T @ a) ** 2, axis=0)


def test_spectra_match_jax(snaps):
    xi, xq = snaps
    rr, ri = bf.sample_covariance(t_(xi), t_(xq))
    jr, ji = jbf.sample_covariance(xi, xq)
    ai, aq = bf.steering(CFG, bf.scan_angles(CFG))
    assert rel(bf.bartlett_spectrum(rr, ri, ai, aq), jbf.bartlett_spectrum(jr, ji, ai, aq)) < TOL
    assert rel(bf.mvdr_spectrum(rr, ri, ai, aq, loading=1e-3),
               jbf.mvdr_spectrum(jr, ji, ai, aq, loading=1e-3)) < TOL
    got = bf.music_spectrum(rr, ri, ai, aq, n_sources=2)
    assert rel(got, jbf.music_spectrum(jr, ji, ai, aq, n_sources=2)) < MUSIC_TOL
    assert rel(got, _music64(rr.numpy(), ri.numpy(), ai, aq, 2)) < MUSIC_TOL
    with pytest.raises(ValueError):
        bf.music_spectrum(rr, ri, ai, aq, n_sources=CFG.n_sensors)


def test_mvdr_weights_match_jax():
    xi, xq = bf.synthesize(CFG, [30.0], 2048, snr_db=40.0, seed=7)
    rr, ri = bf.sample_covariance(t_(xi), t_(xq))
    jr, ji = jbf.sample_covariance(xi, xq)
    ai, aq = bf.steering(CFG, [0.0])
    wi, wq = bf.mvdr_weights(rr, ri, ai[:, 0], aq[:, 0], loading=1e-4)
    jwi, jwq = jbf.mvdr_weights(jr, ji, ai[:, 0], aq[:, 0], loading=1e-4)
    # the loaded covariance of a 40 dB interferer is ill-conditioned: both
    # packages against the float64 solve of the same covariance
    r64 = rr.numpy().astype(np.float64) + 1j * ri.numpy()
    r64 = r64 + 1e-4 * np.trace(r64).real / CFG.n_sensors * np.eye(CFG.n_sensors)
    a = ai[:, 0].astype(np.float64) + 1j * aq[:, 0]
    y = np.linalg.solve(r64, a)
    w64 = y / (a.conj() @ y)
    w = wi.numpy().astype(np.float64) + 1j * wq.numpy()
    jw = np.asarray(jwi, np.float64) + 1j * np.asarray(jwq)
    err, jerr = (float(np.abs(v - w64).max() / np.abs(w64).max()) for v in (w, jw))
    assert err < max(TOL, 2 * jerr), (err, jerr)
    np.testing.assert_allclose(w.conj() @ (ai[:, 0] + 1j * aq[:, 0]), 1.0, atol=1e-4)


@pytest.mark.parametrize("method,tol", [("music", 0.5), ("mvdr", 0.8), ("bartlett", 2.0)])
def test_estimate_doa_matches_jax(snaps, method, tol):
    xi, xq = snaps
    got = bf.estimate_doa(CFG, t_(xi), t_(xq), n_sources=2, method=method)
    want = jbf.estimate_doa(JCFG, xi, xq, n_sources=2, method=method)
    assert np.abs(got - want).max() < DOA_TOL
    np.testing.assert_allclose(got, TRUTH, atol=tol)


def test_forward_backward_doa_matches_jax():
    truth = np.array([-30.0, 20.0])
    xi, xq = bf.synthesize(CFG, truth, 512, snr_db=20.0, seed=6, coherent=True)
    got = bf.estimate_doa(CFG, t_(xi), t_(xq), n_sources=2, forward_backward=True)
    want = jbf.estimate_doa(JCFG, xi, xq, n_sources=2, forward_backward=True)
    assert np.abs(got - want).max() < DOA_TOL
    np.testing.assert_allclose(got, truth, atol=1.0)


@pytest.mark.parametrize("name", ["esprit", "root_music"])
def test_gridfree_estimators_match_jax(name):
    truth = np.array([-37.5, 11.25, 42.8])
    xi, xq = bf.synthesize(CFG, truth, 1024, snr_db=15.0, seed=8)
    got = getattr(bf, name)(CFG, t_(xi), t_(xq), n_sources=3)
    want = getattr(jbf, name)(JCFG, xi, xq, n_sources=3)
    assert np.abs(got - want).max() < DOA_TOL
    np.testing.assert_allclose(got, truth, atol=0.4)
    with pytest.raises(ValueError):
        getattr(bf, name)(CFG, t_(xi), t_(xq), n_sources=CFG.n_sensors)


def test_wideband_music_matches_jax():
    truth = np.array([-30.0, 20.0])
    x = bf.synthesize_wideband(CFG, truth, 1 << 13, spacing_samples=2.0, snr_db=10.0, seed=5)
    got = bf.wideband_music_spectrum(CFG, t_(x), n_sources=2, spacing_samples=2.0)
    want = jbf.wideband_music_spectrum(JCFG, x, n_sources=2, spacing_samples=2.0)
    assert rel(got, want) < TOL
    doa = bf.estimate_doa_wideband(CFG, t_(x), n_sources=2, spacing_samples=2.0)
    assert np.abs(doa - bf._pick_peaks(bf.scan_angles(CFG), np.asarray(want), 2)).max() < DOA_TOL
    np.testing.assert_allclose(doa, truth, atol=0.5)
    with pytest.raises(ValueError):
        bf.wideband_music_spectrum(CFG, t_(x), n_sources=2, spacing_samples=2.0, band=(0.3, 0.2))


@pytest.mark.parametrize("method", ["bartlett", "mvdr", "music"])
def test_spectrum_batch_matches_jax_and_single_blocks(method):
    blocks = [bf.synthesize(CFG, [-10.0 + 5 * s, 40.0], 256, seed=10 + s) for s in range(3)]
    xi = np.stack([b[0] for b in blocks])
    xq = np.stack([b[1] for b in blocks])
    got = bf.spectrum_batch(CFG, t_(xi), t_(xq), method=method, n_sources=2)
    want = np.asarray(jbf.spectrum_batch(JCFG, xi, xq, method=method, n_sources=2))
    tol = MUSIC_TOL if method == "music" else TOL
    assert got.shape == (3, CFG.n_grid) and rel(got, want) < tol
    for s in range(3):
        one = bf.spatial_spectrum(CFG, t_(xi[s]), t_(xq[s]), method=method, n_sources=2)
        assert rel(got[s], one.numpy()) < tol
