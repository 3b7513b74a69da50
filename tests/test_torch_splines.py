"""The port's B-spline filters against the JAX package's and scipy's.

The same NumPy inputs go through the JAX package and through the port on
the CPU, whose seeded recursions are ``sosfilt_chunk`` calls (B12's plain
version here, B12 seeded on the card). Tolerance: 1e-5 of max|c| against the
JAX package and against scipy.signal (float64 throughout): both packages run
the recursions in float32 from float64 boundary sums, which rounds at about
1e-7 of the coefficients. Against scipy only where the JAX package itself
holds to it (tests/test_splines.py): float64 input at the default
precision, at least five samples, and 5e-3 for the 2-D smoothing spline,
where scipy's own Python and C paths differ by about 2e-3. The host helpers
(the basis functions and the evaluations of given coefficients) are the
reference's NumPy: 1e-12.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import splines as jax_splines
from digital_signal_processsing_tpu_torch.ops import splines
from digital_signal_processsing_tpu_torch.utils import last_choice

TOL = 1e-5


def rel_err(got, want):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("lamb", [0.0, 0.5, 3.0])
@pytest.mark.parametrize("shape", [(700,), (3, 400), (1, 5)])
def test_cspline1d_matches_jax_and_scipy(rng, lamb, shape):
    x = rng.standard_normal(shape)
    got = splines.cspline1d(torch.from_numpy(x), lamb)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert rel_err(got, jax_splines.cspline1d(x, lamb)) < TOL
    want = np.stack([sps.cspline1d(r, lamb) for r in np.atleast_2d(x)]).reshape(shape)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("shape", [(700,), (3, 400), (1, 5)])
def test_qspline1d_matches_jax_and_scipy(rng, shape):
    x = rng.standard_normal(shape)
    got = splines.qspline1d(x, device="cpu")
    assert rel_err(got, jax_splines.qspline1d(x)) < TOL
    want = np.stack([sps.qspline1d(r) for r in np.atleast_2d(x)]).reshape(shape)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (1, 3)])
def test_short_interpolating_splines_match_jax(rng, shape):
    x = rng.standard_normal(shape)
    assert rel_err(splines.cspline1d(x, device="cpu"), jax_splines.cspline1d(x)) < TOL
    assert rel_err(splines.qspline1d(x, device="cpu"), jax_splines.qspline1d(x)) < TOL


def test_recursions_go_through_sosfilt_chunk(rng):
    x = torch.from_numpy(rng.standard_normal((2, 500)))
    splines.cspline1d(x)
    assert last_choice("sosfilt_chunk") == "pallas_fused"  # B12 seeded on a card


@pytest.mark.parametrize("dtype,precision", [(np.float64, -1.0), (np.float32, -1.0),
                                             (np.float64, 1e-4)])
def test_symiirorder_matches_jax_and_scipy(rng, dtype, precision):
    x = rng.standard_normal((2, 600)).astype(dtype)
    got1 = splines.symiirorder1(torch.from_numpy(x), 0.8, 0.5, precision)
    want1 = jax_splines.symiirorder1(x, 0.8, 0.5, precision)
    assert rel_err(got1, want1) < TOL
    got2 = splines.symiirorder2(torch.from_numpy(x), 0.6, 0.7, precision)
    assert rel_err(got2, jax_splines.symiirorder2(x, 0.6, 0.7, precision)) < TOL
    if dtype == np.float64 and precision == -1.0:
        assert rel_err(got1[0], sps.symiirorder1(x[0], 0.8, 0.5)) < TOL
        assert rel_err(got2[1], sps.symiirorder2(x[1], 0.6, 0.7)) < TOL


@pytest.mark.parametrize("lamb", [0.0, 0.5])
def test_cspline2d_and_qspline2d_match_jax_and_scipy(rng, lamb):
    img = rng.standard_normal((40, 50))
    got = splines.cspline2d(img, lamb, device="cpu")
    assert rel_err(got, jax_splines.cspline2d(img, lamb)) < TOL
    assert rel_err(got, sps.cspline2d(img, lamb)) < (TOL if lamb == 0.0 else 5e-3)
    got_q = splines.qspline2d(torch.from_numpy(img))
    assert rel_err(got_q, jax_splines.qspline2d(img)) < TOL
    assert rel_err(got_q, sps.qspline2d(img)) < TOL


def test_host_helpers_match_jax(rng):
    pts = np.linspace(-3.0, 3.0, 61)
    np.testing.assert_allclose(splines.bspline3(pts), jax_splines.bspline3(pts), rtol=1e-12)
    np.testing.assert_allclose(splines.bspline2(pts), jax_splines.bspline2(pts), rtol=1e-12)
    np.testing.assert_allclose(splines.gauss_spline(pts, 3),
                               np.asarray(jax_splines.gauss_spline(pts, 3)), rtol=1e-6)
    tg = splines.gauss_spline(torch.from_numpy(pts), 3)
    np.testing.assert_allclose(tg.numpy(), sps.gauss_spline(pts, 3), rtol=1e-12)
    cj = rng.standard_normal(30)
    newx = np.linspace(-5.0, 40.0, 97)
    for port_fn, jax_fn in ((splines.cspline1d_eval, jax_splines.cspline1d_eval),
                            (splines.qspline1d_eval, jax_splines.qspline1d_eval)):
        np.testing.assert_allclose(port_fn(torch.from_numpy(cj), newx, dx=0.5, x0=1.0),
                                   jax_fn(cj, newx, dx=0.5, x0=1.0), rtol=1e-12)
        np.testing.assert_allclose(port_fn(cj[:1], newx), jax_fn(cj[:1], newx), rtol=1e-12)
    # evaluating the coefficients at the samples gives the signal back
    x = rng.standard_normal(200)
    c = splines.cspline1d(x, device="cpu")
    assert rel_err(splines.cspline1d_eval(c, np.arange(200.0)), x) < TOL


def test_refusals_match_jax():
    x1 = np.zeros(50)
    calls = [
        ("symiirorder1", (x1, 0.5, 1.2)),
        ("symiirorder1", (np.zeros((2, 2, 5)), 0.5, 0.3)),
        ("symiirorder2", (x1, 1.1, 0.4)),
        ("symiirorder1", (np.zeros(3), 0.5, 0.9)),  # too short to converge
        ("qspline1d", (x1, 0.5)),
        ("qspline2d", (np.zeros((5, 5)), 0.5)),
        ("cspline2d", (x1,)),
    ]
    for name, args in calls:
        with pytest.raises(ValueError) as want:
            getattr(jax_splines, name)(*args)
        with pytest.raises(ValueError) as got:
            getattr(splines, name)(*args, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="must not be empty"):
        splines.cspline1d_eval(np.zeros(0), [1.0])
