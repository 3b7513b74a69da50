"""S3 and F3 on the card: dlsim's kernel against its plain loop, one launch a call;
each float kernel wrapper refusing a requires_grad input in grad mode.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_surface_gpu.py -q

Tolerances: S3 within 1e-5 of max|y| (and of max|x|) of its plain loop on the
card (the same products summed in another order), at n in {1, 3, 32, 33, 300,
1024, 1100}, T in {1, 4096}, p = q = 1, p = 2, q = 3 and p = 1, q = 40: every
route (the warp, the rows in one CTA, in a cluster, from device memory); and at
n = 300, q = 300 (rows walked past the register rows) and n = 64, p = 4096 (state
registers with the rows read from device memory).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.ops import launch_counts, lti, reset_launch_counts

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def system(rng, n, p, q, dev, radius=0.95):
    a = rng.standard_normal((n, n))
    a *= radius / np.max(np.abs(np.linalg.eigvals(a)))
    mats = (a, rng.standard_normal((n, p)), rng.standard_normal((q, n)), rng.standard_normal((q, p)))
    return [torch.from_numpy(m.astype(np.float32)).to(dev) for m in mats]


@pytest.mark.parametrize("n", [1, 3, 32, 33, 300, 1024, 1100])
@pytest.mark.parametrize("t", [1, 4096])
@pytest.mark.parametrize("pq", [(1, 1), (2, 3), (1, 40)])
def test_s3_matches_plain(dev, n, t, pq):
    check_s3(dev, n, *pq, t)


@pytest.mark.parametrize("n, p, q, route, walked", [(300, 1, 300, 1, True), (64, 4096, 1, 2, False)])
@pytest.mark.parametrize("t", [1, 4096])
def test_s3_register_rows_corners(dev, n, p, q, route, walked, t):
    g = lti.dlsim_geometry(n, p, q)
    assert g.slots > 0 and g.route == route and (g.rows_cta > 2 * lti.DLSIM_REG_WARPS) == walked
    check_s3(dev, n, p, q, t)


def check_s3(dev, n, p, q, t):
    rng = np.random.default_rng(n + t)
    mats = system(rng, n, p, q, dev)
    u = torch.from_numpy(rng.standard_normal((t, p)).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
    reset_launch_counts()
    y, xs = lti.dlsim_scan(*mats, u, x0)
    torch.cuda.synchronize()
    assert launch_counts()["S3"] == 1
    py, px = lti._dlsim_plain(*mats, u, x0)
    for got, want in ((y, py), (xs, px)):
        err = float((got.double() - want.double()).abs().max())
        assert err <= TOL * float(want.abs().max()), err
    assert torch.equal(xs[0], x0)


def test_s3_entry_points(dev):
    reset_launch_counts()
    y, _ = lti.dlsim(lti.tf2ss([1.0, 0.5], [1.0, -1.2, 0.5]), np.ones(100, np.float32))
    t, yl, _ = lti.lsim(([1.0], [1.0, 0.6, 2.0]), np.sin(np.linspace(0, 5, 500)),
                        np.linspace(0, 5, 500))
    assert y.device.type == "cuda" and isinstance(yl, np.ndarray)
    assert launch_counts()["S3"] == 2
    assert lti.dlsim(lti.tf2ss([1.0], [1.0, 0.5]), np.zeros(0))[0].shape == (0, 1)
    assert launch_counts()["S3"] == 2  # T = 0 launches nothing
    # no cap on states or outputs: 1100 of each, one launch
    a = 0.5 * torch.eye(1100, device=dev)
    y, xs = lti.dlsim_scan(a, torch.ones(1100, 1, device=dev), torch.ones(1100, 1100, device=dev),
                           torch.ones(1100, 1, device=dev), torch.ones(4, 1, device=dev),
                           torch.zeros(1100, device=dev))
    torch.cuda.synchronize()
    assert launch_counts()["S3"] == 3 and y.shape == (4, 1100) and xs.shape == (4, 1100)
    assert torch.equal(xs[:, 0].cpu(), torch.tensor([0.0, 1.0, 1.5, 1.75]))
    assert torch.equal(y[:, 0].cpu(), torch.tensor([1.0, 1101.0, 1651.0, 1926.0]))


def test_f3_refusals_on_the_card(dev):
    import chip_smoke

    for kernel, fn in chip_smoke.f3_cases(dev).items():
        shape = (1, 64 * 128) if kernel == "B19" else (2, 8192)
        x = torch.randn(shape, device=dev).requires_grad_()
        with pytest.raises(NotImplementedError, match="F3"):
            fn(x)
        with torch.no_grad():
            fn(x)
    torch.cuda.synchronize()
