"""S3 and F3 on the card: dlsim's kernel against its plain loop, one launch a call;
each float kernel wrapper refusing a requires_grad input in grad mode.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_surface_gpu.py -q

Tolerances: S3 within 1e-5 of max|y| (and of max|x|) of its plain loop on the
card (the same products summed in another order), at n in {1, 3, 32, 33, 300,
1024}, T in {1, 4096}, p = q = 1 and p = 2, q = 3.
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


@pytest.mark.parametrize("n", [1, 3, 32, 33, 300, 1024])
@pytest.mark.parametrize("t", [1, 4096])
@pytest.mark.parametrize("pq", [(1, 1), (2, 3)])
def test_s3_matches_plain(dev, n, t, pq):
    rng = np.random.default_rng(n + t)
    p, q = pq
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
    with pytest.raises(ValueError, match="at most 1024 states"):
        lti.dlsim_scan(torch.eye(1025, device=dev), torch.ones(1025, 1, device=dev),
                       torch.ones(1, 1025, device=dev), torch.ones(1, 1, device=dev),
                       torch.ones(4, 1, device=dev), torch.zeros(1025, device=dev))


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
