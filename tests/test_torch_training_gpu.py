"""The training path on the card: S1 and S2 against their plain loops, one launch
each; the gradient through B20 against autograd through the plain pair; the
trainer and the designer against the CPU.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_training_gpu.py -q

Tolerances: S1 and S2 within 1e-5 of max|d| (y, e) and of max|w| (taps) of
their plain loops on the card (the same operations summed in other orders);
B20's gradients (taps and input) within 1e-5 of max|g| of autograd through ``branch_fir``
+ ``dft_matmul``; the trainer's taps within 1e-5 of max|true| of the CPU's after
10 steps, and a step repeated gives the same bits (cuDNN's deterministic
algorithms); the designer within 1e-5 of max|h| of the CPU's after 20 steps.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.models import adaptive
from digital_signal_processsing_tpu_torch.ops import (
    channelizer,
    launch_counts,
    pfb_os,
    reset_launch_counts,
)

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def echo(rng, p, b, n, noise=0.003):
    h = (rng.standard_normal(p) * np.exp(-np.arange(p) / max(p / 4, 2))).astype(np.float32)
    x = rng.standard_normal((b, n)).astype(np.float32)
    d = np.stack([np.convolve(r, h)[:n] for r in x]) + noise * rng.standard_normal((b, n))
    return h, x, d.astype(np.float32)


def close(got, want, scale, what):
    err = float((got.double() - want.double()).abs().max())
    assert err <= TOL * float(scale.abs().max()), f"{what}: {err:.3e}"


@pytest.mark.parametrize("algo, p, b, n", [
    ("nlms", 8, 5, 3000), ("nlms", 256, 4, 2048), ("nlms", 1030, 2, 1500),
    ("nlms", 1, 5, 3000), ("nlms", 256, 300, 512), ("nlms ar1", 256, 4, 2048),
    ("nlms", 60000, 2, 300), ("rls", 8, 5, 2000), ("rls", 32, 4, 2048), ("rls", 240, 2, 1024),
    ("rls", 16, 300, 512), ("rls", 33, 3, 1024), ("rls", 100, 2, 700), ("rls", 300, 2, 1024),
    ("rls", 400, 2, 1024),
])
def test_recursion_kernel_matches_plain(dev, algo, p, b, n):
    """S1 also on an AR(1) input (its correlations far from diagonal), more
    streams than SMs, p = 1 and past the taps shared memory holds (60000)."""
    rng = np.random.default_rng(p + n)
    _, x, d = echo(rng, min(p, 64), b, n)
    if algo.endswith("ar1"):
        for t in range(1, n):
            x[:, t] += np.float32(0.95) * x[:, t - 1]
        h = rng.standard_normal(64) * np.exp(-np.arange(64) / 16.0)
        d = np.stack([np.convolve(r, h)[:n] for r in x]).astype(np.float32)
    xd, dd = torch.from_numpy(x).to(dev), torch.from_numpy(d).to(dev)
    nl = algo.startswith("nlms")
    scan = adaptive.nlms_scan if nl else adaptive.rls_scan
    plain = adaptive._nlms_plain if nl else adaptive._rls_plain
    kw = (0.5, 1e-6) if nl else (0.999, 1e2)
    reset_launch_counts()
    got = scan(xd, dd, p, *kw)
    torch.cuda.synchronize()
    assert launch_counts()["S1" if nl else "S2"] == 1
    want = plain(xd, dd, p, *kw)
    close(got[0], want[0], dd, "y")
    close(got[1], want[1], dd, "e")
    close(got[2], want[2], want[2], "w")


def test_recursion_edges_on_the_card(dev):
    for algo in (adaptive.nlms, adaptive.rls):
        for shape, p in (((2, 0), 4), ((3,), 8), ((2, 3, 50), 5)):
            x = torch.randn(shape, device=dev)
            y, e, w = algo(x, x, p)
            yc, ec, wc = algo(x.cpu(), x.cpu(), p)
            assert y.shape == yc.shape and w.shape == wc.shape
            if x.numel():
                close(y.cpu(), yc, x.cpu(), "y")
                close(w.cpu(), wc, wc, "w")


def test_b20_taps_gradient_on_the_card(dev):
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.normal(size=(4096, 64)).astype(np.float32)).to(dev)
    h0 = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32)).to(dev)
    wts = torch.from_numpy(rng.normal(size=(2, 64, 4096)).astype(np.float32)).to(dev)
    reset_launch_counts()
    h = h0.clone().requires_grad_()
    re, im = channelizer.fused_branch_dft(u, h, dilation=2, layout="channels")
    ((wts[0] * re).sum() + (wts[1] * im).sum()).backward()
    torch.cuda.synchronize()
    assert launch_counts()["B20"] == 1
    ref = h0.clone().requires_grad_()
    v = channelizer.branch_fir(u[None], ref, dilation=2)[0]
    r2, i2 = channelizer.dft_matmul(v, None, 64)
    ((wts[0] * r2.T).sum() + (wts[1] * i2.T).sum()).backward()
    close(h.grad, ref.grad, ref.grad, "g_hq")
    # the gradient with respect to u (once refused) against autograd through the plain route
    reset_launch_counts()
    ug = u.clone().requires_grad_()
    re, im = channelizer.fused_branch_dft(ug, h0, dilation=2, layout="channels")
    ((wts[0] * re).sum() + (wts[1] * im).sum()).backward()
    torch.cuda.synchronize()
    assert launch_counts()["B20"] == 1
    uref = u.clone().requires_grad_()
    v = channelizer.branch_fir(uref[None], h0, dilation=2)[0]
    r2, i2 = channelizer.dft_matmul(v, None, 64)
    ((wts[0] * r2.T).sum() + (wts[1] * i2.T).sum()).backward()
    close(ug.grad, uref.grad, uref.grad, "g_u")


def test_trainer_on_the_card_matches_the_cpu_and_repeats_its_bits(dev):
    true = (np.random.default_rng(5).standard_normal(64) * 0.3).astype(np.float32)
    kw = dict(steps=10, batch=(16, 8192), seed=2)
    card, _ = adaptive.identify_system(true, **kw)
    again, _ = adaptive.identify_system(true, **kw)
    cpu, _ = adaptive.identify_system(true, device="cpu", **kw)
    np.testing.assert_array_equal(card, again)
    assert np.abs(card - cpu).max() <= TOL * np.abs(true).max()


def test_designer_runs_b20_every_step(dev):
    reset_launch_counts()
    h = pfb_os.design_pr_prototype(8, 8, steps=20)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {"B20": 20}
    hc = pfb_os.design_pr_prototype(8, 8, steps=20, device="cpu")
    assert np.abs(h - hc).max() <= TOL * np.abs(hc).max()
