"""The gradient through B20 and the port's ``design_pr_prototype`` against the JAX
package.

``channelizer.BranchDftTapsGrad`` (B20 forward on the card, its plain pair on
the CPU; the gradient with respect to the branch taps by the DFT's adjoint and
a correlation with u) is pinned by ``torch.autograd.gradcheck`` in float64
through the CPU forward, in each layout, sign and dilation; in float32 its
gradient equals autograd through the composed pair within 1e-6 of max|g|. Its
gradient with respect to ``u`` is held against ``jax.grad`` of the reference's
plain route (``tests/test_torch_surface_rest.py`` holds it in every layout).

The designer runs the reference's data (``default_rng(seed)``), delay, guard,
stopband grid and loss. The JAX package designs on its CPU route, ``branch_fir``
+ ``dft_matmul`` (its TPU route cannot be differentiated, ROADMAP H14); the
port on the CPU takes B20's plain pair. Tolerances: the loss and its gradient
at the start within 1e-6 of the reference's (relative), the taps after 50 steps
within 1e-5 of max|h| (Adam on float32 gradients rounded in another order);
after 600 steps the reference's anchors (tests/test_pfb_os.py:55-64): full-band
reconstruction above 45 dB, stopband below -25 dB.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import channelizer as jax_channelizer
from digital_signal_processsing_tpu.ops import pfb_os as jax_pfb_os
from digital_signal_processsing_tpu_torch.ops import channelizer, pfb_os


@pytest.mark.parametrize("layout", ["rows", "channels", "complex"])
@pytest.mark.parametrize("sign, dilation", [(1, 1), (-1, 2), (1, 3)])
def test_b20_taps_gradient_gradcheck(layout, sign, dilation):
    gen = torch.Generator().manual_seed(7)
    u = torch.randn(13, 6, dtype=torch.float64, generator=gen)
    hq = torch.randn(3, 6, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda h: channelizer.BranchDftTapsGrad.apply(u, h, sign, dilation, layout), (hq,))


@pytest.mark.parametrize("layout", ["rows", "channels", "complex"])
def test_b20_taps_gradient_matches_autograd_of_the_composed_pair(layout, rng):
    u = torch.from_numpy(rng.normal(size=(200, 16)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(4, 16)).astype(np.float32))
    weights = torch.from_numpy(rng.normal(size=(2, 200, 16)).astype(np.float32))

    def loss(out):
        re, im = (out.real.T, out.imag.T) if layout == "complex" else (
            (out[0].T, out[1].T) if layout == "channels" else out)
        return (weights[0] * re).sum() + (weights[1] * im * im).sum()

    h = h0.clone().requires_grad_()
    loss(channelizer.fused_branch_dft(u, h, dilation=2, layout=layout)).backward()
    ref = h0.clone().requires_grad_()
    v = channelizer.branch_fir(u[None], ref, dilation=2)[0]
    re, im = channelizer.dft_matmul(v, None, 16)
    loss(channelizer._arrange(re, im, layout)).backward()
    scale = ref.grad.abs().max()
    assert (h.grad - ref.grad).abs().max() <= 1e-6 * scale


def test_b20_refuses_a_gradient_with_respect_to_u(rng):
    """B20 once refused a ``u`` that requires a gradient; it now gives that gradient,
    held against ``jax.grad`` of the reference's plain route within 1e-5 of max|g|.
    Under ``torch.no_grad()`` the forward runs alone, with no graph."""
    u0 = rng.normal(size=(32, 8)).astype(np.float32)
    hq0 = rng.normal(size=(2, 8)).astype(np.float32)
    w = rng.normal(size=(2, 32, 8)).astype(np.float32)
    u = torch.from_numpy(u0).requires_grad_()
    hq = torch.from_numpy(hq0).requires_grad_()
    re, im = channelizer.fused_branch_dft(u, hq)
    ((torch.from_numpy(w[0]) * re).sum() + (torch.from_numpy(w[1]) * im * im).sum()).backward()

    def jloss(uu, hh):
        v = jax_channelizer.branch_fir(uu[None], hh)[0]
        jre, jim = jax_channelizer.dft_matmul(v, None, 8)
        return (w[0] * jre).sum() + (w[1] * jim * jim).sum()

    gu, gh = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0), jnp.asarray(hq0))
    for got, want in ((u.grad, gu), (hq.grad, gh)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with torch.no_grad():  # no graph asked for: the forward alone
        re, _ = channelizer.fused_branch_dft(u, hq)
    assert re.shape == (32, 8) and not re.requires_grad


def test_design_loss_and_gradient_match_jax():
    n, p = 8, 8
    x, m_cos, m_sin, h0 = pfb_os._design_setup(n, p, 0, torch.device("cpu"))
    h = h0.clone().requires_grad_()
    loss = pfb_os._design_loss(h, x, n, m_cos, m_sin, 0.05)
    loss.backward()

    xj, mc, ms = (jnp.asarray(a.numpy()) for a in (x, m_cos, m_sin))
    k = p * n

    def jloss(hh):  # digital_signal_processsing_tpu/ops/pfb_os.py:177-188
        yi, yq = jax_pfb_os._analyze_planar(xj, hh, n)
        rec = jax_pfb_os._synthesize_planar(yi, yq, hh * (n // 2), n)
        a = rec[k:]
        b = xj[: a.shape[0]]
        err = a[2 * k : -2 * k] - b[2 * k : -2 * k]
        return jnp.mean(err**2) + 0.05 * jnp.mean((mc @ hh) ** 2 + (ms @ hh) ** 2)

    jl, jg = jax.value_and_grad(jloss)(jnp.asarray(h0.numpy()))
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    jg = np.asarray(jg)
    assert np.abs(h.grad.numpy() - jg).max() <= 1e-6 * np.abs(jg).max()


def test_design_matches_jax_after_50_steps():
    h = pfb_os.design_pr_prototype(8, 8, steps=50, device="cpu")
    jh = jax_pfb_os.design_pr_prototype(8, 8, steps=50)
    assert h.dtype == np.float32 and h.shape == (64,)
    assert np.abs(h - jh).max() <= 1e-5 * np.abs(jh).max()


def roundtrip_snr(h, n, rng, blocks=4096):
    """tests/test_pfb_os.py:40-52 through the port's bank on the CPU."""
    d = n // 2
    k = h.size
    x = rng.normal(size=d * blocks).astype(np.float32)
    yi, yq = pfb_os.pfb_analyze_os(torch.from_numpy(x), n, torch.from_numpy(h))
    rec = pfb_os.pfb_synthesize_os(yi, yq, n, torch.from_numpy(h * d)).numpy()
    a = rec[k:]
    b = x[: a.size]
    g = 2 * k
    err = a[g:-g] - b[g:-g]
    return 10 * np.log10(np.sum(b[g:-g] ** 2) / np.sum(err**2))


def test_designed_prototype_reconstructs_full_band(rng):
    n, p = 8, 8
    h = pfb_os.design_pr_prototype(n, p, steps=600, device="cpu")
    snr = roundtrip_snr(h, n, rng)
    assert snr > 45, f"designed prototype: {snr:.1f} dB"
    w = np.fft.rfft(h, 4096)
    f = np.linspace(0, 1, w.size)
    sb = 20 * np.log10(np.max(np.abs(w[f > 2.2 / n])) / np.max(np.abs(w)))
    assert sb < -25, f"stopband peak {sb:.1f} dB"


def test_design_refuses_an_odd_bank():
    with pytest.raises(ValueError, match="even"):
        pfb_os.design_pr_prototype(7, steps=1, device="cpu")
