"""2x-oversampled polyphase filter bank: analysis and synthesis.

Counterpart of ``digital_signal_processsing_tpu/ops/pfb_os.py`` (D = N/2):

  analysis   Y[k,m] = (-1)^{km} sum_q e^{2*pi*i*k*q/N} v_q[m],
             v_q[m] = sum_r h[rN+q] w_q[m-2r],  w_q[s] = x[Ds - q]
  synthesis  x[Ds+p] = sum_r g[Dr+p] * T[s-r, p + D*(r mod 2)],
             T[m, phi] = sum_k (-1)^{km} Y[k,m] e^{2*pi*i*k*phi/N}

On a CUDA tensor with more than one tap a phase the analysis runs through
B20 (``channelizer.fused_branch_dft``, dilation 2), as the reference does on
the TPU, writing the (N, S) planes directly; otherwise ``branch_fir`` +
``dft_matmul``.

``design_pr_prototype`` trains the prototype with Adam on the reconstruction
error through analysis and synthesis plus its stopband energy. On the card
every step runs B20 forward and its gradient with respect to the taps
(``channelizer.BranchDftTapsGrad``); the reference cannot take that route on
its TPU (``jax.grad`` does not pass through its Pallas kernel, ROADMAP H14)
and designs on its CPU route, ``branch_fir`` + ``dft_matmul``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from .channelizer import _phase_taps, branch_fir, commutate, dft_matmul, fused_branch_dft
from .fir import design_lowpass, ieee_fp32_matmul
from .pallas_scan import _on_cuda


def _kms_sign(n: int, s: int, device) -> torch.Tensor:
    """(-1)^{km} as an (N, S) float32 tensor: -1 where k and m are both odd."""
    k_odd = torch.arange(n, dtype=torch.int32, device=device)[:, None] & 1
    m_odd = torch.arange(s, dtype=torch.int32, device=device)[None, :] & 1
    return (1 - 2 * (k_odd & m_odd)).to(torch.float32)


def _analyze_planar(x: torch.Tensor, taps, n: int, *, fused: bool | None = None):
    """Real (T,) -> (re, im) each (N, S), S = T / (N/2). ``fused``: B20 (or its plain
    version on the CPU) or the composed pair; by default B20 on a CUDA tensor with
    more than one tap a phase."""
    # w_q[m] = x[Dm - q]: q in [0, D) the commutator at D; q in [D, N) the
    # one-block delay of q - D
    w_lo = commutate(x, n // 2)
    s = w_lo.shape[0]
    w = torch.cat([w_lo, F.pad(w_lo[:-1], (0, 0, 1, 0))], dim=1)  # (S, N)
    hq = _phase_taps(taps, n, x.device)
    if fused is None:
        fused = _on_cuda(x) and hq.shape[0] > 1
    if fused:
        re, im = fused_branch_dft(w, hq, sign=1, dilation=2, layout="channels")
    else:
        v = branch_fir(w[None], hq, dilation=2)[0]
        re, im = dft_matmul(v, None, n)
        re, im = re.T, im.T
    sgn = _kms_sign(n, s, x.device)
    return re * sgn, im * sgn


def pfb_analyze_os(
    x: torch.Tensor, n_channels: int, taps
) -> tuple[torch.Tensor, torch.Tensor]:
    """2x-oversampled analysis: (T,) real -> planar (I, Q), (N, 2T/N) each.

    Channel k is centred at k/N cycles a sample at output rate fs/(N/2).
    ``T`` must be a multiple of N//2; N even.
    """
    if n_channels % 2 != 0:
        raise ValueError(f"n_channels must be even, got {n_channels}")
    if x.dim() != 1 or x.shape[0] % (n_channels // 2) != 0:
        raise ValueError(f"stream length {tuple(x.shape)} must be a flat multiple of N/2")
    return _analyze_planar(x, taps, n_channels)


def _synthesize_planar(yi: torch.Tensor, yq: torch.Tensor, taps, n: int):
    d = n // 2
    s = yi.shape[1]
    sgn = _kms_sign(n, s, yi.device)
    ti = (yi.to(torch.float32) * sgn).T  # demodulated, (S, N)
    tq = (yq.to(torch.float32) * sgn).T
    # T[m, phi] = Re sum_k (ti + i tq)[m, k] e^{2*pi*i*k*phi/N}: the imaginary
    # part of a real-signal reconstruction cancels
    t_re, _ = dft_matmul(ti, tq, n)
    gq = _phase_taps(taps, d, yi.device)
    p = gq.shape[0]
    # out[s, pp] = sum_r gq[r, pp] * T[s - r, pp + D*(r mod 2)], zeros before s = 0
    tp = F.pad(t_re, (0, 0, p - 1, 0))
    out = None
    for r in range(p):
        col = d * (r % 2)
        term = tp[p - 1 - r : p - 1 - r + s, col : col + d] * gq[r]
        out = term if out is None else out + term
    return out.reshape(-1)


def pfb_synthesize_os(
    yi: torch.Tensor, yq: torch.Tensor, n_channels: int, taps
) -> torch.Tensor:
    """2x-oversampled synthesis: planar (I, Q) (N, S) -> real (S*N/2,)."""
    if n_channels % 2 != 0:
        raise ValueError(f"n_channels must be even, got {n_channels}")
    return _synthesize_planar(yi, yq, taps, n_channels)


def _design_setup(n: int, taps_per_phase: int, seed: int, dev: torch.device):
    """The designer's data: the noise x, the delay, the stopband matrices, the start."""
    d = n // 2
    k = taps_per_phase * n
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=d * 512).astype(np.float32)).to(dev)
    # stopband grid: beyond the oversampled channel edge 2/N (Nyquist units)
    arg = np.pi * np.outer(np.linspace(2.2 / n, 1.0, 200), np.arange(k))
    m_cos = torch.from_numpy(np.cos(arg).astype(np.float32)).to(dev)
    m_sin = torch.from_numpy(np.sin(arg).astype(np.float32)).to(dev)
    h0 = torch.from_numpy(np.asarray(design_lowpass(k, 1.0 / n), np.float32)).to(dev)
    return x, m_cos, m_sin, h0


def _design_loss(h: torch.Tensor, x: torch.Tensor, n: int, m_cos: torch.Tensor,
                 m_sin: torch.Tensor, stopband_weight: float, *, fused: bool | None = None):
    """Reconstruction error through the bank, after its group delay K (the taps'
    count) and away from a guard of 2K at both ends, plus the weighted mean
    stopband power of H on the grid."""
    k = h.shape[0]
    yi, yq = _analyze_planar(x, h, n, fused=fused)
    rec = _synthesize_planar(yi, yq, h * (n // 2), n)
    a = rec[k:]
    b = x[: a.shape[0]]
    guard = 2 * k
    err = a[guard:-guard] - b[guard:-guard]
    recon = torch.mean(err**2)
    with ieee_fp32_matmul():
        hre, him = m_cos @ h, m_sin @ h
    return recon + stopband_weight * torch.mean(hre**2 + him**2)


def design_pr_prototype(
    n_channels: int,
    taps_per_phase: int = 8,
    *,
    steps: int = 600,
    lr: float = 3e-3,
    stopband_weight: float = 0.05,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Optimise a near-perfect-reconstruction prototype through the bank.

    Adam (``torch.optim.Adam(lr)``) on
    ``||synthesize(analyze(x; h); h) - delay(x)||^2 + stopband_weight * stopband
    energy of H``, x broadband noise from ``default_rng(seed)``, starting from
    the windowed-sinc lowpass: the reference's data, delay, guard, grid and
    loss. Returns the taps as float32 NumPy. On the card (the default; pass
    ``device="cpu"`` for the plain route) each step runs B20 forward and back.
    """
    if n_channels % 2 != 0:
        raise ValueError(f"n_channels must be even, got {n_channels}")
    dev = resolve_device(device)
    x, m_cos, m_sin, h0 = _design_setup(n_channels, taps_per_phase, seed, dev)
    h = torch.nn.Parameter(h0)
    opt = torch.optim.Adam([h], lr=lr)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        _design_loss(h, x, n_channels, m_cos, m_sin, stopband_weight).backward()
        opt.step()
    return h.detach().cpu().numpy().astype(np.float32)


__all__ = ["pfb_analyze_os", "pfb_synthesize_os", "design_pr_prototype"]
