"""Order-statistic and adaptive smoothing filters: medfilt, rank, Wiener.

scipy.signal's ``medfilt``, ``order_filter`` and ``wiener`` and
scipy.ndimage's ``rank_filter`` semantics (the reference package's
``ops/rank.py``). A sliding-window order statistic is a median or a sort
along the window axis of an ``unfold`` view of the zero-padded stream: no
gathers, and the window axis is small. The Wiener filter's local moments are
two centered box correlations (``fir._centered_fir``: one ``conv1d`` in IEEE
float32, where the reference runs an XLA convolution outside any Pallas
kernel).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import as_tensor
from .fir import _as_planar, _centered_fir

__all__ = ["medfilt", "rank_filter", "wiener", "order_filter"]


def _odd(k: int, what: str = "kernel_size") -> None:
    if k % 2 == 0 or k < 1:
        raise ValueError(f"{what} must be odd >= 1, got {k}")


def _windows(xp: torch.Tensor, k: int) -> torch.Tensor:
    """(c, t, k) zero-padded centered windows, a view of the padded stream."""
    half = k // 2
    return F.pad(xp.to(torch.float32), (half, half)).unfold(-1, k, 1)


def medfilt(x, kernel_size: int = 3, *, device="cuda") -> torch.Tensor:
    """Sliding-window median (scipy.signal.medfilt: odd window, zero pad) of a
    (time,) or (channels, time) signal, float32."""
    _odd(kernel_size)
    xp, squeeze = _as_planar(as_tensor(x, device))
    y = torch.median(_windows(xp, kernel_size), dim=-1).values
    return y[0] if squeeze else y


def rank_filter(x, kernel_size: int, rank: int, *, device="cuda") -> torch.Tensor:
    """Sliding-window rank filter: the ``rank``-th smallest of each centered
    zero-padded window (rank 0 the minimum, k - 1 the maximum, (k - 1) // 2 the
    median)."""
    _odd(kernel_size)
    if not 0 <= rank < kernel_size:
        raise ValueError(f"rank must be in [0, {kernel_size}), got {rank}")
    xp, squeeze = _as_planar(as_tensor(x, device))
    y = torch.sort(_windows(xp, kernel_size), dim=-1).values[..., rank]
    return y[0] if squeeze else y


def wiener(x, mysize: int = 3, noise: float | None = None, *, device="cuda") -> torch.Tensor:
    """Adaptive local-statistics Wiener filter (scipy.signal.wiener, 1-D).

    Local mean and variance from two centered box correlations; where the
    local variance falls below the noise floor the output is the local mean.
    ``noise=None`` estimates the floor as the mean local variance, as scipy does.
    """
    _odd(mysize, "mysize")
    xp, squeeze = _as_planar(as_tensor(x, device))
    xf = xp.to(torch.float32)
    half = mysize // 2
    box = np.full(mysize, 1.0 / mysize)
    l_mean = _centered_fir(F.pad(xf, (half, half)), box)
    l_var = _centered_fir(F.pad(xf * xf, (half, half)), box) - l_mean * l_mean
    if noise is None:
        nz = torch.mean(l_var, dim=-1, keepdim=True)
    else:
        nz = torch.tensor(noise, dtype=torch.float32, device=xf.device)
    res = l_mean + (1.0 - nz / torch.clamp(l_var, min=1e-30)) * (xf - l_mean)
    y = torch.where(l_var < nz, l_mean, res)
    return y[0] if squeeze else y


def order_filter(x, domain, rank: int, *, device="cuda") -> torch.Tensor:
    """N-D order filter over a 0/1 neighbourhood mask (scipy.signal.order_filter:
    odd domain sides, zero-padded edges): the ``rank``-th smallest of the
    masked neighbours, from shifted views sorted along their stack."""
    domain = np.asarray(domain)
    xf = as_tensor(x, device).to(torch.float32)
    if any(s % 2 == 0 for s in domain.shape):
        raise ValueError("domain sides must be odd")
    if domain.ndim != xf.dim():
        raise ValueError("domain rank must match input rank")
    nnz = int(np.count_nonzero(domain))
    if not 0 <= rank < nnz:
        raise ValueError(f"rank must be in [0, {nnz}), got {rank}")
    pads = []
    for s in reversed(domain.shape):  # F.pad takes the last axis first
        pads += [s // 2, s // 2]
    ext = F.pad(xf, pads)
    dom = domain.astype(bool)
    views = [
        ext[tuple(slice(o, o + n) for o, n in zip(offs, xf.shape))]
        for offs in np.ndindex(*domain.shape) if dom[offs]
    ]
    return torch.sort(torch.stack(views, dim=-1), dim=-1).values[..., rank]
