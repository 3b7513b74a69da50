"""B-spline signal processing (scipy.signal's spline subsystem).

Counterpart of ``digital_signal_processsing_tpu/ops/splines.py``, all but
``spline_filter`` (it reconstructs through ``twod.sepfir2d``, which the port
does not have yet). Unser's recursive B-spline interpolation and smoothing
filters with mirror-symmetric boundaries (B-Spline Signal Processing, IEEE
TSP 1993, parts I-II): the boundary initial conditions are truncated
infinite sums, taken in float64 on the signal's device, and the forward and
backward recursions are seeded chunks of ``ops.iir.sosfilt_chunk``, so on
the card they run the SOS cascade kernel B12 seeded.

A signal is a tensor (it stays on its device) or an array (it goes to
``device``, the card by default); coefficients come back as float64 tensors
on that device, as the reference returns float64 arrays. The evaluation
helpers (``cspline1d_eval``, ``qspline1d_eval``) and the basis functions are
host NumPy, as in the reference.

Parity oracle: scipy.signal, with its two quirks kept as the reference
keeps them: ``symiirorder1``'s initial condition uses the half-sample
mirror (``x[-k] = x[k-1]``), and ``cspline1d(lamb>0)`` (scipy's Python
path) and ``symiirorder2`` (its C path) use slightly different y[1]
boundary sums.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from .iir import sosfilt_chunk


def gauss_spline(x, n: int):
    """Gaussian approximation to the order-``n`` B-spline basis
    (scipy.signal.gauss_spline); a tensor stays a tensor."""
    sig2 = (n + 1) / 12.0
    if isinstance(x, torch.Tensor):
        return (1.0 / math.sqrt(2.0 * math.pi * sig2)) * torch.exp(-(x**2) / (2.0 * sig2))
    x = np.asarray(x, np.float32)
    return ((1.0 / math.sqrt(2.0 * math.pi * sig2)) * np.exp(-(x**2) / (2.0 * sig2))).astype(
        np.float32
    )


def bspline3(x):
    """Closed-form cubic B-spline basis (knots -2..2)."""
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(
        ax <= 1.0,
        2.0 / 3.0 - ax**2 + 0.5 * ax**3,
        np.where(ax < 2.0, (2.0 - ax) ** 3 / 6.0, 0.0),
    )


def bspline2(x):
    """Closed-form quadratic B-spline basis (knots -1.5..1.5)."""
    ax = np.abs(np.asarray(x, np.float64))
    return np.where(
        ax <= 0.5,
        0.75 - ax**2,
        np.where(ax < 1.5, 0.5 * (ax - 1.5) ** 2, 0.0),
    )


def _signal(signal, device) -> tuple[torch.Tensor, bool]:
    """(float64 tensor on its device or ``device``, whether it came in float32)."""
    if isinstance(signal, torch.Tensor):
        return signal.to(torch.float64), signal.dtype == torch.float32
    arr = np.asarray(signal)
    return torch.from_numpy(arr.astype(np.float64)).to(resolve_device(device)), arr.dtype == np.float32


def _resolve_precision(precision: float, single: bool) -> float:
    if 0.0 < precision < 1.0:
        return float(precision)
    return 1e-3 if single else 1e-6


def _trunc_len(base: float, precision: float, k_max: int) -> int:
    """First k with |base|^k < precision (scipy's truncated-sum horizon);
    raises as scipy does when the signal is too short for convergence."""
    if base == 0.0:
        return 1
    k = int(np.ceil(np.log(precision) / np.log(abs(base))))
    if k >= k_max:
        raise ValueError("Sum to find symmetric boundary conditions did not converge.")
    return max(k, 1)


def _on(v: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, np.float64)).to(like.device)


def _sos_pass(row, state_s1: torch.Tensor, state_s2: torch.Tensor, x: torch.Tensor):
    """One seeded first/second-order recursion through ``sosfilt_chunk``.

    ``x``: (C, T); states: (C,). Returns (C, T) float64.
    """
    st = torch.stack([state_s1, state_s2], -1).to(torch.float32)[None]
    _, y = sosfilt_chunk(st, np.asarray(row, np.float32).reshape(1, 6), x.to(torch.float32))
    return y.to(torch.float64)


def _flip(v: torch.Tensor) -> torch.Tensor:
    return torch.flip(v, [-1])


def _symiir1_apply(xb: torch.Tensor, c0: float, z1: float, y0: torch.Tensor):
    """Forward 1/(1-z1 z^-1) from y0, then backward c0/(1-z1 z)."""
    if xb.shape[-1] == 1:
        # the backward pass's boundary value is the whole output
        return (-c0 / (z1 - 1.0) * y0)[:, None]
    y_rest = _sos_pass([1.0, 0, 0, 1.0, -z1, 0], z1 * y0, 0.0 * y0, xb[:, 1:])
    y1 = torch.cat([y0[:, None], y_rest], -1)
    out_last = -c0 / (z1 - 1.0) * y1[:, -1]
    out_rest = _sos_pass(
        [c0, 0, 0, 1.0, -z1, 0], z1 * out_last, 0.0 * out_last, _flip(y1[:, :-1])
    )
    return torch.cat([_flip(out_rest), out_last[:, None]], -1)


def symiirorder1(signal, c0: float, z1: float, precision: float = -1.0, *, device="cuda"):
    """Mirror-symmetric forward-backward first-order smoothing IIR
    (scipy.signal.symiirorder1): ``H(z) = c0 / ((1 - z1 z^-1)(1 - z1 z))``.

    1-D or 2-D (batched over the leading axis); the recursions run in
    float32 through ``sosfilt_chunk``, the boundary sums in float64.
    """
    x, single = _signal(signal, device)
    if abs(z1) >= 1.0:
        raise ValueError("|z1| must be less than 1.0")
    if x.dim() > 2:
        raise ValueError("Input must be 1D or 2D")
    squeeze = x.dim() == 1
    xb = x[None] if squeeze else x
    k = xb.shape[-1]
    kc = _trunc_len(z1, _resolve_precision(precision, single), k)
    # half-sample mirror IC: y0 = x[0] + z1 * sum_k z1^k x[k]
    pows = _on(z1 ** np.arange(kc), xb)
    y0 = xb[:, 0] + z1 * (pows * xb[:, :kc]).sum(-1)
    out = _symiir1_apply(xb, c0, z1, y0)
    return out[0] if squeeze else out


def _hc(kk, cs: float, rho: float, omega: float):
    kk = np.asarray(kk)
    if omega == 0.0:
        return cs * (kk + 1.0) * rho**kk * (kk > -1)
    return cs / np.sin(omega) * rho ** np.maximum(kk, 0) * np.sin(omega * (kk + 1.0)) * (kk > -1)


def _hs(kk, cs: float, rho: float, omega: float):
    kk = np.abs(np.asarray(kk))
    c0 = (
        cs * cs * (1.0 + rho * rho) / (1.0 - rho * rho)
        / (1.0 - 2.0 * rho * rho * np.cos(2.0 * omega) + rho**4)
    )
    gamma = (1.0 - rho * rho) / (1.0 + rho * rho) / np.tan(omega)
    return c0 * rho**kk * (np.cos(omega * kk) + gamma * np.sin(omega * kk))


def _symiir2_apply(xb, r, omega, y0, y1, ylast, ylast2):
    """Forward then backward cs/(1 - a2 z^-1 - a3 z^-2) cascade with the
    given boundary values."""
    rsq = r * r
    a2 = 2.0 * r * np.cos(omega)
    a3 = -rsq
    cs = 1.0 - 2.0 * r * np.cos(omega) + rsq
    row = [cs, 0, 0, 1.0, -a2, -a3]
    y_rest = _sos_pass(row, a3 * y0 + a2 * y1, a3 * y1, xb[:, 2:])
    y_fwd = torch.cat([y0[:, None], y1[:, None], y_rest], -1)
    out_rest = _sos_pass(row, a3 * ylast + a2 * ylast2, a3 * ylast2, _flip(y_fwd[:, :-2]))
    return torch.cat([_flip(out_rest), ylast2[:, None], ylast[:, None]], -1)


def symiirorder2(input, r: float, omega: float, precision: float = -1.0, *, device="cuda"):
    """Mirror-symmetric forward-backward second-order smoothing IIR
    (scipy.signal.symiirorder2; its C boundary convention)."""
    x, single = _signal(input, device)
    if r >= 1.0:
        raise ValueError("r must be less than 1.0")
    if x.dim() > 2:
        raise ValueError("Input must be 1D or 2D")
    squeeze = x.dim() == 1
    xb = x[None] if squeeze else x
    k = xb.shape[-1]
    kc = _trunc_len(r, _resolve_precision(precision, single), k)  # hc/hs decay as r^k
    cs = 1.0 - 2.0 * r * np.cos(omega) + r * r
    kk = np.arange(kc)
    # half-sample mirror: y[0] = hc(0)x[0] + sum hc(k+1)x[k];
    # y[1] = (hc(1)+hc(2))x[0] + (hc(0)+hc(3))x[1] + sum_{k>=2} hc(k+2)x[k]
    y0 = _hc(0, cs, r, omega) * xb[:, 0] + (_on(_hc(kk + 1, cs, r, omega), xb) * xb[:, :kc]).sum(-1)
    w1 = _hc(kk + 2, cs, r, omega)
    w1[0] = _hc(1, cs, r, omega) + _hc(2, cs, r, omega)
    if kc > 1:
        w1[1] = _hc(0, cs, r, omega) + _hc(3, cs, r, omega)
    y1 = (_on(w1, xb) * xb[:, :kc]).sum(-1)
    xr = _flip(xb)[:, :kc]
    wl = _hs(kk, cs, r, omega) + _hs(kk + 1, cs, r, omega)
    wl2 = _hs(kk - 1, cs, r, omega) + _hs(kk + 2, cs, r, omega)
    ylast = (_on(wl, xb) * xr).sum(-1)
    ylast2 = (_on(wl2, xb) * xr).sum(-1)
    out = _symiir2_apply(xb, r, omega, y0, y1, ylast, ylast2)
    return out[0] if squeeze else out


def _coeff_smooth(lam: float):
    xi = 1.0 - 96.0 * lam + 24.0 * lam * math.sqrt(3.0 + 144.0 * lam)
    omeg = math.atan2(math.sqrt(144.0 * lam - 1.0), math.sqrt(xi))
    rho = (24.0 * lam - 1.0 - math.sqrt(xi)) / (24.0 * lam)
    rho = rho * math.sqrt((48.0 * lam + 24.0 * lam * math.sqrt(3.0 + 144.0 * lam)) / xi)
    return rho, omeg


def _smooth_coeff_1d(xb: torch.Tensor, lamb: float):
    """scipy's _cubic_smooth_coeff boundary convention (its Python path:
    y[1] uses hc(0)x0 + hc(1)x1 + sum hc(k+2)x[k], full-length sums)."""
    rho, omega = _coeff_smooth(lamb)
    cs = 1.0 - 2.0 * rho * np.cos(omega) + rho * rho
    kk = np.arange(xb.shape[-1])
    h0, h1 = _hc(0, cs, rho, omega), _hc(1, cs, rho, omega)
    y0 = h0 * xb[:, 0] + (_on(_hc(kk + 1, cs, rho, omega), xb) * xb).sum(-1)
    y1 = h0 * xb[:, 0] + h1 * xb[:, 1] + (_on(_hc(kk + 2, cs, rho, omega), xb) * xb).sum(-1)
    xr = _flip(xb)
    wl = _hs(kk, cs, rho, omega) + _hs(kk + 1, cs, rho, omega)
    wl2 = _hs(kk - 1, cs, rho, omega) + _hs(kk + 2, cs, rho, omega)
    ylast = (_on(wl, xb) * xr).sum(-1)
    ylast2 = (_on(wl2, xb) * xr).sum(-1)
    return _symiir2_apply(xb, rho, omega, y0, y1, ylast, ylast2)


def _interp_coeff_1d(xb: torch.Tensor, zi: float, gain: float):
    """lamb=0 interpolation coefficients: full-length IC sums, no
    convergence requirement (scipy's _cubic_coeff/_quadratic_coeff)."""
    k = xb.shape[-1]
    y0 = xb[:, 0] + zi * (_on(zi ** np.arange(k), xb) * xb).sum(-1)
    if k == 1:
        return gain * (zi / (zi - 1.0)) * y0[:, None]
    return _symiir1_apply(xb, gain * (-zi), zi, y0)


def cspline1d(signal, lamb: float = 0.0, *, device="cuda"):
    """Cubic-spline coefficients of a 1-D signal (or a batch of them along
    the leading axis), mirror-symmetric boundaries (scipy.signal.cspline1d);
    reconstruct by mirror-convolving with [1, 4, 1]/6."""
    x, _ = _signal(signal, device)
    squeeze = x.dim() == 1
    xb = x[None] if squeeze else x
    if lamb != 0.0:
        out = _smooth_coeff_1d(xb, lamb)
    else:
        out = _interp_coeff_1d(xb, -2.0 + math.sqrt(3.0), 6.0)
    return out[0] if squeeze else out


def qspline1d(signal, lamb: float = 0.0, *, device="cuda"):
    """Quadratic-spline coefficients (scipy.signal.qspline1d; reconstruction
    window [1, 6, 1]/8)."""
    if lamb != 0.0:
        raise ValueError("Smoothing quadratic splines not supported yet.")
    x, _ = _signal(signal, device)
    squeeze = x.dim() == 1
    xb = x[None] if squeeze else x
    out = _interp_coeff_1d(xb, -3.0 + 2.0 * math.sqrt(2.0), 8.0)
    return out[0] if squeeze else out


def _spline_eval(cj, newx, dx, x0, kernel, support: float):
    if isinstance(cj, torch.Tensor):
        cj = cj.detach().cpu().numpy()
    cj = np.asarray(cj, np.float64)
    if cj.size == 0:
        raise ValueError("Spline coefficients 'cj' must not be empty.")
    t = (np.asarray(newx, np.float64) - x0) / float(dx)
    n = cj.shape[-1]
    if n == 1:
        return np.full_like(t, cj[0])
    # whole-sample mirror fold into [0, n-1] (one modular fold covers all reflections)
    period = 2.0 * (n - 1)
    t = np.abs(np.remainder(t, period))
    t = np.minimum(t, period - t)
    jlower = np.floor(t - support).astype(int) + 1
    result = np.zeros_like(t)
    for i in range(int(2 * support)):
        thisj = jlower + i
        indj = np.clip(thisj, 0, n - 1)
        result += cj[indj] * kernel(t - thisj)
    return result


def cspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0):
    """Evaluate a cubic spline at new points with mirror-symmetric edges
    (scipy.signal.cspline1d_eval); host NumPy."""
    return _spline_eval(cj, newx, dx, x0, bspline3, 2.0)


def qspline1d_eval(cj, newx, dx: float = 1.0, x0: float = 0):
    """Evaluate a quadratic spline at new points (scipy.signal.qspline1d_eval);
    host NumPy."""
    return _spline_eval(cj, newx, dx, x0, bspline2, 1.5)


def _root_from_lambda(lamb: float):
    tmp = math.sqrt(3.0 + 144.0 * lamb)
    xi = 1.0 - 96.0 * lamb + 24.0 * lamb * tmp
    omega = math.atan(math.sqrt((144.0 * lamb - 1.0) / xi))
    r = (
        (24.0 * lamb - 1.0 - math.sqrt(xi)) / (24.0 * lamb)
        * math.sqrt(48.0 * lamb + 24.0 * lamb * tmp) / math.sqrt(xi)
    )
    return r, omega


def cspline2d(signal, lamb: float = 0.0, precision: float = -1.0, *, device="cuda"):
    """2-D cubic B-spline coefficients (scipy.signal.cspline2d): the 1-D
    recursion along each axis in turn."""
    x, _ = _signal(signal, device)
    if x.dim() != 2:
        raise ValueError("cspline2d needs a rank-2 input")
    if lamb <= 1.0 / 144.0:
        r = -2.0 + math.sqrt(3.0)
        out = symiirorder1(x, -r * 6.0, r, precision=precision)
        return symiirorder1(out.T.contiguous(), -r * 6.0, r, precision=precision).T
    r, omega = _root_from_lambda(lamb)
    out = symiirorder2(x, r, omega, precision=precision)
    return symiirorder2(out.T.contiguous(), r, omega, precision=precision).T


def qspline2d(signal, lamb: float = 0.0, precision: float = -1.0, *, device="cuda"):
    """2-D quadratic B-spline coefficients (scipy.signal.qspline2d)."""
    if lamb > 0:
        raise ValueError("lambda must be negative or zero")
    x, _ = _signal(signal, device)
    if x.dim() != 2:
        raise ValueError("qspline2d needs a rank-2 input")
    r = -3.0 + 2.0 * math.sqrt(2.0)
    out = symiirorder1(x, -r * 8.0, r, precision=precision)
    return symiirorder1(out.T.contiguous(), -r * 8.0, r, precision=precision).T


def spline_filter(Iin, lmbda: float = 5.0, *, device="cuda") -> np.ndarray:
    """Cubic smoothing-spline filter of a rank-2 array (scipy.signal.spline_filter):
    coefficients by :func:`cspline2d` (seeded recursions through
    ``sosfilt_chunk``, B12 on the card), reconstruction by the separable mirror
    FIR [1, 4, 1] / 6 (``twod.sepfir2d``). Returns NumPy float64, as the
    reference does."""
    from .twod import sepfir2d

    ck = cspline2d(Iin, lmbda, device=device)
    h = np.array([1.0, 4.0, 1.0]) / 6.0
    return sepfir2d(ck, h, h).cpu().numpy().astype(np.float64)


__all__ = [
    "gauss_spline",
    "bspline2",
    "bspline3",
    "cspline1d",
    "qspline1d",
    "cspline1d_eval",
    "qspline1d_eval",
    "cspline2d",
    "qspline2d",
    "spline_filter",
    "symiirorder1",
    "symiirorder2",
]
