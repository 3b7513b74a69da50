"""2-D filtering, scipy.signal's image-shaped surface.

``convolve2d``/``correlate2d`` are one ``conv2d`` in IEEE float32 after the
boundary is padded explicitly (``fill``, ``wrap`` and ``symm`` as the
reference package's ``ops/twod.py`` pads them); ``medfilt2d`` takes the
median along the stack of the kh x kw shifted views of the zero-padded
image; ``sepfir2d`` is two 1-D correlations with mirror boundaries. Leading
axes batch. Input that is not a tensor goes to ``device`` (the card by
default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import as_tensor
from .fir import ieee_fp32_conv

__all__ = ["convolve2d", "correlate2d", "medfilt2d", "sepfir2d"]

_MODES = ("full", "valid", "same")
_BOUNDARIES = ("fill", "wrap", "symm")


def _pad_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """Source index of each padded position along an axis of length n: ``wrap``
    is periodic, ``symm`` mirrors with the edge sample repeated (NumPy's
    ``symmetric``), both for pads of any length."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "wrap":
        return torch.remainder(i, n)
    m = torch.remainder(i, 2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _pad2d(xb: torch.Tensor, ph: tuple, pw: tuple, mode: str, fillvalue: float = 0.0):
    """Pad the last two axes of (B, H, W) by (before, after) pairs."""
    if not (any(ph) or any(pw)):
        return xb
    if mode == "fill":
        return F.pad(xb, (pw[0], pw[1], ph[0], ph[1]), value=fillvalue)
    h, w = xb.shape[-2:]
    xb = xb.index_select(-2, _pad_index(h, *ph, mode, xb.device))
    return xb.index_select(-1, _pad_index(w, *pw, mode, xb.device))


def _conv2d(in1, in2, mode: str, boundary: str, flip: bool, fillvalue: float, device):
    if boundary not in _BOUNDARIES:
        raise ValueError(f"boundary must be one of {_BOUNDARIES}, got {boundary!r}")
    xf = as_tensor(in1, device).to(torch.float32)
    kf = as_tensor(in2, xf.device).to(device=xf.device, dtype=torch.float32)
    kh, kw = kf.shape
    batch = xf.shape[:-2]
    xb = xf.reshape((-1,) + tuple(xf.shape[-2:]))
    if mode == "full":
        ph, pw = (kh - 1, kh - 1), (kw - 1, kw - 1)
    elif mode == "same":
        # the centred part of full: scipy puts the extra sample of an even kernel
        # before for convolution and after for correlation
        if flip:
            ph, pw = (kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2)
        else:
            ph, pw = ((kh - 1) // 2, kh // 2), ((kw - 1) // 2, kw // 2)
    elif mode == "valid":
        ph = pw = (0, 0)
        h, w = xb.shape[-2:]
        if kh > h or kw > w:
            # the reference's VALID convolution gives no rows where the kernel is the
            # larger (scipy swaps the inputs or raises instead)
            return xf.new_zeros(tuple(batch) + (max(h - kh + 1, 0), max(w - kw + 1, 0)))
    else:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    xb = _pad2d(xb, ph, pw, boundary, fillvalue)
    if flip:  # convolution flips the kernel; correlation does not
        kf = torch.flip(kf, (0, 1))
    with ieee_fp32_conv():
        y = F.conv2d(xb[:, None], kf[None, None])[:, 0]
    return y.reshape(tuple(batch) + tuple(y.shape[-2:]))


def convolve2d(in1, in2, mode: str = "full", boundary: str = "fill", fillvalue: float = 0.0,
               *, device="cuda") -> torch.Tensor:
    """2-D convolution (scipy.signal.convolve2d); ``in1``'s leading axes batch,
    ``in2`` is the (kh, kw) kernel."""
    return _conv2d(in1, in2, mode, boundary, True, float(fillvalue), device)


def correlate2d(in1, in2, mode: str = "full", boundary: str = "fill", fillvalue: float = 0.0,
                *, device="cuda") -> torch.Tensor:
    """2-D cross-correlation (scipy.signal.correlate2d)."""
    return _conv2d(in1, in2, mode, boundary, False, float(fillvalue), device)


def medfilt2d(x, kernel_size=3, *, device="cuda") -> torch.Tensor:
    """2-D sliding median with zero-padded edges (scipy.signal.medfilt2d), from
    the kh x kw shifted views of the padded image."""
    kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
    if kh % 2 == 0 or kw % 2 == 0 or kh < 1 or kw < 1:
        raise ValueError(f"kernel sizes must be odd >= 1, got {(kh, kw)}")
    xf = as_tensor(x, device).to(torch.float32)
    h, w = xf.shape[-2:]
    ext = F.pad(xf, (kw // 2, kw // 2, kh // 2, kh // 2))
    views = [ext[..., i : i + h, j : j + w] for i in range(kh) for j in range(kw)]
    return torch.median(torch.stack(views, dim=-1), dim=-1).values


def sepfir2d(x, hrow, hcol, *, device="cuda") -> torch.Tensor:
    """Separable 2-D FIR with mirror-symmetric boundaries (scipy.signal.sepfir2d:
    odd-length filters, the output the input's shape): along rows, then columns."""
    xf = as_tensor(x, device).to(torch.float32)
    # scipy convolves (the kernel flipped); conv2d correlates
    hr = torch.flip(as_tensor(hrow, xf.device).to(xf.device, torch.float32).reshape(-1), (0,))
    hc = torch.flip(as_tensor(hcol, xf.device).to(xf.device, torch.float32).reshape(-1), (0,))
    if hr.numel() % 2 == 0 or hc.numel() % 2 == 0:
        raise ValueError("sepfir2d filters must be odd-length")
    h, w = xf.shape[-2:]
    batch = xf.shape[:-2]
    xb = xf.reshape(-1, h, w)
    ext = _pad2d(xb, (0, 0), (hr.numel() // 2,) * 2, "symm")
    with ieee_fp32_conv():
        y = F.conv2d(ext[:, None], hr.view(1, 1, 1, -1))[:, 0]
        ext = _pad2d(y, (hc.numel() // 2,) * 2, (0, 0), "symm")
        y = F.conv2d(ext[:, None], hc.view(1, 1, -1, 1))[:, 0]
    return y.reshape(tuple(batch) + (h, w))
