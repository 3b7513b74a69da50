"""Linear Kalman filtering and RTS smoothing.

Counterpart of ``digital_signal_processsing_tpu/models/kalman.py``. The
reference's ``lax.scan`` over time becomes a Python loop over T whose state
(the batched mean and the shared covariance) stays on the tensors' device;
independent measurement streams ride the leading batch axes. Every product
runs in IEEE float32 (``ieee_fp32_matmul``): the reference's bf16 default
drifted a track by 3.04 bins over 16 CPIs (its BENCH_NOTES).
"""

from __future__ import annotations

import torch

from ..ops.fir import ieee_fp32_matmul
from ..utils.device import as_tensor


def _f32(a, device) -> torch.Tensor:
    return as_tensor(a, device).to(device=device, dtype=torch.float32)


def kalman_filter(F, H, Q, R, z, *, x0=None, P0=None, device="cuda"):
    """Forward Kalman filter over measurements ``z``.

    ``F`` (n, n) transition, ``H`` (m, n) observation, ``Q`` (n, n) and
    ``R`` (m, m) noises; ``z``: (..., T, m) measurement streams (leading
    axes batch), or (T,) for one scalar stream. Returns ``(x_filt, P_filt)``
    with shapes ``(..., T, n)`` and ``(T, n, n)`` (the covariances do not
    depend on the measurements, so the batch shares them). A tensor ``z``
    sets the device; NumPy inputs go to ``device``.
    """
    dev = z.device if isinstance(z, torch.Tensor) else torch.device(device)
    z = _f32(z, dev)
    F = _f32(F, dev)
    H = torch.atleast_2d(_f32(H, dev))
    Q = _f32(Q, dev)
    R = torch.atleast_2d(_f32(R, dev))
    if z.dim() == 1:
        z = z[:, None]
    batch = z.shape[:-2]
    t_len, m = z.shape[-2], z.shape[-1]
    n = F.shape[0]
    zb = z.reshape(-1, t_len, m)
    b = zb.shape[0]
    x = zb.new_zeros((b, n)) if x0 is None else _f32(x0, dev).expand(b, n)
    P = torch.eye(n, device=dev) * 1e3 if P0 is None else _f32(P0, dev)
    eye = torch.eye(n, device=dev)
    xs, Ps = [], []
    with ieee_fp32_matmul():
        for t in range(t_len):
            xp = x @ F.T
            Pp = F @ P @ F.T + Q
            S = H @ Pp @ H.T + R
            K = torch.linalg.solve(S, H @ Pp).T  # (n, m)
            innov = zb[:, t] - xp @ H.T
            x = xp + innov @ K.T
            P = (eye - K @ H) @ Pp
            P = 0.5 * (P + P.T)  # keep symmetric in float32
            xs.append(x)
            Ps.append(P)
    x_filt = torch.stack(xs, 1).reshape(batch + (t_len, n))
    return x_filt, torch.stack(Ps)


def rts_smoother(F, Q, x_filt, P_filt, *, device="cuda"):
    """Rauch-Tung-Striebel fixed-interval smoother over
    :func:`kalman_filter` outputs. Returns ``(x_smooth, P_smooth)``."""
    dev = x_filt.device if isinstance(x_filt, torch.Tensor) else torch.device(device)
    F = _f32(F, dev)
    Q = _f32(Q, dev)
    x_filt = _f32(x_filt, dev)
    P_filt = _f32(P_filt, dev)
    squeeze = x_filt.dim() == 2
    batch = x_filt.shape[:-2]
    xb = x_filt.reshape((-1,) + x_filt.shape[-2:])
    t_len, n = xb.shape[-2], xb.shape[-1]
    x_next, P_next = xb[:, -1], P_filt[-1]
    xs, Ps = [x_next], [P_next]
    with ieee_fp32_matmul():
        for t in range(t_len - 2, -1, -1):
            xf, Pf = xb[:, t], P_filt[t]
            Pp = F @ Pf @ F.T + Q
            G = torch.linalg.solve(Pp, F @ Pf).T  # (n, n) smoother gain
            x_next = xf + (x_next - xf @ F.T) @ G.T
            P_next = Pf + G @ (P_next - Pp) @ G.T
            xs.append(x_next)
            Ps.append(P_next)
    out = torch.stack(xs[::-1], 1)
    out = out[0] if squeeze else out.reshape(batch + (t_len, n))
    return out, torch.stack(Ps[::-1])


__all__ = ["kalman_filter", "rts_smoother"]
