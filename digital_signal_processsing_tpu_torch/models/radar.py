"""Pulse-Doppler radar chain: LFM compression, Doppler DFT, CA-CFAR.

Counterpart of ``digital_signal_processsing_tpu/models/radar.py``: a
coherent processing interval (CPI) of LFM pulses turned into a range-Doppler
detection map.

- the fast-time matched filter of every pulse is one batched planar complex
  correlation (``ops.correlate.correlate_complex``: ``conv1d`` in IEEE
  float32; ``detect`` keeps the reference's ``direct_gauss``);
- the slow-time Doppler transform is one dense (P, P) DFT matrix pair with
  the taper and the fftshift folded in, under ``ieee_fp32_matmul`` (the
  reference's ``Precision.HIGHEST``), and ``torch.fft`` past 512 pulses;
- CA-CFAR sums are separable: a banded (D, D) matrix over the Doppler axis
  and a centred boxcar ``fir_direct`` over the range axis; the per-cell
  training counts come from closed-form 1-D factors, so edge cells get
  their true count.

No kernel of the package runs here: the reference computes these stages
outside any Pallas kernel. Every entry point takes leading batch axes, so
``detect_batch`` is one call over its CPIs. NumPy inputs go to ``device``
(the card by default); tensors stay where they are. The host helpers
(``RadarConfig``, ``lfm_pulse``, ``synthesize``) are copies of the
reference's NumPy code.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.correlate import correlate_complex
from ..ops.fft import get_window
from ..ops.fir import fir_direct, ieee_fp32_matmul
from ..parallel.mesh import batch_sharding, check_mesh
from ..utils.device import as_planar, as_tensor

__all__ = [
    "RadarConfig",
    "lfm_pulse",
    "synthesize",
    "pulse_compress",
    "doppler_map",
    "ca_cfar",
    "near_threshold",
    "DETECTION_MARGIN",
    "detect",
    "detect_batch",
    "ambiguity",
]

# the Doppler transform is a dense matrix pair up to this many pulses
DFT_MAX_PULSES = 512
# relative distance from the threshold inside which two float32 computations of
# one CPI (another batch size, another library) may decide a cell differently
DETECTION_MARGIN = 1e-4


@dataclasses.dataclass(frozen=True)
class RadarConfig:
    """One coherent processing interval. ``bandwidth`` is the LFM sweep in
    cycles/sample (time-bandwidth product = bandwidth * pulse_len);
    ``guard``/``train`` are CFAR half-window cell counts per axis
    (doppler, range)."""

    n_pulses: int = 64
    n_range: int = 1024  # fast-time samples per PRI
    pulse_len: int = 128
    bandwidth: float = 0.5
    window: str = "hann"
    guard: tuple[int, int] = (2, 2)
    train: tuple[int, int] = (4, 8)
    pfa: float = 1e-4

    def __post_init__(self):
        if self.pulse_len > self.n_range:
            raise ValueError(f"pulse_len {self.pulse_len} exceeds n_range {self.n_range}")
        if not 0.0 < self.bandwidth <= 1.0:
            raise ValueError(f"bandwidth must be in (0, 1], got {self.bandwidth}")

    @property
    def n_bins(self) -> int:
        """Output range bins after 'valid' compression."""
        return self.n_range - self.pulse_len + 1


def lfm_pulse(cfg: RadarConfig) -> tuple[np.ndarray, np.ndarray]:
    """Unit-energy linear-FM chirp sweeping [-bw/2, +bw/2), planar (i, q)."""
    t = np.arange(cfg.pulse_len, dtype=np.float64)
    phase = np.pi * cfg.bandwidth * (t * t / cfg.pulse_len - t)
    p = np.exp(1j * phase) / np.sqrt(cfg.pulse_len)
    return p.real.astype(np.float32), p.imag.astype(np.float32)


def synthesize(
    cfg: RadarConfig,
    targets,
    *,
    noise_power: float = 0.0,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side echo simulator (the tests' oracle).

    ``targets``: iterable of (range_bin, doppler, amplitude) with
    ``doppler`` in cycles/PRI in [-0.5, 0.5), the stop-and-hop model: a
    constant phase step per pulse. Returns planar (i, q), each
    (n_pulses, n_range).
    """
    pr, pi = lfm_pulse(cfg)
    pulse = pr.astype(np.float64) + 1j * pi.astype(np.float64)
    x = np.zeros((cfg.n_pulses, cfg.n_range), np.complex128)
    for rbin, fd, amp in targets:
        rbin = int(rbin)
        if not 0 <= rbin <= cfg.n_range - cfg.pulse_len:
            raise ValueError(f"range bin {rbin} outside [0, {cfg.n_bins - 1}]")
        steps = np.exp(2j * np.pi * fd * np.arange(cfg.n_pulses))
        x[:, rbin : rbin + cfg.pulse_len] += amp * np.outer(steps, pulse)
    if noise_power > 0.0:
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(noise_power / 2.0)
        x += sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def pulse_compress(cfg: RadarConfig, i, q, *, device="cuda") -> torch.Tensor:
    """Fast-time matched filter: valid correlation of every pulse with the
    transmit chirp, all pulses in one batched planar complex correlation.
    A point echo of amplitude a at range bin r peaks at output bin r with
    amplitude a (unit-energy chirp). Returns complex64 (..., n_pulses, n_bins)."""
    i, q = as_planar(i, q, device)
    pr, pi = lfm_pulse(cfg)
    c_re, c_im = correlate_complex(i, q, pr, pi, mode="valid")
    return torch.complex(c_re, c_im)


@functools.lru_cache(maxsize=16)
def _doppler_dft(n_pulses: int, window: str, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed, fftshifted slow-time DFT as one dense matrix on ``device``:
    row r is doppler (r - n//2)/n cycles/PRI with the taper folded in."""
    n = n_pulses
    f = (np.arange(n) - n // 2)[:, None] / n
    c = np.exp(-2j * np.pi * f * np.arange(n)[None, :])
    c *= np.asarray(get_window(window, n), np.float64)[None, :]
    return (
        torch.from_numpy(c.real.astype(np.float32)).to(device),
        torch.from_numpy(c.imag.astype(np.float32)).to(device),
    )


def _doppler_power(cfg: RadarConfig, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """|Doppler DFT|^2 of planar (..., n_pulses, W) compressed pulses."""
    if cfg.n_pulses <= DFT_MAX_PULSES:
        cr, ci = _doppler_dft(cfg.n_pulses, cfg.window, str(xr.device))
        with ieee_fp32_matmul():
            rr = cr @ xr - ci @ xi
            ri = cr @ xi + ci @ xr
        return rr * rr + ri * ri
    w = torch.from_numpy(np.asarray(get_window(cfg.window, cfg.n_pulses), np.float32)).to(xr.device)
    rd = torch.fft.fft(torch.complex(xr, xi) * w[:, None], dim=-2)
    return torch.fft.fftshift(rd, dim=-2).abs() ** 2


def doppler_map(cfg: RadarConfig, rc: torch.Tensor) -> torch.Tensor:
    """Slow-time DFT across pulses -> fftshifted power map (n_pulses
    dopplers, n_bins ranges). Doppler f maps to row n_pulses//2 +
    round(f * n_pulses). Up to ``DFT_MAX_PULSES`` one dense matrix pair in
    IEEE float32, past it ``torch.fft``; both agree to rounding."""
    return _doppler_power(cfg, rc.real.to(torch.float32), rc.imag.to(torch.float32))


@functools.lru_cache(maxsize=16)
def _band(d: int, hd: int, device: str) -> torch.Tensor:
    band = np.zeros((d, d), np.float32)
    for i in range(d):
        band[i, max(0, i - hd) : min(d, i + hd + 1)] = 1.0
    return torch.from_numpy(band).to(device)


def _box_sum(a: torch.Tensor, hd: int, hr: int) -> torch.Tensor:
    """Zero-filled centred 2-D box sum of (..., D, R), separable: a banded
    (D, D) matrix over the Doppler axis, then the centred boxcar over the
    range axis as a causal ``fir_direct`` of the right-padded rows."""
    d, r = a.shape[-2:]
    with ieee_fp32_matmul():
        y = _band(d, hd, str(a.device)) @ a
    yp = F.pad(y.reshape(-1, r), (0, hr))
    taps = torch.ones(2 * hr + 1, device=a.device)
    return fir_direct(yp, taps)[:, hr:].reshape(a.shape)


def _count1d(n: int, h: int) -> np.ndarray:
    i = np.arange(n)
    return (np.minimum(i + h, n - 1) - np.maximum(i - h, 0) + 1).astype(np.float32)


def _count1d_window(n_full: int, lo: int, nb: int, h: int) -> np.ndarray:
    """Per-cell 1-D training count clipped to the valid window [lo, lo+nb):
    the count _count1d(nb, h) would produce on the sliced axis, evaluated
    at full-width positions (1.0 outside the window, masked downstream)."""
    i = np.arange(n_full)
    j = np.clip(i - lo, 0, max(nb - 1, 0))
    c = np.minimum(j + h, nb - 1) - np.maximum(j - h, 0) + 1
    return np.where((i >= lo) & (i < lo + nb), c.astype(np.float32), np.float32(1.0))


@functools.lru_cache(maxsize=32)
def _count_on(n: int, h: int, window: tuple[int, int] | None, device: str) -> torch.Tensor:
    """A count factor as a float32 tensor on ``device``, built once."""
    c = _count1d(n, h) if window is None else _count1d_window(n, window[0], window[1], h)
    return torch.from_numpy(c).to(device)


def _cfar_core(
    p: torch.Tensor,
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    range_window: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CA-CFAR sums and the exact per-cell-count alpha over (..., D, R).

    The range count factors are the array's own, or with ``range_window`` =
    (lo, nb) those of the valid window [lo, lo+nb) (``detect``'s full-width
    chain)."""
    gd, gr = guard
    td, tr = train
    d, r = p.shape[-2:]
    dev = str(p.device)
    outer_sum = _box_sum(p, gd + td, gr + tr)
    inner_sum = _box_sum(p, gd, gr)
    outer_n = _count_on(d, gd + td, None, dev)[:, None] * _count_on(r, gr + tr, range_window, dev)
    inner_n = _count_on(d, gd, None, dev)[:, None] * _count_on(r, gr, range_window, dev)
    n = outer_n - inner_n
    z = outer_sum - inner_sum  # training-cell power sum
    alpha = n * (torch.pow(pfa, -1.0 / n) - 1.0)
    thresh = alpha * z / n
    return p > thresh, thresh


def ca_cfar(
    power,
    *,
    guard: tuple[int, int],
    train: tuple[int, int],
    pfa: float,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cell-averaging CFAR over a (..., D, R) power map -> (detections, threshold).

    Noise is estimated per cell from the ring of training cells (the
    (guard+train) box minus the guard box); the threshold multiplier is the
    exact exponential-noise alpha = N * (pfa^(-1/N) - 1) with each cell's
    true training count N (edge cells have fewer).
    """
    if not 0.0 < pfa < 1.0:
        raise ValueError(f"pfa must be in (0, 1), got {pfa}")
    if train[0] < 1 or train[1] < 1:
        raise ValueError(f"need >= 1 training cell per axis, got {train}")
    p = as_tensor(power, device).to(torch.float32)
    return _cfar_core(p, guard, train, pfa)


def near_threshold(power, threshold, margin: float = DETECTION_MARGIN) -> torch.Tensor:
    """Cells whose power lies within ``margin`` * |threshold| of the threshold
    (compared in float64): outside them, two runs must detect alike."""
    p, th = torch.as_tensor(power).double(), torch.as_tensor(threshold).double()
    return (p - th).abs() <= margin * th.abs()


def ambiguity(pulse_i, pulse_q, *, dopplers=None, n_doppler: int = 65, device="cuda"):
    """Normalized power ambiguity surface |chi(tau, nu)|^2 of a pulse.

    ``chi(tau, nu) = sum_n u[n+tau] u*[n] e^{j 2 pi nu n}``, peak-normalized
    so ``|chi(0, 0)|^2 = 1``. Returns ``(delays, dopplers, amb)``: integer
    delays -(L-1)..(L-1), the Doppler grid in cycles/sample (by default
    ``n_doppler`` points spanning +-2/L) and the (n_doppler, 2L-1) float32
    surface on ``device`` (the pulse's, where it is a tensor): one batched
    planar complex correlation of the Doppler-shifted bank against u.
    """
    if isinstance(pulse_i, torch.Tensor):
        device = pulse_i.device
    pi_ = np.asarray(pulse_i.cpu() if isinstance(pulse_i, torch.Tensor) else pulse_i, np.float32)
    qi_ = np.asarray(pulse_q.cpu() if isinstance(pulse_q, torch.Tensor) else pulse_q, np.float32)
    if pi_.ndim != 1 or pi_.shape != qi_.shape:
        raise ValueError(f"pulse must be planar 1-D (i, q), got {pi_.shape}/{qi_.shape}")
    length = pi_.shape[0]
    if dopplers is None:
        dopplers = np.linspace(-2.0 / length, 2.0 / length, n_doppler)
    dopplers = np.asarray(dopplers, np.float64)
    ph = 2.0 * np.pi * np.outer(dopplers, np.arange(length))
    cr = as_tensor(np.cos(ph).astype(np.float32), device)
    sr = as_tensor(np.sin(ph).astype(np.float32), cr.device)
    ui = torch.from_numpy(pi_).to(cr.device)
    uq = torch.from_numpy(qi_).to(cr.device)
    ar = cr * ui - sr * uq  # u * e^{j 2 pi nu n}, planar
    ai = sr * ui + cr * uq
    rr, ri = correlate_complex(ar, ai, ui, uq, mode="full")
    energy = float(np.sum(pi_.astype(np.float64) ** 2 + qi_.astype(np.float64) ** 2))
    amb = (rr * rr + ri * ri) / np.float32(energy**2)
    delays = np.arange(-(length - 1), length)
    return delays, dopplers, amb


def detect_batch(cfg: RadarConfig, i, q, *, mesh=None, device="cuda"):
    """Batch of CPIs through the full chain in one call.

    ``i``/``q``: (batch, n_pulses, n_range) planar echoes. Returns
    (detections, power, threshold), each (batch, n_pulses, n_bins).

    With ``mesh`` (the family's dp step): every rank passes the global batch,
    runs :func:`detect` on its ``ch`` share (``parallel.batch_sharding``; a
    batch that the ch axis does not divide is refused) on the mesh's device,
    and gathers the three outputs over ``ch``, so every rank returns the
    global batch. One CPI never spans ranks: no collective inside the step.
    """
    sharding = None
    if mesh is not None:
        sharding = batch_sharding(check_mesh(mesh))
        i, q = (sharding.shard(v).to(mesh.device) for v in (i, q))
    i, q = as_planar(i, q, device)
    if i.dim() != 3:
        raise ValueError(f"expected (batch, n_pulses, n_range), got {tuple(i.shape)}")
    out = detect(cfg, i, q)
    return out if sharding is None else tuple(sharding.gather(y) for y in out)


def detect(cfg: RadarConfig, i, q, *, device="cuda"):
    """Full chain: planar (..., n_pulses, n_range) echoes -> detection map.

    Returns (detections, power, threshold): boolean (..., n_pulses, n_bins)
    range-Doppler detections plus the underlying map and CFAR threshold. As
    in the reference, the matched filter runs in 'full' mode and the CFAR at
    full width, with the columns outside the valid window masked to zero and
    the range counts clipped to that window, so each cell's alpha is the
    sliced map's; the valid slice is taken last.
    """
    i, q = as_planar(i, q, device)
    pr, pi_ = lfm_pulse(cfg)
    c_re, c_im = correlate_complex(i, q, pr, pi_, mode="full", method="direct_gauss")
    full = _doppler_power(cfg, c_re, c_im)  # (..., n_pulses, n_range + pulse_len - 1)
    del c_re, c_im
    lo, nb = cfg.pulse_len - 1, cfg.n_bins
    w = full.shape[-1]
    col = torch.arange(w, device=full.device)
    p_masked = torch.where((col >= lo) & (col < lo + nb), full, 0.0)
    det_f, thresh_f = _cfar_core(p_masked, cfg.guard, cfg.train, cfg.pfa, range_window=(lo, nb))
    sl = slice(lo, lo + nb)
    return det_f[..., sl], full[..., sl], thresh_f[..., sl]
