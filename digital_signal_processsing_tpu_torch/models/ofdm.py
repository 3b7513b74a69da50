"""OFDM receiver: CP-based symbol sync, CFO estimation, FFT demod, 1-tap EQ.

Counterpart of ``digital_signal_processsing_tpu/models/ofdm.py``: QPSK
subcarriers, a known pilot symbol for the one-tap frequency-domain
equalizer and common-phase tracking, van de Beek's cyclic-prefix
correlation for timing and carrier offset.

- the CP moving sum (the reference's ``blocked_causal_conv`` with ``cp``
  ones) is ``fir_filter`` with ``cp`` ones, the fused overlap-save kernel
  B8 on the card; the I and Q products of every burst are the channels of
  one call;
- the receiver takes one burst (T,) or a leading burst axis (B, T), so the
  reference's ``vmap`` over bursts is one call;
- the timing offset stays on the device and selects the frame by an index
  tensor (``gather``), never by a host read; a start past the last whole
  frame is clamped there, as the reference's ``dynamic_slice`` clamps it;
- the carrier correction's oscillator phase is taken in float64 and
  wrapped to one turn before the float32 cos/sin: the reference's float32
  phase reaches 387 rad over a burst of 558k samples, whose rounding
  (3e-5 rad) moves the symbols by 4e-5 of their peak for a change of the
  carrier estimate in its 7th digit (ROADMAP H13);
- the common-phase unwrap (the reference's scan over symbols) is its
  closed form: each symbol's quarter-turn count is the running sum of the
  rounded differences, so phi_k = raw_k + q_k * pi/2 with q_k =
  sum_{j<=k} round((raw_{j-1} - raw_j) / (pi/2)), raw_{-1} = 0. The counts
  are the scan's wherever no difference lies within rounding of an odd
  multiple of pi/4 (a rotation of 45 degrees between symbols, where the
  estimator itself is ambiguous).

NumPy inputs go to the receiver's device (the card by default).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.fir import fir_filter
from ..utils.device import as_planar, resolve_device


@dataclasses.dataclass(frozen=True)
class OfdmConfig:
    n_fft: int = 64
    cp: int = 16
    n_symbols: int = 50  # data symbols per burst (after the pilot)
    active: int = 48  # used subcarriers (centered, DC unused)

    @property
    def symbol_len(self) -> int:
        return self.n_fft + self.cp

    def subcarriers(self) -> np.ndarray:
        """Active subcarrier FFT bins (DC excluded, centered)."""
        half = self.active // 2
        return np.r_[np.arange(1, half + 1), np.arange(self.n_fft - half, self.n_fft)]


def qpsk_mod(bits: np.ndarray) -> np.ndarray:
    """Pairs of bits -> unit-energy QPSK symbols (Gray: 00->1+1j scaled)."""
    b = np.asarray(bits).reshape(-1, 2)
    return ((1 - 2 * b[:, 0]) + 1j * (1 - 2 * b[:, 1])) / np.sqrt(2)


def qpsk_demod(sym: np.ndarray) -> np.ndarray:
    """Hard-decision QPSK -> bit pairs (inverse of qpsk_mod)."""
    s = np.asarray(sym)
    return np.stack([(s.real < 0), (s.imag < 0)], axis=-1).astype(np.int8).reshape(-1)


def ofdm_modulate(
    cfg: OfdmConfig, bits: np.ndarray, pilot_seed: int = 7
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side burst generator (the test oracle's transmitter).

    Returns planar (i, q) of the burst: [pilot symbol | data symbols], each
    IFFT(n_fft) with a cp-sample cyclic prefix. ``bits`` length must be
    2 * active * n_symbols.
    """
    want = 2 * cfg.active * cfg.n_symbols
    if np.asarray(bits).size != want:
        raise ValueError(f"need {want} bits, got {np.asarray(bits).size}")
    sc = cfg.subcarriers()
    rng = np.random.default_rng(pilot_seed)
    pilot = np.exp(1j * 2 * np.pi * rng.integers(0, 4, cfg.active) / 4)
    syms = qpsk_mod(bits).reshape(cfg.n_symbols, cfg.active)
    grid = np.zeros((cfg.n_symbols + 1, cfg.n_fft), complex)
    grid[0, sc] = pilot
    grid[1:, sc] = syms
    time = np.fft.ifft(grid, axis=-1) * np.sqrt(cfg.n_fft)
    burst = np.concatenate([time[:, -cfg.cp :], time], axis=-1).reshape(-1)
    return burst.real.astype(np.float32), burst.imag.astype(np.float32)


def _pilot_freq(cfg: OfdmConfig, pilot_seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(pilot_seed)
    return np.exp(1j * 2 * np.pi * rng.integers(0, 4, cfg.active) / 4)


class OfdmReceiver:
    """Stateless burst receiver; config baked at construction, its pilot and
    subcarrier index on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, cfg: OfdmConfig = OfdmConfig(), pilot_seed: int = 7, *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        p = _pilot_freq(cfg, pilot_seed)
        self._pilot = torch.complex(
            torch.from_numpy(p.real.astype(np.float32)), torch.from_numpy(p.imag.astype(np.float32))
        ).to(self.device)
        self._sc = torch.from_numpy(cfg.subcarriers().astype(np.int64)).to(self.device)

    def synchronize(self, i, q):
        """(timing_offset, cfo) from the cyclic-prefix correlation, each of
        the bursts' leading shape.

        van de Beek: gamma[d] = sum_{k<cp} r[d+k] * conj(r[d+k+n_fft]);
        |gamma| peaks where a CP aligns, and the peak's phase / (2 pi n_fft)
        is minus the carrier offset (cycles/sample). The moving sum of every
        burst's I and Q products is one ``fir_filter`` call.
        """
        c = self.cfg
        n, cp = c.n_fft, c.cp
        x_re, x_im = as_planar(i, q, self.device)
        lead = x_re.shape[:-1]
        a_re, a_im = x_re[..., :-n], x_im[..., :-n]
        b_re, b_im = x_re[..., n:], x_im[..., n:]
        p_re = a_re * b_re + a_im * b_im
        p_im = a_im * b_re - a_re * b_im
        length = p_re.shape[-1]
        rows = torch.stack([p_re.reshape(-1, length), p_im.reshape(-1, length)])  # (2, B, L)
        g = fir_filter(rows.reshape(-1, length), np.ones(cp, np.float32))
        g = g.reshape(2, -1, length)[..., cp - 1 :]
        g_re, g_im = g[0], g[1]
        mag = g_re**2 + g_im**2
        # the first CP lies within the first symbol span
        d = torch.argmax(mag[:, : c.symbol_len], dim=-1, keepdim=True)
        ang = torch.atan2(g_im.gather(-1, d), g_re.gather(-1, d))[:, 0]
        cfo = -ang / (2.0 * np.pi * n)  # cycles/sample
        return d[:, 0].to(torch.int32).reshape(lead), cfo.reshape(lead)

    def demodulate(self, i, q, timing, cfo):
        """(eq_re, eq_im): equalized active-subcarrier symbols, (..., n_symbols, active)."""
        c = self.cfg
        n, cp, sl = c.n_fft, c.cp, c.symbol_len
        total = (c.n_symbols + 1) * sl
        x_re, x_im = as_planar(i, q, self.device)
        lead = x_re.shape[:-1]
        t = x_re.shape[-1]
        x_re, x_im = x_re.reshape(-1, t), x_im.reshape(-1, t)
        timing = torch.as_tensor(timing, device=x_re.device).reshape(-1, 1).to(torch.int64)
        timing = timing.clamp(0, t - total)
        cfo = torch.as_tensor(cfo, device=x_re.device).reshape(-1, 1).to(torch.float64)
        # CFO correction with the exact-phase oscillator (float64 turns,
        # wrapped), then align
        turns = cfo * torch.arange(t, device=x_re.device, dtype=torch.float64)
        ph = (-2.0 * np.pi * (turns - torch.round(turns))).to(torch.float32)
        lo_re, lo_im = torch.cos(ph), torch.sin(ph)
        idx = timing + torch.arange(total, device=x_re.device)
        y_re = (x_re * lo_re - x_im * lo_im).gather(-1, idx)
        y_im = (x_re * lo_im + x_im * lo_re).gather(-1, idx)
        # frame symbols, drop CPs, FFT
        fr = torch.complex(y_re, y_im).reshape(-1, c.n_symbols + 1, sl)[..., cp:]
        spec = torch.fft.fft(fr, dim=-1) / np.sqrt(np.float32(n))
        act = spec.index_select(-1, self._sc)  # (B, n_symbols+1, active)
        # 1-tap EQ from the pilot symbol
        h = act[:, 0] / self._pilot
        eq = act[:, 1:] / h[:, None]
        # common-phase tracking (Viterbi & Viterbi): per symbol,
        # angle(sum((eq/|eq|)^4)) - pi over 4 is the common rotation modulo
        # 90 degrees; the ambiguity resolves differentially from the
        # pilot-anchored start
        u = eq / (eq.abs() + 1e-12)
        u2 = u * u
        z4 = torch.sum(u2 * u2, dim=-1)
        phi_raw = (torch.angle(z4) - np.pi) / 4.0  # (B, n_symbols)
        quarter = np.pi / 2.0
        prev = torch.nn.functional.pad(phi_raw[:, :-1], (1, 0))
        turns = torch.cumsum(torch.round((prev - phi_raw) / quarter), dim=-1)
        phi = phi_raw + turns * quarter
        eq = eq * torch.polar(torch.ones_like(phi), -phi)[..., None]
        shape = lead + (c.n_symbols, c.active)
        return eq.real.reshape(shape), eq.imag.reshape(shape)

    def receive_bits(self, i, q) -> np.ndarray:
        """Full burst receive on host conventions: bits out, (n_bits,) for one
        burst or (B, n_bits) for a leading burst axis."""
        x_re, x_im = as_planar(i, q, self.device)
        d, cfo = self.synchronize(x_re, x_im)
        er, ei = self.demodulate(x_re, x_im, d, cfo)
        sym = er.cpu().numpy() + 1j * ei.cpu().numpy()
        return qpsk_demod(sym).reshape(sym.shape[:-2] + (-1,))


__all__ = [
    "OfdmConfig",
    "OfdmReceiver",
    "ofdm_modulate",
    "qpsk_demod",
    "qpsk_mod",
]
