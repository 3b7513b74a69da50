"""Single-carrier QAM modem: RRC shaping, matched filter, batch sync, LS EQ.

Counterpart of ``digital_signal_processsing_tpu/models/modem.py``:
Gray-mapped square QAM through root-raised-cosine pulses, and the receiver
that recovers it without a sample-serial loop until the phase tracker.

- the matched filter is ``fir_filter`` with the RRC taps on the I and Q
  planes, which is the fused overlap-save kernel B8 on the card (two
  launches a call);
- timing (Oerder-Meyr), the coarse carrier (the 4th-power spectral line at
  symbol rate), frame sync (preamble correlation, ``correlate_complex``)
  and the multi-lag fine carrier are batched reductions; the timing phase
  and the frame start stay on the device and select by index tensors, never
  by a host read, over the reference's padding (so a start never clamps);
- the equalizer is one ridge least-squares solve on the preamble in real
  block form, in IEEE float32 (``ieee_fp32_matmul``);
- the decision-directed tracker (``_dd_phase_track``) is a Python loop over
  blocks whose phase stays on the device: each step computes only the
  block's phase error (its I and Q rows as one (2, block) tensor, the error
  sums as one 2x2 product), and the rotated output of every block is
  formed after the loop in one pass. ``_vv_phase_track`` is the reference's
  parallel tracker.

NumPy inputs go to ``device`` (the card by default); tensors stay where
they are. The host transmitter and channel are the reference's NumPy code;
``transmit``'s interpolation is the port's ``upfirdn`` on ``device``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.correlate import correlate_complex
from ..ops.fir import design_rrc, fir_filter, ieee_fp32_matmul
from ..ops.resample import upfirdn
from ..utils.device import as_planar, as_tensor, resolve_device

__all__ = [
    "ModemConfig",
    "map_bits",
    "demap_symbols",
    "preamble_symbols",
    "transmit",
    "channel",
    "receive",
]


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Link parameters. ``bits_per_symbol``: 1 (BPSK), 2 (QPSK), 4 (16QAM),
    6 (64QAM). ``rrc_span``: pulse length in symbols (taps = span*sps + 1)."""

    bits_per_symbol: int = 2
    sps: int = 8
    beta: float = 0.35
    rrc_span: int = 10
    preamble_len: int = 64  # QPSK symbols, known at the receiver
    preamble_seed: int = 17
    eq_taps: int = 9  # symbol-spaced, odd (centered reference tap)
    eq_ridge: float = 1e-4
    dd_block: int = 32  # decision-directed phase-tracking block (symbols)
    # the reference's scan unroll; accepted, and changes nothing here
    dd_unroll: int = 4
    # phase tracker engine: "dd" = serial decision-directed loop, "vv" =
    # parallel smoothed power-m + unwrap + parallel DD refine
    tracker: str = "dd"
    vv_smooth: int = 5  # blocks averaged per coarse power-m estimate
    vv_refine: int = 2  # parallel decision-directed refine rounds

    def __post_init__(self):
        if self.bits_per_symbol not in (1, 2, 4, 6):
            raise ValueError(f"bits_per_symbol must be 1/2/4/6, got {self.bits_per_symbol}")
        if self.eq_taps % 2 == 0:
            raise ValueError(f"eq_taps must be odd, got {self.eq_taps}")
        if self.tracker not in ("dd", "vv"):
            raise ValueError(f"tracker must be 'dd' or 'vv', got {self.tracker}")

    @property
    def rrc_num_taps(self) -> int:
        return self.rrc_span * self.sps + 1

    def rrc(self) -> np.ndarray:
        return design_rrc(self.rrc_num_taps, self.beta, self.sps)


def _axis_params(bits_per_symbol: int) -> tuple[int, int, float]:
    """(bits per axis, levels per axis, amplitude scale) for square QAM."""
    k = bits_per_symbol // 2
    lvl = 1 << k
    scale = float(np.sqrt(3.0 / (2.0 * (lvl * lvl - 1))))
    return k, lvl, scale


def _gray_decode(g: np.ndarray) -> np.ndarray:
    """Binary-reflected Gray code -> level index (numpy ints)."""
    i = np.asarray(g).copy()
    shift = 1
    while shift < 16:
        i ^= i >> shift
        shift *= 2
    return i


def map_bits(bits, bits_per_symbol: int) -> np.ndarray:
    """Host bit-to-symbol mapper (the test oracle's transmitter side).

    Gray-mapped unit-average-energy square QAM: the first half of each
    symbol's bits (MSB first) select the I level, the second half the Q
    level. BPSK (1 bit): antipodal on the real axis.
    """
    b = np.asarray(bits).astype(np.int64).reshape(-1)
    if b.size % bits_per_symbol:
        raise ValueError(f"bit count {b.size} not a multiple of {bits_per_symbol}")
    if np.any((b < 0) | (b > 1)):
        raise ValueError("bits must be 0/1")
    if bits_per_symbol == 1:
        return (1.0 - 2.0 * b).astype(np.complex128)
    k, lvl, scale = _axis_params(bits_per_symbol)
    b = b.reshape(-1, bits_per_symbol)
    weights = 1 << np.arange(k - 1, -1, -1)
    gi = (b[:, :k] * weights).sum(axis=1)
    gq = (b[:, k:] * weights).sum(axis=1)
    ai = 2 * _gray_decode(gi) - (lvl - 1)
    aq = 2 * _gray_decode(gq) - (lvl - 1)
    return scale * (ai + 1j * aq)


def demap_symbols(yr, yi, bits_per_symbol: int, *, device="cuda") -> torch.Tensor:
    """Hard-decision Gray demapper on planar symbol-rate input.

    Returns int32 bits, shape (n * bits_per_symbol,), on the input's device.
    The Gray re-encode is integer bit math (i ^ (i >> 1)).
    """
    yr = as_tensor(yr, device)
    yi = as_tensor(yi, yr.device).to(yr.device)
    if bits_per_symbol == 1:
        return (yr < 0).to(torch.int32)
    k, lvl, scale = _axis_params(bits_per_symbol)

    def axis_bits(y):
        idx = torch.clip(torch.round((y / scale + (lvl - 1)) * 0.5), 0, lvl - 1).to(torch.int32)
        g = idx ^ (idx >> 1)
        return torch.stack([(g >> (k - 1 - j)) & 1 for j in range(k)], dim=-1)

    return torch.cat([axis_bits(yr), axis_bits(yi)], dim=-1).reshape(-1)


def preamble_symbols(cfg: ModemConfig) -> np.ndarray:
    """The known QPSK preamble (same for any payload constellation)."""
    rng = np.random.default_rng(cfg.preamble_seed)
    bits = rng.integers(0, 2, 2 * cfg.preamble_len)
    return map_bits(bits, 2)


def transmit(cfg: ModemConfig, bits, *, device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """[preamble | payload] -> RRC-shaped planar (i, q) at sps rate, NumPy.

    The zero-stuffing interpolation is the port's ``upfirdn`` on ``device``;
    output length (n_sym - 1) * sps + rrc_num_taps.
    """
    syms = np.concatenate([preamble_symbols(cfg), map_bits(bits, cfg.bits_per_symbol)])
    dev = resolve_device(device)
    s = torch.from_numpy(np.stack([syms.real, syms.imag]).astype(np.float32)).to(dev)
    y = upfirdn(cfg.rrc(), s, up=cfg.sps).cpu().numpy()
    return y[0], y[1]


def channel(
    i,
    q,
    *,
    delay: int = 0,
    cfo: float = 0.0,
    phase: float = 0.0,
    symbol_snr_db: float | None = None,
    taps=None,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side impairment simulator (NumPy; the tests' channel oracle).

    ``cfo`` in cycles/sample (applied as exp(+2j pi cfo n)); ``taps``: an
    optional complex sample-rate multipath response; ``symbol_snr_db``:
    Es/N0 at the matched-filter output, so the complex per-sample noise
    variance is sigma^2 = 10^(-snr/10).
    """
    x = np.asarray(i, np.float64) + 1j * np.asarray(q, np.float64)
    if taps is not None:
        x = np.convolve(x, np.asarray(taps, np.complex128))
    if delay:
        x = np.concatenate([np.zeros(delay, np.complex128), x])
    n = np.arange(x.size)
    x = x * np.exp(1j * (phase + 2.0 * np.pi * cfo * n))
    if symbol_snr_db is not None:
        rng = np.random.default_rng(seed)
        sigma = np.sqrt(10.0 ** (-symbol_snr_db / 10.0) / 2.0)
        x = x + sigma * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def _matched_filter(cfg: ModemConfig, xr: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """The RRC matched filter of each plane: ``fir_filter``, B8 on the card."""
    h = cfg.rrc()
    return torch.complex(fir_filter(xr, h), fir_filter(xi, h))


def _coarse_cfo(r: torch.Tensor, power: int) -> torch.Tensor:
    """Spectral-line carrier estimate: argmax of |FFT(r^power)| / power.

    Square constellations have E[s^power] != 0 at power 4 (2 for BPSK), so
    r^power carries a line at power*cfo; capture range |cfo| < 1/(2*power)
    of the symbol rate. The power is taken by repeated squaring.
    """
    z = r * r
    if power == 4:
        z = z * z
    nfft = 1 << int(np.ceil(np.log2(z.shape[-1])))
    s = torch.fft.fft(z, n=nfft)
    f = torch.argmax(s.abs()).to(torch.float32) / nfft
    f = torch.where(f >= 0.5, f - 1.0, f)
    return f / power


def _oerder_meyr(y: torch.Tensor, sps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(integer phase, fractional offset in samples) from one |y|^2 line."""
    n = y.shape[-1]
    p2 = y.abs() ** 2
    k = (torch.arange(n, device=y.device) % sps).to(torch.float32)
    w = -2.0 * np.pi * k / sps
    m_re = torch.sum(p2 * torch.cos(w))
    m_im = torch.sum(p2 * torch.sin(w))
    tau = torch.remainder(-torch.atan2(m_im, m_re) / (2.0 * np.pi) * sps, sps)
    phase = torch.remainder(torch.round(tau).to(torch.int32), sps)
    return phase, tau


def _preamble_sync(r: torch.Tensor, pre: np.ndarray) -> torch.Tensor:
    """argmax |<r[k:k+P], pre>| over k: one planar complex valid correlation."""
    c_re, c_im = correlate_complex(
        r.real.contiguous(), r.imag.contiguous(),
        pre.real.astype(np.float32), pre.imag.astype(np.float32), mode="valid",
    )
    return torch.argmax(c_re**2 + c_im**2)


def _symbol_frames(seg: torch.Tensor, n_out: int, n_taps: int) -> torch.Tensor:
    """(n_out, n_taps) frames F[k, j] = seg[k + j] (seg pre-padded by the
    caller for a centred reference tap): a view by ``unfold``."""
    return seg.unfold(0, n_taps, 1)[:n_out]


def _ls_equalizer(frames: torch.Tensor, target: torch.Tensor, ridge: float) -> torch.Tensor:
    """Ridge LS taps for min ||F w - t||^2 in real block form (one small
    dense solve, IEEE float32)."""
    fr, fi = frames.real, frames.imag
    a = torch.cat([torch.cat([fr, -fi], dim=1), torch.cat([fi, fr], dim=1)], dim=0)
    b = torch.cat([target.real, target.imag])
    t2 = a.shape[1]
    with ieee_fp32_matmul():
        ata = a.T @ a + ridge * torch.eye(t2, device=a.device)
        w = torch.linalg.solve(ata, a.T @ b)
    half = t2 // 2
    return torch.complex(w[:half], w[half:])


def _decide_axis(y: torch.Tensor, lvl: int, scale: float) -> torch.Tensor:
    idx = torch.clip(torch.round((y / scale + (lvl - 1)) * 0.5), 0, lvl - 1)
    return (2.0 * idx - (lvl - 1)) * scale


def _decide(yr: torch.Tensor, yi: torch.Tensor, bits_per_symbol: int):
    """Nearest-constellation-point planar decisions."""
    if bits_per_symbol == 1:
        return torch.where(yr < 0, -1.0, 1.0), torch.zeros_like(yi)
    _, lvl, scale = _axis_params(bits_per_symbol)
    return _decide_axis(yr, lvl, scale), _decide_axis(yi, lvl, scale)


def _decide_rows(y: torch.Tensor, bits_per_symbol: int, imag_row: torch.Tensor) -> torch.Tensor:
    """:func:`_decide` of a (..., 2, block) tensor whose rows are I and Q;
    ``imag_row`` is (2, 1) [0; 1], which BPSK's zero Q decisions need."""
    if bits_per_symbol == 1:
        return torch.where((y < 0) & ~imag_row, -1.0, torch.where(imag_row, 0.0, 1.0))
    _, lvl, scale = _axis_params(bits_per_symbol)
    return _decide_axis(y, lvl, scale)


def _blocks(eq, known_r, known_i, known_mask, block):
    """The reference's zero-padded (nb, block) views of each input."""
    n = eq.shape[-1]
    nb = -(-n // block)
    pad = nb * block - n

    def rows(v):
        return F.pad(v, (0, pad)).reshape(nb, block)

    return n, nb, rows(eq.real), rows(eq.imag), rows(known_r), rows(known_i), rows(known_mask)


def _dd_phase_track(
    eq: torch.Tensor,
    known_r: torch.Tensor,
    known_i: torch.Tensor,
    known_mask: torch.Tensor,
    bits_per_symbol: int,
    block: int,
    unroll: int = 1,
) -> torch.Tensor:
    """Blockwise decision-directed carrier phase tracking.

    A first-order phase loop at block granularity, as the reference: block
    b is rotated by the running phase, decided (known symbols, the
    preamble, take the place of the decisions), and the angle of one
    conjugate-product sum moves the phase on. The loop runs n/block steps
    on device tensors with no host read; each step rotates the block's I
    and Q rows as one (2, block) tensor and takes the four error sums as
    one 2x2 product. Every block's output (its rotated samples turned by
    its own error, the reference's spelling) is formed after the loop in one
    pass. ``unroll`` is the reference's scan unroll and changes nothing.
    """
    n, nb, yr, yi, kr, ki, km = _blocks(eq, known_r, known_i, known_mask, block)
    y = torch.stack([yr, yi], dim=1)  # (nb, 2, block)
    y_sw = torch.stack([yi, -yr], dim=1)  # y * c + y_sw * s = [yr c + yi s; yi c - yr s]
    k = torch.stack([kr, ki], dim=1)
    kmask = torch.stack([km, km], dim=1)
    imag_row = torch.tensor([[False], [True]], device=eq.device)
    phi = torch.zeros((), device=eq.device)
    rot, errs = [], []
    with ieee_fp32_matmul():
        for b in range(nb):
            r = y[b] * torch.cos(phi) + y_sw[b] * torch.sin(phi)  # y * exp(-j phi)
            d = torch.where(kmask[b], k[b], _decide_rows(r, bits_per_symbol, imag_row))
            m = r @ d.T  # [[r1.rr, r1.ri], [i1.rr, i1.ri]]
            e = torch.atan2(m[1, 0] - m[0, 1], m[0, 0] + m[1, 1])
            phi = phi + e
            rot.append(r)
            errs.append(e)
    r = torch.stack(rot)  # (nb, 2, block)
    e = torch.stack(errs)[:, None]
    ce, se = torch.cos(e), torch.sin(e)
    out_r = r[:, 0] * ce + r[:, 1] * se
    out_i = r[:, 1] * ce - r[:, 0] * se
    return torch.complex(out_r.reshape(-1)[:n], out_i.reshape(-1)[:n])


def _convolve_same(a: torch.Tensor, m: int) -> torch.Tensor:
    """Sums of ``a`` over windows of ``m`` centred as ``jnp.convolve(a,
    ones(m), mode="same")`` centres them, clipped at the ends: that call
    where len(a) >= m. Shorter inputs keep their length, where the
    reference's call returns m outputs (ROADMAP H12)."""
    n = a.shape[-1]
    full = F.conv1d(F.pad(a, (m - 1, m - 1))[None, None], a.new_ones(1, 1, m))[0, 0]
    start = (m - 1) // 2
    return full[start : start + n]


def _vv_phase_track(
    eq: torch.Tensor,
    known_r: torch.Tensor,
    known_i: torch.Tensor,
    known_mask: torch.Tensor,
    bits_per_symbol: int,
    block: int,
    smooth: int = 5,
    refine: int = 2,
) -> torch.Tensor:
    """Parallel blockwise phase tracking (no serial loop).

    1. A decision-free phase a block from the power-m estimator (m=2 BPSK,
       m=4 QAM), block sums smoothed over ``smooth`` neighbour blocks
       (fewer blocks than ``smooth`` are smoothed too, where the reference
       raises: ROADMAP H12).
    2. Unwrap: block-to-block differences wrapped into (-pi/m, pi/m], then
       a cumulative sum.
    3. Anchor: the data-aided preamble phase picks the power-m branch.
    4. ``refine`` rounds of per-block decisions and one conjugate-product
       reduction, all blocks at once.
    """
    n, nb, yr, yi, kr, ki, km = _blocks(eq, known_r, known_i, known_mask, block)
    vm = (torch.arange(nb * block, device=eq.device) < n).reshape(nb, block)
    vmf = vm.to(yr.dtype)

    m = 2 if bits_per_symbol == 1 else 4
    zr, zi = yr, yi
    for _ in range(1 if m == 2 else 2):
        zr, zi = zr * zr - zi * zi, 2.0 * zr * zi
    br = torch.where(vm, zr, 0.0).sum(dim=1)
    bi = torch.where(vm, zi, 0.0).sum(dim=1)
    if smooth > 1:
        br = _convolve_same(br, smooth)
        bi = _convolve_same(bi, smooth)
    offset = float(np.pi) if m == 4 else 0.0
    theta = (torch.atan2(bi, br) - offset) / m  # phi mod 2pi/m, per block

    two_pi_m = 2.0 * float(np.pi) / m
    d = torch.diff(theta)
    d = d - two_pi_m * torch.round(d / two_pi_m)  # wrapped differences
    unwr = theta[0] + torch.cat([theta.new_zeros(1), torch.cumsum(d, 0)])

    use = (km & vm).to(yr.dtype)
    da_re = torch.sum((yr * kr + yi * ki) * use)
    da_im = torch.sum((yi * kr - yr * ki) * use)
    phi_da = torch.atan2(da_im, da_re)
    branch = two_pi_m * torch.round((phi_da - unwr[0]) / two_pi_m)
    phi = unwr + branch  # (nb,)

    for _ in range(refine):
        c = torch.cos(phi)[:, None]
        s = torch.sin(phi)[:, None]
        r1 = yr * c + yi * s
        i1 = yi * c - yr * s
        dr, di = _decide(r1, i1, bits_per_symbol)
        rr = torch.where(km, kr, dr) * vmf
        ri = torch.where(km, ki, di) * vmf
        e_re = torch.sum(r1 * rr + i1 * ri, dim=1)
        e_im = torch.sum(i1 * rr - r1 * ri, dim=1)
        phi = phi + torch.atan2(e_im, e_re)

    c = torch.cos(phi)[:, None]
    s = torch.sin(phi)[:, None]
    out_r = yr * c + yi * s
    out_i = yi * c - yr * s
    return torch.complex(out_r.reshape(-1)[:n], out_i.reshape(-1)[:n])


def _equalized(cfg: ModemConfig, xr: torch.Tensor, xi: torch.Tensor, n_payload: int):
    """The receive path up to the phase tracker: (eq, pre_c, diag) with the
    equalized [preamble | payload] symbols, the preamble on the device and
    the synchronization diagnostics."""
    dev = xr.device
    pre = preamble_symbols(cfg)
    p_len = cfg.preamble_len
    pre_c = torch.complex(
        torch.from_numpy(pre.real.astype(np.float32)), torch.from_numpy(pre.imag.astype(np.float32))
    ).to(dev)
    power = 2 if cfg.bits_per_symbol == 1 else 4

    # tail zeros so the causal matched filter and the symbol-grid reshape
    # cover the last symbol's peak plus the equalizer margin
    tail = cfg.rrc_num_taps + (cfg.eq_taps + 2) * cfg.sps
    y = _matched_filter(cfg, F.pad(xr, (0, tail)), F.pad(xi, (0, tail)))

    phase, tau = _oerder_meyr(y, cfg.sps)
    n_sym = y.shape[-1] // cfg.sps
    y2d = y[: n_sym * cfg.sps].reshape(n_sym, cfg.sps)
    r = y2d.index_select(1, phase.reshape(1).to(torch.int64))[:, 0]

    # coarse carrier at symbol rate (cycles/symbol)
    cfo_c = _coarse_cfo(r, power)
    n_k = torch.arange(r.shape[-1], device=dev).to(torch.float32)
    rot = -2.0 * np.pi * cfo_c * n_k
    r = r * torch.complex(torch.cos(rot), torch.sin(rot))

    start = _preamble_sync(r, pre)
    seg_len = p_len + n_payload
    half = cfg.eq_taps // 2
    ext_len = seg_len + 2 * half
    # the equalizer's half-tap margin of received samples on both sides,
    # padded so that the slice never clamps (a clamped start would shift
    # the frame); the start selects by an index tensor
    r_pad = F.pad(r, (half, ext_len))
    seg_ext = r_pad[start + torch.arange(ext_len, device=dev)]

    # fine CFO: Luise-Reggiannini multi-lag phase slope over the preamble,
    # the sum over lags 1..P/2 of R(m) = sum_k v[k+m] conj(v[k]) as one
    # masked sum of the (P, P) products
    v = seg_ext[half : half + p_len] * torch.conj(pre_c)
    m_lag = p_len // 2
    lag = torch.arange(p_len, device=dev)
    lag = lag[:, None] - lag[None, :]
    acc = torch.sum((v[:, None] * torch.conj(v[None, :])) * ((lag >= 1) & (lag <= m_lag)))
    cfo_f = torch.atan2(acc.imag, acc.real) / (np.pi * (m_lag + 1))  # cycles/symbol
    ks = (torch.arange(ext_len, device=dev) - half).to(torch.float32)
    rot_f = -2.0 * np.pi * cfo_f * ks
    seg_ext = seg_ext * torch.complex(torch.cos(rot_f), torch.sin(rot_f))

    frames = _symbol_frames(seg_ext, seg_len, cfg.eq_taps)
    w = _ls_equalizer(frames[:p_len], pre_c, cfg.eq_ridge)
    with ieee_fp32_matmul():
        eq = frames @ w
    diag = {
        "cfo_coarse": cfo_c,
        "cfo_fine_per_symbol": cfo_f,
        "timing_phase": phase,
        "timing_tau": tau,
        "frame_start": start,
    }
    return eq, pre_c, diag


def _known(pre_c: torch.Tensor, n_payload: int):
    """(known_r, known_i, known_mask): the preamble the trackers anchor on."""
    p_len = pre_c.shape[0]
    known_mask = torch.arange(p_len + n_payload, device=pre_c.device) < p_len
    return F.pad(pre_c.real, (0, n_payload)), F.pad(pre_c.imag, (0, n_payload)), known_mask


def receive(cfg: ModemConfig, i, q, n_payload: int, *, device="cuda") -> tuple[torch.Tensor, dict]:
    """Full receive path: planar sps-rate (i, q) -> payload bits.

    Matched filter -> Oerder-Meyr timing -> symbol-rate downsample ->
    coarse 4th-power CFO -> preamble-correlation frame sync -> multi-lag
    fine CFO -> ridge-LS equalizer trained on the preamble -> blockwise
    phase tracking -> hard Gray decisions. Returns (bits, diagnostics) as
    tensors on the input's device; diag cfo_* entries are cycles/symbol.
    """
    eq, pre_c, diag = _equalized(cfg, *as_planar(i, q, device), n_payload)
    known = _known(pre_c, n_payload)
    if cfg.tracker == "vv":
        tracked = _vv_phase_track(
            eq, *known, cfg.bits_per_symbol, cfg.dd_block, cfg.vv_smooth, cfg.vv_refine
        )
    else:
        tracked = _dd_phase_track(eq, *known, cfg.bits_per_symbol, cfg.dd_block, cfg.dd_unroll)
    p_len = cfg.preamble_len
    bits = demap_symbols(tracked[p_len:].real, tracked[p_len:].imag, cfg.bits_per_symbol)
    diag["evm"] = torch.sqrt(torch.mean((tracked[:p_len] - pre_c).abs() ** 2))
    return bits, diag
