"""The port's QAM modem and OFDM receiver (``models/modem.py``,
``models/ofdm.py``) against the JAX package.

The same seeded NumPy bursts (the JAX package's transmitter and channel)
go through both receivers on the CPU. The port's matched filter and CP sum
are ``fir_filter``'s fused route, whose plain version runs here (B8 on the
card); the reference takes its direct convolution. Both trackers are held
(ROADMAP H4: the reference has no unit test of ``_vv_phase_track``) at BPSK,
QPSK and 16QAM under a carrier ramp and noise.

Tolerances:

- bits equal to the JAX package's, and the integer diagnostics
  (``timing_phase``, ``frame_start``) equal;
- float diagnostics within ``DIAG_TOL`` = 1e-5: absolute for the carrier
  estimates (cycles/symbol) and the EVM, relative for ``timing_tau``
  (samples);
- the transmitter within 1e-5 of max|want| (``TOL``; ``upfirdn`` by
  ``conv_transpose1d`` against the reference's banded product);
- OFDM: timing offsets equal, carrier estimates within 1e-5 relative,
  equalized symbols within 1e-5 of max|want|, bits equal; a batch of bursts
  equal to per-burst calls within the same bounds; a start past the last
  frame clamped as the reference clamps it; on a burst of 558k samples the
  symbols within 1e-5 of max|want| of a float64 demodulation (ROADMAP H13:
  the reference's float32 oscillator phase is not held to that).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models import modem as jmod
from digital_signal_processsing_tpu.models import ofdm as jofdm
from digital_signal_processsing_tpu_torch.models import modem, ofdm

TOL = 1e-5
DIAG_TOL = 1e-5
N_PAYLOAD = 640


def t_(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def rel(got, want) -> float:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def test_map_and_demap_are_the_reference(rng):
    for bps in (1, 2, 4, 6):
        bits = rng.integers(0, 2, 60 * bps)
        syms = modem.map_bits(bits, bps)
        np.testing.assert_array_equal(syms, jmod.map_bits(bits, bps))
        noisy = syms + 0.01 * (rng.standard_normal(syms.size) + 1j * rng.standard_normal(syms.size))
        yr, yi = noisy.real.astype(np.float32), noisy.imag.astype(np.float32)
        got = modem.demap_symbols(t_(yr), t_(yi), bps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jmod.demap_symbols(yr, yi, bps)))
        np.testing.assert_array_equal(got.numpy(), bits)
    cfg = modem.ModemConfig()
    np.testing.assert_array_equal(modem.preamble_symbols(cfg), jmod.preamble_symbols(jmod.ModemConfig()))
    with pytest.raises(ValueError):
        modem.ModemConfig(tracker="pll")


def test_transmit_matches_jax(rng):
    cfg, jcfg = modem.ModemConfig(bits_per_symbol=4), jmod.ModemConfig(bits_per_symbol=4)
    bits = rng.integers(0, 2, 200 * 4)
    for got, want in zip(modem.transmit(cfg, bits, device="cpu"), jmod.transmit(jcfg, bits)):
        assert isinstance(got, np.ndarray) and rel(got, want) < TOL


def _burst(bps: int, seed: int):
    jcfg = jmod.ModemConfig(bits_per_symbol=bps)
    r = np.random.default_rng(seed)
    bits = r.integers(0, 2, N_PAYLOAD * bps)
    ti, tq = jmod.transmit(jcfg, bits)
    # a carrier ramp (cfo) and a phase offset, a fractional-symbol delay, noise
    ci, cq = jmod.channel(ti, tq, delay=29 + seed, cfo=1.7e-4, phase=0.6, symbol_snr_db=24.0, seed=seed)
    return bits, ci, cq


@pytest.mark.parametrize("tracker", ["dd", "vv"])
@pytest.mark.parametrize("bps", [1, 2, 4])
def test_receive_matches_jax(bps, tracker):
    bits, ci, cq = _burst(bps, seed=bps)
    kw = dict(bits_per_symbol=bps, tracker=tracker)
    got_bits, diag = modem.receive(modem.ModemConfig(**kw), t_(ci), t_(cq), N_PAYLOAD)
    want_bits, jdiag = jmod.receive(jmod.ModemConfig(**kw), jnp.asarray(ci), jnp.asarray(cq), N_PAYLOAD)
    assert got_bits.dtype == torch.int32
    np.testing.assert_array_equal(got_bits.numpy(), np.asarray(want_bits))
    np.testing.assert_array_equal(got_bits.numpy(), bits)
    for key in ("timing_phase", "frame_start"):
        assert int(diag[key]) == int(jdiag[key]), key
    for key in ("cfo_coarse", "cfo_fine_per_symbol", "evm"):
        assert abs(float(diag[key]) - float(jdiag[key])) < DIAG_TOL, key
    assert abs(float(diag["timing_tau"]) - float(jdiag["timing_tau"])) < DIAG_TOL * max(
        1.0, abs(float(jdiag["timing_tau"]))
    )


def test_trackers_match_jax_on_a_ramp():
    """Both trackers alone on equalized symbols with a residual phase ramp,
    against the JAX package's: the tracked symbols within TOL of max|want|."""
    r = np.random.default_rng(9)
    cfg = jmod.ModemConfig(bits_per_symbol=4)
    pre = jmod.preamble_symbols(cfg)
    n_pay = 1000
    syms = np.concatenate([pre, jmod.map_bits(r.integers(0, 2, 4 * n_pay), 4)])
    n = np.arange(syms.size)
    noise = r.standard_normal(n.size) + 1j * r.standard_normal(n.size)
    rx = syms * np.exp(1j * (0.3 + 2e-3 * n)) + 0.03 * noise
    eq = rx.astype(np.complex64)
    known_r = np.pad(pre.real, (0, n_pay)).astype(np.float32)
    known_i = np.pad(pre.imag, (0, n_pay)).astype(np.float32)
    mask = np.arange(syms.size) < pre.size
    for port_fn, jax_fn, extra in (
        (modem._dd_phase_track, jmod._dd_phase_track, ()),
        (modem._vv_phase_track, jmod._vv_phase_track, (5, 2)),
    ):
        got = port_fn(t_(eq), t_(known_r), t_(known_i), t_(mask), 4, 32, *extra)
        want = np.asarray(jax_fn(jnp.asarray(eq), known_r, known_i, jnp.asarray(mask), 4, 32, *extra))
        assert rel(got.real, want.real) < TOL and rel(got.imag, want.imag) < TOL
        dec = modem.demap_symbols(got.real[pre.size:], got.imag[pre.size:], 4)
        np.testing.assert_array_equal(
            dec.numpy(), np.asarray(jmod.demap_symbols(want.real[pre.size:], want.imag[pre.size:], 4))
        )


def test_convolve_same_is_jnp_convolve(rng):
    for n, m in ((20, 5), (20, 4), (5, 5), (1, 1)):
        a = rng.standard_normal(n).astype(np.float32)
        got = modem._convolve_same(t_(a), m)
        want = np.asarray(jnp.convolve(jnp.asarray(a), jnp.ones(m, jnp.float32), mode="same"))
        assert got.shape == want.shape and rel(got, want) < 1e-6
    # fewer blocks than the window (ROADMAP H12): the clipped centred sums
    a = rng.standard_normal(3).astype(np.float32)
    want = np.convolve(a.astype(np.float64), np.ones(5))[2:5]
    assert rel(modem._convolve_same(t_(a), 5), want) < 1e-6


def test_vv_tracker_on_fewer_blocks_than_its_smoothing():
    """ROADMAP H12: the reference's vv tracker raises when the segment has
    fewer blocks than ``vv_smooth``; the port tracks it."""
    bits, ci, cq = _burst(2, seed=2)
    n_pay = 64  # 128 symbols with the preamble: 4 blocks of 32, smoothing over 5
    cfg = modem.ModemConfig(tracker="vv")
    got, _ = modem.receive(cfg, t_(ci), t_(cq), n_pay)
    np.testing.assert_array_equal(got.numpy(), bits[: 2 * n_pay])
    with pytest.raises(TypeError):
        jmod.receive(jmod.ModemConfig(tracker="vv"), jnp.asarray(ci), jnp.asarray(cq), n_pay)


# --- OFDM -------------------------------------------------------------------

OFDM_CFG = dict(n_fft=64, cp=16, n_symbols=24, active=48)


def _bursts(batch: int):
    cfg = jofdm.OfdmConfig(**OFDM_CFG)
    r = np.random.default_rng(7)
    bi, bq, bits_all = [], [], []
    for b in range(batch):
        bits = r.integers(0, 2, 2 * cfg.active * cfg.n_symbols)
        ti, tq = jofdm.ofdm_modulate(cfg, bits)
        x = ti.astype(np.float64) + 1j * tq.astype(np.float64)
        x = np.concatenate([np.zeros(13 + 3 * b, complex), x, np.zeros(64, complex)])
        x = x * np.exp(1j * 2 * np.pi * (1.1e-4 + 4e-5 * b) * np.arange(x.size))
        noise = r.standard_normal(x.size) + 1j * r.standard_normal(x.size)
        x = x + 10 ** (-25 / 20) * noise / np.sqrt(2)
        x = np.concatenate([x, np.zeros(3 * (batch - 1 - b), complex)])  # equal lengths
        bi.append(x.real.astype(np.float32))
        bq.append(x.imag.astype(np.float32))
        bits_all.append(bits)
    return np.stack(bi), np.stack(bq), np.stack(bits_all)


@pytest.fixture(scope="module")
def ofdm_case():
    i, q, bits = _bursts(3)
    jrx = jofdm.OfdmReceiver(jofdm.OfdmConfig(**OFDM_CFG))
    want = []
    for b in range(3):
        d, cfo = jrx.synchronize(jnp.asarray(i[b]), jnp.asarray(q[b]))
        er, ei = jrx.demodulate(jnp.asarray(i[b]), jnp.asarray(q[b]), d, cfo)
        want.append((int(d), float(cfo), np.asarray(er), np.asarray(ei), jrx.receive_bits(i[b], q[b])))
    return i, q, bits, want


def test_ofdm_one_burst_matches_jax(ofdm_case):
    i, q, bits, want = ofdm_case
    rx = ofdm.OfdmReceiver(ofdm.OfdmConfig(**OFDM_CFG), device="cpu")
    for b in range(3):
        d, cfo = rx.synchronize(t_(i[b]), t_(q[b]))
        wd, wcfo, wer, wei, wbits = want[b]
        assert d.shape == () and int(d) == wd
        assert abs(float(cfo) - wcfo) <= DIAG_TOL * abs(wcfo)
        er, ei = rx.demodulate(t_(i[b]), t_(q[b]), d, cfo)
        scale = max(np.abs(wer).max(), np.abs(wei).max())
        assert np.abs(er.numpy() - wer).max() < TOL * scale
        assert np.abs(ei.numpy() - wei).max() < TOL * scale
        got_bits = rx.receive_bits(i[b], q[b])
        np.testing.assert_array_equal(got_bits, wbits)
        np.testing.assert_array_equal(got_bits, bits[b])


def test_ofdm_batch_equals_per_burst_calls(ofdm_case):
    i, q, bits, _ = ofdm_case
    rx = ofdm.OfdmReceiver(ofdm.OfdmConfig(**OFDM_CFG), device="cpu")
    d, cfo = rx.synchronize(t_(i), t_(q))
    er, ei = rx.demodulate(t_(i), t_(q), d, cfo)
    assert d.shape == cfo.shape == (3,) and er.shape == (3, 24, 48)
    for b in range(3):
        d1, cfo1 = rx.synchronize(t_(i[b]), t_(q[b]))
        er1, ei1 = rx.demodulate(t_(i[b]), t_(q[b]), d1, cfo1)
        assert int(d[b]) == int(d1) and abs(float(cfo[b]) - float(cfo1)) <= DIAG_TOL * abs(float(cfo1))
        assert rel(er[b], er1.numpy()) < TOL and rel(ei[b], ei1.numpy()) < TOL
    np.testing.assert_array_equal(rx.receive_bits(i, q), bits)


def test_ofdm_demodulate_clamps_a_late_start_as_the_reference(ofdm_case):
    i, q, _, want = ofdm_case
    rx = ofdm.OfdmReceiver(ofdm.OfdmConfig(**OFDM_CFG), device="cpu")
    jrx = jofdm.OfdmReceiver(jofdm.OfdmConfig(**OFDM_CFG))
    late = i.shape[-1]  # past the last whole frame: the reference's dynamic_slice clamps it
    er, ei = rx.demodulate(t_(i[0]), t_(q[0]), late, want[0][1])
    jer, jei = jrx.demodulate(jnp.asarray(i[0]), jnp.asarray(q[0]), late, jnp.float32(want[0][1]))
    assert rel(er, np.asarray(jer)) < TOL and rel(ei, np.asarray(jei)) < TOL


def _demodulate64(cfg, x, timing, cfo, pilot):
    """``demodulate`` in float64 NumPy, the reference's steps."""
    sl, total = cfg.symbol_len, (cfg.n_symbols + 1) * cfg.symbol_len
    y = (x * np.exp(-2j * np.pi * cfo * np.arange(x.size)))[timing : timing + total]
    spec = np.fft.fft(y.reshape(cfg.n_symbols + 1, sl)[:, cfg.cp :], axis=-1) / np.sqrt(cfg.n_fft)
    act = spec[:, cfg.subcarriers()]
    eq = act[1:] / (act[0] / pilot)
    u = eq / (np.abs(eq) + 1e-12)
    raw = (np.angle(np.sum(u**4, axis=-1)) - np.pi) / 4.0
    phi, prev = np.empty_like(raw), 0.0
    for k, r in enumerate(raw):
        prev = phi[k] = r + np.round((prev - r) / (np.pi / 2)) * (np.pi / 2)
    return eq * np.exp(-1j * phi)[:, None]


def test_ofdm_long_burst_against_float64():
    """ROADMAP H13: on a burst of 558k samples (the family row's) the
    oscillator phase reaches 387 rad; the port's float64 turns keep the
    equalized symbols within TOL of a float64 demodulation."""
    cfg = ofdm.OfdmConfig(n_fft=1024, cp=64, n_symbols=512, active=768)
    r = np.random.default_rng(21)
    ti, tq = ofdm.ofdm_modulate(cfg, r.integers(0, 2, 2 * cfg.active * cfg.n_symbols))
    x = np.concatenate([np.zeros(13), ti + 1j * tq, np.zeros(64)])
    x = x * np.exp(2j * np.pi * 1.1e-4 * np.arange(x.size))
    x = (x + 0.05 * (r.standard_normal(x.size) + 1j * r.standard_normal(x.size))).astype(np.complex64)
    rx = ofdm.OfdmReceiver(cfg, device="cpu")
    d, cfo = rx.synchronize(t_(x.real), t_(x.imag))
    er, ei = rx.demodulate(t_(x.real), t_(x.imag), d, cfo)
    want = _demodulate64(cfg, x.astype(np.complex128), int(d), float(cfo), ofdm._pilot_freq(cfg))
    scale = np.abs(want).max()
    assert np.abs(er.numpy() - want.real).max() < TOL * scale
    assert np.abs(ei.numpy() - want.imag).max() < TOL * scale


def test_ofdm_host_helpers_are_the_reference(rng):
    cfg = ofdm.OfdmConfig(**OFDM_CFG)
    bits = rng.integers(0, 2, 2 * cfg.active * cfg.n_symbols)
    want = jofdm.ofdm_modulate(jofdm.OfdmConfig(**OFDM_CFG), bits)
    for a, b in zip(ofdm.ofdm_modulate(cfg, bits), want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ofdm.qpsk_demod(ofdm.qpsk_mod(bits)), bits)
    np.testing.assert_array_equal(cfg.subcarriers(), jofdm.OfdmConfig(**OFDM_CFG).subcarriers())
