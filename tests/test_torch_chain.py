"""The port's resampler, demodulators and receiver chain against the JAX package.

The same NumPy inputs go through the JAX package and the port on the CPU.
Tolerances and why:
- decimate / interpolate / resample_poly: 1e-5 of max|y|, two float32
  convolutions of the same products summed in another order;
- the oscillator bank: 5e-6, its own stated error (demod.py:107);
- fm_demodulate: 1e-5 absolute on inputs whose phasors stay away from 0,
  where atan2 does not magnify the rounding of the complex products;
- the chain: rtol=1e-3, atol=1e-4 after the ramp (the JAX package's own
  chain tolerance, tests/test_models.py:178-179: near-zero FM phasors
  during the ramp amplify float noise), and on an FM tone (test_models.py:
  50-79), where the phasors stay away from zero, rtol=1e-4, atol=1e-5 on
  the channel that carries it.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models.chain import ChainConfig as JaxChainConfig
from digital_signal_processsing_tpu.models.chain import DspChain as JaxDspChain
from digital_signal_processsing_tpu.models.chain import chain_stream_chunk as jax_chunk
from digital_signal_processsing_tpu.models.chain import chain_stream_init as jax_init
from digital_signal_processsing_tpu.ops import demod as jax_demod
from digital_signal_processsing_tpu.ops import resample as jax_resample
from digital_signal_processsing_tpu.parallel.pipeline import chain_halo as jax_chain_halo
from digital_signal_processsing_tpu_torch.models import (
    ChainConfig,
    DspChain,
    chain_from_jax,
    chain_state_from_jax,
    chain_stream_chunk,
    chain_stream_init,
)
from digital_signal_processsing_tpu_torch.ops import demod, resample
from digital_signal_processsing_tpu_torch.ops import fft_mxu as fm
from digital_signal_processsing_tpu_torch.ops.fir import FIR_FFT_CROSSOVER
from digital_signal_processsing_tpu_torch.parallel import chain_halo
from digital_signal_processsing_tpu_torch.utils import last_choice



def signal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def rel_err(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t_(x):
    return torch.from_numpy(np.array(x))  # a writable copy (JAX outputs are read-only)


# ---- resample -----------------------------------------------------------------------


@pytest.mark.parametrize("t", [1001, 4099, 4096, 7])
@pytest.mark.parametrize("q", [2, 3, 8])
def test_decimate_phase_and_length_match_jax(rng, q, t):
    x = signal(rng, (3, t))
    got = resample.decimate(t_(x), q).numpy()
    want = np.asarray(jax_resample.decimate(x, q))
    assert got.shape == want.shape == (3, t // q)
    if want.size:
        assert rel_err(got, want) < 1e-5


def test_decimate_taps_1d_and_factor_one(rng):
    x = signal(rng, 5003)
    h = signal(rng, 40)
    np.testing.assert_allclose(
        resample.decimate(t_(x), 5, taps=h).numpy(),
        np.asarray(jax_resample.decimate(x, 5, taps=h)), rtol=0, atol=1e-5 * np.abs(x).max() * 8,
    )
    np.testing.assert_array_equal(resample.decimate(t_(x), 1).numpy(), x)
    got = resample.decimate(t_(x), 4, ftype="iir").numpy()  # ported with the IIR slice
    assert rel_err(got, np.asarray(jax_resample.decimate(x, 4, ftype="iir"))) < 1e-5
    with pytest.raises(ValueError, match="factor must be >= 1"):
        resample.decimate(t_(x), 0)
    with pytest.raises(ValueError, match="ftype must be"):
        resample.decimate(t_(x), 2, ftype="cic")


@pytest.mark.parametrize("t", [1000, 333, 1])
@pytest.mark.parametrize("q", [2, 3, 8])
def test_interpolate_matches_jax(rng, q, t):
    x = signal(rng, (2, t))
    got = resample.interpolate(t_(x), q).numpy()
    want = np.asarray(jax_resample.interpolate(x, q))
    assert got.shape == want.shape == (2, t * q)
    assert rel_err(got, want) < 1e-5


def test_interpolate_short_taps(rng):
    # fewer taps than the factor: conv_transpose1d's tail is padded with zeros
    x = signal(rng, (2, 500))
    h = np.array([0.5, 1.0, 0.25], np.float32)
    got = resample.interpolate(t_(x), 8, taps=h).numpy()
    want = np.asarray(jax_resample.interpolate(x, 8, taps=h))
    assert got.shape == want.shape and rel_err(got, want) < 1e-6


@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (1, 4), (5, 1), (4, 6), (2, 2)])
def test_resample_poly_matches_jax(rng, up, down):
    x = signal(rng, (2, 3001))
    got = resample.resample_poly(t_(x), up, down).numpy()
    want = np.asarray(jax_resample.resample_poly(x, up, down))
    assert got.shape == want.shape
    assert rel_err(got, want) < 1e-5


# ---- demod ----------------------------------------------------------------------------


@pytest.mark.parametrize("t0", [0, 1_234_567, 2**30 + 12_345, -1000, -(2**20 + 7)])
def test_oscillator_bank_matches_jax(t0):
    f = np.array([0.373, -0.4, 0.1234567, -3e-5, 0.0], np.float32)
    c, s = demod.oscillator_bank(t_(f), 4096, t0)
    jc, js = jax_demod.oscillator_bank(f, 4096, t0)
    assert np.abs(c.numpy() - np.asarray(jc)).max() < 5e-6
    assert np.abs(s.numpy() - np.asarray(js)).max() < 5e-6
    # and against the float64 phase, where the limb split is exact (|f| >= 2^-13,
    # demod.py:64-68; both packages lose the low bits of smaller frequencies alike)
    exact = np.abs(f) >= 2.0**-13
    n = t0 + np.arange(4096)
    theta = -2 * np.pi * np.mod(f.astype(np.float64)[exact, None] * n[None, :], 1.0)
    assert np.abs(c.numpy()[exact] - np.cos(theta)).max() < 5e-6


def test_frac_mul_int_matches_jax():
    import jax.numpy as jnp

    f = np.array([0.373, -0.4, 1e-5, -0.2999999, 0.5], np.float32)[:, None]
    n = np.array([0, 1, 4095, 4096, 2**24 + 3, 2**31 - 1, -1, -4097], np.int32)[None, :]
    got = demod._frac_mul_int(t_(f), t_(n.astype(np.int64))).numpy()
    want = np.asarray(jax_demod._frac_mul_int(jnp.asarray(f), jnp.asarray(n)))
    np.testing.assert_array_equal(got, want)


def test_fm_demodulate_and_friends_match_jax(rng):
    t = 5000
    msg = signal(rng, (2, t)) * 0.3
    z = np.asarray(jax_demod.fm_modulate(msg, deviation=0.5))
    np.testing.assert_allclose(demod.fm_modulate(t_(msg), 0.5).numpy(), z, atol=1e-5)
    got = demod.fm_demodulate(t_(z), gain=2.0).numpy()
    want = np.asarray(jax_demod.fm_demodulate(z, gain=2.0))
    assert got[:, 0].tolist() == [0.0, 0.0]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 1:], 2.0 * 0.5 * msg[:, 1:], atol=1e-4)  # loopback
    np.testing.assert_allclose(
        demod.am_demodulate(t_(z)).numpy(), np.asarray(jax_demod.am_demodulate(z)), atol=1e-5
    )
    np.testing.assert_allclose(
        demod.fm_demodulate(t_(msg)).numpy(), np.asarray(jax_demod.fm_demodulate(msg)), atol=1e-6
    )
    x = signal(rng, (3, 777))
    fr = np.array([0.1, -0.25, 0.33], np.float32)
    np.testing.assert_allclose(
        demod.frequency_translate(t_(x), t_(fr)).numpy(),
        np.asarray(jax_demod.frequency_translate(x, fr)), atol=1e-5,
    )
    with pytest.raises(ValueError, match="one frequency"):
        demod.frequency_translate(t_(x[0]), t_(fr))


# ---- the chain -------------------------------------------------------------------


SMALL = dict(channels=4, decimation=4, channel_taps=65, audio_taps=33)
CONFIGS = {
    "default": SMALL,
    "long_taps": dict(SMALL, channel_taps=4097),
    "fused_frontend": dict(SMALL, channel_taps=64, fused_frontend=True),
}


def ramp(cfg):
    return (cfg["channel_taps"] + 8 * cfg["decimation"]) // cfg["decimation"] + cfg["audio_taps"]


def chains(cfg):
    return JaxDspChain(JaxChainConfig(**cfg)), DspChain(ChainConfig(**cfg), device="cpu")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_matches_jax(rng, name):
    cfg = CONFIGS[name]
    jc, pc = chains(cfg)
    t = 1 << 14
    i, q = signal(rng, (4, t)), signal(rng, (4, t))
    want = np.asarray(jc.forward_planar(i, q))
    got = pc.forward_planar(t_(i), t_(q)).numpy()
    if not cfg.get("fused_frontend"):
        auto = "direct" if cfg["channel_taps"] <= FIR_FFT_CROSSOVER else "overlap_save_fused"
        assert last_choice("fir_filter") == auto
    assert got.shape == want.shape == (4, t // 4)
    r = ramp(cfg)
    np.testing.assert_allclose(got[:, r:], want[:, r:], rtol=1e-3, atol=1e-4)
    z = (i + 1j * q).astype(np.complex64)
    np.testing.assert_allclose(pc(t_(z)).numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["default", "long_taps"])
def test_chain_recovers_an_fm_tone_as_jax_does(name):
    cfg = CONFIGS[name]
    jc, pc = chains(cfg)
    t = 1 << 14
    msg_f = 0.002
    n = np.arange(t)
    msg = np.sin(2 * np.pi * msg_f * n).astype(np.float32)
    base = np.asarray(jax_demod.fm_modulate(msg, deviation=0.05))
    lo = ChainConfig(**cfg).lo_frequencies()
    rng = np.random.default_rng(0)
    iq = (0.01 * (rng.normal(size=(4, t)) + 1j * rng.normal(size=(4, t)))).astype(np.complex64)
    iq[2] += base * np.exp(2j * np.pi * lo[2] * n)
    want = np.asarray(jc(iq))
    got = pc(t_(iq)).numpy()
    r = ramp(cfg)
    np.testing.assert_allclose(got[2, r:], want[2, r:], rtol=1e-4, atol=1e-5)
    seg = got[2, r:]
    spec = np.abs(np.fft.rfft(seg - seg.mean()))
    assert abs(int(np.argmax(spec)) - msg_f * 4 * seg.shape[0]) < 3


@pytest.mark.parametrize("name", list(CONFIGS))
def test_chain_stream_chunks_match_one_shot(rng, name):
    cfg = CONFIGS[name]
    jc, pc = chains(cfg)
    assert chain_halo(pc) == jax_chain_halo(jc)
    t = 1 << 13
    i, q = signal(rng, (4, t)), signal(rng, (4, t))
    one_shot = pc.forward_planar(t_(i), t_(q)).numpy()
    state = chain_stream_init(pc)
    outs = []
    cuts = [0, 2048, 2052, 3072, 3072, 8000, t]  # uneven, one empty, all multiples of 4
    for a, b in zip(cuts, cuts[1:]):
        state, y = chain_stream_chunk(pc, state, t_(i[:, a:b]), t_(q[:, a:b]))
        outs.append(y.numpy())
    got = np.concatenate(outs, axis=-1)
    assert got.shape == one_shot.shape and state.t0 == t
    r = ramp(cfg)
    np.testing.assert_allclose(got[:, r:], one_shot[:, r:], rtol=1e-3, atol=1e-4)


def test_chain_from_jax_and_its_stream_state(rng):
    import jax.numpy as jnp

    cfg = SMALL
    jc = JaxDspChain(JaxChainConfig(**cfg))
    jc.channel_taps = jnp.asarray(signal(rng, 65) / 8)  # weights of its own
    jc.audio_taps = jnp.asarray(signal(rng, 33) / 6)
    jc.lo = jnp.asarray(np.array([0.1, -0.2, 0.3, 0.05], np.float32))
    params = {k: np.asarray(getattr(jc, k)) for k in ("channel_taps", "audio_taps", "lo")}
    pc = chain_from_jax(params, ChainConfig(**cfg), device="cpu")
    t = 1 << 13
    i, q = signal(rng, (4, t)), signal(rng, (4, t))
    want = np.asarray(jc.forward_planar(i, q))
    got = pc.forward_planar(t_(i), t_(q)).numpy()
    r = ramp(cfg)
    np.testing.assert_allclose(got[:, r:], want[:, r:], rtol=1e-3, atol=1e-4)
    # the JAX stream's state after a first chunk continues in the port
    jstate, _ = jax_chunk(jc, jax_init(jc), i[:, :4096], q[:, :4096])
    jstate, jy = jax_chunk(jc, jstate, i[:, 4096:], q[:, 4096:])
    jstate1, _ = jax_chunk(jc, jax_init(jc), i[:, :4096], q[:, :4096])
    state = chain_state_from_jax(jstate1, device="cpu")
    assert state.t0 == 4096
    state, y = chain_stream_chunk(pc, state, t_(i[:, 4096:]), t_(q[:, 4096:]))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3, atol=1e-4)
    assert state.t0 == int(np.asarray(jstate.t0))


def test_long_taps_chain_keeps_the_spectrum_as_buffers():
    pc = DspChain(ChainConfig(**CONFIGS["long_taps"]), device="cpu")
    r = pc.channel_response()
    assert r is not None and r.geometry == fm.fused_geometry(4097, fm.pick_fused_block(4097))
    assert {"channel_h", "channel_h_kernel", "channel_taps", "lo"} <= dict(pc.named_buffers(remove_duplicate=False)).keys()
    direct = [dict(SMALL, channel_taps=FIR_FFT_CROSSOVER)] if FIR_FFT_CROSSOVER >= 1 else []
    for cfg in (*direct, CONFIGS["fused_frontend"]):
        assert DspChain(ChainConfig(**cfg), device="cpu").channel_response() is None  # no fir_filter


def test_chain_refusals():
    # the Farrow stage, once refused, now runs: the audio at 441/2560 of its rate
    from digital_signal_processsing_tpu_torch.ops.farrow import farrow_output_len

    locked = DspChain(ChainConfig(**SMALL, audio_resample=(441, 2560)), device="cpu")
    audio = locked.forward_planar(torch.zeros(4, 4096), torch.ones(4, 4096))
    assert audio.shape == (4, farrow_output_len(1024, (441, 2560)))
    pc = DspChain(ChainConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError, match="input on"):
        pc(torch.zeros(4, 64, dtype=torch.complex64, device="meta"))
