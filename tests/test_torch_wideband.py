"""The port's wideband PFB receiver and the chain's Farrow stage against the JAX package.

The same NumPy inputs go through the JAX package and the port on the CPU.
Tolerance: rtol=1e-3, atol=1e-4, the chain's (tests/test_models.py:178-179):
the FM discriminator amplifies the rounding of near-zero phasors, so the
first outputs, while the filters fill, are left out.
"""

import dataclasses

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models.chain import ChainConfig as JaxChainConfig
from digital_signal_processsing_tpu.models.chain import DspChain as JaxDspChain
from digital_signal_processsing_tpu.models.wideband import WidebandConfig as JaxWidebandConfig
from digital_signal_processsing_tpu.models.wideband import WidebandFmReceiver as JaxReceiver
from digital_signal_processsing_tpu_torch.models import (
    ChainConfig,
    DspChain,
    WidebandConfig,
    WidebandFmReceiver,
    chain_from_jax,
    wideband_from_jax,
)
from digital_signal_processsing_tpu_torch.ops.farrow import farrow_output_len, resample_farrow
from digital_signal_processsing_tpu_torch.utils import last_choice


def fm_wideband(n, k, msg_f, dev, t):
    """A real FM tone centred on channel k of n (tests/test_wideband.py:11-16)."""
    idx = np.arange(t)
    msg = np.sin(2 * np.pi * msg_f * idx)
    phase = 2 * np.pi * (k / n) * idx + dev * 2 * np.pi * np.cumsum(msg)
    return np.cos(phase).astype(np.float32)


def ramp(cfg) -> int:
    return cfg.taps_per_phase + cfg.audio_taps


@pytest.mark.parametrize("squelch", [0.2, None])
def test_receiver_matches_jax_on_an_fm_tone(squelch):
    n, k = 16, 5
    jcfg = JaxWidebandConfig(n_channels=n, audio_taps=33, squelch=squelch)
    cfg = WidebandConfig(n_channels=n, audio_taps=33, squelch=squelch)
    x = fm_wideband(n, k, 0.002, 0.1 / n, n * 2048)
    want = np.asarray(JaxReceiver(jcfg)(x))
    rx = WidebandFmReceiver(cfg, device="cpu")
    got = rx(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (n, 2048)
    assert last_choice("pfb_channelize") == "composed"
    r = ramp(cfg)
    # the tone's channel and its conjugate image; an empty channel demodulates
    # noise, where the discriminator turns rounding into arbitrary phase
    live = [k, n - k]
    np.testing.assert_allclose(got[live, r:], want[live, r:], rtol=1e-3, atol=1e-4)
    if squelch is not None:
        # the gate is the same: only the tone's channel and its image survive
        power, jpower = (np.mean(a[:, r:] ** 2, axis=1) for a in (got, want))
        assert set(np.nonzero(power > 1e-12)[0]) == set(np.nonzero(jpower > 1e-12)[0]) <= {k, n - k}
    # the message tone at its bin on the tone's channel
    a = got[k, 256:] - got[k, 256:].mean()
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    assert int(np.argmax(spec)) == round(0.002 * n * a.size)


def test_wideband_from_jax_and_example_input(rng):
    jrx = JaxReceiver(JaxWidebandConfig(n_channels=8, audio_taps=17))
    params = {"prototype": np.asarray(jrx.prototype), "audio_taps": np.asarray(jrx.audio_taps)}
    cfg = WidebandConfig(n_channels=8, audio_taps=17)
    rx = wideband_from_jax(params, cfg, device="cpu")
    np.testing.assert_array_equal(rx.prototype.numpy(), params["prototype"])
    np.testing.assert_array_equal(rx.audio_taps.numpy(), params["audio_taps"])
    fresh = WidebandFmReceiver(cfg, device="cpu")
    np.testing.assert_array_equal(fresh.prototype.numpy(), params["prototype"])
    x = rx.example_input(t=8 * 256)
    np.testing.assert_array_equal(x, jrx.example_input(t=8 * 256))
    assert rx(torch.from_numpy(x)).shape == (8, 256)
    assert WidebandFmReceiver(device="cpu").example_input().shape == (64 * 4096,)
    assert {"prototype", "audio_taps"} <= dict(rx.named_buffers()).keys()
    with pytest.raises(ValueError, match="input on"):
        rx(torch.zeros(64, device="meta"))


def test_chain_locks_to_a_non_integer_audio_rate(rng):
    rate = (441, 2560)  # 44.1 kHz from 256 kHz
    kw = dict(channels=2, decimation=4, channel_taps=33, audio_taps=17, audio_resample=rate)
    jchain = JaxDspChain(JaxChainConfig(**kw))
    t = 1 << 13
    i = rng.normal(size=(2, t)).astype(np.float32)
    q = rng.normal(size=(2, t)).astype(np.float32)
    want = np.asarray(jchain.forward_planar(i, q))
    params = {a: np.asarray(getattr(jchain, a)) for a in ("channel_taps", "audio_taps", "lo")}
    chain = chain_from_jax(params, ChainConfig(**kw), device="cpu")
    got = chain.forward_planar(torch.from_numpy(i), torch.from_numpy(q))
    assert got.shape == (2, farrow_output_len(t // 4, rate)) and last_choice("resample_farrow") == "matmul"
    r = (33 + 32) // 4 + 17
    np.testing.assert_allclose(got[:, r:].numpy(), want[:, r:], rtol=1e-3, atol=1e-4)
    # the same as resampling the unlocked chain's audio
    base = DspChain(dataclasses.replace(ChainConfig(**kw), audio_resample=None), device="cpu")
    base._set_weights(params["channel_taps"], params["audio_taps"], params["lo"], device="cpu")
    unlocked = base.forward_planar(torch.from_numpy(i), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), resample_farrow(unlocked, rate).numpy())
