"""The port's streaming FIR (``fir_init``/``fir_chunk``) against the JAX package's.

A stream cut into chunks of any length (one sample, shorter than the taps,
longer) gives one-shot ``fir_direct``'s output; a stream started in the JAX
package continues in the port from ``fir_state_from_jax``. Tolerance: 1e-5
of max|y| against the JAX package and scipy's float64 ``lfilter`` (float32
convolutions summed in other orders, about 1e-7 of the output for 201
taps); the carried tail bit for bit.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu.ops import streaming as jax_streaming
from digital_signal_processsing_tpu_torch.ops import fir, streaming

TOL = 1e-5
CUTS = (0, 1, 2, 150, 151, 600, 1000, 1733, 2048)  # one sample, shorter than the taps, longer


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def remez_taps():
    return fir.design_remez(201, [0.0, 0.1, 0.15, 1.0], [1.0, 0.0])


@pytest.mark.parametrize("taps", ["remez201", "one", "two"])
def test_chunks_match_one_shot_jax_and_scipy(rng, taps):
    h = {"remez201": remez_taps(), "one": np.array([0.5], np.float32),
         "two": np.array([0.5, -0.25], np.float32)}[taps]
    x = rng.standard_normal((3, CUTS[-1])).astype(np.float32)
    st = streaming.fir_init(h.size, 3, device="cpu")
    jst = jax_streaming.fir_init(h.size, 3)
    outs, jouts = [], []
    for a, b in zip(CUTS[:-1], CUTS[1:]):
        st, y = streaming.fir_chunk(st, torch.from_numpy(x[:, a:b]), h)
        jst, jy = jax_streaming.fir_chunk(jst, x[:, a:b], h)
        outs.append(y.numpy())
        jouts.append(np.asarray(jy))
        np.testing.assert_array_equal(st.tail.numpy(), np.asarray(jst.tail))
    got = np.concatenate(outs, -1)
    one = fir.fir_direct(torch.from_numpy(x), h).numpy()
    want64 = sps.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64), axis=-1)
    assert rel_err(got, one) < TOL
    assert rel_err(got, np.concatenate(jouts, -1)) < TOL
    assert rel_err(got, want64) < TOL


def test_stream_started_in_jax_continues_in_the_port(rng):
    h = remez_taps()
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    jst = jax_streaming.fir_init(h.size, 2)
    head = []
    for a, b in ((0, 700), (700, 1301)):
        jst, y = jax_streaming.fir_chunk(jst, x[:, a:b], h)
        head.append(np.asarray(y))
    st = streaming.fir_state_from_jax(np.asarray(jst.tail), device="cpu")
    tail = []
    for a, b in ((1301, 1302), (1302, 3000)):
        st, y = streaming.fir_chunk(st, torch.from_numpy(x[:, a:b]), h)
        tail.append(y.numpy())
    got = np.concatenate(head + tail, -1)
    want64 = sps.lfilter(h.astype(np.float64), [1.0], x.astype(np.float64), axis=-1)
    assert rel_err(got, want64) < TOL
    assert rel_err(got[:, 1301:], fir.fir_direct(torch.from_numpy(x), h).numpy()[:, 1301:]) < TOL


def test_one_dimensional_stream(rng):
    h = remez_taps()
    x = rng.standard_normal(900).astype(np.float32)
    st = streaming.fir_init(h.size, device="cpu")
    st, a = streaming.fir_chunk(st, torch.from_numpy(x[:100]), h)
    st, b = streaming.fir_chunk(st, torch.from_numpy(x[100:]), h)
    assert a.shape == (100,) and b.shape == (800,) and st.tail.shape == (1, 200)
    assert rel_err(np.concatenate([a, b]), fir.fir_direct(torch.from_numpy(x), h).numpy()) < TOL


def test_state_refusals():
    h = remez_taps()
    st = streaming.fir_init(101, 2, device="cpu")
    with pytest.raises(ValueError, match="taps need 200"):
        streaming.fir_chunk(st, torch.zeros(2, 10), h)
    with pytest.raises(ValueError, match="num_taps"):
        streaming.fir_init(0, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        streaming.fir_state_from_jax(np.zeros((2, 200)), device="cpu")
    with pytest.raises(ValueError, match="float32"):
        streaming.fir_state_from_jax(np.zeros(200, np.float32), device="cpu")
    with pytest.raises(ValueError, match="on meta"):
        streaming.fir_chunk(streaming.fir_init(201, 2, device="cpu"),
                            torch.zeros(2, 10, device="meta"), h)
