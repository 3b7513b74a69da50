"""The port's direct averager (B5) and the two plain anchors against the JAX package.

``direct``, ``xla_scan`` and ``xla_direct`` go through the JAX package (the
direct Pallas kernel in interpret mode on the CPU) and through the port on
the CPU with the same NumPy input; bit-exact. ``emulate_direct`` does what
a block of ``csrc/direct.cu`` does, with the geometry
``ops/pallas_direct.py`` passes to the launch.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import moving_average as jax_moving_average
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import (
    MAX_DIRECT_WINDOW,
    direct_averager,
    moving_average,
    moving_average_reduce_window,
)
from digital_signal_processsing_tpu_torch.ops import pallas_direct as pd
from digital_signal_processsing_tpu_torch.utils import last_choice
from tests.conftest import make_interleaved

WINDOWS = [1, 3, 16, 500, 5000]
CHANNELS = [1, 2, 3, 16]


def port(x: np.ndarray, window: int, channels: int, method: str) -> np.ndarray:
    return moving_average(torch.from_numpy(x), window, channels, method=method).numpy()


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("window", [w for w in WINDOWS if w <= MAX_DIRECT_WINDOW])
def test_direct_matches_jax(rng, window, channels):
    x = make_interleaved(rng, 1000, channels)
    got = port(x, window, channels, "direct")
    assert last_choice("moving_average") == "direct"
    np.testing.assert_array_equal(
        got, np.asarray(jax_moving_average(x, window, channels, method="direct"))
    )
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize("window", [w for w in WINDOWS if w > MAX_DIRECT_WINDOW] + [257])
def test_direct_refuses_large_windows_as_jax_does(rng, window):
    x = make_interleaved(rng, 100, 1)
    with pytest.raises(ValueError, match="direct method supports window <= 256") as port_err:
        port(x, window, 1, "direct")
    with pytest.raises(ValueError, match="direct") as jax_err:
        jax_moving_average(x, window, 1, method="direct")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("method", ["xla_scan", "xla_direct"])
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("window", WINDOWS)
def test_anchors_match_jax(rng, method, window, channels):
    x = make_interleaved(rng, 1000, channels)
    got = port(x, window, channels, method)
    assert last_choice("moving_average") == method
    np.testing.assert_array_equal(
        got, np.asarray(jax_moving_average(x, window, channels, method=method))
    )


@pytest.mark.parametrize("method", ["direct", "xla_direct", "xla_scan"])
@pytest.mark.parametrize("n", [1, 7, 127, 129, 32769])
def test_awkward_lengths(rng, method, n):
    x = rng.integers(-32768, 32768, size=n, dtype=np.int16)
    np.testing.assert_array_equal(port(x, 4, 1, method), moving_average_golden(x, 4, 1))


@pytest.mark.parametrize("method", ["direct", "xla_direct"])
def test_int16_min(method):
    x = np.full(50000, -32768, dtype=np.int16)
    want = moving_average_golden(x, 63, 1)
    np.testing.assert_array_equal(port(x, 63, 1, method), want)
    np.testing.assert_array_equal(np.asarray(jax_moving_average(x, 63, 1, method=method)), want)


def test_direct_checks(rng):
    x = torch.from_numpy(make_interleaved(rng, 100, 2))
    with pytest.raises(ValueError, match="256"):
        direct_averager(x, 300, 2)
    with pytest.raises(ValueError, match="shared memory"):
        direct_averager(torch.zeros(8192 * 4, dtype=torch.int16), 256, 8192)
    got = direct_averager(x, 9, 2, tile_samples=64).numpy()
    np.testing.assert_array_equal(got, moving_average_golden(x.numpy(), 9, 2))
    assert torch.equal(direct_averager(x, 9, 2), moving_average_reduce_window(x, 9, 2))


# ---- the block of csrc/direct.cu, in NumPy -------------------------------------


def emulate_direct(x, window, channels, tile_samples=None):
    g = pd.direct_geometry(window, channels, tile_samples)
    n, t, lead = x.size, g.tile_samples, (window - 1) * channels
    assert 4 * (lead + t) == g.smem_bytes
    out = np.zeros(n, np.int16)
    written = np.zeros(n, np.int64)
    for b in range(g.blocks(n)):
        t0 = b * t
        gi = np.arange(t0 - lead, t0 + t)
        buf = np.zeros(gi.size, np.int32)
        inside = (gi >= 0) & (gi < n)
        buf[inside] = x[gi[inside]]
        tt = np.arange(min(t, n - t0))
        acc = np.zeros(tt.size, np.int32)
        for j in range(window):
            acc += buf[lead + tt - j * channels]
        q = np.where(acc >= 0, acc // window, -((-acc) // window))
        out[t0 + tt] = q.astype(np.int16)
        written[t0 + tt] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize(
    "window,channels,frames,tile_samples",
    [(1, 1, 20000, None), (16, 2, 9000, None), (64, 3, 5001, 1000), (256, 16, 1500, None),
     (255, 1, 30000, 4096), (200, 5, 7, None)],
)
def test_direct_block_algorithm(rng, window, channels, frames, tile_samples):
    x = make_interleaved(rng, frames, channels)
    np.testing.assert_array_equal(
        emulate_direct(x, window, channels, tile_samples), moving_average_golden(x, window, channels)
    )


def test_direct_block_algorithm_int16_min():
    x = np.full(30000, -32768, np.int16)
    for window, channels in [(256, 1), (64, 16), (3, 2)]:
        np.testing.assert_array_equal(
            emulate_direct(x, window, channels), moving_average_golden(x, window, channels)
        )


@pytest.mark.parametrize("channels", [1, 2, 3, 16, 64])
def test_direct_geometry_fits_the_card(channels):
    for window in (1, 64, MAX_DIRECT_WINDOW):
        g = pd.direct_geometry(window, channels)
        assert pd.direct_supported(window, channels)
        assert g.tile_samples >= pd.TILE_SAMPLES and g.smem_bytes <= pd.SMEM_MAX
    assert not pd.direct_supported(MAX_DIRECT_WINDOW + 1, channels)
