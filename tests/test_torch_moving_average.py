"""The port's moving average against the JAX package and the golden model.

Same NumPy inputs through ``digital_signal_processsing_tpu`` (its Pallas
kernels in interpret mode on the CPU, as its own tests run them) and through
``digital_signal_processsing_tpu_torch`` on the CPU (the plain PyTorch
versions of the kernels). The tolerance is bit-exact throughout.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.golden import moving_average_golden as jax_moving_average_golden
from digital_signal_processsing_tpu.ops import moving_average as jax_moving_average
from digital_signal_processsing_tpu_torch.golden import (
    moving_average_golden,
    moving_average_golden_loop,
)
from digital_signal_processsing_tpu_torch.ops import METHODS, moving_average
from digital_signal_processsing_tpu_torch.utils import last_choice
from tests.conftest import make_interleaved

WINDOWS = [1, 3, 16, 500, 5000, 65535]
CHANNELS = [1, 2, 3, 16]
FRAMES = [1, 7, 127, 128, 129, 32769]


def port(x: np.ndarray, window: int, channels: int, **kw) -> np.ndarray:
    return moving_average(torch.from_numpy(x), window, channels, **kw).numpy()


def port_packed(x: np.ndarray, window: int, channels: int) -> np.ndarray:
    x32 = torch.from_numpy(x).view(torch.int32)
    return moving_average(x32, window, channels).view(torch.int16).numpy()


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("window", WINDOWS)
def test_matches_golden_over_envelope(rng, window, channels, frames):
    # the JAX package's golden model, and the port's copy of it
    x = make_interleaved(rng, frames, channels)
    want = jax_moving_average_golden(x, window, channels)
    np.testing.assert_array_equal(port(x, window, channels), want)
    np.testing.assert_array_equal(moving_average_golden(x, window, channels), want)


@pytest.mark.parametrize("channels", CHANNELS)
@pytest.mark.parametrize("window", WINDOWS)
def test_matches_jax_auto(rng, window, channels):
    x = make_interleaved(rng, 129, channels)
    want = np.asarray(jax_moving_average(x, window, channels, method="auto"))
    np.testing.assert_array_equal(port(x, window, channels), want)


@pytest.mark.parametrize(
    "window,channels,frames",
    [(16, 2, f) for f in FRAMES]
    + [(5000, 2, 32769), (500, 3, 32769), (65535, 16, 32769), (1024, 16, 32769)],
)
def test_matches_jax_auto_lengths(rng, window, channels, frames):
    x = make_interleaved(rng, frames, channels)
    want = np.asarray(jax_moving_average(x, window, channels, method="auto"))
    np.testing.assert_array_equal(port(x, window, channels), want)


@pytest.mark.parametrize("window,channels", [(1024, 1), (65535, 1), (5000, 16)])
def test_int16_min_matches_jax_and_golden(window, channels):
    # most negative window sums: truncation toward zero and int32 exactness
    x = np.full(50000 * channels, -32768, dtype=np.int16)
    want = moving_average_golden(x, window, channels)
    np.testing.assert_array_equal(port(x, window, channels), want)
    np.testing.assert_array_equal(
        np.asarray(jax_moving_average(x, window, channels, method="auto")), want
    )


def test_two_pass_route_matches_jax(rng):
    # halo 5000*16 = 80000 is beyond the windowed kernel: two-pass route
    x = make_interleaved(rng, 9000, 16)
    got = port(x, 5000, 16)
    assert last_choice("moving_average") == "windowed:two_pass_fallback"
    np.testing.assert_array_equal(got, moving_average_golden(x, 5000, 16))
    np.testing.assert_array_equal(got, np.asarray(jax_moving_average(x, 5000, 16)))


@pytest.mark.parametrize(
    "channels,window", [(2, 16), (2, 1024), (4, 7), (2, 5000), (3, 16), (6, 16), (1, 33)]
)
def test_packed_matches_jax(rng, channels, window):
    # int32 pair-view input, odd channel counts included
    x = make_interleaved(rng, 768, channels)  # an even sample count for every C
    got = port_packed(x, window, channels)
    assert last_choice("moving_average") == "windowed_packed"
    want = np.asarray(jax_moving_average(x.view(np.int32), window, channels)).view(np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


def test_packed_two_pass_route(rng):
    x = make_interleaved(rng, 6000, 16)
    got = port_packed(x, 5000, 16)
    assert last_choice("moving_average") == "windowed:two_pass_fallback"
    np.testing.assert_array_equal(got, moving_average_golden(x, 5000, 16))


@pytest.mark.parametrize(
    "window,channels,frames,route",
    [
        (10119, 2, 12000, "windowed_packed"),  # past B2's former two-block bound
        (24828, 2, 26000, "windowed_packed"),  # the last window whose B1 ring fits
        (3103, 16, 3500, "windowed_packed"),
        (24829, 2, 26000, "windowed:two_pass_fallback"),
    ],
)
def test_packed_route_takes_b1_bound(rng, window, channels, frames, route):
    """int32 input takes B2 wherever the int16 stream takes B1, bit-exact with the
    JAX package on the same view (its unpack fallback there) and golden."""
    x = make_interleaved(rng, frames, channels)
    got = port_packed(x, window, channels)
    assert last_choice("moving_average") == route
    want = np.asarray(jax_moving_average(x.view(np.int32), window, channels)).view(np.int16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


@pytest.mark.parametrize(
    "window,channels,route",
    [
        (16, 2, "windowed"),
        (3103, 16, "windowed"),  # the last window whose B1 ring fits shared memory
        (3104, 16, "windowed:two_pass_fallback"),
        (65535, 1, "windowed:two_pass_fallback"),
        (100, 3, "windowed"),  # any channel count takes the kernel
    ],
)
@pytest.mark.parametrize("method", ["auto", "windowed"])
def test_last_choice_names_route(rng, window, channels, route, method):
    x = make_interleaved(rng, 300, channels)
    port(x, window, channels, method=method)
    assert last_choice("moving_average") == route


def test_golden_method(rng):
    x = make_interleaved(rng, 500, 2)
    got = port(x, 9, 2, method="golden")
    assert last_choice("moving_average") == "golden"
    np.testing.assert_array_equal(got, moving_average_golden(x, 9, 2))


@pytest.mark.parametrize("window", [0, -1, 65536, 70000])
def test_window_out_of_range_rejected(rng, window):
    x = make_interleaved(rng, 100, 1)
    with pytest.raises(ValueError, match="65535"):
        port(x, window, 1)


@pytest.mark.parametrize(
    "method", ["scan", "scan_hillis", "scan_mxu", "direct", "xla_scan", "xla_direct"]
)
def test_unported_methods_name_the_roadmap(rng, method):
    # the methods ROADMAP.md listed as not ported: now each records its own
    # route and equals the JAX package's same method
    assert method in METHODS
    x = make_interleaved(rng, 10, 1)
    got = port(x, 2, 1, method=method)
    assert last_choice("moving_average") == method
    np.testing.assert_array_equal(got, np.asarray(jax_moving_average(x, 2, 1, method=method)))


def test_bad_inputs_rejected(rng):
    x = make_interleaved(rng, 10, 2)
    with pytest.raises(ValueError, match="unknown method"):
        port(x, 2, 2, method="warp")
    with pytest.raises(ValueError, match="multiple of channels"):
        port(x[:-1], 2, 2)
    with pytest.raises(TypeError, match="torch.Tensor"):
        moving_average(x, 2, 2)
    with pytest.raises(TypeError, match="int16"):
        moving_average(torch.zeros(4, dtype=torch.float32), 2, 1)
    with pytest.raises(ValueError, match="channels"):
        port(x, 2, 0)


@pytest.mark.parametrize("window,channels", [(1, 1), (5, 3), (40, 2)])
def test_golden_loop_equals_vectorized(rng, window, channels):
    x = make_interleaved(rng, 120, channels)
    np.testing.assert_array_equal(
        moving_average_golden_loop(x, window, channels),
        moving_average_golden(x, window, channels),
    )
