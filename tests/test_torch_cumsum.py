"""The port's per-channel cumsum and two-pass averager against the JAX package.

``cumsum_pallas`` runs in interpret mode on the CPU; the port's wrappers
take their plain PyTorch versions for CPU tensors. Bit-exact, int32
wraparound included.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops.pallas_scan import (
    cumsum_pallas,
)
from digital_signal_processsing_tpu.ops.pallas_scan import (
    moving_average_two_pass as jax_two_pass,
)
from digital_signal_processsing_tpu_torch.golden import (
    cumsum_per_channel_golden,
    moving_average_golden,
)
from digital_signal_processsing_tpu_torch.ops import cumsum, cumsum_ref, moving_average_two_pass
from digital_signal_processsing_tpu_torch.utils.numerics import wrap_int32
from tests.conftest import make_interleaved


def port_cumsum(x: np.ndarray, channels: int) -> np.ndarray:
    return cumsum(torch.from_numpy(x), channels).numpy()


@pytest.mark.parametrize("channels", [1, 2, 4, 16, 128])
def test_cumsum_matches_jax(rng, channels):
    x = make_interleaved(rng, 700, channels)
    want = np.asarray(cumsum_pallas(x, channels))
    got = port_cumsum(x, channels)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fill,channels", [(32767, 1), (-32768, 1), (-32768, 2)])
def test_cumsum_int32_wraparound_matches_jax(fill, channels):
    # |sum| reaches 100001 * 32768 > 2^31: the int32 result wraps
    x = np.full(100002, fill, dtype=np.int16)
    want = np.asarray(cumsum_pallas(x, channels))
    got = port_cumsum(x, channels)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, cumsum_per_channel_golden(x, channels).astype(np.int32)  # mod 2^32
    )


@pytest.mark.parametrize("channels", [3, 5, 16])
def test_cumsum_any_channel_count(rng, channels):
    # the JAX kernel needs channels | 128; the port's takes any count
    x = make_interleaved(rng, 3001, channels)
    np.testing.assert_array_equal(
        port_cumsum(x, channels), cumsum_per_channel_golden(x, channels).astype(np.int32)
    )


def test_wrap_int32_is_modular(rng):
    v = rng.integers(-(2**40), 2**40, size=10000, dtype=np.int64)
    v[:6] = [2**31, -(2**31) - 1, 2**32 - 1, -(2**32), 2**31 - 1, -(2**31)]
    got = wrap_int32(torch.from_numpy(v))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), v.astype(np.int32))


def test_cumsum_ref_is_the_plain_version(rng):
    x = torch.from_numpy(make_interleaved(rng, 400, 2))
    assert torch.equal(cumsum(x, 2), cumsum_ref(x, 2))


@pytest.mark.parametrize("window,channels", [(5000, 2), (65535, 1), (300, 16), (4096, 128)])
def test_two_pass_matches_jax(rng, window, channels):
    x = make_interleaved(rng, 6000, channels)
    got = moving_average_two_pass(torch.from_numpy(x), window, channels).numpy()
    want = np.asarray(jax_two_pass(x, window, channels))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, moving_average_golden(x, window, channels))


def test_cumsum_rejects_bad_streams(rng):
    with pytest.raises(TypeError, match="int16"):
        cumsum(torch.zeros(8, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="multiple of channels"):
        cumsum(torch.zeros(7, dtype=torch.int16), 2)
    with pytest.raises(ValueError, match="contiguous"):
        cumsum(torch.zeros(16, dtype=torch.int16)[::2], 1)
    with pytest.raises(ValueError, match="flat"):
        cumsum(torch.zeros(4, 2, dtype=torch.int16), 2)
