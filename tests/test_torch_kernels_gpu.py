"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

``--noconftest`` keeps pytest from loading ``tests/conftest.py``, which sets
up JAX for the other tests.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import moving_average
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_ref, moving_average_ref
from digital_signal_processsing_tpu_torch.ops.streaming import (
    moving_average_chunk,
    moving_average_init,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def stream(dev, frames, channels, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, size=frames * channels, dtype=np.int16)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("frames", [1, 127, 129, 20001])
@pytest.mark.parametrize("channels", [1, 2, 3, 16])
@pytest.mark.parametrize("window", [1, 16, 1024])
def test_windowed_matches_plain(dev, window, channels, frames):
    x = stream(dev, frames, channels)
    before = ps.windowed_averager.launches
    got = ps.windowed_averager(x, window, channels)
    assert ps.windowed_averager.launches == before + 1
    assert torch.equal(got, moving_average_ref(x, window, channels))


@pytest.mark.parametrize("frames", [2, 128, 130, 20002])
@pytest.mark.parametrize("channels", [1, 2, 3, 16])
@pytest.mark.parametrize("window", [1, 16, 1023])
def test_packed_matches_plain(dev, window, channels, frames):
    x = stream(dev, frames, channels)
    got = ps.windowed_averager_packed(x.view(torch.int32), window, channels)
    assert torch.equal(got.view(torch.int16), moving_average_ref(x, window, channels))


@pytest.mark.parametrize("frames", [1, 127, 8193, 300001])
@pytest.mark.parametrize("channels", [1, 2, 3, 16])
def test_cumsum_matches_plain(dev, channels, frames):
    x = stream(dev, frames, channels)
    assert torch.equal(ps.cumsum(x, channels), cumsum_ref(x, channels))


def test_cumsum_wraps_like_int32(dev):
    x = torch.full((1 << 20,), 32767, dtype=torch.int16, device=dev)
    want = (np.arange(1, (1 << 20) + 1, dtype=np.int64) * 32767).astype(np.int32)
    assert np.array_equal(ps.cumsum(x, 1).cpu().numpy(), want)


@pytest.mark.parametrize("window,channels", [(65535, 1), (65535, 16), (2000, 16)])
def test_two_pass_matches_plain(dev, window, channels):
    x = stream(dev, 70000, channels)
    got = ps.moving_average_two_pass(x, window, channels)
    assert torch.equal(got, moving_average_ref(x, window, channels))


@pytest.mark.parametrize("window,channels", [(65535, 1), (1024, 16), (3, 3)])
def test_int16_min(dev, window, channels):
    x = torch.full((100000 * channels,), -32768, dtype=torch.int16, device=dev)
    want = torch.from_numpy(moving_average_golden(x.cpu().numpy(), window, channels))
    assert torch.equal(moving_average(x, window, channels).cpu(), want)


def test_seeded_matches_suffix(dev):
    window, channels = 1024, 2
    x = stream(dev, 50000, channels)
    cut = 20000 * channels
    seed = x[cut - window * channels : cut]
    got = ps.windowed_averager(x[cut:], window, channels, seed=seed)
    assert torch.equal(got, moving_average_ref(x, window, channels)[cut:])


def test_streaming_on_the_card(dev):
    window, channels = 300, 2
    x = stream(dev, 100000, channels)
    state = moving_average_init(window, channels, device=dev)
    outs, i = [], 0
    for ln in [4096, 1000, 2, 0, 70000, 124902]:
        state, y = moving_average_chunk(state, x[i : i + ln], window, channels)
        outs.append(y)
        i += ln
    assert torch.equal(torch.cat(outs), moving_average_ref(x, window, channels))
