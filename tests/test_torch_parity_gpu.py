"""The parity slice on the card: the K-differential timer on B1, the planar DFT
functions, and F6, F7 and F8 on CUDA tensors.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_parity_gpu.py -q

``time_phases(chain=16)`` on B1 must give a finite, positive compute time and
launch B1 exactly as often as its chains ask; the DFT functions hold within
1e-4 of max|X| of NumPy's float64 transforms.
"""

import math

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.harness import time_phases
from digital_signal_processsing_tpu_torch.ops import (
    fft_mxu as fm,
    launch_counts,
    lpc,
    pallas_scan as ps,
    reset_launch_counts,
    signal,
    twod,
)

pytestmark = pytest.mark.cuda

DFT_RTOL = 1e-4  # of max|X|


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("chain", [1, 16])
def test_time_phases_chain_on_b1(dev, chain):
    x = np.random.default_rng(0).integers(-32768, 32768, size=1 << 24, dtype=np.int16)
    warmup, rounds = 1, 3
    reset_launch_counts()
    res = time_phases(lambda v: ps.windowed_averager(v, 1024, 2), x, warmup=warmup,
                      rounds=rounds, resident=True, chain=chain).averaged()
    assert math.isfinite(res.compute_ms) and res.compute_ms > 0 and res.h2d_ms == 0
    small = 0 if chain == 1 else max(chain // 4, 1)
    assert launch_counts()["B1"] == (1 + warmup) * chain + rounds * (chain + small)


def test_dft_functions_on_the_card(dev):
    rng = np.random.default_rng(1)
    xr, xi = (rng.standard_normal((4, 16384)).astype(np.float32) for _ in range(2))
    want = np.fft.fft(xr.astype(np.float64) + 1j * xi)
    for fn in (fm.dft_factored, fm.fft_large):
        re, im = fn(torch.from_numpy(xr).to(dev), torch.from_numpy(xi).to(dev))
        assert re.is_cuda and re.dtype == torch.float32
        got = re.cpu().numpy() + 1j * im.cpu().numpy()
        assert np.abs(got - want).max() <= DFT_RTOL * np.abs(want).max()
    hop, nfft = 128, 512
    x = rng.standard_normal((2, 40 * hop)).astype(np.float32)
    w = np.hanning(nfft)
    re, im = fm.rfft_dense_framed(torch.from_numpy(x).to(dev), 30, hop, nfft, w, detrend=True)
    fr = np.stack([x[:, i * hop : i * hop + nfft] for i in range(30)], 1).astype(np.float64)
    want = np.fft.rfft((fr - fr.mean(-1, keepdims=True)) * w, axis=-1)
    got = re.cpu().numpy() + 1j * im.cpu().numpy()
    assert np.abs(got - want).max() <= DFT_RTOL * np.abs(want).max()


def test_f6_f7_f8_on_the_card(dev):
    y = twod.convolve2d(torch.ones(2, 3, 6, device=dev), torch.ones(4, 2, device=dev), "valid")
    assert y.is_cuda and tuple(y.shape) == (2, 0, 5)
    c = signal.chirp(10.0, 100.0, 0)
    assert c.is_cuda and c.dtype == torch.float32 and tuple(c.shape) == (0,)
    a, k, err = lpc.levinson(np.array([[4.0, 2.0, 1.0, 0.5]], np.float32))
    assert a.is_cuda and k.is_cuda and err.is_cuda and float(a[0, 0]) == 1.0
