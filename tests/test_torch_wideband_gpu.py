"""The PFB kernels (B19, B20) and the Farrow kernel (B21) against their plain versions, on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_wideband_gpu.py -q

Tolerances, relative to max|y|: 1e-5 for B19 and B20 (the JAX package's
bound between its fused and composed PFB, tests/test_channelizer.py:176-177),
2e-5 for B21 (its bound for the segment kernel, tests/test_farrow.py:208-209).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.models import WidebandConfig, WidebandFmReceiver
from digital_signal_processsing_tpu_torch.ops import channelizer as ch
from digital_signal_processsing_tpu_torch.ops import farrow as fw
from digital_signal_processsing_tpu_torch.ops import pfb_os
from digital_signal_processsing_tpu_torch.utils import last_choice

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(got, want) -> float:
    got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale else got.abs().max().item()


def plain_pfb(src, raw, n, hq, sign, d, layout):
    u = ch.commutate(src, n) if raw else src
    out = ch._pfb_plain(u, hq, sign, d, layout)
    return out if layout == "complex" else tuple(o.contiguous() for o in out)


@pytest.mark.parametrize("n", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("p,d", [(2, 1), (8, 1), (16, 2)])
def test_b19_matches_plain(dev, n, p, d):
    rng = np.random.default_rng(n + p)
    hq = torch.from_numpy(rng.normal(size=(p, n)).astype(np.float32)).to(dev)
    rows = ch.pfb_rows(n)
    for m in (1, rows, 3 * rows + 1, 2 * p * d + 5):
        if not ch.raw_envelope(m * n, n):
            continue
        x = torch.from_numpy(rng.normal(size=m * n).astype(np.float32)).to(dev)
        for layout in ch.LAYOUTS:
            before = ch.fused_pfb_raw.launches
            got = ch.fused_pfb_raw(x, n, hq, dilation=d, layout=layout)
            assert ch.fused_pfb_raw.launches == before + 1
            want = plain_pfb(x, True, n, hq, 1, d, layout)
            torch.cuda.synchronize()
            for g, w in zip(got, want) if layout != "complex" else ((got, want),):
                assert rel_err(g, w) < 1e-5, (n, p, d, m, layout)


# every plan: each power of two 2..8192, the radix-3 route 3 * 2^a up to 6144, and
# the direct DFT (1 and odd n)
B20_NS = [1 << e for e in range(1, 14)] + [3 << e for e in range(12)] + [1, 7]


@pytest.mark.parametrize("n", B20_NS)
@pytest.mark.parametrize("sign,d", [(1, 1), (-1, 2)])
def test_b20_matches_plain(dev, n, sign, d):
    rng = np.random.default_rng(n)
    for p in (2, 8, 16):
        hq = torch.from_numpy(rng.normal(size=(p, n)).astype(np.float32)).to(dev)
        for m in (1, 5, 777, 4099) if n <= 1024 else (1, 5, 3 * ch.pfb_rows(n) + 1):
            u = torch.from_numpy(rng.normal(size=(m, n)).astype(np.float32)).to(dev)
            re, im = ch.fused_branch_dft(u, hq, sign=sign, dilation=d)
            wre, wim = plain_pfb(u, False, n, hq, sign, d, "rows")
            torch.cuda.synchronize()
            scale = max(wre.abs().max().item(), wim.abs().max().item())
            assert (re - wre).abs().max().item() < 1e-5 * scale, (n, p, m)
            assert (im - wim).abs().max().item() < 1e-5 * scale, (n, p, m)


# the main path's plans: B19 at 64 and 1024 channels, B20 at 64 (dilation 2) and 48
MAIN_PLANS = (("B19", 64, 1), ("B19", 1024, 1), ("B20", 64, 2), ("B20", 48, 1))


@pytest.mark.parametrize("kind,n,d", MAIN_PLANS)
def test_pfb_kernel_attrs(dev, kind, n, d):
    """No local memory at the main path's plans; 256 threads, two blocks an SM."""
    regs, local, shared, blocks, threads = ch.pfb_kernel_attrs(kind, n, 8, d)
    g = ch.pfb_geometry(n, 8, d, kind == "B19", 1)
    assert threads == ch.PFB_THREADS and local == 0 and regs <= 128
    assert shared >= g.smem_bytes and blocks >= 2


def test_zeros_stay_zero(dev):
    hq = torch.randn(8, 64, device=dev)
    re, im = ch.fused_pfb_raw(torch.zeros(64 * 1000, device=dev), 64, hq)
    y = ch.fused_branch_dft(torch.zeros(1000, 48, device=dev), torch.randn(8, 48, device=dev),
                            layout="complex")
    torch.cuda.synchronize()
    assert not re.any() and not im.any() and not y.any()


@pytest.mark.parametrize("rate", [(46337, 65521), (46349, 65521), (46351, 65537), (3, 7),
                                  (48000, 44100), np.pi / 3])
@pytest.mark.parametrize("c", [1, 2, 16])
def test_b21_matches_plain(dev, rate, c):
    up, down = fw.as_rational_rate(rate)
    rng = np.random.default_rng(c)
    for t in (4, 5, 100, 1 << 20):
        x = torch.from_numpy(rng.normal(size=(c, t)).astype(np.float32)).to(dev)
        before = fw.resample_farrow_segmented.launches
        y = fw.resample_farrow_segmented(x, rate)
        assert fw.resample_farrow_segmented.launches == before + 1
        want = fw.segmented_plain(x, up, down, fw.farrow_output_len(t, rate))
        torch.cuda.synchronize()
        assert rel_err(y, want) < 2e-5, (rate, c, t)


def test_routes_on_the_card(dev):
    rx = WidebandFmReceiver(WidebandConfig(n_channels=64), device=dev)
    audio = rx(torch.randn(64 * 4096, device=dev))
    assert audio.shape == (64, 4096) and last_choice("pfb_channelize") == "fused_raw"
    ch.pfb_channelize(torch.randn(48 * 64, device=dev), 48)
    assert last_choice("pfb_channelize") == "fused"
    before = ch.fused_branch_dft.launches
    pfb_os.pfb_analyze_os(torch.randn(32 * 100, device=dev), 64, ch.design_prototype(64))
    assert ch.fused_branch_dft.launches == before + 1
    for rate in ((46337, 65521), (441, 2560), (160, 147)):
        before = fw.resample_farrow_segmented.launches
        fw.resample_farrow(torch.randn(2, 10_000, device=dev), rate)
        assert last_choice("resample_farrow") == "segmented"
        assert fw.resample_farrow_segmented.launches == before + 1
