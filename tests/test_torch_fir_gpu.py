"""The fused overlap-save kernels (B8, B9) against their plain versions, on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_fir_gpu.py -q

Tolerance: 1e-5 of max|y| against the plain version (``torch.fft`` on the
same segments and spectrum), the JAX package's own bound between its fused
and composed overlap-save (tests/test_fft_mxu.py:97); 1e-4 against a
float64 direct FIR (test_fft_mxu.py:42).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch import _build
from digital_signal_processsing_tpu_torch.models import ChainConfig, DspChain
from digital_signal_processsing_tpu_torch.ops import fft_mxu as fm
from digital_signal_processsing_tpu_torch.ops import fir
from digital_signal_processsing_tpu_torch.utils import last_choice

pytestmark = pytest.mark.cuda

LAST_B8 = fm.FUSED_MAX_NFFT // 2 + 1
LAST_B9 = fm.FUSED3_MAX_NFFT // 2 + 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale else got.abs().max().item()


def case(dev, k, channels, t, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(channels, t)).astype(np.float32)).to(dev)
    h = (rng.normal(size=k) / np.sqrt(k)).astype(np.float32)
    g = fm.fused_geometry(k, fm.pick_fused_block(k))
    return x, h, fm.tap_response(h, g, dev)


def lengths(k, block):
    return sorted({1, max(1, k - 1), block, block + 1, 100_003})


def check_kernel(dev, k, channels, kernel):
    wrapper = fm.fused_fir if kernel == "B8" else fm.fused_fir3
    for t in lengths(k, fm.pick_fused_block(k)):
        x, h, r = case(dev, k, channels, t)
        assert r.geometry.kernel == kernel
        before = wrapper.launches
        got = wrapper(x, r)
        assert wrapper.launches == before + 1
        want = fm.overlap_save_plain(x, r)
        torch.cuda.synchronize()
        assert got.shape == want.shape and rel_err(got, want) < 1e-5, (k, channels, t)


@pytest.mark.parametrize("channels", [1, 3, 16])
@pytest.mark.parametrize("k", [1, 2, 63, 257, 4097, LAST_B8])
def test_b8_matches_plain(dev, k, channels):
    check_kernel(dev, k, channels, "B8")


@pytest.mark.parametrize("log2n", sorted(fm.B8_PLANS))
def test_every_b8_plan_matches_plain(dev, log2n):
    """Each Stockham plan (nfft 128 only at block 128 and one tap) against plain
    and a float64 FIR, on lengths that leave ragged pairs and blocks."""
    k = 1 if log2n == 7 else 1 << (log2n - 3)
    g = fm.fused_geometry(k, 128 if log2n == 7 else fm.pick_fused_block(k))
    assert g.log2n == log2n and g.kernel == "B8"
    rng = np.random.default_rng(log2n)
    h = (rng.normal(size=k) / np.sqrt(k)).astype(np.float32)
    r = fm.tap_response(h, g, dev)
    for channels, t in ((1, g.block - 1), (5, 3 * g.block + 7), (16, 50_001)):
        x = torch.from_numpy(rng.normal(size=(channels, t)).astype(np.float32)).to(dev)
        y = fm.fused_fir(x, r)
        assert rel_err(y, fm.overlap_save_plain(x, r)) < 1e-5, (channels, t)
        n = min(t, 300)
        xs = x[-1, max(0, t - n - k + 1):].double().cpu().numpy()
        xs = np.pad(xs, (max(0, n + k - 1 - xs.size), 0))
        want = np.convolve(xs, h.astype(np.float64), "valid")
        got = y[-1, t - n:].double().cpu().numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-4


def test_b8_kernel_attrs(dev):
    """The launch the wrapper asks for fits: at least one block an SM, the
    threads and shared bytes of the geometry; no local memory below nfft 16384
    (there the 512 threads' 128 registers hold the pair and a little spills)."""
    for log2n in sorted(fm.B8_PLANS):
        g = fm.FusedGeometry(k=2, block=1 << (log2n - 1), nfft=1 << log2n)
        regs, local, shared, blocks, threads = fm.fused_kernel_attrs(log2n)
        assert threads == g.threads and shared >= g.smem_bytes and blocks >= 1, log2n
        assert regs <= 255 and (local == 0 or log2n == 14), (log2n, regs, local)


def test_b9_kernel_attrs(dev):
    """B9's three launches at every nfft fit at least one block an SM with the
    geometry's threads and shared bytes; the column and output launches hold
    their lines without local memory."""
    for log2n in range(15, 21):
        g = fm.FusedGeometry(k=2, block=1 << (log2n - 1), nfft=1 << log2n)
        attrs = fm.fused3_kernel_attrs(g)
        for name, smem, threads in (("columns", g.column_smem_bytes, g.column_threads),
                                    ("rows", g.row_smem_bytes, fm.B9_ROW_THREADS),
                                    ("outputs", g.column_smem_bytes, g.column_threads)):
            regs, local, shared, blocks, t = attrs[name]
            assert t == threads and shared >= smem and blocks >= 1, (log2n, name, attrs[name])
            assert regs <= 255 and (local == 0 or name == "rows" or log2n == 20), (log2n, name, attrs[name])


@pytest.mark.parametrize("log2n", range(15, 21))
def test_b9_every_nfft_matches_plain(dev, log2n):
    nfft = 1 << log2n
    k = nfft // 4
    rng = np.random.default_rng(log2n)
    h = (rng.standard_normal(k) / np.sqrt(k)).astype(np.float32)
    r = fm.tap_response(h, fm.fused_geometry(k, (nfft - k + 1) // 128 * 128), dev)
    x = torch.from_numpy(rng.standard_normal((3, 2 * nfft + 17), dtype=np.float32)).to(dev)
    assert rel_err(fm.fused_fir3(x, r), fm.overlap_save_plain(x, r)) < 1e-5


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("k", [LAST_B8 + 1, 65537, LAST_B9])
def test_b9_matches_plain(dev, k, channels):
    check_kernel(dev, k, channels, "B9")


@pytest.mark.parametrize("k", [257, LAST_B8, LAST_B8 + 1, 65537])
def test_against_float64_fir(dev, k):
    x, h, r = case(dev, k, 3, 200_000, seed=1)
    y = fm.overlap_save_fused(x, h, block=r.geometry.block, response=r)[:, -300:].cpu().numpy()
    xs = x[:, -(300 + k - 1):].cpu().double().numpy()
    want = np.stack([np.convolve(row, h.astype(np.float64), "valid") for row in xs])
    assert np.abs(y - want).max() / np.abs(want).max() < 1e-4


@pytest.mark.parametrize("k", [63, LAST_B8, LAST_B8 + 1, 65537])
def test_impulse_gives_the_taps_and_zeros_give_zeros(dev, k):
    _, h, r = case(dev, k, 1, 1)
    t = 3 * r.geometry.block + 5
    x = torch.zeros(3, t, device=dev)
    starts = [0, r.geometry.block - 1, t - k // 2 - 1]  # at the start, across a segment edge
    for c, p in enumerate(starts):
        x[c, p] = 1.0
    y = fm.overlap_save_fused(x, h, block=r.geometry.block, response=r).cpu().numpy()
    for c, p in enumerate(starts):
        want = np.zeros(t, np.float32)
        n = min(k, t - p)
        want[p : p + n] = h[:n]
        assert np.abs(y[c] - want).max() < 1e-5 * np.abs(h).max(), (k, c, p)
    zero = fm.overlap_save_fused(torch.zeros_like(x), h, block=r.geometry.block, response=r)
    assert torch.count_nonzero(zero).item() == 0


def test_fir_filter_routes_on_the_card(dev):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(4, 300_000)).astype(np.float32)).to(dev)
    for k, kernel in ((fir.FIR_FFT_CROSSOVER + 1, "B8"), (LAST_B8, "B8"), (LAST_B8 + 1, "B9")):
        h = (rng.normal(size=k) / np.sqrt(k)).astype(np.float32)
        wrapper = fm.fused_fir if kernel == "B8" else fm.fused_fir3
        before = wrapper.launches
        y = fir.fir_filter(x, h)
        assert last_choice("fir_filter") == "overlap_save_fused"
        assert wrapper.launches == before + 1
        assert rel_err(y, fir.fir_filter(x.cpu(), h).to(dev)) < 1e-5


def test_conv1d_runs_in_ieee_fp32(dev):
    # TF32 keeps 10 mantissa bits (about 1e-3 relative); IEEE float32 about 1e-7
    def setting():
        conv = getattr(torch.backends.cudnn, "conv", None)
        if conv is not None and hasattr(conv, "fp32_precision"):
            return conv.fp32_precision
        return torch.backends.cudnn.allow_tf32

    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 100_000)).astype(np.float32)
    h = (rng.normal(size=257) / 16).astype(np.float32)
    before = setting()
    got = fir.fir_direct(torch.from_numpy(x).to(dev), h).cpu().numpy()
    assert setting() == before  # restored: never changed globally
    want = np.stack([np.convolve(row.astype(np.float64), h.astype(np.float64))[:100_000] for row in x])
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


def test_chain_on_the_card_matches_the_cpu(dev):
    for taps in (65, 4097):
        cfg = ChainConfig(channels=4, decimation=4, channel_taps=taps, audio_taps=33)
        i, q = DspChain(cfg, device="cpu").example_planar_input(t=1 << 15)
        want = DspChain(cfg, device="cpu").forward_planar(torch.from_numpy(i), torch.from_numpy(q))
        got = DspChain(cfg, device=dev).forward_planar(
            torch.from_numpy(i).to(dev), torch.from_numpy(q).to(dev)
        )
        ramp = (taps + 8 * 4) // 4 + 33
        np.testing.assert_allclose(
            got.cpu().numpy()[:, ramp:], want.numpy()[:, ramp:], rtol=1e-3, atol=1e-4
        )


def test_a_kernel_that_cannot_build_raises(dev, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "library", broken)
    x, h, r = case(dev, 257, 2, 5000)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fm.fused_fir(x, r)
    x, h, r = case(dev, LAST_B8 + 1, 2, 5000)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fm.fused_fir3(x, r)
