"""The IIR kernels (B10, B12, B13, B15) against their plain versions, on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_iir_gpu.py -q

Tolerance: 1e-5 of max|y| against the plain version (the same recurrence in
PyTorch, its tile carry summed in another order); 1e-4 against scipy's
float64 filter with the same float32 coefficients, the FIR's bound on the
card.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu_torch import _build
from digital_signal_processsing_tpu_torch.ops import gain, iir
from digital_signal_processsing_tpu_torch.ops.resample import decimate
from digital_signal_processsing_tpu_torch.serve import stream_sosfilt
from digital_signal_processsing_tpu_torch.io import read_wav, write_wav
from digital_signal_processsing_tpu_torch.utils import last_choice

pytestmark = pytest.mark.cuda

SUB = iir.SUB_TILE
LENGTHS = (1, SUB - 1, SUB, SUB + 1, 3 * SUB + 77, 100_003)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rel_err(got, want) -> float:
    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    assert got.shape == want.shape
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale if scale else got.abs().max().item()


def sos_of(sections: int) -> np.ndarray:
    return iir.design_butterworth(2 * sections, 0.1)


def case(dev, channels, t, sections, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(channels, t)).astype(np.float32)).to(dev)
    st = torch.from_numpy((0.3 * rng.normal(size=(sections, channels, 2))).astype(np.float32))
    return x, st.to(dev)


def scipy64(sos, x, zi=None):
    s64 = np.asarray(sos, np.float32).astype(np.float64)
    x64 = x.double().cpu().numpy()
    if zi is None:
        return sps.sosfilt(s64, x64, axis=-1)
    return sps.sosfilt(s64, x64, axis=-1, zi=zi.double().cpu().numpy())


@pytest.mark.parametrize("channels", [1, 3, 16])
@pytest.mark.parametrize("sections", [1, 2, 4, 8])
def test_b12_matches_plain(dev, sections, channels):
    sos = sos_of(sections)
    for t in LENGTHS:
        x, st = case(dev, channels, t, sections)
        before = iir.sos_cascade.launches
        y, _ = iir.sos_cascade(x, sos)
        ys, end = iir.sos_cascade(x, sos, st)
        assert iir.sos_cascade.launches == before + 2
        y_plain, _ = iir._sos_plain(x, sos, None)
        ys_plain, end_plain = iir._sos_plain(x, sos, st)
        torch.cuda.synchronize()
        assert rel_err(y, y_plain) < 1e-5, (sections, channels, t)
        assert rel_err(ys, ys_plain) < 1e-5, (sections, channels, t)
        scale = ys_plain.abs().max().item()
        assert (end - end_plain).abs().max().item() < 1e-5 * scale, (sections, channels, t)
        want, zf = scipy64(sos, x, st)
        assert rel_err(ys, want) < 1e-4
        assert np.abs(end.double().cpu().numpy() - zf).max() < 1e-4 * np.abs(want).max()


def test_b12_is_deterministic(dev):
    # the look-back's depth is fixed: the same terms in the same order, whichever
    # tiles publish first
    sos = sos_of(4)
    x, st = case(dev, 16, 1 << 20, 4, seed=11)
    for state in (None, st):
        y1, e1 = iir.sos_cascade(x, sos, state)
        y2, e2 = iir.sos_cascade(x, sos, state)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2)
        assert state is None or torch.equal(e1, e2)


def test_b12_kernel_attrs(dev):
    # no local memory up to 8 sections; past them the instance keeping 32 partial
    # sums a lane spills under its 80 registers (40 bytes on an H100, PERF.md)
    for sections in (1, 4, 5, 8, 16):
        regs, local, smem, blocks = iir.cascade_kernel_attrs(sections)
        assert local <= (0 if sections <= 8 else 40), (sections, local)
        assert 0 < regs <= 255 and blocks >= 1 and smem > 0
    for sections in range(1, iir.MAX_UNROLLED + 1):  # B13's instances
        regs, local, smem, blocks = iir.cascade_kernel_attrs(sections, unrolled=True)
        assert 0 < regs <= 255 and blocks >= 1 and smem > 0, sections


@pytest.mark.parametrize("sections", range(1, 9))
def test_b13_matches_plain(dev, sections):
    sos = sos_of(sections)
    for t in (1, SUB + 1, 100_003):
        x, _ = case(dev, 3, t, sections, seed=sections)
        before = iir.sos_cascade_unrolled.launches
        y = iir.sos_cascade_unrolled(x, sos)
        assert iir.sos_cascade_unrolled.launches == before + 1
        assert rel_err(y, iir._sos_plain(x, sos, None)[0]) < 1e-5, (sections, t)
        assert rel_err(y, scipy64(sos, x)) < 1e-4
        assert torch.equal(iir.sos_cascade_unrolled(x, sos), y)  # the look-back's fixed order


@pytest.mark.parametrize("sections", [1, 4, 8])
def test_b15_matches_plain(dev, sections):
    sos = sos_of(sections)
    for t in (1, SUB, 3 * SUB + 77, 100_003):
        x, st = case(dev, 3, t, sections, seed=t)
        before = iir.sos_sections.launches
        y, end = iir.sos_sections(x, sos, st)
        assert iir.sos_sections.launches == before + 1
        y_plain, end_plain = iir._sections_plain(x, sos, st)
        torch.cuda.synchronize()
        assert rel_err(y, y_plain) < 1e-5, (sections, t)
        assert (end - end_plain).abs().max().item() < 1e-5 * y_plain.abs().max().item()


@pytest.mark.parametrize("a", [0.5, -0.3, 0.99, 0.9999])
def test_b10_matches_plain(dev, a):
    for channels in (1, 16):
        for t in LENGTHS:
            x, _ = case(dev, channels, t, 1)
            before = iir.iir1_block_scan.launches
            y = iir.iir1_block_scan(x, a, 0.7)
            assert iir.iir1_block_scan.launches == before + 1
            assert rel_err(y, iir._iir1_plain(x, a, 0.7)) < 1e-5, (a, channels, t)
            a32, b32 = float(np.float32(a)), float(np.float32(0.7))
            want = sps.lfilter([b32], [1.0, -a32], x.double().cpu().numpy(), axis=-1)
            assert rel_err(y, want) < 1e-4


def test_seeded_chunks_continue_one_shot(dev):
    sos = sos_of(4)
    x, _ = case(dev, 16, 1 << 20, 4, seed=5)
    y_one, end_one = iir.sos_cascade(x, sos, torch.zeros(4, 16, 2, device=dev))
    st = torch.zeros(4, 16, 2, device=dev)
    outs = []
    for a, b in ((0, 1), (1, SUB + 3), (SUB + 3, 500_001), (500_001, 1 << 20)):
        st, y = iir.sosfilt_chunk(st, sos, x[:, a:b], method="pallas_fused")
        outs.append(y)
    assert rel_err(torch.cat(outs, 1), y_one) < 1e-5
    assert (st - end_one).abs().max().item() < 1e-5 * y_one.abs().max().item()


def test_impulse_and_zeros(dev):
    sos = sos_of(4)
    t = 3 * SUB + 5
    x = torch.zeros(4, t, device=dev)
    for c, p in enumerate((0, SUB - 1, SUB, t - 100)):
        x[c, p] = 1.0
    for run in (lambda v: iir.sos_cascade(v, sos)[0], lambda v: iir.sos_cascade_unrolled(v, sos),
                lambda v: iir.sos_sections(v, sos)[0]):
        y = run(x)
        assert rel_err(y, scipy64(sos, x)) < 1e-5
        assert torch.count_nonzero(y[1, : SUB - 1]).item() == 0  # nothing before the impulse
        assert torch.count_nonzero(run(torch.zeros_like(x))).item() == 0
    assert torch.count_nonzero(iir.iir1_block_scan(torch.zeros_like(x), 0.99)).item() == 0


def test_routes_and_callers_on_the_card(dev):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3, 300_000)).astype(np.float32)).to(dev)
    sos = sos_of(4)
    xc = x.cpu()
    for method in ("auto", "pallas_fused", "pallas", "xla_scan"):
        y = iir.sosfilt(sos, x, method=method)
        assert rel_err(y, iir.sosfilt(sos, xc, method="xla_scan")) < 1e-5
    assert rel_err(gain.dc_block(x), gain.dc_block(xc)) < 1e-5
    assert rel_err(gain.agc(x), gain.agc(xc)) < 1e-5
    assert rel_err(iir.sosfiltfilt(sos, x[0]), iir.sosfiltfilt(sos, xc[0])) < 1e-5
    assert rel_err(decimate(x, 4, ftype="iir"), decimate(xc, 4, ftype="iir")) < 1e-5


def test_stream_sosfilt_on_the_card(dev, tmp_path):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(2 * 300_001) * 8000).astype(np.int16)
    write_wav(tmp_path / "a.wav", x[:400_000], 16000, 2)
    write_wav(tmp_path / "b.wav", x[400_000:], 16000, 2)
    sos = iir.design_butterworth(6, 0.15)
    paths = [tmp_path / "a.wav", tmp_path / "b.wav"]
    n = stream_sosfilt(paths, tmp_path / "gpu.wav", sos, chunk_samples=1 << 17, device="cuda")
    assert last_choice("sosfilt_chunk") == "pallas_fused"
    stream_sosfilt(paths, tmp_path / "cpu.wav", sos, chunk_samples=1 << 17, device="cpu")
    _, got = read_wav(tmp_path / "gpu.wav")
    _, want = read_wav(tmp_path / "cpu.wav")
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert n == x.size and diff.max() <= 1 and (diff > 0).mean() < 2e-3


def test_refusals_on_the_card(dev, monkeypatch):
    x, _ = case(dev, 2, 5000, 1)
    with pytest.raises(ValueError, match="B13"):
        iir.sos_cascade_unrolled(x, np.zeros((0, 6), np.float32))
    with pytest.raises(ValueError, match="B12"):
        iir.sos_cascade(x, np.zeros((0, 6), np.float32))
    # past the largest instances the wrappers chain groups, a launch each
    for fn, sos, groups in ((iir.sos_cascade_unrolled, sos_of(9), 2),
                            (lambda v, s: iir.sos_cascade(v, s)[0], np.tile(sos_of(1), (17, 1)), 2),
                            (iir.sos_cascade_mxu, np.tile(sos_of(1), (17, 1)), 2)):
        counts = (iir.sos_cascade.launches, iir.sos_cascade_unrolled.launches,
                  iir.sos_cascade_mxu.launches)
        y = fn(x, sos)
        after = (iir.sos_cascade.launches, iir.sos_cascade_unrolled.launches,
                 iir.sos_cascade_mxu.launches)
        assert sum(after) - sum(counts) == groups
        assert rel_err(y, iir._sos_plain(x, sos, None)[0]) < 1e-5

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "library", broken)
    for call in (lambda: iir.sos_cascade(x, sos_of(2)), lambda: iir.sos_cascade_unrolled(x, sos_of(2)),
                 lambda: iir.sos_sections(x, sos_of(2)), lambda: iir.iir1_block_scan(x, 0.9)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
