"""The anchors B11 and B14 against their plain versions and scipy, on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_iir_anchors_gpu.py -q

Tolerance: 1e-5 of max|y| against the plain versions (B10's and B12's, the
same recurrences summed in another order) and 1e-4 against scipy's float64
filter with the same float32 coefficients, the port's bounds for its IIR
kernels.
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu_torch import _build
from digital_signal_processsing_tpu_torch.ops import iir, iir_design, launch_counts, reset_launch_counts

pytestmark = pytest.mark.cuda

SUB = iir.SUB_TILE
LENGTHS = (1, iir.MXU_SEG + 1, iir.MXU_SUB - 1, SUB - 1, SUB, SUB + 1, 100_003)
TOL, TOL64 = 1e-5, 1e-4


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


def signal(dev, channels, t, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(channels, t)).astype(np.float32)).to(dev)


def designs():
    return {
        "butter": iir_design.iirfilter(8, 0.1),
        "cheby2": iir_design.iirfilter(6, 0.2, ftype="cheby2", rs=50.0),
        "ellip": iir_design.iirdesign(0.1, 0.15, 0.5, 60.0, ftype="ellip"),
    }


@pytest.mark.parametrize("a", [0.5, -0.3, 0.99, 0.9999])
@pytest.mark.parametrize("channels", [1, 3, 16])
def test_b11_against_plain_and_scipy(dev, a, channels):
    for t in LENGTHS:
        x = signal(dev, channels, t)
        y = iir.iir1_affine_scan(x, a, 0.7)
        assert rel_err(y, iir._iir1_plain(x, a, 0.7)) < TOL, t
        want = sps.lfilter([float(np.float32(0.7))], [1.0, -float(np.float32(a))],
                           x.double().cpu().numpy(), axis=-1)
        assert rel_err(y, want) < TOL64, t


@pytest.mark.parametrize("name", ["butter", "cheby2", "ellip"])
@pytest.mark.parametrize("channels", [1, 3, 16])
def test_b14_against_plain_and_scipy(dev, name, channels):
    sos = np.asarray(designs()[name], np.float32)
    for t in LENGTHS:
        x = signal(dev, channels, t)
        y = iir.sos_cascade_mxu(x, sos)
        assert rel_err(y, iir._sos_plain(x, sos, None)[0]) < TOL, t
        want = sps.sosfilt(sos.astype(np.float64), x.double().cpu().numpy(), axis=-1)
        assert rel_err(y, want) < TOL64, t


@pytest.mark.parametrize("sections", [1, 2, 4, 8, iir.MAX_SECTIONS])
def test_b14_by_sections_and_tile(dev, sections):
    """At 16 sections of butter(32, 0.1) (poles at radius 0.985) the plain
    float32 recurrence lies more than 1e-5 of max|y| from float64 and B14,
    whose lane pass is float64, nearer (chip_smoke.py phase 3 prints both):
    B14 is held to plain within 1e-5 plus plain's own error, and to float64
    within the larger of 1e-5 and plain's error (to 1%, so that equal errors
    pass)."""
    sos = iir.design_butterworth(2 * sections, 0.1)
    x = signal(dev, 3, 5 * SUB + 17)
    plain = iir._sos_plain(x, sos, None)[0]
    want = sps.sosfilt(sos.astype(np.float64), x.double().cpu().numpy(), axis=-1)
    e_plain = rel_err(plain, want)
    for tile_rows in (None, 32, 64):
        y = iir.sos_cascade_mxu(x, sos, tile_rows=tile_rows)
        assert rel_err(y, plain) < TOL + e_plain
        assert rel_err(y, want) < max(TOL, 1.01 * e_plain)


@pytest.mark.parametrize("channels,t", [(9, 7 * SUB + 5), (1, 3), (17, iir.MXU_SUB)])
def test_b14_warp_tasks_and_tiles(dev, channels, t):
    """Channel and tile counts that leave a block's last warps idle, and tiles
    of one sub-tile, against plain: every (channel, tile) task runs once."""
    sos = np.asarray(designs()["ellip"], np.float32)
    x = signal(dev, channels, t, seed=channels)
    for tile_rows in (None, 32):
        y = iir.sos_cascade_mxu(x, sos, tile_rows=tile_rows)
        assert rel_err(y, iir._sos_plain(x, sos, None)[0]) < TOL, tile_rows


def test_b14_kernel_attrs(dev):
    """B14's tile kernel at 1 to 16 sections: 8 warps, at least one block an SM
    (two up to 8 sections), its T staged whole within the 227 KB a block has."""
    for sections in (1, 5, 8, iir.MAX_SECTIONS):
        regs, local, shared, blocks, warps = iir.mxu_kernel_attrs(sections)
        assert warps == iir.MXU_WARPS and regs <= 128 and shared <= 227 * 1024, sections
        assert blocks >= (2 if sections <= 8 else 1), (sections, blocks)


def test_entry_points_launch_the_anchors(dev):
    sos = np.asarray(designs()["ellip"], np.float32)
    x = signal(dev, 4, 3 * SUB + 5)
    reset_launch_counts()
    y11 = iir.iir_first_order_pallas(x, 0.995, kernel="tile")
    y14 = [iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu", row_pass=rp)
           for rp in ("bcast", "compact")]
    counts = launch_counts()
    assert counts["B11"] == 1 and counts["B14"] == 2 and counts["B10"] == counts["B12"] == 0
    assert rel_err(y11, iir._iir1_plain(x, 0.995, 1.0)) < TOL
    for y in y14:
        assert rel_err(y, iir._sos_plain(x, sos, None)[0]) < TOL


def test_impulses_and_zeros(dev):
    sos = np.asarray(designs()["ellip"], np.float32)
    t = 3 * SUB + 5
    x = torch.zeros(5, t, device=dev)
    for c, p in enumerate((0, iir.MXU_SEG - 1, iir.MXU_SUB, SUB, t - 100)):
        x[c, p] = 1.0
    want = sps.sosfilt(sos.astype(np.float64), x.double().cpu().numpy(), axis=-1)
    assert rel_err(iir.sos_cascade_mxu(x, sos), want) < TOL
    want1 = sps.lfilter([1.0], [1.0, -float(np.float32(0.99))], x.double().cpu().numpy(), axis=-1)
    assert rel_err(iir.iir1_affine_scan(x, 0.99), want1) < TOL
    zero = torch.zeros_like(x)
    assert not torch.count_nonzero(iir.sos_cascade_mxu(zero, sos)).item()
    assert not torch.count_nonzero(iir.iir1_affine_scan(zero, 0.9999)).item()


def test_refusals(dev):
    x = signal(dev, 2, 100)
    with pytest.raises(ValueError, match="B14"):  # no section (17 take two groups)
        iir.sos_cascade_mxu(x, np.zeros((0, 6), np.float32))
    with pytest.raises(TypeError, match="float32"):
        iir.iir1_affine_scan(x.double(), 0.5)
    with pytest.raises(ValueError, match="contiguous"):
        iir.sos_cascade_mxu(x.t().contiguous().t(), iir.design_butterworth(2, 0.1))


def test_build_failure_raises(dev, monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "library", broken)
    x = signal(dev, 2, 1000)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        iir.iir1_affine_scan(x, 0.5)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        iir.sos_cascade_mxu(x, iir.design_butterworth(4, 0.1))
