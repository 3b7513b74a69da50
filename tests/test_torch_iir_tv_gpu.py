"""The time-varying IIR kernels (B16, B17, B18) and the LPC kernel (B22) on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_iir_tv_gpu.py -q

Tolerance: 1e-5 of max|y| against the plain version (the same recurrence in
PyTorch, its tile carry summed in another order) and against a float64 NumPy
sample loop with the same float32 rows. B22 against its plain version: bit
for bit (both subtract the same products in the same order, each rounded).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.models import tracking_notch
from digital_signal_processsing_tpu_torch.ops import iir, lpc
from digital_signal_processsing_tpu_torch.ops import launch_counts, reset_launch_counts
from digital_signal_processsing_tpu_torch.utils import last_choice

pytestmark = pytest.mark.cuda

TOL = 1e-5
SUB = iir.SUB_TILE
LENGTHS = (1, iir.THREADS * iir.TV_SEG - 1, SUB, 3 * SUB + 77)


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


def schedule(rng, sections, coef_channels, rows, a0=1.25):
    """Swept resonators (S, Cc, rows, 6), peak gain about 1 (b = (1 - r^2)/2), a0 != 1:
    a cascade of 17 keeps its output near the input's size."""
    f = np.linspace(0, 3, rows)
    out = np.empty((sections, coef_channels, rows, 6), np.float32)
    for k in range(sections):
        for c in range(coef_channels):
            ph = rng.uniform(0, 6)
            r = 0.5 + 0.4 * np.sin(f + ph)
            th = 0.3 + 0.2 * np.cos(2 * f + ph)
            g = (1 - r * r) / 2
            out[k, c] = np.stack([g, 0.2 * g * np.sin(5 * f + ph), -g, np.ones(rows),
                                  -2 * r * np.cos(th), r * r], -1) * a0
    return out


def tv64(x, rows4, frame_len, state=None):
    """Float64 sample loop over channels: (y, end state). The rows are divided by
    their a0 in float32 as the kernels divide them (a reciprocal, then products)."""
    x = x.double().cpu().numpy()
    r = rows4.float().cpu().numpy()
    r = (r * (np.float32(1) / r[..., 3:4])).astype(np.float64)
    r[..., 3] = 1.0
    c, t = x.shape
    s = r.shape[0]
    st = np.zeros((s, c, 2)) if state is None else state.double().cpu().numpy().copy()
    y = np.empty_like(x)
    for j in range(t):
        u = x[:, j]
        for k in range(s):
            b0, b1, b2, a0, a1, a2 = np.moveaxis(r[k, :, j // frame_len], -1, 0)
            b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
            yo = b0 * u + st[k, :, 0]
            st[k, :, 0], st[k, :, 1] = b1 * u - a1 * yo + st[k, :, 1], b2 * u - a2 * yo
            u = yo
        y[:, j] = u
    return torch.from_numpy(y), torch.from_numpy(st)


def case(dev, rng, channels, t, sections, shared, frame_len=1):
    x = torch.from_numpy(rng.normal(size=(channels, t)).astype(np.float32)).to(dev)
    rows = schedule(rng, sections, 1 if shared else channels, -(-t // frame_len))
    st = torch.from_numpy((0.3 * rng.normal(size=(sections, channels, 2))).astype(np.float32))
    return x, torch.from_numpy(rows).to(dev), st.to(dev)


def check(kernel, plain, x, rows, frame_len, st, label, ref64):
    y, _ = kernel(x, rows)
    ys, end = kernel(x, rows, st)
    yp, _ = plain(x, rows, frame_len, None)
    ysp, endp = plain(x, rows, frame_len, st)
    torch.cuda.synchronize()
    assert rel_err(y, yp) < TOL, label
    assert rel_err(ys, ysp) < TOL, label
    scale = ysp.abs().max().item()
    assert (end - endp).abs().max().item() <= TOL * scale, label
    if ref64:
        want, zf = tv64(x, rows, frame_len, st)
        assert rel_err(ys, want) < TOL, label
        assert (end.double().cpu() - zf).abs().max().item() <= TOL * want.abs().max().item(), label


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("sections", [1, 2, 4, 6, 16, 17])
def test_b16_matches_plain_and_float64(dev, sections, shared):
    rng = np.random.default_rng(sections)
    for channels in (1, 64):
        for t in LENGTHS if sections <= 6 else (1, LENGTHS[-1]):
            x, rows, st = case(dev, rng, channels, t, sections, shared)
            before = iir.tv_cascade.launches
            check(iir.tv_cascade, iir._tv_plain, x, rows, 1, st, (sections, channels, t, shared),
                  channels == 1 or t < SUB)
            assert iir.tv_cascade.launches == before + 2


@pytest.mark.parametrize("shared", [True, False])
def test_b17_matches_plain_and_float64(dev, shared):
    rng = np.random.default_rng(17)
    for channels in (1, 64):
        for t in LENGTHS + (100_003,):
            x, rows, st = case(dev, rng, channels, t, 1, shared)
            check(iir.tv_section, iir._tv_plain, x, rows, 1, st, (channels, t, shared),
                  channels == 1 and t < 50_000)


@pytest.mark.parametrize("frame_len", [100, 256, 1024, 65536])
@pytest.mark.parametrize("sections", [1, 4, 17])
def test_b18_matches_plain_and_float64(dev, frame_len, sections):
    rng = np.random.default_rng(frame_len + sections)
    for channels, t, shared in ((1, 3 * SUB + 77, True), (64, 2 * SUB + 5, False),
                                (3, 3 * 65536 + 99, True)):
        x, rows, st = case(dev, rng, channels, t, sections, shared, frame_len)
        kernel = lambda x, r, s=None: iir.tv_frames_cascade(x, r, frame_len, s)  # noqa: E731
        check(kernel, iir._tv_plain, x, rows, frame_len, st, (frame_len, channels, t, shared),
              t < 70_000 and sections < 17)


@pytest.mark.parametrize("frame_len, route", [(256, "state"), (768, "state"), (100, "compose"),
                                               (1000, "compose")])
def test_b18_routes_match_plain_and_float64(dev, frame_len, route):
    """B18 on both sides of its state route's condition (frame_len a multiple of a
    warp's 256 samples; 768 puts frame edges inside sub-tiles), rows shared by
    five channels (a column group of three and one of two) and per channel."""
    rng = np.random.default_rng(frame_len)
    for channels, shared in ((5, True), (5, False)):
        x, rows, st = case(dev, rng, channels, 3 * SUB + 77, 2, shared, frame_len)
        kernel = lambda x, r, s=None: iir.tv_frames_cascade(x, r, frame_len, s)  # noqa: E731
        check(kernel, iir._tv_plain, x, rows, frame_len, st, (frame_len, shared), True)
        assert iir.tv_frames_cascade.route == route


def test_tile_kernels_keep_three_blocks_an_sm(dev):
    """Every tile kernel of csrc/iir_tv.cu within 80 registers, three blocks an SM."""
    for shared in (True, False):
        for name, (regs, _, smem, blocks, cols) in iir.tv_kernel_attrs(4, shared).items():
            assert regs <= 80 and blocks >= 3, (name, shared, regs, smem, blocks)
            assert cols == (1 if not shared else 4 if name == "B18 state" else 3), name


def test_tiles_and_impulses(dev):
    rng = np.random.default_rng(3)
    t = 5 * SUB + 11
    rows = torch.from_numpy(schedule(rng, 4, 1, t)).to(dev)
    x = torch.zeros(4, t, device=dev)
    for c, p in enumerate((0, SUB - 1, SUB, t - 100)):
        x[c, p] = 1.0
    for tile_rows in (None, 32, 64):
        y, _ = iir.tv_cascade(x, rows, tile_rows=tile_rows)
        want, _ = tv64(x, rows, 1)
        assert rel_err(y, want) < TOL, tile_rows
    zero = torch.zeros_like(x)
    y, end = iir.tv_cascade(zero, rows, torch.zeros(4, 4, 2, device=dev))
    torch.cuda.synchronize()
    assert not torch.count_nonzero(y).item() and not torch.count_nonzero(end).item()


def test_high_q_kernels_stay_near_plain(dev):
    """Resonant rows (pole radius 0.95 at angle 0.1 rad; a notch at q = 30, radius
    about 0.995): B16 and B18 against the plain version run in float64 on the same
    rows, within 2x the float32 plain version's own error there."""
    rng = np.random.default_rng(8)
    t, r = 200_000, 0.95
    x = torch.from_numpy(rng.normal(size=(4, t)).astype(np.float32)).to(dev)
    g = (1 - r * r) / 2
    res = torch.tensor([g, 0.2 * g, -g, 1.0, -2 * r * np.cos(0.1), r * r]) * 1.25
    om = np.pi * 0.1
    gn = 1 / (1 + np.tan(om / 60))
    notch = torch.tensor([gn, -2 * gn * np.cos(om), gn, 1.0, -2 * gn * np.cos(om), 2 * gn - 1])
    for kernel, rows, fl in ((iir.tv_cascade, res.expand(2, 1, t, 6), 1),
                             (iir.tv_frames_cascade, notch.expand(1, 1, -(-t // 1024), 6), 1024)):
        rows = rows.float().contiguous().to(dev)
        y = kernel(x, rows)[0] if fl == 1 else kernel(x, rows, fl)[0]
        want = iir._tv_plain(x.double(), rows, fl, None)[0]
        plain = iir._tv_plain(x, rows, fl, None)[0]
        assert rel_err(y, want) <= 2 * rel_err(plain, want), kernel.__name__


def test_entry_points_launch_their_kernels(dev):
    rng = np.random.default_rng(5)
    t = 8 * SUB
    x = torch.from_numpy(rng.normal(size=(4, t)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(schedule(rng, 3, 1, t)[:, 0]).to(dev)  # (S, t, 6) shared
    reset_launch_counts()
    y_auto = iir.sosfilt_tv(rows, x)
    assert last_choice("sosfilt_tv") == "fused"
    y_scan = iir.sosfilt_tv(rows, x, method="scan")
    assert last_choice("sosfilt_tv") == "scan"
    fr = rows[:, ::1024].contiguous()
    y_fr = iir.sosfilt_tv_frames(fr, x, 1024)
    assert last_choice("sosfilt_tv_frames") == "frames"
    y_ex = iir.sosfilt_tv_frames(fr, x, 1024, method="expand")
    counts = launch_counts()
    assert (counts["B16"], counts["B17"], counts["B18"]) == (2, 3, 1), counts
    assert rel_err(y_scan, y_auto) < TOL and rel_err(y_fr, y_ex) < TOL
    # chunks of whole reference tiles (tile_rows=128: 16384 samples) against one shot
    st = torch.zeros(3, 4, 2, device=dev)
    parts = []
    for lo in range(0, t, t // 2):
        st, yp = iir.sosfilt_tv_chunk(st, rows[:, lo : lo + t // 2], x[:, lo : lo + t // 2],
                                      tile_rows=128)
        parts.append(yp)
    assert rel_err(torch.cat(parts, 1), y_auto) < TOL
    st = torch.zeros(3, 4, 2, device=dev)
    parts = []
    for lo in range(0, t, t // 2):
        st, yp = iir.sosfilt_tv_frames_chunk(st, fr[:, lo // 1024 :], x[:, lo : lo + t // 2], 1024,
                                             tile_rows=128)
        parts.append(yp)
    assert rel_err(torch.cat(parts, 1), y_fr) < TOL


def test_ragged_and_short_chunks_run_their_kernels(dev):
    """Chunks of one sample, under one reference tile and ragged run whole
    through B17 and B18 seeded (no sample loop on the card), against one shot."""
    rng = np.random.default_rng(6)
    t = 40 * 1024 + 333  # over one reference tile (32768 samples), ragged
    x = torch.from_numpy(rng.normal(size=(4, t)).astype(np.float32)).to(dev)
    rows = torch.from_numpy(schedule(rng, 3, 1, t)[:, 0]).to(dev)
    fr = rows[:, ::1024].contiguous()
    y_one = iir.sosfilt_tv(rows, x)
    y_fr = iir.sosfilt_tv_frames(fr, x, 1024)
    edges = (0, 1, 1000, SUB + 77, 2 * SUB - 5, t)
    reset_launch_counts()
    st, parts = torch.zeros(3, 4, 2, device=dev), []
    for lo, hi in zip(edges, edges[1:]):
        st, yp = iir.sosfilt_tv_chunk(st, rows[:, lo:hi], x[:, lo:hi])
        parts.append(yp)
    assert rel_err(torch.cat(parts, 1), y_one) < TOL
    # frame-aligned starts: one frame, 30 (under a reference tile), 5, then a ragged end
    edges = (0, 1024, 31 * 1024, 36 * 1024, t)
    sf, fparts = torch.zeros(3, 4, 2, device=dev), []
    for lo, hi in zip(edges, edges[1:]):
        sf, yp = iir.sosfilt_tv_frames_chunk(sf, fr[:, lo // 1024 :], x[:, lo:hi], 1024)
        fparts.append(yp)
    assert rel_err(torch.cat(fparts, 1), y_fr) < TOL
    counts = launch_counts()
    assert (counts["B16"], counts["B17"], counts["B18"]) == (0, 3 * 5, 4), counts
    want, zf = tv64(x, rows[:, None], 1)
    assert (st.double().cpu() - zf).abs().max().item() <= TOL * want.abs().max().item()


@pytest.mark.parametrize("p", [1, 2, 12, 32, 40])
@pytest.mark.parametrize("length", [8, 33, 100, 256])
def test_b22_bit_exact_against_plain(dev, p, length):
    rng = np.random.default_rng(p * 1000 + length)
    for frames in (1, 127, 129, 1000):
        a = torch.from_numpy((0.3 / p * rng.normal(size=(frames, p))).astype(np.float32)).to(dev)
        s0 = torch.from_numpy(rng.normal(size=(frames, p)).astype(np.float32)).to(dev)
        e = torch.from_numpy(rng.normal(size=(frames, length)).astype(np.float32)).to(dev)
        before = lpc.lpc_synth_pass.launches
        y, z = lpc.lpc_synth_pass(a, s0, e)
        yp, zp = lpc._lpc_pass_plain(a, s0, e)
        torch.cuda.synchronize()
        assert lpc.lpc_synth_pass.launches == before + 1
        assert torch.equal(y, yp) and torch.equal(z, zp), (p, length, frames)
        assert torch.equal(lpc.lpc_synth_state(a, s0, e), zp), (p, length, frames)
        assert lpc.lpc_synth_pass.launches == before + 2


def test_lpc_routes_launch_b22_and_b18(dev):
    rng = np.random.default_rng(9)
    nf, fl, order = 64, 256, 12
    a_rows = []
    for _ in range(nf):
        # radius 0.6: inside the compose's envelope (pallas), which loses every digit
        # by 0.85 at p = 12 (A^L grows to 2e21 before it decays)
        poles = 0.6 * np.exp(1j * rng.uniform(0.2, 2.9, order // 2))
        a_rows.append(np.poly(np.concatenate([poles, poles.conj()])).real)
    a = torch.from_numpy(np.stack(a_rows).astype(np.float32)).to(dev)
    gain = torch.ones(nf, device=dev)
    e = torch.from_numpy(rng.normal(size=nf * fl).astype(np.float32)).to(dev)
    ref = lpc.lpc_synthesis_ref(a, gain, e, fl)
    reset_launch_counts()
    for method, passes in (("auto", 3), ("refine", 3), ("pallas", 2)):
        before = launch_counts()["B22"]
        y = lpc.lpc_synthesis(a, gain, e, fl, method=method)
        assert launch_counts()["B22"] == before + passes
        assert rel_err(y, ref) < 5e-3, method
    poles = 0.995 * np.exp(1j * np.array([0.4, 1.3, 2.2]))
    row = np.poly(np.concatenate([poles, poles.conj()])).real
    a_res = torch.from_numpy(np.tile(row, (nf, 1)).astype(np.float32)).to(dev)
    y = lpc.lpc_synthesis(a_res, gain, e, fl)
    assert last_choice("lpc_synthesis") == "factored" and launch_counts()["B18"] == 1
    assert np.isfinite(y.cpu().numpy()).all()


def test_tracking_notch_on_the_card(dev):
    rng = np.random.default_rng(2)
    n, fl = 64000, 512
    f_inst = 0.1 + 0.25 * np.arange(n) / n
    tone = 10.0 * np.sin(np.cumsum(np.pi * f_inst))
    noise = rng.standard_normal(n)
    x = torch.from_numpy((tone + noise).astype(np.float32)).to(dev)
    reset_launch_counts()
    y, w0 = tracking_notch(x, fl, q=30.0)
    assert launch_counts()["B18"] == 1
    y, w0 = y.cpu().numpy(), w0.cpu().numpy()
    centers = f_inst[fl // 2 :: fl][: w0.size]
    assert np.mean(np.abs(w0 - centers)) < 0.004
    assert np.mean((y - noise)[2 * fl :] ** 2) < 0.05 * np.mean(tone**2)
    assert np.corrcoef(y[2 * fl :], noise[2 * fl :])[0, 1] > 0.8
