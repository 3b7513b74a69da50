"""The model families on the card: each against the same call on the CPU,
with TF32 turned on by the caller, and the B8 launches of the modem's
matched filter and the OFDM receiver's CP sum.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_models_gpu.py -q

Tolerances: 1e-5 of max|y| between the card and the CPU for maps, spectra
and tracked positions (IEEE float32 products summed in other orders); bits,
timing, frame starts and track ids equal; detections equal outside a
relative margin of 1e-4 around the threshold (ROADMAP H5); MUSIC spectra
2e-4 (float32 eigenvectors from two solvers).
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.models import beamform, modem, ofdm, radar, tracking
from digital_signal_processsing_tpu_torch.ops import launch_counts, reset_launch_counts

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def rel(got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def test_detect_and_tracks_match_the_cpu(dev, tf32_on):
    rcfg = radar.RadarConfig(n_pulses=64, n_range=4096, pulse_len=128, guard=(2, 4), train=(4, 16))
    cpis = [radar.synthesize(rcfg, [(500 + c, 0.02, 4.0), (1200 - 2 * c, -0.03, 3.0)],
                             noise_power=0.05, seed=c) for c in range(4)]
    i = torch.from_numpy(np.stack([c[0] for c in cpis]))
    q = torch.from_numpy(np.stack([c[1] for c in cpis]))
    det, power, thresh = radar.detect_batch(rcfg, i.to(dev), q.to(dev))
    cdet, cpower, cthresh = radar.detect_batch(rcfg, i, q)
    assert rel(power, cpower) < TOL and rel(thresh, cthresh) < TOL
    inside = ((cpower - cthresh).abs() <= 1e-4 * cthresh.abs())
    assert torch.equal(det.cpu()[~inside], cdet[~inside])
    tcfg = tracking.TrackerConfig(max_tracks=16, max_meas=4, vel_scale=64.0)
    state, _ = tracking.track_detections(rcfg, tcfg, i.to(dev), q.to(dev))
    cstate, _ = tracking.track_detections(rcfg, tcfg, i, q)
    for name in ("active", "hits", "tid", "next_id"):
        assert torch.equal(getattr(state, name).cpu(), getattr(cstate, name))
    assert (state.x.cpu() - cstate.x).abs().max() < TOL * 4096


@pytest.mark.parametrize("tracker", ["dd", "vv"])
def test_modem_matches_the_cpu_and_launches_b8(dev, tf32_on, tracker):
    cfg = modem.ModemConfig(bits_per_symbol=4, tracker=tracker)
    bits = np.random.default_rng(5).integers(0, 2, 4096 * 4)
    ci, cq = modem.channel(*modem.transmit(cfg, bits, device=dev), delay=37, cfo=2.4e-4, phase=0.8,
                           symbol_snr_db=22.0, seed=1)
    reset_launch_counts()
    got, diag = modem.receive(cfg, ci, cq, 4096)  # NumPy in: the card by default
    torch.cuda.synchronize()
    assert launch_counts()["B8"] == 2
    want, cdiag = modem.receive(cfg, ci, cq, 4096, device="cpu")
    assert torch.equal(got.cpu(), want) and (want.numpy() == bits).all()
    for key in ("timing_phase", "frame_start"):
        assert int(diag[key]) == int(cdiag[key])


def test_ofdm_batch_matches_the_cpu_and_launches_b8_once(dev):
    cfg = ofdm.OfdmConfig(n_fft=1024, cp=64, n_symbols=8, active=768)  # the family row's symbols
    r = np.random.default_rng(7)
    bursts, bits = [], []
    for b in range(4):
        bb = r.integers(0, 2, 2 * cfg.active * cfg.n_symbols)
        ti, tq = ofdm.ofdm_modulate(cfg, bb)
        x = np.concatenate([np.zeros(13 + b), ti + 1j * tq, np.zeros(64 + 3 - b)])
        x = x * np.exp(2j * np.pi * 1.1e-4 * np.arange(x.size))
        noise = r.standard_normal(x.size) + 1j * r.standard_normal(x.size)
        x = x + 10 ** (-25 / 20) * noise / np.sqrt(2)
        bursts.append(x)
        bits.append(bb)
    x = np.stack(bursts)
    i, q = x.real.astype(np.float32), x.imag.astype(np.float32)
    rx = ofdm.OfdmReceiver(cfg)
    reset_launch_counts()
    d, cfo = rx.synchronize(i, q)
    torch.cuda.synchronize()
    assert launch_counts()["B8"] == 1
    er, ei = rx.demodulate(i, q, d, cfo)
    crx = ofdm.OfdmReceiver(cfg, device="cpu")
    cd, ccfo = crx.synchronize(torch.from_numpy(i), torch.from_numpy(q))
    cer, cei = crx.demodulate(torch.from_numpy(i), torch.from_numpy(q), cd, ccfo)
    assert torch.equal(d.cpu(), cd) and rel(er, cer) < TOL and rel(ei, cei) < TOL
    assert (rx.receive_bits(i, q) == np.stack(bits)).all()


@pytest.mark.parametrize("method", ["mvdr", "music"])
def test_spectrum_batch_matches_the_cpu(dev, tf32_on, method):
    cfg = beamform.ArrayConfig(n_sensors=16)
    blocks = [beamform.synthesize(cfg, [-12.0, 23.0], 4096, snr_db=10.0, seed=s) for s in range(4)]
    xi = torch.from_numpy(np.stack([b[0] for b in blocks]))
    xq = torch.from_numpy(np.stack([b[1] for b in blocks]))
    got = beamform.spectrum_batch(cfg, xi.to(dev), xq.to(dev), method=method, n_sources=2)
    want = beamform.spectrum_batch(cfg, xi, xq, method=method, n_sources=2)
    assert rel(got, want) < (2e-4 if method == "music" else TOL)
    doa = beamform._pick_peaks(beamform.scan_angles(cfg), got[0].cpu().numpy(), 2)
    assert np.abs(doa - np.array([-12.0, 23.0])).max() < 0.5
