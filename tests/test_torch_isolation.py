"""The port imports neither JAX nor the JAX package, and never moves to the CPU
or the plain path on its own."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch import _build
from digital_signal_processsing_tpu_torch.io import write_wav
from digital_signal_processsing_tpu_torch.models import ChainConfig, DspChain, WidebandFmReceiver
from digital_signal_processsing_tpu_torch.ops import (
    METHODS,
    cumsum,
    direct_averager,
    farrow_init,
    farrow_matmul_init,
    fir_filter,
    fused_branch_dft,
    fused_fir,
    fused_fir3,
    fused_pfb_raw,
    launch_counts,
    moving_average,
    moving_average_init,
    moving_average_two_pass,
    pfb_analyze_os,
    pfb_channelize,
    pfb_channelize_chunk,
    pfb_stream_init,
    resample_farrow,
    resample_farrow_segmented,
    reset_launch_counts,
    scan_averager,
    windowed_averager,
    windowed_averager_packed,
)
from digital_signal_processsing_tpu_torch.ops.demod import oscillator_bank
from digital_signal_processsing_tpu_torch.ops.fir import FIR_FFT_CROSSOVER as fir_crossover
from digital_signal_processsing_tpu_torch.ops.fft_mxu import (
    fused_geometry,
    pick_fused_block,
    tap_response,
)
from digital_signal_processsing_tpu_torch.ops.cic import cic_decimate, cic_interpolate
from digital_signal_processsing_tpu_torch.ops.fir import savgol_filter
from digital_signal_processsing_tpu_torch.ops.iir import (
    design_butterworth,
    iir1_block_scan,
    iir_first_order,
    iir_first_order_pallas,
    sos_cascade,
    sos_cascade_unrolled,
    sos_sections,
    sosfilt,
    sosfilt_chunk,
    sosfilt_init,
    sosfilt_pallas_fused,
    sosfilt_tv,
    sosfilt_tv_chunk,
    sosfilt_tv_frames,
    sosfilt_tv_frames_chunk,
    sosfilt_tv_fused,
    tv_cascade,
    tv_frames_cascade,
    tv_section,
)
from digital_signal_processsing_tpu_torch.ops.lpc import lpc_synth_pass, lpc_synthesis, lpc_vocoder
from digital_signal_processsing_tpu_torch.ops.resample import resample_fft, upfirdn
from digital_signal_processsing_tpu_torch.ops.splines import cspline1d, qspline1d
from digital_signal_processsing_tpu_torch.ops.streaming import fir_chunk, fir_init
from digital_signal_processsing_tpu_torch.models.adaptive import tracking_notch
from digital_signal_processsing_tpu_torch.serve import stream_moving_average

REPO = Path(__file__).resolve().parents[1]

NO_JAX = """
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np, torch
import digital_signal_processsing_tpu_torch as port
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.io import write_wav, read_wav
from digital_signal_processsing_tpu_torch.ops import METHODS, moving_average
from digital_signal_processsing_tpu_torch.serve import stream_moving_average
from digital_signal_processsing_tpu_torch.models import run_variant
from digital_signal_processsing_tpu_torch.harness import sweep  # noqa: F401
import digital_signal_processsing_tpu_torch.__main__  # noqa: F401
import chip_smoke  # noqa: F401  (its imports only; main() is not run)
from digital_signal_processsing_tpu_torch.ops import fir, fft_mxu, resample, demod  # noqa: F401
from digital_signal_processsing_tpu_torch.models.chain import ChainConfig, DspChain
from digital_signal_processsing_tpu_torch.parallel.pipeline import chain_halo  # noqa: F401
from digital_signal_processsing_tpu_torch.ops import gain, iir
from digital_signal_processsing_tpu_torch.serve import stream_sosfilt
sos = iir.design_butterworth(4, 0.2)
xf = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 3000)).astype(np.float32))
for method in ("auto", "pallas_fused", "pallas", "xla_scan"):
    assert iir.sosfilt(sos, xf, method=method).shape == (2, 3000)
assert gain.agc(gain.dc_block(xf)).shape == (2, 3000)
chain = DspChain(ChainConfig(channels=2, decimation=4, channel_taps=4097, audio_taps=17), device="cpu")
i, q = chain.example_planar_input(t=8192)
audio = chain.forward_planar(torch.from_numpy(i), torch.from_numpy(q))
assert audio.shape == (2, 2048) and bool(torch.isfinite(audio).all())
x = np.random.default_rng(0).integers(-32768, 32768, size=4000, dtype=np.int16)
y = moving_average(torch.from_numpy(x), 64, 2).numpy()
assert (y == moving_average_golden(x, 64, 2)).all()
for method in METHODS:
    assert (moving_average(torch.from_numpy(x), 64, 2, method=method).numpy() == y).all()
assert (run_variant("scan", torch.from_numpy(x), 64, 2).numpy() == y).all()
write_wav(sys.argv[1] + "/in.wav", x, 8000, 2)
n = stream_moving_average([sys.argv[1] + "/in.wav"], sys.argv[1] + "/out.wav", 64,
                          chunk_samples=1000, device="cpu")
assert n == x.size and (read_wav(sys.argv[1] + "/out.wav")[1] == y).all()
n = stream_sosfilt([sys.argv[1] + "/in.wav"], sys.argv[1] + "/iir.wav", sos, chunk_samples=1000,
                   device="cpu")
assert n == x.size
from digital_signal_processsing_tpu_torch.ops import channelizer, farrow, pfb_os  # noqa: F401
from digital_signal_processsing_tpu_torch.models.wideband import WidebandConfig, WidebandFmReceiver
rx = WidebandFmReceiver(WidebandConfig(n_channels=8, audio_taps=17), device="cpu")
assert rx(torch.from_numpy(rx.example_input(t=8 * 256))).shape == (8, 256)
xw = torch.from_numpy(np.random.default_rng(2).normal(size=64 * 64).astype(np.float32))
for method in ("auto", "fused_raw", "fused", "composed"):
    assert channelizer.pfb_channelize(xw, 64, method=method).shape == (64, 64)
assert pfb_os.pfb_analyze_os(xw, 8, channelizer.design_prototype(8))[0].shape == (8, 1024)
for method in ("auto", "matmul", "segmented", "gather"):
    assert farrow.resample_farrow(xf, (441, 2560), method=method).shape[0] == 2
locked = DspChain(ChainConfig(channels=2, decimation=4, channel_taps=33, audio_taps=17,
                              audio_resample=(441, 2560)), device="cpu")
assert locked.forward_planar(torch.from_numpy(i), torch.from_numpy(q)).shape == (2, 353)
from digital_signal_processsing_tpu_torch.ops import fft, lpc  # noqa: F401
from digital_signal_processsing_tpu_torch.models import adaptive
rows = torch.ones(2, 3000, 6) * torch.tensor([0.3, 0.1, 0.05, 1.25, -0.5, 0.2])
for method in ("auto", "fused", "scan"):
    assert iir.sosfilt_tv(rows, xf, method=method).shape == (2, 3000)
for method in ("auto", "frames", "expand"):
    assert iir.sosfilt_tv_frames(rows[:, ::128], xf, 128, tile_rows=128, method=method).shape == (2, 3000)
a, g = lpc.lpc(xf, 8, 256)
for method in ("auto", "scan", "pallas", "refine", "factored"):
    assert lpc.lpc_synthesis(a, g, xf[:, :2816], 256, method=method).shape == (2, 2816)
assert adaptive.tracking_notch(xf, 512)[0].shape == (2, 3000)
from digital_signal_processsing_tpu_torch.ops import cic, iir_design, splines, streaming
ell = iir_design.iirdesign(0.1, 0.15, 0.5, 60.0, ftype="ellip")
for rp in ("bcast", "compact"):
    assert iir.sosfilt_pallas_fused(ell, xf, lane_pass="mxu", row_pass=rp).shape == (2, 3000)
assert iir.iir_first_order_pallas(xf, 0.99, kernel="tile").shape == (2, 3000)
taps = fir.design_remez(201, [0.0, 0.1, 0.15, 1.0], [1.0, 0.0])
st = streaming.fir_init(201, 2, device="cpu")
st, yc = streaming.fir_chunk(st, xf[:, :1000], taps)
assert yc.shape == (2, 1000) and st.tail.shape == (2, 200)
assert cic.cic_decimate(xf, 8).shape == (2, 375)
assert cic.cic_interpolate(xf, 8).shape == (2, 24000)
assert cic.design_cic_compensator(31, 8).shape == (31,)
assert resample.upfirdn(taps, xf, 3, 2).shape == (2, 4599)
assert resample.resample_fft(xf, 1234).shape == (2, 1234)
assert fir.savgol_filter(xf, 11, 3).shape == (2, 3000)
assert splines.cspline1d(xf).shape == splines.qspline1d(xf).shape == (2, 3000)
from digital_signal_processsing_tpu_torch.ops import cepstrum, mel, phase_vocoder, stft_class  # noqa: F401
import digital_signal_processsing_tpu_torch.ops.correlate  # noqa: F401
from digital_signal_processsing_tpu_torch.ops.correlate import correlate, correlate_complex, oaconvolve
from digital_signal_processsing_tpu_torch.ops.fft import czt, hilbert, istft, stft, welch
from digital_signal_processsing_tpu_torch.serve import stream_mfcc, stream_time_stretch
xs = xf[:, :2048]
assert istft(stft(xs, nfft=256, hop=128, window="sqrt_hann"), nfft=256, hop=128).shape == (2, 2048)
assert welch(xs, nfft=256).shape == (2, 129) and czt(xs, 64).shape == (2, 64)
assert hilbert(xs, method="fir", num_taps=33).shape == hilbert(xs).shape == (2, 2048)
assert correlate(xs, xs[0, :33]).shape == oaconvolve(xs, xs[0, :33]).shape == (2, 2080)
assert correlate_complex(xs, xs, xs[0, :33], xs[0, :33], "valid")[0].shape == (2, 2016)
assert mel.mfcc(xs, sample_rate=8000.0, nfft=256, hop=128, n_mels=20).shape == (2, 15, 13)
assert phase_vocoder.time_stretch(xs, 1.25, nfft=256).shape[0] == 2
assert cepstrum.complex_cepstrum(xs)[0].shape == (2, 2048)
assert stft_class.ShortTimeFFT(np.hanning(16), 4, 1.0).stft(xs).shape[:2] == (2, 9)
feats = stream_mfcc([sys.argv[1] + "/in.wav"], chunk_samples=1000, nfft=256, hop=128, device="cpu")
assert feats.shape == (2, 16, 13)
assert stream_time_stretch([sys.argv[1] + "/in.wav"], sys.argv[1] + "/ts.wav", 1.25, nfft=256,
                           chunk_samples=1000, device="cpu") > 0
from digital_signal_processsing_tpu_torch.models import (
    ArrayConfig, ModemConfig, OfdmConfig, OfdmReceiver, RadarConfig, TrackerConfig, beamform, kalman,
    modem, radar, tracker_state_from_jax, tracking,
)
rc = RadarConfig(n_pulses=16, n_range=256, pulse_len=32, guard=(1, 2), train=(2, 4))
ri, rq = (torch.from_numpy(np.stack([a] * 2)) for a in radar.synthesize(rc, [(60, 0.25, 1.0)], noise_power=0.01))
det = radar.detect_batch(rc, ri, rq)[0]
assert det.shape == (2, 16, 225) and bool(det[0, 12, 60])
st, hist = tracking.track_detections(rc, TrackerConfig(max_tracks=4, max_meas=4), ri, rq)
assert hist["x"].shape == (2, 4, 2)
assert tracker_state_from_jax(tuple(t.numpy() for t in st), device="cpu").hits.dtype == torch.int32
assert kalman.kalman_filter(np.eye(2), np.eye(2), np.eye(2), np.eye(2), torch.zeros(5, 2))[0].shape == (5, 2)
mc = ModemConfig(bits_per_symbol=4)
mbits = np.random.default_rng(3).integers(0, 2, 4 * 256)
mi, mq = (torch.from_numpy(a) for a in modem.channel(*modem.transmit(mc, mbits, device="cpu"), delay=5))
for tracker in ("dd", "vv"):
    got = modem.receive(ModemConfig(bits_per_symbol=4, tracker=tracker), mi, mq, 256)[0]
    assert (got.numpy() == mbits).all()
oc = OfdmConfig(n_symbols=4)
from digital_signal_processsing_tpu_torch.models.ofdm import ofdm_modulate
obits = np.random.default_rng(4).integers(0, 2, 2 * 48 * 4)
oi, oq = (np.pad(a, (7, 30)) for a in ofdm_modulate(oc, obits))
assert (OfdmReceiver(oc, device="cpu").receive_bits(torch.from_numpy(oi), torch.from_numpy(oq)) == obits).all()
xi, xq = (torch.from_numpy(a) for a in beamform.synthesize(ArrayConfig(), [-20.0, 30.0], 256))
assert beamform.estimate_doa(ArrayConfig(), xi, xq, n_sources=2).shape == (2,)
assert beamform.spectrum_batch(ArrayConfig(), xi[None], xq[None], method="mvdr").shape == (1, 361)
import torch.distributed as dist
from digital_signal_processsing_tpu_torch import parallel
from digital_signal_processsing_tpu_torch.parallel import (  # noqa: F401
    mesh, multihost, pipeline, pipeline_parallel, ring_pallas, sharded_fir, sharded_scan, sharded_tv,
)
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1] + "/store", 1), rank=0,
                        world_size=1)
tm = parallel.make_time_mesh(device="cpu")
for method in ("windowed", "scan"):
    for h in ("ppermute", "pallas_ring", "fused_ring"):
        got = parallel.sharded_moving_average(torch.from_numpy(x), 64, 2, mesh=tm, method=method,
                                              halo_impl=h)
        assert (got.numpy() == y).all()
step = adaptive.make_sharded_train_step(parallel.make_mesh(device="cpu"))
taps, loss = adaptive.identify_system(np.array([0.5, -0.25], np.float32), steps=3, batch=(2, 256),
                                      train_step=step, device="cpu")
assert taps.shape == (2,) and np.isfinite(loss)
dist.destroy_process_group()
from digital_signal_processsing_tpu_torch import graft_entry
fn, args = graft_entry.entry(device="cpu")
assert fn(*args).shape == (16, 8192)
for kind in ("multichip", "multiprocess"):  # each dry run's rank, in this process: a world of one
    graft_entry._rank_main([kind, "0", "1", sys.argv[1] + "/" + kind + ".store", "cpu", "gloo",
                            sys.argv[1] + "/" + kind + ".json"])
wx = torch.from_numpy(np.random.default_rng(6).normal(size=8 * 512).astype(np.float32))
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1] + "/store2", 1), rank=0,
                        world_size=1)
wm = parallel.make_mesh(device="cpu")
assert parallel.sharded_wideband(rx, wx, wm).shape == (8, 512)
assert radar.detect_batch(rc, ri, rq, mesh=wm)[0].shape == (2, 16, 225)
dist.destroy_process_group()
from digital_signal_processsing_tpu_torch.utils import checkpoint
from digital_signal_processsing_tpu_torch.ops.pfb_os import design_pr_prototype
fir = adaptive.AdaptiveFir.create(4, device="cpu")
adaptive.lms_train_step(fir, xf[:, :512], xf[:, 1:513])
checkpoint.save_training_state(sys.argv[1] + "/train.npz", fir.taps, fir.opt_state(), 1)
assert checkpoint.load_training_state(sys.argv[1] + "/train.npz", fir.opt_state())[2] == 1
for algo in (adaptive.nlms, adaptive.rls):
    assert algo(xf, xf, 4)[2].shape == (2, 4)
assert design_pr_prototype(4, 4, steps=2, device="cpu").shape == (16,)
from digital_signal_processsing_tpu_torch import compat
from digital_signal_processsing_tpu_torch.ops import (  # noqa: F401
    companding, lti, metrics, peaks, rank, signal, twod, wavelets,
)
from digital_signal_processsing_tpu_torch.utils import numerics
assert compat.sosfilt(compat.butter(4, 0.2, output="sos"), xf).shape == (2, 3000)
assert compat.medfilt(xf, 5).shape == compat.wiener(xf, 5).shape == (2, 3000)
assert compat.cwt(xf[0, :256], compat.ricker, [1, 2, 4]).shape == (3, 256)
assert compat.find_peaks(np.cumsum(np.random.default_rng(5).normal(size=500)))[0].ndim == 1
assert compat.convolve2d(xf[:, :64], np.ones((3, 3)), "same", "symm").shape == (2, 64)
assert companding.mulaw_decode(companding.mulaw_encode(torch.from_numpy(x))).shape == x.shape
assert float(metrics.enob(signal.tone(0.0123, 4096, device="cpu"))) > 0
yl, xl = compat.dlsim(compat.tf2ss([1.0, 0.5], [1.0, -1.2, 0.5]), xf[0, :100, None])
assert yl.shape == (100, 1) and xl.shape == (100, 2)
assert compat.lsim(([1.0], [1.0, 0.5]), np.ones(50), np.linspace(0, 1, 50), device="cpu")[1].shape == (50,)
assert compat.spline_filter(np.ones((40, 40)), device="cpu").shape == (40, 40)
assert numerics.exact_window_bound() == 65535
assert not [m for m in sys.modules if m.startswith("jax") and sys.modules[m] is not None]
reference = [m for m in sys.modules
             if m == "digital_signal_processsing_tpu" or m.startswith("digital_signal_processsing_tpu.")]
assert not reference, reference
print("NO_JAX_OK")
"""


def run_python(args, cwd, env_extra=None):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


def test_port_runs_without_jax(tmp_path):
    r = run_python(["-c", NO_JAX, str(tmp_path)], REPO, {"PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


def test_cuda_device_without_a_card_raises(tmp_path):
    from types import SimpleNamespace

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    write_wav(tmp_path / "in.wav", np.zeros(64, np.int16), 8000, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_moving_average([tmp_path / "in.wav"], tmp_path / "out.wav", 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        moving_average_init(4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DspChain()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DspChain(ChainConfig(channels=2, channel_taps=8193))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        oscillator_bank(np.array([0.1], np.float32), 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WidebandFmReceiver()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfb_stream_init(64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        farrow_init((441, 2560), 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        farrow_matmul_init((441, 2560), 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fir_init(201, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cspline1d(np.zeros((2, 64)))
    from digital_signal_processsing_tpu_torch.ops import mel, phase_vocoder, streaming
    from digital_signal_processsing_tpu_torch.ops.fft import stft
    from digital_signal_processsing_tpu_torch.serve import stream_mfcc, stream_time_stretch

    for call in (
        lambda: streaming.stft_init(512, 256), lambda: streaming.istft_init(512, 256),
        lambda: mel.mfcc_init(512, 256), lambda: phase_vocoder.time_stretch_init(1.25),
        lambda: stft(np.zeros((2, 2048), np.float32)),
        lambda: stream_mfcc([tmp_path / "in.wav"]),
        lambda: stream_time_stretch([tmp_path / "in.wav"], tmp_path / "ts.wav", 1.25),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from digital_signal_processsing_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([str(tmp_path / "in.wav"), "4", "--out", str(tmp_path / "o.wav")])
    from digital_signal_processsing_tpu_torch import graft_entry

    for call in (graft_entry.entry, lambda: graft_entry.dryrun_multichip(4),
                 lambda: graft_entry.dryrun_multiprocess(4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from digital_signal_processsing_tpu_torch.models import adaptive
    from digital_signal_processsing_tpu_torch.ops.pfb_os import design_pr_prototype

    z = np.zeros((2, 64), np.float32)
    for call in (
        lambda: adaptive.AdaptiveFir.create(4), lambda: adaptive.identify_system(np.ones(3)),
        lambda: adaptive.nlms(z, z, 4), lambda: adaptive.rls(z, z, 4),
        lambda: adaptive.opt_state_from_optax((SimpleNamespace(count=1, mu=z[0, :4],
                                                               nu=z[0, :4]),), z[0, :4]),
        lambda: design_pr_prototype(8, steps=1),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from digital_signal_processsing_tpu_torch.models import (
        ArrayConfig, ModemConfig, OfdmConfig, OfdmReceiver, RadarConfig, TrackerConfig, beamform,
        kalman, modem, radar, tracking,
    )

    rc = RadarConfig(n_pulses=8, n_range=128, pulse_len=16)
    e = np.zeros((8, 128), np.float32)
    xs = np.zeros((8, 64), np.float32)
    for call in (
        lambda: radar.detect(rc, e, e), lambda: radar.detect_batch(rc, e[None], e[None]),
        lambda: radar.pulse_compress(rc, e, e), lambda: radar.ambiguity(e[0], e[0]),
        lambda: radar.ca_cfar(e, guard=(1, 1), train=(2, 2), pfa=1e-3),
        lambda: tracking.tracker_init(TrackerConfig()),
        lambda: tracking.track_detections(rc, TrackerConfig(), e[None], e[None]),
        lambda: kalman.kalman_filter(np.eye(2), np.eye(2), np.eye(2), np.eye(2), np.zeros((4, 2))),
        lambda: modem.receive(ModemConfig(), e[0], e[0], 4), lambda: modem.transmit(ModemConfig(), [0, 1]),
        lambda: OfdmReceiver(OfdmConfig()),
        lambda: beamform.estimate_doa(ArrayConfig(), xs, xs, n_sources=1),
        lambda: beamform.spectrum_batch(ArrayConfig(), xs[None], xs[None]),
        lambda: beamform.wideband_music_spectrum(ArrayConfig(), xs, n_sources=1, spacing_samples=1.0),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    from digital_signal_processsing_tpu_torch import compat
    from digital_signal_processsing_tpu_torch.ops import (
        companding, lti, metrics, peaks, rank, signal, twod, wavelets,
    )

    tf = lti.tf2ss([1.0, 0.5], [1.0, -1.2, 0.5])
    for call in (
        lambda: companding.mulaw_encode(np.zeros(8, np.int16)), lambda: signal.tone(0.1, 64),
        lambda: signal.white_noise(64), lambda: metrics.tone_metrics(np.zeros(64, np.float32)),
        lambda: rank.medfilt(z, 3), lambda: rank.wiener(z, 3), lambda: wavelets.cwt(z[0], wavelets.ricker, [1]),
        lambda: wavelets.lombscargle(z[0], z[0], z[0]), lambda: peaks.peak_mask(z),
        lambda: peaks.find_peaks_cwt(z[0], [2, 4]), lambda: twod.medfilt2d(z),
        lambda: twod.convolve2d(z, np.ones((3, 3))), lambda: lti.dlsim(tf, np.ones(8)),
        lambda: lti.dstep(([1.0], [1.0, 0.5]), 8), lambda: lti.lsim(([1.0], [1.0, 0.5]), None, np.arange(4.0)),
        lambda: compat.sosfilt(compat.butter(2, 0.3, output="sos"), z), lambda: compat.hilbert(z),
        lambda: compat.welch(z, nperseg=16), lambda: compat.spline_filter(np.ones((40, 40))),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_tensors_never_build_kernels(monkeypatch, rng):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    reset_launch_counts()
    x = torch.from_numpy(rng.integers(-32768, 32768, size=4096, dtype=np.int16))
    windowed_averager(x, 16, 2)
    windowed_averager(x, 16, 2, seed=torch.zeros(32, dtype=torch.int16))
    windowed_averager(x, 16, 2, tile_samples=1024)
    windowed_averager_packed(x.view(torch.int32), 16, 2)
    for variant in ("blelloch", "hillis_steele", "mxu"):
        scan_averager(x, 16, 2, variant=variant)
        scan_averager(x, 16, 2, variant=variant, tile_samples=2048)
    direct_averager(x, 16, 2)
    direct_averager(x, 16, 2, tile_samples=1024)
    cumsum(x, 2)
    moving_average_two_pass(x, 4000, 2)
    for method in METHODS:
        moving_average(x, 16, 2, method=method)
    xf = torch.from_numpy(rng.normal(size=(3, 5000)).astype(np.float32))
    for k in (max(1, fir_crossover), 8193, 8194):  # auto's shortest route, B8's, B9's
        taps = np.ones(k, np.float32) / k
        for method in ("auto", "direct", "overlap_save", "overlap_save_mxu", "overlap_save_fused"):
            fir_filter(xf, taps, method=method)
    chain = DspChain(ChainConfig(channels=3, decimation=4, channel_taps=8193), device="cpu")
    chain.forward_planar(xf, xf)
    sos = design_butterworth(4, 0.2)
    for method in ("auto", "pallas_fused", "pallas", "xla_scan"):
        sosfilt(sos, xf, method=method)
        sosfilt_chunk(sosfilt_init(sos, (3,), device="cpu"), sos, xf, method=method)
    for method in ("auto", "pallas", "xla_scan"):
        iir_first_order(xf, 0.9, method=method)
    sos_cascade_unrolled(xf, sos)
    xw = torch.from_numpy(rng.normal(size=64 * 128).astype(np.float32))
    for n, method in ((64, "auto"), (64, "fused_raw"), (64, "fused"), (48, "fused"), (64, "composed")):
        pfb_channelize(xw[: n * 128], n, method=method)
    pfb_channelize_chunk(pfb_stream_init(64, device="cpu"), xw, 64)
    pfb_analyze_os(xw, 64, np.ones(512, np.float32) / 512)
    for rate in ((441, 2560), (46337, 65521)):
        for method in ("auto", "matmul", "segmented", "gather"):
            if method != "matmul" or rate[0] * rate[1] <= 1 << 22:
                resample_farrow(xf, rate, method=method)
    rows = torch.ones(2, 5000, 6) * torch.tensor([0.3, 0.1, 0.05, 1.25, -0.5, 0.2])
    for method in ("auto", "fused", "scan"):
        sosfilt_tv(rows, xf, method=method)
    sosfilt_tv_fused(rows, xf)
    sosfilt_tv_chunk(torch.zeros(2, 3, 2), rows, xf, tile_rows=32)
    for method in ("auto", "frames", "expand"):
        sosfilt_tv_frames(rows[:, ::128], xf, 128, tile_rows=128, method=method)
    sosfilt_tv_frames_chunk(torch.zeros(2, 3, 2), rows[:, ::128], xf, 128, tile_rows=32)
    for method in ("auto", "scan", "pallas", "refine", "factored"):
        lpc_vocoder(xf, 8, 256, excitation=xf)
        lpc_synthesis(torch.tensor([[1.0, -0.5]] * 4), torch.ones(4), xf[0, :1024], 256,
                      method=method)
    tracking_notch(xf, 512)
    iir_first_order(xf, 0.9, method="pallas")
    iir_first_order_pallas(xf, 0.9, kernel="tile")
    for row_pass in ("bcast", "compact"):
        sosfilt_pallas_fused(sos, xf, lane_pass="mxu", row_pass=row_pass)
    cic_decimate(xf, 8)
    cic_interpolate(xf, 8)
    upfirdn(np.ones(29), xf, 8, 3)
    resample_fft(xf, 777)
    savgol_filter(xf, 11, 3)
    fir_chunk(fir_init(201, 3, device="cpu"), xf, np.ones(201) / 201)
    cspline1d(xf)
    qspline1d(xf)
    from digital_signal_processsing_tpu_torch.ops import mel, phase_vocoder
    from digital_signal_processsing_tpu_torch.ops.correlate import (
        convolve, correlate, correlate_complex, oaconvolve,
    )
    from digital_signal_processsing_tpu_torch.ops.fft import czt, hilbert, hilbert_fir, tone_power

    hilbert(xf, method="fir", num_taps=513)
    hilbert_fir(xf, num_taps=65, row_len=1000)
    for k in (257, 8194):
        oaconvolve(xf, np.ones(k, np.float32) / k)
        convolve(xf, np.ones(k, np.float32) / k)
    for method in ("auto", "direct", "direct_gauss", "xla", "mxu"):
        correlate_complex(xf, xf, xf[0, :128], xf[0, :128], "valid", method=method)
    correlate(xf, xf[0, :128], method="direct")
    czt(xf[:, :1000], 100)
    tone_power(xf, [0.1, 0.2])
    mel.mfcc(xf, sample_rate=8000.0, nfft=256, hop=128, n_mels=20)
    phase_vocoder.pitch_shift(xf, 2 ** (3 / 12), nfft=256)
    from digital_signal_processsing_tpu_torch.models import modem, ofdm

    xm = xf[0, :2048]
    for tracker in ("dd", "vv"):
        modem.receive(modem.ModemConfig(tracker=tracker), xm, xm, 16)
    rx = ofdm.OfdmReceiver(ofdm.OfdmConfig(n_symbols=4), device="cpu")
    rx.receive_bits(xf[:, :500], xf[:, :500])
    from digital_signal_processsing_tpu_torch.models import adaptive
    from digital_signal_processsing_tpu_torch.ops.pfb_os import design_pr_prototype

    for p in (3, 1030):
        adaptive.nlms(xf[:, :300], xf[:, :300], p)
    for p in (3, 240):
        adaptive.rls(xf[:, :40], xf[:, :40], p)
    adaptive.identify_system(np.ones(3, np.float32), steps=2, batch=(2, 256), device="cpu")
    design_pr_prototype(8, 2, steps=2, device="cpu")
    from digital_signal_processsing_tpu_torch import compat

    sos = compat.butter(4, 0.2, output="sos")
    for call in (lambda: compat.sosfilt(sos, xf), lambda: compat.sosfilt(sos, xf, zi=np.zeros((2, 3, 2))),
                 lambda: compat.lfilter(*compat.butter(4, 0.2), xf), lambda: compat.sosfiltfilt(sos, xf),
                 lambda: compat.filtfilt(*compat.butter(4, 0.2), xf), lambda: compat.decimate(xf, 4),
                 lambda: compat.oaconvolve(xf, np.ones(257) / 257),
                 lambda: compat.convolve(xf, np.ones(257) / 257, method="fft"),
                 lambda: compat.hilbert(xf), lambda: compat.resample_poly(xf, 3, 2),
                 lambda: compat.savgol_filter(xf, 31, 3),
                 lambda: compat.spline_filter(np.ones((40, 40)), device="cpu"),
                 lambda: compat.dlsim(compat.tf2ss([1.0], [1.0, 0.5]), xf[0, :64, None]),
                 lambda: compat.lsim(([1.0], [1.0, 0.5]), None, np.arange(64.0), device="cpu"),
                 lambda: compat.find_peaks_cwt(xf[0], [2, 4])):
        call()
    assert not any(launch_counts().values()), launch_counts()


def test_anchor_wrappers_raise_when_the_build_fails(monkeypatch, rng):
    """B11 and B14 on a tensor the wrappers take for a CUDA one: the failed build
    raises, and neither the plain version nor a launch count is taken."""
    from digital_signal_processsing_tpu_torch.ops import iir

    def broken():
        raise RuntimeError("nvcc failed on iir.cu")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(iir, "_on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "library", broken)
    monkeypatch.setattr(iir, "_iir1_plain", no_plain)
    monkeypatch.setattr(iir, "_sos_plain", no_plain)
    reset_launch_counts()
    xf = torch.from_numpy(rng.normal(size=(2, 5000)).astype(np.float32))
    sos = design_butterworth(4, 0.2)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        iir.iir_first_order_pallas(xf, 0.9, kernel="tile")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        iir.iir1_affine_scan(xf, 0.9)
    for row_pass in ("bcast", "compact"):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            iir.sosfilt_pallas_fused(sos, xf, lane_pass="mxu", row_pass=row_pass)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        iir.sos_cascade_mxu(xf, sos)
    assert launch_counts()["B11"] == launch_counts()["B14"] == 0


def test_ring_wrappers_raise_when_the_build_fails(monkeypatch, rng):
    """B6 and B7 on tensors the wrappers take for CUDA ones: the failed build
    raises, and neither the ppermute spelling nor a launch count is taken."""
    from types import SimpleNamespace

    from digital_signal_processsing_tpu_torch.parallel import ring_pallas

    def broken():
        raise RuntimeError("nvcc failed on ring.cu")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ring_pallas, "_on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "library", broken)
    monkeypatch.setattr(ring_pallas, "shift_right", no_plain)
    monkeypatch.setattr(ring_pallas, "windowed_averager", no_plain)
    reset_launch_counts()
    x = torch.from_numpy(rng.integers(-32768, 32768, size=4096, dtype=np.int16))
    mesh = SimpleNamespace(device=x.device, rings={}, n_time=2, t=1)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ring_pallas.ring_shift_right_shard(x, mesh)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ring_pallas.fused_ring_windowed_shard(x, 16, 2, mesh)
    assert launch_counts()["B6"] == launch_counts()["B7"] == 0 and not mesh.rings


def test_recursion_wrappers_raise_when_the_build_fails(monkeypatch, rng):
    """S1 and S2 on tensors the wrappers take for CUDA ones: the failed build raises,
    and neither the plain loop nor a launch count is taken."""
    from digital_signal_processsing_tpu_torch.models import adaptive

    def broken():
        raise RuntimeError("nvcc failed on adaptive.cu")

    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    from digital_signal_processsing_tpu_torch.ops import lti

    monkeypatch.setattr(adaptive, "_on_cuda", lambda x: True)
    monkeypatch.setattr(lti, "_on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "library", broken)
    monkeypatch.setattr(adaptive, "_nlms_plain", no_plain)
    monkeypatch.setattr(adaptive, "_rls_plain", no_plain)
    monkeypatch.setattr(lti, "_dlsim_plain", no_plain)
    reset_launch_counts()
    xf = torch.from_numpy(rng.normal(size=(2, 100)).astype(np.float32))
    tf = lti.tf2ss([1.0, 0.5], [1.0, -1.2, 0.5])
    for call in (lambda: adaptive.nlms(xf, xf, 8), lambda: adaptive.rls(xf, xf, 8),
                 lambda: lti.dlsim(tf, xf[0, :, None]), lambda: lti.dstep(tf, 10, device="cpu"),
                 lambda: lti.lsim(([1.0], [1.0, 0.5]), None, np.arange(5.0), device="cpu")):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            call()
    assert launch_counts()["S1"] == launch_counts()["S2"] == launch_counts()["S3"] == 0


def test_other_devices_are_refused():
    x = torch.zeros(8, dtype=torch.int16, device="meta")
    for wrapper in (windowed_averager, scan_averager, direct_averager):
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            wrapper(x, 2, 1)
    xf = torch.zeros(2, 8, device="meta")
    for k, wrapper in ((5, fused_fir), (8194, fused_fir3)):
        g = fused_geometry(k, pick_fused_block(k))
        response = tap_response(np.ones(k, np.float32), g, "cpu")
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            wrapper(xf, response)
    xm = torch.zeros(32 * 128, device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        fused_pfb_raw(xm, 32, torch.zeros(8, 32, device="meta"))
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        fused_branch_dft(xm.view(128, 32), torch.zeros(8, 32, device="meta"))
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resample_farrow_segmented(xf, (46337, 65521))
    sos = design_butterworth(2, 0.3)
    from digital_signal_processsing_tpu_torch.ops.iir import iir1_affine_scan, sos_cascade_mxu

    for call in (
        lambda: sos_cascade(xf, sos), lambda: sos_cascade_unrolled(xf, sos),
        lambda: sos_sections(xf, sos), lambda: iir1_block_scan(xf, 0.5),
        lambda: iir1_affine_scan(xf, 0.5), lambda: sos_cascade_mxu(xf, sos),
    ):
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            call()
    from digital_signal_processsing_tpu_torch.parallel import ring_pallas

    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ring_pallas.ring_shift_right_shard(xm, None)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ring_pallas.fused_ring_windowed_shard(x, 2, 1, None)
    from digital_signal_processsing_tpu_torch.models import adaptive

    for scan in (adaptive.nlms_scan, adaptive.rls_scan):
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            scan(xf, xf, 4)
    from digital_signal_processsing_tpu_torch.ops import lti

    m = torch.zeros(2, 2, device="meta")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        lti.dlsim_scan(m, m[:, :1], m[:1], m[:1, :1], torch.zeros(8, 1, device="meta"), m[0])
    rows = torch.ones(1, 1, 8, 6, device="meta")
    for call in (
        lambda: tv_cascade(xf, rows), lambda: tv_section(xf, rows),
        lambda: tv_frames_cascade(xf, rows, 1),
        lambda: lpc_synth_pass(torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, device="meta"),
                               xf),
    ):
        with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
            call()


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = run_python(["chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


NO_JAX_REST = """
import importlib, shutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np, torch
from digital_signal_processsing_tpu_torch.examples import NAMES
for name in NAMES:
    importlib.import_module("digital_signal_processsing_tpu_torch.examples." + name)
from digital_signal_processsing_tpu_torch.harness import trace
from digital_signal_processsing_tpu_torch.harness.sweep import generate_wav
from digital_signal_processsing_tpu_torch.io import WavChunkLoader, device_chunks, native
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_interleaved_xla
from digital_signal_processsing_tpu_torch.serve import stream_moving_average
from digital_signal_processsing_tpu_torch.utils.layout import as_numpy_int16, interleaved_frames
x = generate_wav(sys.argv[1] + "/in.wav", 4000, 2, seed=1)
chunks = list(device_chunks(WavChunkLoader([sys.argv[1] + "/in.wav"], 1000), device="cpu"))
assert (torch.cat(chunks).numpy() == x).all()
assert trace(lambda: torch.ones(4).sum(), sys.argv[1] + "/trace").is_file()
assert cumsum_interleaved_xla(torch.from_numpy(x), 2).dtype == torch.int32
assert interleaved_frames(x.size, 2) == 2000 and as_numpy_int16(x) is x
if shutil.which("g++"):
    assert stream_moving_average([sys.argv[1] + "/in.wav"], sys.argv[1] + "/out.wav", 16,
                                 chunk_samples=999, use_native=True, device="cpu") == x.size
    assert (native.moving_average_native(x, 16, 2) ==
            native.read_wav_native(sys.argv[1] + "/out.wav")[2]).all()
assert not [m for m in sys.modules if m.startswith("jax") and sys.modules[m] is not None]
reference = [m for m in sys.modules
             if m == "digital_signal_processsing_tpu" or m.startswith("digital_signal_processsing_tpu.")]
assert not reference, reference
print("NO_JAX_REST_OK")
"""


def test_native_path_and_examples_run_without_jax(tmp_path):
    r = run_python(["-c", NO_JAX_REST, str(tmp_path)], REPO, {"PYTHONPATH": str(REPO)})
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_REST_OK" in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = run_python(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_build_is_keyed_by_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()  # stable for unchanged sources
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "windowed.cu", "cumsum.cu", "scan.cu", "direct.cu", "fused_fir.cu", "fused_fir3.cu",
        "iir.cu", "pfb.cu", "farrow.cu", "iir_tv.cu", "lpc.cu", "ring.cu", "adaptive.cu", "lti.cu",
    }
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
