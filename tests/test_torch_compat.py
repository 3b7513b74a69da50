"""The port's scipy.signal facade (``compat``) against the JAX package's, F4 at
n = 1, F3's refusal, and the names the slice owes the reference (CPU).

Tolerances, each the op's own: the designers within 1e-8 of max|coefficient|
(host float64 in both packages); the filters, FIRs, resamplers and spectral
estimators within 1e-5 of max|y| (float32 in both, summed in other orders);
``find_peaks`` equal (host float64).
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu import compat as jcompat
from digital_signal_processsing_tpu.ops import cepstrum as jcep
from digital_signal_processsing_tpu_torch import _build, compat
from digital_signal_processsing_tpu_torch.ops import cepstrum, launch_counts
from digital_signal_processsing_tpu_torch.utils.dispatch import refuse_grad

REPO = Path(__file__).resolve().parents[1]
INTENTIONALLY_OUT = {"band_stop_obj", "test"}
DESIGN_RTOL = 1e-8
FLOAT_RTOL = 1e-5


def test_every_scipy_signal_callable_resolves():
    """The pin of tests/test_compat_facade.py, held to the port's facade."""
    pub = [n for n in dir(sps) if not n.startswith("_") and callable(getattr(sps, n))]
    missing = [n for n in pub if n not in INTENTIONALLY_OUT and not hasattr(compat, n)]
    assert missing == [], f"the port's facade lacks: {missing}"
    import digital_signal_processsing_tpu_torch as port

    assert "compat" in port.__all__


def _public(path: Path) -> set:
    """Top-level functions, classes and assignments that do not start with '_'."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_") and n != "__all__"}


@pytest.mark.parametrize("path", [
    "ops/companding.py", "ops/signal.py", "ops/metrics.py", "ops/rank.py", "ops/wavelets.py",
    "ops/peaks.py", "ops/twod.py", "ops/lti.py", "compat.py",
])
def test_the_port_has_every_public_name(path):
    ref = _public(REPO / "digital_signal_processsing_tpu" / path)
    port = _public(REPO / "digital_signal_processsing_tpu_torch" / path)
    assert ref - port == set()


def test_the_port_has_spline_filter_and_the_numerics_helpers():
    pairs = (("ops/splines.py", {"spline_filter"}),
             ("utils/numerics.py", {"float_reciprocal_quantize", "exact_window_bound", "snr_db"}))
    for path, names in pairs:
        assert names <= _public(REPO / "digital_signal_processsing_tpu" / path)
        assert names <= _public(REPO / "digital_signal_processsing_tpu_torch" / path)


# --- the battery: each adapter against the JAX facade on the same inputs -------------

rng0 = np.random.default_rng(21)
X = (np.sin(0.07 * np.arange(2 * 600)).reshape(2, 600)
     + 0.5 * rng0.normal(size=(2, 600))).astype(np.float32)
Y = (0.6 * X + 0.4 * rng0.normal(size=X.shape)).astype(np.float32)
X3 = rng0.normal(size=(40, 3, 2)).astype(np.float32)
V = rng0.normal(size=33).astype(np.float32)
SOS = sps.butter(4, 0.2, output="sos")
B, A = sps.butter(4, 0.2)
ZI = rng0.normal(size=(2, 2, 2)).astype(np.float32)
ZI_AXIS = rng0.normal(size=(2, 2, 3, 2)).astype(np.float32)  # scipy's zi for axis=0 of X3
PEAKS = np.cumsum(rng0.normal(size=2000))

DESIGNERS = {
    "butter low": lambda m: m.butter(4, 0.3),
    "butter bandpass sos": lambda m: m.butter(4, [0.2, 0.5], btype="bandpass", output="sos"),
    "butter analog zpk": lambda m: m.butter(3, 2.0, analog=True, output="zpk"),
    "butter fs": lambda m: m.butter(4, 1000, btype="high", fs=8000),
    "cheby1": lambda m: m.cheby1(4, 1.0, 0.3),
    "cheby2 high": lambda m: m.cheby2(4, 40.0, 0.3, btype="high"),
    "ellip zpk": lambda m: m.ellip(4, 1.0, 40.0, 0.3, output="zpk"),
    "bessel": lambda m: m.bessel(4, 0.3),
    "iirfilter": lambda m: m.iirfilter(4, [0.2, 0.4], rp=1.0, rs=40.0, ftype="ellip"),
    "firwin2": lambda m: m.firwin2(31, [0, 0.5, 1], [1, 1, 0]),
    "firls": lambda m: m.firls(31, [0, 0.3, 0.4, 1], [1, 1, 0, 0]),
    "remez": lambda m: m.remez(31, [0, 0.2, 0.3, 0.5], [1, 0]),
    "savgol_coeffs": lambda m: m.savgol_coeffs(11, 3, deriv=1),
}

FILTERS = {
    "savgol_filter": lambda m, c: m.savgol_filter(c(X), 11, 3),
    "savgol_filter axis 0": lambda m, c: m.savgol_filter(c(X3[:, :, 0]), 11, 3, axis=0),
    "resample": lambda m, c: m.resample(c(X), 300),
    "resample axis 0": lambda m, c: m.resample(c(X3[:, :, 0]), 25, axis=0),
    "decimate iir": lambda m, c: m.decimate(c(X), 4),
    "decimate fir": lambda m, c: m.decimate(c(X), 4, ftype="fir"),
    "sosfilt": lambda m, c: m.sosfilt(SOS, c(X)),
    "sosfilt zi": lambda m, c: m.sosfilt(SOS, c(X), zi=ZI),
    "sosfilt axis 0 zi": lambda m, c: m.sosfilt(SOS, c(X3), axis=0, zi=ZI_AXIS),
    "lfilter": lambda m, c: m.lfilter(B, A, c(X)),
    "lfilter fir": lambda m, c: m.lfilter(V, 1.0, c(X)),
    "lfilter axis 0": lambda m, c: m.lfilter(B, A, c(X3), axis=0),
    "correlate": lambda m, c: m.correlate(c(X), V),
    "convolve same": lambda m, c: m.convolve(c(X), V, "same"),
    "convolve fft": lambda m, c: m.convolve(c(X), V, method="fft"),
    "oaconvolve": lambda m, c: m.oaconvolve(c(X), V),
    "hilbert": lambda m, c: m.hilbert(c(X)),
    "hilbert N": lambda m, c: m.hilbert(c(X), N=700),
    "hilbert axis 0": lambda m, c: m.hilbert(c(X3), axis=0),
    "detrend": lambda m, c: m.detrend(c(X)),
    "detrend constant axis 0": lambda m, c: m.detrend(c(X3), axis=0, type="constant"),
    "resample_poly": lambda m, c: m.resample_poly(c(X), 3, 2),
    "resample_poly axis 0": lambda m, c: m.resample_poly(c(X3[:, :, 0]), 2, 3, axis=0),
    "filtfilt": lambda m, c: m.filtfilt(B, A, c(X)),
    "sosfiltfilt": lambda m, c: m.sosfiltfilt(SOS, c(X)),
    "sosfiltfilt axis 0": lambda m, c: m.sosfiltfilt(SOS, c(X3), axis=0),
    "welch": lambda m, c: m.welch(c(X), nperseg=64),
    "welch fs hamming": lambda m, c: m.welch(c(X), fs=8.0, window="hamming", nperseg=128,
                                             noverlap=32, scaling="spectrum"),
    "periodogram": lambda m, c: m.periodogram(c(X)),
    "periodogram hann": lambda m, c: m.periodogram(c(X), window="hann", nfft=600, fs=2.0),
    "csd": lambda m, c: m.csd(c(X), c(Y), nperseg=64),
    "coherence": lambda m, c: m.coherence(c(X), c(Y), nperseg=64),
    "spectrogram psd": lambda m, c: m.spectrogram(c(X), nperseg=64),
    "spectrogram magnitude": lambda m, c: m.spectrogram(c(X), nperseg=64, mode="magnitude",
                                                        scaling="spectrum"),
    "spectrogram complex": lambda m, c: m.spectrogram(c(X), nperseg=64, mode="complex"),
    "stft": lambda m, c: m.stft(c(X), nperseg=64),
    "medfilt": lambda m, c: m.medfilt(c(X), 5),
    "wiener": lambda m, c: m.wiener(c(X), 5),
    "upfirdn": lambda m, c: m.upfirdn(V, c(X), 3, 2),
    "cwt": lambda m, c: m.cwt(c(X[0]), m.ricker, [1, 4, 9]),
    "convolve2d": lambda m, c: m.convolve2d(c(X3[:, :, 0]), V[:9].reshape(3, 3), "same", "symm"),
    "sepfir2d": lambda m, c: m.sepfir2d(c(X3[:, :, 0]), V[:3], V[3:6]),
    "chirp": lambda m, c: m.chirp(0.01, 0.2, 500) if m is jcompat else m.chirp(0.01, 0.2, 500, device="cpu"),
}


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.resolve_conj().numpy()
    if isinstance(v, (tuple, list)):
        return type(v)(_host(e) for e in v)
    return np.asarray(v)


def _assert_close(got, want, rtol):
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w, rtol)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.size:
        err = np.abs(g.astype(np.complex128) - w.astype(np.complex128)).max()
        assert err <= rtol * max(np.abs(w).max(), 1e-30), err / np.abs(w).max()


@pytest.mark.parametrize("name", list(DESIGNERS))
def test_designer_adapters(name):
    _assert_close(_host(DESIGNERS[name](compat)), _host(DESIGNERS[name](jcompat)), DESIGN_RTOL)


@pytest.mark.parametrize("name", list(FILTERS))
def test_filter_adapters(name):
    got = _host(FILTERS[name](compat, torch.from_numpy))
    want = _host(FILTERS[name](jcompat, lambda a: a))
    _assert_close(got, want, FLOAT_RTOL)


def test_istft_adapter():
    _, _, z = jcompat.stft(X, nperseg=64)
    z = np.asarray(z)
    _assert_close(_host(compat.istft(torch.from_numpy(z), nperseg=64)),
                  _host(jcompat.istft(z, nperseg=64)), FLOAT_RTOL)


@pytest.mark.parametrize("kw", [
    dict(height=0.0), dict(prominence=2.0, width=3), dict(distance=10, threshold=0.05),
    dict(plateau_size=1, width=(2, 40)), dict(plateau_size=(1, 3), prominence=1.0),
])
def test_find_peaks_adapter(kw):
    got, gprops = compat.find_peaks(PEAKS, **kw)
    want, wprops = jcompat.find_peaks(PEAKS, **kw)
    np.testing.assert_array_equal(got, want)
    assert set(gprops) == set(wprops)
    for key in gprops:
        np.testing.assert_array_equal(gprops[key], wprops[key])


def test_adapter_refusals():
    x = torch.zeros(2, 64)
    for call in (lambda: compat.lfilter(B, A, x, zi=ZI), lambda: compat.correlate(x, V, method="x"),
                 lambda: compat.hilbert(x, N=0), lambda: compat.detrend(x, bp=[3]),
                 lambda: compat.filtfilt(B, A, x, padtype="even"),
                 lambda: compat.sosfiltfilt(SOS, x, padlen=3),
                 lambda: compat.decimate(x, 2, zero_phase=False),
                 lambda: compat.savgol_filter(x, 5, 2, cval=1.0),
                 lambda: compat.welch(x, nperseg=32, nfft=64), lambda: compat.butter(2, 0.3, btype="x")):
        with pytest.raises(ValueError):
            call()


def test_numpy_input_goes_to_the_named_device():
    got = compat.sosfilt(SOS, X, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _assert_close(got.numpy(), np.asarray(jcompat.sosfilt(SOS, X)), FLOAT_RTOL)


@pytest.mark.parametrize("name", ["savgol_filter", "resample", "resample_poly", "hilbert"])
def test_leading_axes_past_one_are_rows(name):
    """The reference takes (channels, time) only for these; the port's adapters take
    any leading axes as rows, each row as the reference filters it."""
    call = {"savgol_filter": lambda m, v: m.savgol_filter(v, 11, 3, axis=0),
            "resample": lambda m, v: m.resample(v, 25, axis=0),
            "resample_poly": lambda m, v: m.resample_poly(v, 2, 3, axis=0),
            "hilbert": lambda m, v: m.hilbert(v, axis=0)}[name]
    got = _host(call(compat, torch.from_numpy(X3)))
    for k in range(X3.shape[2]):
        _assert_close(got[:, :, k], _host(call(jcompat, X3[:, :, k])), FLOAT_RTOL)


# --- F4: complex_cepstrum at n = 1 ---------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), (2, 1)])
def test_complex_cepstrum_of_one_sample(shape):
    x = np.full(shape, -2.0, np.float32)
    c, nd = cepstrum.complex_cepstrum(torch.from_numpy(x))
    jc, jnd = jcep.complex_cepstrum(x)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6)
    np.testing.assert_array_equal(nd.numpy(), np.asarray(jnd))
    np.testing.assert_allclose(c.numpy(), np.full(shape, np.log(2.0), np.float32), rtol=1e-6)
    assert (nd.numpy() == 0).all()


# --- F3: the refusal of a gradient through a float kernel -----------------------------


def test_refuse_grad_helper():
    x = torch.ones(4, requires_grad=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP §3 F3.*") as info:
        refuse_grad("fused_fir (B8)", None, 3.0, torch.ones(2), x)
    assert "fused_fir (B8)" in str(info.value)
    refuse_grad("fused_fir (B8)", torch.ones(2), None)  # nothing requires a gradient
    with torch.no_grad():
        refuse_grad("fused_fir (B8)", x)


FLOAT_WRAPPERS = ("B8", "B9", *(f"B{k}" for k in range(10, 20)), "B21", "B22", "S1", "S2", "S3")


def _wrappers() -> dict:
    """Each float kernel of launch_counts() and the function that holds its kernel
    branch (the time-varying kernels share one)."""
    from digital_signal_processsing_tpu_torch.models import adaptive
    from digital_signal_processsing_tpu_torch.ops import channelizer, farrow, fft_mxu, iir, lpc, lti

    return {
        "B8": [fft_mxu.fused_fir], "B9": [fft_mxu.fused_fir3], "B10": [iir.iir1_block_scan],
        "B11": [iir.iir1_affine_scan], "B12": [iir.sos_cascade], "B13": [iir.sos_cascade_unrolled],
        "B14": [iir.sos_cascade_mxu], "B15": [iir.sos_sections], "B16": [iir._tv_kernel],
        "B17": [iir._tv_kernel], "B18": [iir._tv_kernel], "B19": [channelizer.fused_pfb_raw],
        "B21": [farrow.resample_farrow_segmented],
        "B22": [lpc.lpc_synth_pass, lpc.lpc_synth_state], "S1": [adaptive.nlms_scan],
        "S2": [adaptive.rls_scan], "S3": [lti.dlsim_scan],
    }


def test_every_float_wrapper_calls_refuse_grad_on_its_kernel_branch():
    """By source: the call comes after the CPU branch returns and before the build."""
    assert set(FLOAT_WRAPPERS) | {"B20"} <= set(launch_counts())
    for kernel, fns in _wrappers().items():
        for fn in fns:
            src = inspect.getsource(fn)
            assert "refuse_grad(" in src, (kernel, fn.__name__)
            at = src.index("refuse_grad(")
            assert "_on_cuda(" in src[:at], (kernel, fn.__name__)
            if "_build.library()" in src:
                assert at < src.index("_build.library()"), (kernel, fn.__name__)


def test_float_wrappers_refuse_before_the_build(monkeypatch, rng):
    """On tensors the wrappers take for CUDA ones: a requires_grad input raises
    NotImplementedError naming F3 before any build; under no_grad the call goes
    on to the (here broken) build."""
    from digital_signal_processsing_tpu_torch.models import adaptive
    from digital_signal_processsing_tpu_torch.ops import (
        channelizer, farrow, fft_mxu, iir, lpc, lti, pallas_scan,
    )

    def broken():
        raise RuntimeError("nvcc failed")

    for mod in (adaptive, channelizer, farrow, fft_mxu, iir, lpc, lti, pallas_scan):
        monkeypatch.setattr(mod, "_on_cuda", lambda x: True)
    monkeypatch.setattr(_build, "library", broken)
    import chip_smoke  # its cases for the card: each wrapper as a function of the data

    calls = chip_smoke.f3_cases(torch.device("cpu"))
    x = torch.from_numpy(rng.normal(size=(2, 8192)).astype(np.float32))
    assert set(calls) == set(FLOAT_WRAPPERS)
    before = launch_counts()
    for kernel, call in calls.items():
        v = x[:1] if kernel == "B19" else x
        with pytest.raises(NotImplementedError, match="F3"):
            call(v.clone().requires_grad_())
        with torch.no_grad(), pytest.raises(RuntimeError, match="nvcc failed"):
            call(v.clone().requires_grad_())
    assert launch_counts() == before


def test_cpu_plain_versions_keep_the_graph(rng):
    from digital_signal_processsing_tpu_torch.ops import iir, lti

    x = torch.from_numpy(rng.normal(size=(2, 300)).astype(np.float32)).requires_grad_()
    y, _ = iir.sos_cascade(x, iir.design_butterworth(4, 0.2))
    y.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    u = torch.from_numpy(rng.normal(size=(50, 1)).astype(np.float32)).requires_grad_()
    yl, _ = lti.dlsim_scan(0.5 * torch.eye(2), torch.ones(2, 1), torch.ones(1, 2), torch.ones(1, 1),
                           u, torch.zeros(2))
    yl.sum().backward()
    assert u.grad is not None and torch.isfinite(u.grad).all()
