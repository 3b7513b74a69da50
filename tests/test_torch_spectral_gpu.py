"""The spectral slice on the card: the FIR routes (B8, B9) against the same calls
on the CPU, and the dense products in IEEE float32 with TF32 turned on.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_spectral_gpu.py -q

Tolerances: 1e-5 of max|y| between the card and the CPU (float32 overlap-save
and transforms summed in other orders, about 1e-7 of the output), and 1e-5
against float64 for the products with TF32 turned on by the caller (TF32's
10 mantissa bits would err about 1e-3).
"""

import numpy as np
import pytest
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu_torch.ops import correlate as cor
from digital_signal_processsing_tpu_torch.ops import fft as spec
from digital_signal_processsing_tpu_torch.ops import launch_counts, mel, reset_launch_counts
from digital_signal_processsing_tpu_torch.utils import last_choice

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def tf32_on():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def rel(got: torch.Tensor, want) -> float:
    got = got.cpu().resolve_conj().numpy().astype(np.complex128)
    want = np.asarray(want.cpu().resolve_conj().numpy() if isinstance(want, torch.Tensor) else want,
                      np.complex128)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def signal(channels: int, t: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((channels, t), dtype=np.float32))


@pytest.mark.parametrize("k,kernel", [(1, "B8"), (257, "B8"), (8193, "B8"), (8194, "B9"), (20000, "B9")])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_oaconvolve_and_convolve_on_the_card(dev, k, kernel, mode):
    x = signal(3, 100_003)
    h = (np.random.default_rng(k).standard_normal(k) / np.sqrt(k)).astype(np.float32)
    want = cor.oaconvolve(x, h, mode)
    reset_launch_counts()
    got = cor.oaconvolve(x.to(dev), h, mode)
    assert last_choice("fir_filter") == "overlap_save_fused"
    got_c = cor.convolve(x.to(dev), torch.from_numpy(h).to(dev), mode)
    assert launch_counts()[kernel] == 2
    assert rel(got, want) < TOL and rel(got_c, want) < TOL


def test_hilbert_fir_on_the_card(dev):
    x = signal(4, 1 << 20, seed=1)
    reset_launch_counts()
    got = spec.hilbert(x.to(dev), method="fir")
    assert launch_counts()["B8"] == 1 and last_choice("hilbert") == "fir"
    assert rel(got, spec.hilbert(x, method="fir")) < TOL
    assert torch.equal(got.real.cpu(), x)
    got = spec.hilbert(x.to(dev), method="fft")
    assert rel(got, sps.hilbert(x.double().numpy(), axis=-1)) < TOL
    reset_launch_counts()
    spec.hilbert(torch.zeros(2, spec.HILBERT_BLOCKED_MIN_T, device=dev))
    assert last_choice("hilbert") == "fir" and launch_counts()["B8"] == 1


def test_correlate_routes_on_the_card(dev):
    ar, ai = signal(4, 1 << 17, seed=2), signal(4, 1 << 17, seed=3)
    vr, vi = signal(1, 128, seed=4)[0], signal(1, 128, seed=5)[0]
    want = cor.correlate_complex(ar, ai, vr, vi, "valid", method="xla")
    for method in ("auto", "direct", "direct_gauss", "xla"):
        gr, gi = cor.correlate_complex(ar.to(dev), ai.to(dev), vr.to(dev), vi.to(dev), "valid",
                                       method=method)
        assert rel(gr, want[0]) < TOL and rel(gi, want[1]) < TOL, method
    assert rel(cor.correlate(ar.to(dev), vr.to(dev), "same"), cor.correlate(ar, vr, "same")) < TOL


def test_products_stay_ieee_with_tf32_on(dev, tf32_on):
    x = signal(2, 1 << 16, seed=6)
    c = mel.mfcc(x.to(dev), sample_rate=16000.0, nfft=512, hop=256, n_mels=40)
    assert rel(c, mel.mfcc(x, sample_rate=16000.0, nfft=512, hop=256, n_mels=40)) < TOL
    n = (x.shape[-1] - 512) // 256 + 1
    idx = np.arange(n)[:, None] * 256 + np.arange(512)
    w = spec.spectral_window("hann", 512).astype(np.float64)
    p64 = np.abs(np.fft.rfft(x.double().numpy()[..., idx] * w, axis=-1)) ** 2
    m64 = p64 @ mel.mel_filterbank(40, 512, 16000.0).astype(np.float64).T
    assert rel(mel.melspectrogram(x.to(dev), sample_rate=16000.0, nfft=512, hop=256, n_mels=40), m64) < TOL
    c64 = np.log(np.maximum(m64, 1e-10)) @ mel.dct_matrix(13, 40).astype(np.float64).T
    assert rel(c, c64) < TOL
    xc = x[:, :4096]
    w_, a_ = np.exp(-0.0013j), np.exp(0.2j)
    z = spec.czt(xc.to(dev), 2048, w_, a_)
    assert last_choice("czt") == "matmul"
    assert rel(z, np.stack([sps.czt(r, 2048, w_, a_) for r in xc.double().numpy()])) < TOL
    f = np.array([0.01, 0.123, 0.3], np.float32)
    ph = 2 * np.pi * np.outer(f.astype(np.float64), np.arange(x.shape[-1]))
    x64 = x.double().numpy()
    tp64 = 2 * ((x64 @ np.cos(ph).T / x.shape[-1]) ** 2 + (x64 @ np.sin(ph).T / x.shape[-1]) ** 2)
    assert rel(spec.tone_power(x.to(dev), f), tp64) < TOL


def test_stream_states_live_on_the_card(dev):
    from digital_signal_processsing_tpu_torch.ops import phase_vocoder, streaming

    assert streaming.stft_init(512, 256, 2).tail.device.type == "cuda"
    assert mel.mfcc_init(512, 256, 2).tail.device.type == "cuda"
    assert phase_vocoder.time_stretch_init(1.25, channels=2).ola_tail.device.type == "cuda"
    x = signal(2, 1 << 16, seed=7)
    st, s = streaming.stft_chunk(streaming.stft_init(512, 256, 2), x.to(dev), nfft=512, hop=256)
    st_c, s_c = streaming.stft_chunk(streaming.stft_init(512, 256, 2, device="cpu"), x, nfft=512, hop=256)
    assert rel(s, s_c) < TOL and rel(st.tail, st_c.tail) == 0.0
