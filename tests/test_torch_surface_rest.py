"""The rest of the port's surface against the JAX package, on the CPU.

``io.dataset.device_chunks`` (the loader's chunks as tensors; ``sharding=``
refused, as the multi-card path is not ported yet), ``harness.profile.trace``
(a Chrome trace of one call), ``harness.sweep.generate_wav`` (the JAX
function's samples and file bytes for the same seed), the three small
helpers ``ops.scan_xla.cumsum_interleaved_xla`` and
``utils.layout.interleaved_frames``/``as_numpy_int16`` (results and errors
equal), and B20's gradient with respect to its input ``u``: against
``jax.grad`` of the JAX package's plain route (``branch_fir`` +
``dft_matmul``, the route it differentiates) within 1e-5 of max|g|, and by
``torch.autograd.gradcheck`` in float64, at dilation 1 and 2, in the three
layouts, with 1 to 4 taps a phase.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.harness import sweep as jax_sweep
from digital_signal_processsing_tpu.ops import channelizer as jax_channelizer
from digital_signal_processsing_tpu.ops import scan_xla as jax_scan_xla
from digital_signal_processsing_tpu.utils import layout as jax_layout
from digital_signal_processsing_tpu_torch.harness import sweep, trace
from digital_signal_processsing_tpu_torch.io import WavChunkLoader, device_chunks, write_wav
from digital_signal_processsing_tpu_torch.ops import channelizer
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_interleaved_xla
from digital_signal_processsing_tpu_torch.utils.layout import as_numpy_int16, interleaved_frames
from tests.conftest import make_interleaved

LAYOUTS = ("rows", "channels", "complex")
GRAD_RTOL = 1e-5


def write_inputs(rng, tmp_path, frames=(1000, 333), channels=2):
    paths = []
    for i, n in enumerate(frames):
        paths.append(tmp_path / f"in{i}.wav")
        write_wav(paths[-1], make_interleaved(rng, n, channels), 8000, channels)
    return paths


@pytest.mark.parametrize("packed", [False, True])
def test_device_chunks_on_the_cpu_are_the_loaders_chunks(rng, tmp_path, packed):
    paths = write_inputs(rng, tmp_path)
    want = list(WavChunkLoader(paths, 512, packed=packed))
    got = list(device_chunks(WavChunkLoader(paths, 512, packed=packed), device="cpu", depth=1))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)


def test_device_chunks_refusals(rng, tmp_path):
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import parallel

    loader = WavChunkLoader(write_inputs(rng, tmp_path), 512)
    with pytest.raises(TypeError, match="parallel.Sharding"):
        device_chunks(loader, device="cpu", sharding=object())
    # a sharding over a world of one (gloo, in this process) hands out the loader's chunks
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        flat = parallel.time_sharding(parallel.make_mesh(device="cpu"))
        got = list(device_chunks(loader, sharding=flat))
    finally:
        dist.destroy_process_group()
    want = list(loader)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device_chunks(loader)
    with pytest.raises(ValueError, match="unsupported device"):
        device_chunks(loader, device="meta")


def test_device_chunks_surface_loader_errors(tmp_path):
    write_wav(tmp_path / "a.wav", np.zeros(100, np.int16), 8000, 2)
    write_wav(tmp_path / "b.wav", np.zeros(100, np.int16), 8000, 1)
    loader = WavChunkLoader([tmp_path / "a.wav", tmp_path / "b.wav"], 64)
    with pytest.raises(ValueError, match="channels"):
        list(device_chunks(loader, device="cpu"))


def test_trace_writes_a_chrome_trace(tmp_path):
    calls = []

    def fn():
        calls.append(1)
        return torch.ones(256).cumsum(0)

    path = trace(fn, tmp_path / "traces", warmup=2)
    assert len(calls) == 3 and path.parent == tmp_path / "traces" and path.is_file()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("cumsum" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("num_samples, channels, seed", [(10_000, 2, 0), (1001, 2, 5), (999, 3, 7)])
def test_generate_wav_equals_jax(tmp_path, num_samples, channels, seed):
    got = sweep.generate_wav(tmp_path / "port.wav", num_samples, channels, seed)
    want = jax_sweep.generate_wav(tmp_path / "jax.wav", num_samples, channels, seed)
    np.testing.assert_array_equal(got, want)
    assert got.size == num_samples // channels * channels
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


@pytest.mark.parametrize("channels", [1, 2, 3, 16])
def test_cumsum_interleaved_equals_jax(rng, channels):
    x = make_interleaved(rng, 3000, channels)
    x[:channels * 200] = -32768  # wraps int32 within 2^16 frames of the extreme
    got = cumsum_interleaved_xla(torch.from_numpy(np.tile(x, 40)), channels)
    want = np.asarray(jax_scan_xla.cumsum_interleaved_xla(jnp.asarray(np.tile(x, 40)), channels))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n, channels", [(12, 3), (0, 1), (7, 2), (8, 0), (8, -2)])
def test_interleaved_frames_equals_jax(n, channels):
    try:
        want = jax_layout.interleaved_frames(n, channels)
    except ValueError as exc:
        with pytest.raises(ValueError) as err:
            interleaved_frames(n, channels)
        assert str(err.value) == str(exc)
    else:
        assert interleaved_frames(n, channels) == want


def test_as_numpy_int16_equals_jax():
    x = np.arange(-5, 5, dtype=np.int16)
    for arg in (x, torch.from_numpy(x)):
        got = as_numpy_int16(arg)
        np.testing.assert_array_equal(got, jax_layout.as_numpy_int16(x))
        assert got.dtype == np.int16
    for bad in (x.astype(np.int32), torch.zeros(3, dtype=torch.float32)):
        with pytest.raises(TypeError, match="expected int16 samples"):
            as_numpy_int16(bad)
    with pytest.raises(TypeError, match="expected int16 samples"):
        jax_layout.as_numpy_int16(x.astype(np.int32))


def port_loss(out, layout, w):
    re, im = (out.real.T, out.imag.T) if layout == "complex" else (
        (out[0].T, out[1].T) if layout == "channels" else out)
    return (w[0] * re).sum() + (w[1] * im * im).sum()


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_b20_input_gradient_matches_jax(rng, layout, dilation, p):
    m, n = 57, 12
    u0 = rng.normal(size=(m, n)).astype(np.float32)
    hq0 = rng.normal(size=(p, n)).astype(np.float32)
    w = rng.normal(size=(2, m, n)).astype(np.float32)
    u = torch.from_numpy(u0).requires_grad_()
    port_loss(channelizer.fused_branch_dft(u, torch.from_numpy(hq0), sign=1, dilation=dilation,
                                           layout=layout), layout, torch.from_numpy(w)).backward()

    def jloss(uu):
        v = jax_channelizer.branch_fir(uu[None], jnp.asarray(hq0), dilation=dilation)[0]
        re, im = jax_channelizer.dft_matmul(v, None, n)
        return (w[0] * re).sum() + (w[1] * im * im).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(u0)))
    assert np.abs(u.grad.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_b20_input_gradient_gradcheck(layout, dilation, p):
    gen = torch.Generator().manual_seed(11 * p + dilation)
    u = torch.randn(11, 5, dtype=torch.float64, generator=gen, requires_grad=True)
    hq = torch.randn(p, 5, dtype=torch.float64, generator=gen)
    for sign in (1, -1):
        assert torch.autograd.gradcheck(
            lambda uu, s=sign: channelizer.BranchDftTapsGrad.apply(uu, hq, s, dilation, layout),
            (u,))
    hq.requires_grad_()  # both inputs at once
    assert torch.autograd.gradcheck(
        lambda uu, hh: channelizer.BranchDftTapsGrad.apply(uu, hh, 1, dilation, layout), (u, hq))


def test_b20_input_gradient_only_where_asked(rng):
    u = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32)).requires_grad_()
    hq = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    re, im = channelizer.fused_branch_dft(u, hq, dilation=2)
    g_u, = torch.autograd.grad((re.sum() + im.sum()), (u,))
    ref = u.detach().clone().requires_grad_()
    v = channelizer.branch_fir(ref[None], hq, dilation=2)[0]
    r2, i2 = channelizer.dft_matmul(v, None, 8)
    (r2.sum() + i2.sum()).backward()
    assert (g_u - ref.grad).abs().max() <= GRAD_RTOL * ref.grad.abs().max()
    assert hq.grad is None
