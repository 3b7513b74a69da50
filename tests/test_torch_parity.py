"""The last gaps between the port and the JAX package, each held against the reference.

- F6: ``convolve2d``/``correlate2d`` with ``mode="valid"`` and a kernel larger
  than the image give the reference's empty result, in every boundary mode;
- F7: ``chirp`` of zero samples is an empty float32 tensor;
- F8: ``levinson`` places NumPy input on its ``device``;
- ``moving_average_two_pass(variant=)`` and ``cumsum(variant=)`` take the
  reference's variant names and refuse the others with its message;
- the planar DFT functions of ``fft_mxu`` against the reference's matmul
  engines on the CPU, within 1e-4 of max|X| (measured: 2.0e-7 to 5.9e-7 of
  max|X| for ``dft_factored``, ``fft_large``, ``rfft_dense`` and
  ``irfft_dense``, ``rfft_dense_framed`` 2.9e-7 to 1.8e-6, detrended at nfft
  4096 the largest);
- the harness's K-differential timer: its slope against the reference's
  ``time_phases(chain=)`` on the same clock readings, the chain's refusals,
  and ``--chain`` through the sweep's command line and grid.
"""

import types

import numpy as np
import pytest
import torch

import digital_signal_processsing_tpu.harness.profile as jax_profile
from digital_signal_processsing_tpu.harness import sweep as jax_sweep
from digital_signal_processsing_tpu.ops import fft_mxu as jax_fm
from digital_signal_processsing_tpu.ops import lpc as jax_lpc
from digital_signal_processsing_tpu.ops import signal as jax_signal
from digital_signal_processsing_tpu.ops import twod as jax_twod
from digital_signal_processsing_tpu.ops.pallas_scan import (
    moving_average_two_pass as jax_two_pass,
)
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.harness import profile, sweep
from digital_signal_processsing_tpu_torch.ops import cumsum, fft_mxu as fm, lpc, signal, twod
from digital_signal_processsing_tpu_torch.ops.pallas_scan import (
    CUMSUM_VARIANTS,
    moving_average_two_pass,
)
from digital_signal_processsing_tpu_torch.utils import device as device_mod
from tests.conftest import make_interleaved

DFT_RTOL = 1e-4  # of max|X|


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


# --- F6 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("boundary", ["fill", "wrap", "symm"])
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
@pytest.mark.parametrize("shapes", [((3, 3), (4, 5)), ((3, 6), (4, 2)), ((2, 3, 3, 6), (4, 2))])
@pytest.mark.parametrize("name", ["convolve2d", "correlate2d"])
def test_conv2d_kernel_larger_than_image_matches_jax(rng, name, shapes, mode, boundary):
    x = rng.standard_normal(shapes[0]).astype(np.float32)
    k = rng.standard_normal(shapes[1]).astype(np.float32)
    want = np.asarray(getattr(jax_twod, name)(x, k, mode, boundary, 0.5))
    got = getattr(twod, name)(x, k, mode, boundary, 0.5, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    if want.size:
        assert rel_err(got, want) <= 1e-5
    if mode == "valid":
        assert want.shape[-2:] == {(3, 3): (0, 0), (3, 6): (0, 5)}[shapes[0][-2:]]


# --- F7 ---------------------------------------------------------------------------------


@pytest.mark.parametrize("t", [0, 1])
def test_chirp_short_matches_jax(t):
    want = np.asarray(jax_signal.chirp(10.0, 100.0, t))
    got = signal.chirp(10.0, 100.0, t, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape == (t,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


# --- F8 ---------------------------------------------------------------------------------


def test_levinson_places_numpy_input_on_its_device(rng):
    x = rng.standard_normal((3, 400))
    r = np.stack([np.correlate(row, row, "full")[399:412] for row in x]).astype(np.float32)
    got = lpc.levinson(r, device="cpu")
    want = jax_lpc.levinson(r)
    for g, w in zip(got, want, strict=True):
        assert g.device.type == "cpu" and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            lpc.levinson(r)


# --- the two-pass averager's variants ----------------------------------------------------


@pytest.mark.parametrize("variant", CUMSUM_VARIANTS)
def test_two_pass_variants_match_jax(rng, variant):
    x = make_interleaved(rng, 1500, 2)
    want = np.asarray(jax_two_pass(x, 300, 2, variant=variant))
    got = moving_average_two_pass(torch.from_numpy(x), 300, 2, variant=variant).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, moving_average_golden(x, 300, 2))


def test_two_pass_refuses_an_unknown_variant_as_jax_does(rng):
    x = make_interleaved(rng, 100, 2)
    with pytest.raises(ValueError) as want:
        jax_two_pass(x, 5, 2, variant="kogge_stone")
    with pytest.raises(ValueError) as got:
        moving_average_two_pass(torch.from_numpy(x), 5, 2, variant="kogge_stone")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown variant"):
        cumsum(torch.from_numpy(x), 2, variant="kogge_stone")


# --- the planar DFT functions ------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("n", [256, 4096])
def test_dft_factored_matches_jax(rng, n, real, inverse):
    xr = rng.standard_normal((3, n)).astype(np.float32)
    xi = None if real else rng.standard_normal((3, n)).astype(np.float32)
    want = jax_fm.dft_factored(xr, xi, inverse=inverse)
    got = fm.dft_factored(xr, xi, inverse=inverse, device="cpu")
    for g in got:
        assert g.dtype == torch.float32 and g.device.type == "cpu" and g.shape == (3, n)
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    err = max(np.abs(g.numpy() - np.asarray(w)).max() for g, w in zip(got, want, strict=True))
    assert err <= DFT_RTOL * scale


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("real", [True, False])
def test_fft_large_matches_jax(rng, real, inverse):
    n = 16384
    xr = rng.standard_normal((2, n)).astype(np.float32)
    xi = None if real else rng.standard_normal((2, n)).astype(np.float32)
    want = jax_fm.fft_large(xr, xi, inverse=inverse)
    got = fm.fft_large(torch.from_numpy(xr), None if real else torch.from_numpy(xi),
                       inverse=inverse)
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    err = max(np.abs(g.numpy() - np.asarray(w)).max() for g, w in zip(got, want, strict=True))
    assert err <= DFT_RTOL * scale


@pytest.mark.parametrize("n", [256, 4096])
def test_dense_real_dft_matches_jax(rng, n):
    x = rng.standard_normal((2, 3, n)).astype(np.float32)
    got = fm.rfft_dense(x, device="cpu")
    want = jax_fm.rfft_dense(x)
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for g, w in zip(got, want, strict=True):
        assert tuple(g.shape) == (2, 3, n // 2 + 1)
        assert np.abs(g.numpy() - np.asarray(w)).max() <= DFT_RTOL * scale
    # the inverse of the reference's half spectrum, its DC and Nyquist parts included
    y = fm.irfft_dense(*(torch.from_numpy(np.array(w)) for w in want), n)
    assert rel_err(y, jax_fm.irfft_dense(*want, n)) <= DFT_RTOL
    assert rel_err(y, x) <= DFT_RTOL


@pytest.mark.parametrize("detrend", [False, True])
@pytest.mark.parametrize("nfft,hop", [(256, 128), (4096, 1024)])
def test_rfft_dense_framed_matches_jax(rng, nfft, hop, detrend):
    frames = 7
    x = (rng.standard_normal((2, frames * hop + nfft // 2)) + 0.3).astype(np.float32)  # short
    w = np.hanning(nfft).astype(np.float32)
    want = jax_fm.rfft_dense_framed(x, frames, hop, nfft, w, detrend=detrend)
    got = fm.rfft_dense_framed(torch.from_numpy(x), frames, hop, nfft, w, detrend=detrend)
    scale = max(np.abs(np.asarray(v)).max() for v in want)
    for g, v in zip(got, want, strict=True):
        assert tuple(g.shape) == (2, frames, nfft // 2 + 1)
        assert np.abs(g.numpy() - np.asarray(v)).max() <= DFT_RTOL * scale


@pytest.mark.parametrize("call", [
    lambda m: m.dft_factored(np.zeros((2, 300), np.float32), None),
    lambda m: m.fft_large(np.zeros(1000, np.float32), None),
    lambda m: m.fft_large(np.zeros(128 * 128 * 257, np.float32), None),
    lambda m: m.rfft_dense_framed(np.zeros(4096, np.float32), 2, 96, 384, np.ones(384)),
])
def test_dft_refusals_match_jax(call):
    with pytest.raises(ValueError) as want:
        call(jax_fm)
    with pytest.raises(ValueError) as got:
        call(fm)
    assert str(got.value).split(" (use")[0] == str(want.value).split(" (use")[0]


def test_dft_constants_are_the_reference_limits():
    assert (fm.FACTORED_MAX_N, fm.DENSE_RFFT_MAX_N) == (jax_fm.FACTORED_MAX_N,
                                                        jax_fm.DENSE_RFFT_MAX_N)


# --- the K-differential timer --------------------------------------------------------------


@pytest.mark.parametrize("chain", [2, 4, 5, 16, 17])
def test_k_differential_is_the_reference_slope(monkeypatch, chain):
    """The reference's time_phases on a scripted clock: its compute phase is the
    mean over rounds of the port's slope of the same two readings."""
    rounds = [(9.0, 3.0), (12.5, 4.25), (2.0, 5.0)]  # (long chain ms, short chain ms)
    ticks = [0.0, 0.001]  # the first call
    for big, small in rounds:  # t0, t1, after the long chain, after d2h, t4, after the short
        ticks += [0.0, 0.0, big / 1e3, big / 1e3, 0.0, small / 1e3]
    clock = iter(ticks)
    monkeypatch.setattr(jax_profile, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    res = jax_profile.time_phases(lambda v: v + 1.0, np.zeros(16, np.float32), warmup=0,
                                  rounds=len(rounds), chain=chain)
    want = res.compute_ms / res.rounds
    got = np.mean([profile.k_differential(big, small, chain) for big, small in rounds])
    assert got == pytest.approx(want, rel=1e-9, abs=1e-12)
    assert profile.chain_lengths(chain) == (chain, max(chain // 4, 1))
    assert profile.k_differential(2.0, 5.0, chain) == 0.0  # clamped, as the reference clamps


def test_chain_runs_fn_on_its_own_output_and_refuses_a_change_of_shape():
    x = torch.arange(6, dtype=torch.int16)
    assert torch.equal(profile.chained(lambda v: v * 2, 3)(x), x * 8)
    with pytest.raises(ValueError, match="keep shape and dtype"):
        profile.chained(lambda v: v.to(torch.int32), 2)(x)
    with pytest.raises(ValueError, match="keep shape and dtype"):
        profile.chained(lambda v: v[1:], 2)(x)
    with pytest.raises(ValueError, match="chain must be >= 1"):
        profile.time_phases(lambda v: v, np.zeros(4, np.int16), device="cpu", chain=0)


def test_sweep_grid_forwards_chain(monkeypatch, tmp_path):
    seen = []

    def fake(fn, host_input, *, chain=1, **kw):
        seen.append(chain)
        return profile.ProfileResult(compute_ms=1.0, rounds=1)

    monkeypatch.setattr(sweep, "time_phases", fake)
    assert sweep.run_suite([1000], [4], ["windowed", "scan"], [None], str(tmp_path / "s.csv"),
                           verbose=False, device="cpu", chain=4) == 0
    assert seen == [4] * 4  # two variants, staged and resident


@pytest.mark.parametrize("argv", [["--smoke", "--chain", "4"], ["--sizes", "1000", "--chain", "7"]])
def test_sweep_cli_parses_chain_as_the_reference_does(monkeypatch, argv):
    calls = {}

    def recorder(package):
        def run_suite(*args, **kw):
            calls[package] = kw
            return 0
        return run_suite

    monkeypatch.setattr(sweep, "run_suite", recorder("port"))
    monkeypatch.setattr(jax_sweep, "run_suite", recorder("jax"))
    monkeypatch.setattr(device_mod, "resolve_device", lambda d: torch.device("cuda"))
    assert sweep.main(argv) == 0 and jax_sweep.main(argv) == 0
    assert calls["port"]["chain"] == calls["jax"]["chain"] == int(argv[-1])


def test_sweep_subprocesses_get_chain(monkeypatch):
    cmds = []
    monkeypatch.setattr(sweep.subprocess, "run",
                        lambda cmd: cmds.append(cmd) or types.SimpleNamespace(returncode=0))
    monkeypatch.setattr(device_mod, "resolve_device", lambda d: torch.device("cuda"))
    assert sweep.main(["--sizes", "1000", "--grades", "4", "--subprocess", "--chain", "3"]) == 0
    assert len(cmds) == 1 and cmds[0][cmds[0].index("--chain") + 1] == "3"
