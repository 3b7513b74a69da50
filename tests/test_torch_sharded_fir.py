"""The port's sharded FIR, receiver chain and pipelined cascade against the JAX package.

Four gloo processes on the CPU (``tests/torch_sharded_cases.py``, suite
``fir``) run the cases on a 1x4 and a 2x2 (channel, time) mesh once a
module; the JAX package runs the same NumPy inputs on 4 of the 8 virtual
CPU devices. Tolerances, relative to max|y|, are the port's single-card
ones: 1e-4 against the JAX package's FIR (tests/test_torch_fir.py: a direct
and an FFT route, or two FFT segmentations, sum in another order) and 1e-5
against the port's own unsharded FIR of the same method; the chain
rtol=1e-3, atol=1e-4 after its ramp (tests/test_torch_chain.py); the
cascade rtol=1e-4, atol=1e-5 (the JAX package's, tests/test_sharded.py).
"""

import re

import jax
import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.models import ChainConfig as JaxChainConfig
from digital_signal_processsing_tpu.models import DspChain as JaxDspChain
from digital_signal_processsing_tpu.ops.fir import fir_direct as jax_fir_direct
from digital_signal_processsing_tpu.parallel import make_mesh, sharded_fir_filter
from digital_signal_processsing_tpu.parallel.pipeline import sharded_chain
from digital_signal_processsing_tpu.parallel.pipeline_parallel import pipelined_fir_cascade
from digital_signal_processsing_tpu_torch.models import ChainConfig, DspChain
from digital_signal_processsing_tpu_torch.ops import fir
from digital_signal_processsing_tpu_torch.ops.fir import FIR_FFT_CROSSOVER
from tests.torch_sharded_cases import (
    CHAINS,
    FIR_BIG,
    FIR_METHODS,
    FIR_MESHES,
    FIR_SHAPE,
    FIR_TAPS,
    cascade_input,
    chain_input,
    fir_taps,
    run_suite,
    signal,
)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_suite("fir", tmp_path_factory.mktemp("sharded_fir"))


@pytest.fixture(scope="module")
def jmeshes():
    d = jax.devices()[:4]
    return {"1x4": make_mesh(n_time=4, n_channel=1, devices=d),
            "2x2": make_mesh(n_time=2, n_channel=2, devices=d)}


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("k", FIR_TAPS)
@pytest.mark.parametrize("method", FIR_METHODS)
@pytest.mark.parametrize("mesh", FIR_MESHES)
def test_sharded_fir_matches_jax(port, jmeshes, mesh, method, k):
    x, h = signal(1, FIR_SHAPE), fir_taps(k)
    got = port[f"fir/{mesh}/{method}/{k}"]
    want = np.asarray(sharded_fir_filter(x, h, mesh=jmeshes[mesh], method=method))
    assert rel_err(got, want) < 1e-4
    one_card = fir.fir_filter(torch.from_numpy(x), h, method=method).numpy()
    assert rel_err(got, one_card) < 1e-5
    if method == "auto":
        want_route = "direct" if k <= FIR_FFT_CROSSOVER else "overlap_save_fused"
        assert port[f"fir/{mesh}/{method}/{k}#route"] == want_route


def test_sharded_fir_flat_stream(port, jmeshes):
    x, h = signal(1, FIR_SHAPE)[0], fir_taps(129)
    want = np.asarray(sharded_fir_filter(x, h, mesh=jmeshes["1x4"], method="direct"))
    assert port["fir/flat"].shape == x.shape and rel_err(port["fir/flat"], want) < 1e-4
    assert rel_err(port["fir/flat"], np.asarray(jax_fir_direct(x, h))) < 1e-4


def test_sharded_fir_auto_long_taps(port, jmeshes):
    # above the reference's crossover: its fused kernel (interpret mode), the
    # port's fused route (B8's plain version here)
    shape, k = FIR_BIG
    x, h = signal(2, shape), fir_taps(k)
    want = np.asarray(sharded_fir_filter(x, h, mesh=jmeshes["2x2"]))
    assert rel_err(port["fir/big"], want) < 1e-4
    assert port["fir/big#route"] == "overlap_save_fused"


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("name", list(CHAINS))
def test_sharded_chain_matches_jax(port, jmeshes, name, planar):
    mesh, cfg, _ = CHAINS[name]
    iq = chain_input(name)
    want = np.asarray(sharded_chain(JaxDspChain(JaxChainConfig(**cfg)), iq, jmeshes[mesh]))
    got = port[name + ("/planar" if planar else "")]
    one_card = DspChain(ChainConfig(**cfg), device="cpu")(torch.from_numpy(iq)).numpy()
    assert got.shape == want.shape == one_card.shape
    # the FM ramp: near-zero phasors make angle() amplify float jitter
    ramp = (cfg["channel_taps"] + 8 * cfg["decimation"]) // cfg["decimation"] + cfg["audio_taps"]
    np.testing.assert_allclose(got[:, ramp:], want[:, ramp:], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[:, ramp:], one_card[:, ramp:], rtol=1e-3, atol=1e-4)


def test_pipelined_fir_cascade(port, jmeshes):
    chunks, taps = cascade_input()
    want = np.asarray(pipelined_fir_cascade(chunks, taps, mesh=jmeshes["1x4"]))
    np.testing.assert_allclose(port["cascade"], want, rtol=1e-4, atol=1e-5)
    m, c, L = chunks.shape
    seq = torch.from_numpy(chunks.transpose(1, 0, 2).reshape(c, m * L).copy())
    for h in taps:
        seq = fir.fir_direct(seq, h)
    got = port["cascade"].transpose(1, 0, 2).reshape(c, m * L)
    np.testing.assert_allclose(got, seq.numpy(), rtol=1e-4, atol=1e-5)


REFUSALS = {
    "chain_halo": "halo",
    "chain_channels": "channels",
    "chain_decimation": "decimation",
    "fir_taps": "exceeds one time shard",
    "fir_method": "unknown method",
    "cascade_stages": "stages",
    "shard_divisible": "divisible",
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_sharded_fir_refusals(port, name):
    got = port[f"error/{name}"]
    assert isinstance(got, tuple) and got[1] == "ValueError", got
    assert re.search(REFUSALS[name], got[2]), got
