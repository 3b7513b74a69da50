"""The port's sharded time-varying IIR and LPC synthesis, the multi-host helpers and
the world of one, against the JAX package.

Four gloo processes on the CPU (``tests/torch_sharded_cases.py``, suite
``tv``) run the cases on a 2x2 (channel, time) mesh once a module; one
process runs suite ``world1``. The JAX package runs the same NumPy inputs on
4 of the 8 virtual CPU devices. Tolerances: the sharded ops equal the port's
one-card op bit for bit (each rank runs it on its channels); against the
JAX package 1e-5 of max|y| for ``sosfilt_tv`` (tests/test_torch_iir_tv.py)
and 1e-4 for the LPC synthesis (tests/test_torch_lpc.py); the averager and
cumsum bit-exact.
"""

import re

import jax
import numpy as np
import pytest

from digital_signal_processsing_tpu.golden import moving_average_golden
from digital_signal_processsing_tpu.parallel import make_mesh
from digital_signal_processsing_tpu.parallel.sharded_tv import (
    sharded_lpc_synthesis,
    sharded_sosfilt_tv,
)
from tests.torch_sharded_cases import (
    HALO_IMPLS,
    LPC,
    averager_input,
    lpc_input,
    run_suite,
    tv_input,
)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_suite("tv", tmp_path_factory.mktemp("sharded_tv"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return run_suite("world1", tmp_path_factory.mktemp("sharded_world1"), world=1)


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(n_time=2, n_channel=2, devices=jax.devices()[:4])


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind", ["shared", "per"])
def test_sharded_sosfilt_tv(port, jmesh, kind):
    x, shared, per = tv_input()
    rows = shared if kind == "shared" else per
    got = port[f"tv/{kind}"]
    np.testing.assert_array_equal(got, port[f"tv/{kind}/one_card"])
    want = np.asarray(sharded_sosfilt_tv(rows, x, mesh=jmesh))
    assert rel_err(got, want) < 1e-5


def test_sharded_lpc_synthesis(port, jmesh):
    a, gain, e = lpc_input()
    np.testing.assert_array_equal(port["lpc"], port["lpc/one_card"])
    want = np.asarray(sharded_lpc_synthesis(a, gain, e, LPC["frame_len"], mesh=jmesh))
    assert rel_err(port["lpc"], want) < 1e-4


def test_topology_summary(port, world1):
    assert port["topology"] == {
        "process_index": 0, "process_count": 4, "local_devices": 1, "global_devices": 4,
        "platform": "cpu", "backend": "gloo",
    }
    assert world1["topology"]["process_count"] == 1


REFUSALS = {
    "tv_ndim": ("ValueError", "channels, time"),
    "tv_rows": ("ValueError", "sos_t must be"),
    "tv_per_channel": ("ValueError", "per-channel schedule"),
    "lpc_streams": ("ValueError", "streams"),
    "hosts_differ": ("RuntimeError", "differs across hosts"),
    "mesh_shape": ("ValueError", "ranks"),
    "axis": ("ValueError", "unknown mesh axis"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_sharded_tv_refusals(port, name):
    kind, pattern = REFUSALS[name]
    got = port[f"error/{name}"]
    assert isinstance(got, tuple) and got[1] == kind and re.search(pattern, got[2]), got


@pytest.mark.parametrize("halo_impl", HALO_IMPLS)
@pytest.mark.parametrize("method", ["windowed", "scan"])
def test_world_of_one(world1, method, halo_impl):
    # one rank is its own neighbour; its halo is the causal zeros
    x = averager_input(257, 2)
    np.testing.assert_array_equal(world1[f"avg/{method}/{halo_impl}"],
                                  moving_average_golden(x, 257, 2))


def test_world_of_one_ring_and_cumsum(world1):
    x = averager_input(257, 2)
    np.testing.assert_array_equal(world1["ring"], np.zeros_like(x))
    want = np.cumsum(x.reshape(-1, 2).astype(np.int64), axis=0).astype(np.int32).reshape(-1)
    np.testing.assert_array_equal(world1["cumsum"], want)
