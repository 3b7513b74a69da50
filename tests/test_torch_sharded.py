"""The port's sharded averager, cumsum and ring shift against the JAX package.

Four gloo processes on the CPU (``tests/torch_sharded_cases.py``) run every
case through the port's ``parallel`` package once a module, and gather each
output with the port's sharding helpers. Each parametrised test holds one
case against the JAX package's sharded function on 4 of the 8 virtual CPU
devices (``tests/conftest.py``) and against its golden model: bit-exact,
as the integer averager and cumsum are. On the CPU the port takes the plain
versions of B1, B2, B4, B6 and B7 (the ``ppermute`` spelling for the ring);
B7's block split is emulated in ``tests/test_torch_ring_geometry.py`` and
the kernels run on the card in ``tests/test_torch_ring_gpu.py``.
"""

import re

import jax
import numpy as np
import pytest

from digital_signal_processsing_tpu.golden import moving_average_golden
from digital_signal_processsing_tpu.parallel import sharded_cumsum, sharded_moving_average
from digital_signal_processsing_tpu.parallel.mesh import make_time_mesh
from digital_signal_processsing_tpu.parallel.ring_pallas import ring_shift_right
from tests.torch_sharded_cases import (
    AVERAGER_CONFIGS,
    AVERAGER_METHODS,
    CARRY_IMPLS,
    GIANT,
    HALO_IMPLS,
    PACKED,
    RING_SHAPES,
    SEQ,
    averager_input,
    giant_input,
    packed_input,
    ring_input,
    run_suite,
    seq_input,
)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_suite("averager", tmp_path_factory.mktemp("sharded_averager"))


@pytest.fixture(scope="module")
def jmesh():
    return make_time_mesh(jax.devices()[:4])


def cumsum64(x, channels):
    return np.cumsum(x.reshape(-1, channels).astype(np.int64), axis=0).astype(np.int32).reshape(-1)


@pytest.mark.parametrize("halo_impl", HALO_IMPLS)
@pytest.mark.parametrize("method,use_pallas", AVERAGER_METHODS)
@pytest.mark.parametrize("window,channels", AVERAGER_CONFIGS)
def test_sharded_average_parity(port, jmesh, method, use_pallas, halo_impl, window, channels):
    key = f"avg/{method}/{use_pallas}/{halo_impl}/{window}/{channels}"
    x = averager_input(window, channels)
    want = np.asarray(sharded_moving_average(
        x, window, channels, mesh=jmesh, use_pallas=use_pallas, method=method,
        halo_impl=halo_impl,
    ))
    np.testing.assert_array_equal(want, moving_average_golden(x, window, channels))
    np.testing.assert_array_equal(port[key], want)
    route = "scan" if method == "scan" or not use_pallas else "windowed"
    if route == "windowed" and halo_impl == "fused_ring":
        route = "fused_ring"
    assert port[key + "#route"] == route


@pytest.mark.parametrize("window,channels", AVERAGER_CONFIGS)
@pytest.mark.parametrize("carry_impl", CARRY_IMPLS)
def test_carry_impls_bit_exact(port, jmesh, carry_impl, window, channels):
    x = averager_input(window, channels)
    want = np.asarray(sharded_moving_average(
        x, window, channels, mesh=jmesh, method="scan", carry_impl=carry_impl
    ))
    np.testing.assert_array_equal(port[f"carry/{carry_impl}/{window}/{channels}"], want)


@pytest.mark.parametrize("window,channels", PACKED)
@pytest.mark.parametrize("halo_impl", HALO_IMPLS)
def test_sharded_packed_bit_exact(port, jmesh, halo_impl, window, channels):
    x = packed_input(window, channels)
    got = port[f"packed/{halo_impl}/{window}/{channels}"]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.int16), moving_average_golden(x, window, channels))
    if channels % 2 == 0:  # the reference's packed route takes whole pair planes only
        want = np.asarray(sharded_moving_average(x.view(np.int32), window, channels, mesh=jmesh))
        np.testing.assert_array_equal(got, want)
    assert port[f"packed/{halo_impl}/{window}/{channels}#route"] == "windowed_packed"


def test_sharded_giant_halo_falls_back_to_scan(port, jmesh):
    x = giant_input()
    want = np.asarray(sharded_moving_average(x, *GIANT, mesh=jmesh))
    np.testing.assert_array_equal(want, moving_average_golden(x, *GIANT))
    np.testing.assert_array_equal(port["giant"], want)
    assert port["giant#route"] == "scan"


@pytest.mark.parametrize("carry_impl", CARRY_IMPLS)
@pytest.mark.parametrize("use_pallas", [True, False])
def test_sharded_cumsum_parity(port, jmesh, use_pallas, carry_impl):
    x = averager_input(16, 2)
    want = np.asarray(sharded_cumsum(x, 2, mesh=jmesh, use_pallas=use_pallas,
                                     carry_impl=carry_impl))
    np.testing.assert_array_equal(want, cumsum64(x, 2))
    np.testing.assert_array_equal(port[f"cumsum/{use_pallas}/{carry_impl}"], want)


def test_sharded_small_shards(port):
    # shards of 512 samples: the reference falls back to its carry path, the
    # port's windowed kernel takes any shard that holds one halo
    x = averager_input(16, 2)[:2048]
    np.testing.assert_array_equal(port["small_shards"], moving_average_golden(x, 3, 2))
    assert port["small_shards#route"] == "windowed"


@pytest.mark.parametrize("i", range(len(SEQ)))
def test_fused_ring_back_to_back_and_interleaved(port, jmesh, i):
    w, c = SEQ[i]
    x = seq_input(i)
    want = np.asarray(sharded_moving_average(x, w, c, mesh=jmesh, halo_impl="fused_ring"))
    np.testing.assert_array_equal(want, moving_average_golden(x, w, c))
    np.testing.assert_array_equal(port[f"seq/{i}/{w}/{c}"], want)


@pytest.mark.parametrize("name", list(RING_SHAPES))
def test_ring_shift_right_semantics(port, jmesh, name):
    x = ring_input(name)
    got = port[f"ring/{name}"]
    n_loc = x.shape[-1] // 4
    want = np.concatenate([np.zeros_like(x[..., :n_loc]), x[..., :-n_loc]], axis=-1)
    np.testing.assert_array_equal(got, want)
    if x.ndim == 1:
        np.testing.assert_array_equal(got, np.asarray(ring_shift_right(x, jmesh)))


REFUSALS = {
    "halo_too_big": ("ValueError", "halo|shard"),
    "carry_impl": ("ValueError", "carry_impl"),
    "cumsum_carry_impl": ("ValueError", "carry_impl"),
    "packed_odd": ("ValueError", "packed"),
    "packed_scan": ("ValueError", "packed"),
    "method": ("ValueError", "unknown method"),
    "halo_impl": ("ValueError", "halo_impl"),
    "frames": ("ValueError", "whole frames"),
    "window": ("ValueError", "window must be"),
    "fused_envelope": ("ValueError", "envelope"),
    "ring_axis": ("ValueError", "time axis"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_sharded_refusals(port, name):
    kind, pattern = REFUSALS[name]
    got = port[f"error/{name}"]
    assert isinstance(got, tuple) and got[0] == "error", got
    assert got[1] == kind and re.search(pattern, got[2]), got


def test_refusals_match_the_reference(jmesh):
    x = averager_input(16, 2)
    with pytest.raises(ValueError, match="halo|shard"):
        sharded_moving_average(x[:16000], 4000, 2, mesh=jmesh, use_pallas=False)
    with pytest.raises(ValueError, match="carry_impl"):
        sharded_moving_average(x, 257, 2, mesh=jmesh, method="scan", carry_impl="tree?")
    with pytest.raises(ValueError, match="packed"):
        sharded_moving_average(x.view(np.int32), 16, 2, mesh=jmesh, method="scan")
