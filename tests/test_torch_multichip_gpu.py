"""The multi-card surface on the card: four processes time-slicing one card over gloo.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_multichip_gpu.py -q

``tests/torch_sharded_cases.py`` suite ``multichip_gpu``: every rank on
cuda:0. ``time_phases(sharding=time_sharding(mesh))`` of the fused-ring
averager reports the same phases on every rank (the slowest rank's), and the
averager is bit-exact against the golden model; ``detect_batch`` over a 2x2
mesh against the one-card call (power and threshold within 1e-5 of max,
detections outside the 1e-4 margin); ``sharded_wideband`` at 64 channels
(B19) within rtol 1e-4 / atol 1e-5 of the one-card receiver;
``device_chunks(sharding=)`` gathered back to the loader's chunks.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.io import WavChunkLoader
from torch_sharded_cases import (  # tests/ is on the path: pytest puts it there
    MC_CHUNK,
    MC_GPU_AVG,
    WORLD,
    _mc_wavs,
    run_suite,
    stream,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return run_suite("multichip_gpu", tmp_path_factory.mktemp("multichip_gpu"), timeout=600)


def test_time_phases_with_a_sharding(port):
    phases = port["time_phases"]
    assert len(phases) == WORLD
    assert all(p == phases[0] for p in phases)  # the slowest rank's, on every rank
    r = phases[0]
    assert r["rounds"] == 3 and r["compute_ms"] > 0 and r["h2d_ms"] > 0 and r["d2h_ms"] > 0
    n, k, c = MC_GPU_AVG
    np.testing.assert_array_equal(port["avg"], moving_average_golden(stream(41, n // c, c), k, c))


def test_detect_batch_over_a_mesh_on_the_card(port):
    (det, power, thresh), (det1, power1, thresh1) = port["radar"], port["radar/one_card"]
    for got, want in ((power, power1), (thresh, thresh1)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    inside = np.abs(power1.astype(np.float64) - thresh1) <= 1e-4 * np.abs(thresh1)
    np.testing.assert_array_equal(det[~inside], det1[~inside])


def test_sharded_wideband_on_the_card(port):
    np.testing.assert_allclose(port["wide"], port["wide/one_card"], rtol=1e-4, atol=1e-5)
    assert all(c["B19"] >= 1 for c in port["counts"])  # each rank's extended shard on B19
    assert all(c["B7"] >= 1 for c in port["counts"])  # the fused ring under time_phases


def test_device_chunks_with_a_sharding_on_the_card(port, tmp_path):
    want = list(WavChunkLoader(_mc_wavs(tmp_path), MC_CHUNK))
    assert len(port["chunks"]) == len(want)
    for got, w in zip(port["chunks"], want):
        np.testing.assert_array_equal(got, w)
