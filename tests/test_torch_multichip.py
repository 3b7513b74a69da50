"""The port's multi-card surface against the JAX package.

Four gloo processes on the CPU (``tests/torch_sharded_cases.py``, suite
``multichip``) run once a module: ``radar.detect_batch(mesh=)`` and
``beamform.spectrum_batch(mesh=)`` with the batch over ``ch`` of a 4x1 and a
2x2 (channel x time) mesh, ``parallel.sharded_wideband`` with the stream
over ``t`` of a 1x4 and a 2x2 mesh, ``io.device_chunks(sharding=)`` and the
refusals. The JAX package runs the same NumPy inputs on the 8 virtual CPU
devices of ``tests/conftest.py`` (``P("ch")`` for the batches, ``P("t")``
for the stream). Tolerances:

- radar: power and threshold within 1e-5 of max|want| (``TOL``); detections
  equal outside the H5 margin of 1e-4 of the threshold
  (``radar.DETECTION_MARGIN``, ``tests/test_torch_radar.py``);
- spectra: Bartlett and MVDR 1e-5 of max|want|, MUSIC 2e-4 (float32
  eigenvectors from two solvers, ``tests/test_torch_beamform.py``);
- the wideband receiver: rtol 1e-4, atol 1e-5 (``tests/test_wideband.py:65``),
  with every channel's level clear of the squelch threshold by more than 1e-3
  of it (the sharded level sums in another order); also on blocks of unequal
  length against the JAX receiver's unsharded call;
- the chunks: equal, shard for shard.

Then ``graft_entry.dryrun_multichip(4, device="cpu")`` once.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from digital_signal_processsing_tpu.io.dataset import WavChunkLoader as JaxLoader
from digital_signal_processsing_tpu.io.dataset import device_chunks as jax_device_chunks
from digital_signal_processsing_tpu.models import beamform as jbf
from digital_signal_processsing_tpu.models import radar as jrad
from digital_signal_processsing_tpu.models.wideband import WidebandConfig as JaxWidebandConfig
from digital_signal_processsing_tpu.models.wideband import WidebandFmReceiver as JaxReceiver
from digital_signal_processsing_tpu.parallel import make_mesh
from digital_signal_processsing_tpu_torch import graft_entry
from digital_signal_processsing_tpu_torch.models import WidebandConfig, WidebandFmReceiver, radar
from digital_signal_processsing_tpu_torch.parallel import wideband_halo
from tests.torch_sharded_cases import (
    BATCH_MESHES,
    BEAM_METHODS,
    MC_BEAM,
    MC_CHUNK,
    MC_MESHES,
    MC_RADAR,
    TIME_MESHES,
    WIDE,
    WIDE_TIGHT_SHARD,
    WIDE_UNEVEN,
    _mc_wavs,
    beam_batch,
    radar_batch,
    run_suite,
    wideband_input,
)

TOL = 1e-5
MUSIC_TOL = 2e-4
SQUELCH_CLEAR = 1e-3


def _jax_receivers():
    return {name: JaxReceiver(JaxWidebandConfig(n_channels=n, audio_taps=a, squelch=sq))
            for name, (n, a, sq, _) in WIDE.items()}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multichip")
    taps = {}
    for rx in _jax_receivers().values():
        c = rx.config
        taps[f"{c.n_channels}/{c.audio_taps}/prototype"] = np.asarray(rx.prototype)
        taps[f"{c.n_channels}/{c.audio_taps}/audio"] = np.asarray(rx.audio_taps)
    np.savez(tmp / "wideband_taps.npz", **taps)
    return run_suite("multichip", tmp)


@pytest.fixture(scope="module")
def jmeshes():
    """The JAX meshes over the 8 virtual devices: a batch over ch, a stream over t."""
    return {"batch": make_mesh(n_time=4, n_channel=2),
            **{m: make_mesh(n_time=t, n_channel=c, devices=jax.devices()[: t * c])
               for m, (t, c) in MC_MESHES.items()}}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def jradar(jmeshes):
    i, q = radar_batch()
    return [np.asarray(v) for v in jrad.detect_batch(jrad.RadarConfig(**MC_RADAR), i, q,
                                                     mesh=jmeshes["batch"])]


@pytest.mark.parametrize("mesh", BATCH_MESHES)
def test_detect_batch_over_a_mesh(port, jradar, mesh):
    det, power, thresh = port[f"radar/{mesh}"]
    jdet, jpower, jthresh = jradar
    assert det.shape == jdet.shape == (8, MC_RADAR["n_pulses"], MC_RADAR["n_range"] - MC_RADAR["pulse_len"] + 1)
    assert rel_err(power, jpower) < TOL
    assert rel_err(thresh, jthresh) < TOL
    inside = radar.near_threshold(torch.tensor(jpower), torch.tensor(jthresh)).numpy()
    np.testing.assert_array_equal(det[~inside], jdet[~inside])
    assert det.sum() > 0  # the targets are detected


@pytest.mark.parametrize("mesh", BATCH_MESHES)
@pytest.mark.parametrize("method", BEAM_METHODS)
def test_spectrum_batch_over_a_mesh(port, jmeshes, mesh, method):
    xi, xq = beam_batch()
    want = np.asarray(jbf.spectrum_batch(jbf.ArrayConfig(**MC_BEAM), xi, xq, method=method,
                                         n_sources=2, mesh=jmeshes["batch"]))
    got = port[f"beam/{method}/{mesh}"]
    assert got.shape == (8, MC_BEAM["n_grid"])
    assert rel_err(got, want) < (MUSIC_TOL if method == "music" else TOL)


def _clear_of_squelch(name: str, x: np.ndarray) -> None:
    """Every channel's level (float64) clear of squelch * max by SQUELCH_CLEAR of it."""
    n, a, squelch, _ = WIDE[name]
    rx = WidebandFmReceiver(WidebandConfig(n_channels=n, audio_taps=a), device="cpu")
    i, q = rx.channelize(torch.from_numpy(x))
    level = np.sqrt(i.double().numpy() ** 2 + q.double().numpy() ** 2).mean(axis=-1)
    gap = np.abs(level - squelch * level.max()) / (squelch * level.max())
    assert gap.min() > SQUELCH_CLEAR, (name, gap.min())


@pytest.mark.parametrize("mesh", TIME_MESHES)
@pytest.mark.parametrize("name", list(WIDE))
def test_sharded_wideband_matches_the_jax_receiver(port, jmeshes, mesh, name):
    n_time = MC_MESHES[mesh][0]
    x = wideband_input(name, n_time)
    _clear_of_squelch(name, x)
    jrx = _jax_receivers()[name]
    want = np.asarray(jrx(jax.device_put(x, NamedSharding(jmeshes[mesh], PartitionSpec("t")))))
    got = port[f"wide/{name}/{mesh}"]
    n = WIDE[name][0]
    assert got.shape == want.shape == (n, x.size // n)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    if name == "fm":  # the gate: only the tone's channel and its image are live
        assert set(np.nonzero(np.abs(got).max(axis=1))[0].tolist()) == {5, n - 5}


def test_sharded_wideband_on_uneven_blocks(port):
    x = wideband_input("fm", len(WIDE_UNEVEN))
    assert x.size == sum(WIDE_UNEVEN)
    _clear_of_squelch("fm", x)
    want = np.asarray(_jax_receivers()["fm"](x))
    got = port["wide/fm/uneven"]
    n = WIDE["fm"][0]
    assert got.shape == want.shape == (n, x.size // n)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert set(np.nonzero(np.abs(got).max(axis=1))[0].tolist()) == {5, n - 5}


def test_tight_case_halo_spans_most_of_a_shard():
    n, a, _, _ = WIDE["tight"]
    rx = WidebandFmReceiver(WidebandConfig(n_channels=n, audio_taps=a), device="cpu")
    halo = wideband_halo(rx)
    # the PFB's 8 steps of look-back, the discriminator's 1 and the audio FIR's 32,
    # rounded up to 128 samples: 41 * 16 = 656 -> 768 of a 1024-sample shard
    assert halo == 768 and halo / WIDE_TIGHT_SHARD == 0.75


@pytest.mark.parametrize("mesh", TIME_MESHES)
def test_device_chunks_with_a_sharding(port, jmeshes, tmp_path, mesh):
    paths = _mc_wavs(tmp_path)
    jmesh = jmeshes[mesh]
    want = list(jax_device_chunks(JaxLoader(paths, MC_CHUNK),
                                  sharding=NamedSharding(jmesh, PartitionSpec("t"))))
    got = port[f"chunks/{mesh}"]  # got[rank][chunk]: each rank's shards, in order
    n_time, n_channel = MC_MESHES[mesh]
    devices = np.asarray(jmesh.devices)  # (ch, t)
    assert all(len(g) == len(want) == 4 for g in got)  # 16002 samples, the last chunk padded
    for j, chunk in enumerate(want):
        by_device = {s.device: np.asarray(s.data) for s in chunk.addressable_shards}
        for rank in range(n_time * n_channel):
            ch, t = divmod(rank, n_time)
            np.testing.assert_array_equal(got[rank][j], by_device[devices[ch, t]])


@pytest.mark.parametrize("name,kind,match", [
    ("radar_uneven", "ValueError", "divisible by 4"),
    ("beam_uneven", "ValueError", "divisible by 2"),
    ("not_a_mesh", "TypeError", "parallel.Mesh"),
    ("wide_halo", "ValueError", "halo 768 exceeds one time shard"),
    ("wide_grid", "ValueError", "whole commutator steps"),
    ("wide_flat", "ValueError", "flat"),
    ("chunks_uneven", "ValueError", "not divisible by 4"),
    ("chunks_not_sharding", "TypeError", "parallel.Sharding"),
    ("time_phases_cpu", "RuntimeError", "CUDA device"),
])
def test_multichip_refusals(port, name, kind, match):
    err = port[f"error/{name}"]
    assert err is not None and err[0] == "error" and err[1] == kind, err
    assert match in err[2], err


def test_dryrun_multichip_on_the_cpu(capsys):
    record = graft_entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip OK: mesh=(2x2)" in capsys.readouterr().out
    assert record["backend"] == "gloo" and record["mesh"] == [2, 2]
    assert np.isfinite(record["loss0"]) and record["loss2"] <= record["loss0"] + 1e-3
    assert len(record["seconds"]) == 4
    # CPU tensors take every wrapper's plain version: no kernel launched
    assert not any(sum(c.values()) for c in record["launches"])


def test_dry_run_counts_leave_out_the_one_process_calls():
    from digital_signal_processsing_tpu_torch import ops

    def reference_call():  # stands for a one-process call that launches B8 twice
        ops.fused_fir.launches += 2
        return 7

    ops.reset_launch_counts()
    try:
        ref = graft_entry._Uncounted()
        assert ref(reference_call) == 7
        ops.fused_fir.launches += 1  # a sharded call's launch
        assert ref.launches["B8"] == 2 and ops.launch_counts()["B8"] == 3
        assert sum(ref.launches.values()) == 2
    finally:
        ops.reset_launch_counts()
