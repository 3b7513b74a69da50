"""The ring kernels (B6, B7) and B2 seeded, on the card.

Skipped without a CUDA device. On a machine with one (JAX is not needed):

    python -m pytest --noconftest tests/test_torch_ring_gpu.py -q

Four processes share the one card as a ring (gloo coordinates the hosts
at a key's first call; the halos move by B6's put through CUDA IPC mappings
of the neighbours' receive buffers, ordered by counters there on the
device), and every gathered output is held bit for bit against the golden
model over the whole stream: the corners, 64 calls of two keys interleaved
back to back with no host step between a key's second call and its last,
and calls after one rank's stream or host was held back; then world size 1
in this process.
"""

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.ops import launch_counts, reset_launch_counts
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.ops.scan_xla import moving_average_xla
from torch_sharded_cases import (  # tests/ is on the path: pytest puts it there
    B2B_AVERAGER,
    B2B_CALLS,
    HALO_IMPLS,
    HELD,
    HELD_CALLS,
    PACKED,
    RING_CORNERS,
    RING_SHAPES,
    SEQ,
    WORLD,
    packed_input,
    ring_corner_input,
    b2b_input,
    b2b_shift_input,
    ring_input,
    run_suite,
    seq_input,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return run_suite("ring_gpu", tmp_path_factory.mktemp("ring_gpu"), timeout=600)


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import parallel

    store = tmp_path_factory.mktemp("world1") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    mesh = parallel.make_time_mesh(device="cuda")
    yield mesh
    mesh.close()
    dist.destroy_process_group()


@pytest.mark.parametrize("halo_impl", [*HALO_IMPLS, "scan_ring"])
@pytest.mark.parametrize("i", range(len(RING_CORNERS)))
def test_ring_corners_bit_exact(ring, i, halo_impl):
    w, c, _ = RING_CORNERS[i]
    np.testing.assert_array_equal(ring[f"corner/{i}/{halo_impl}"],
                                  moving_average_golden(ring_corner_input(i), w, c))


@pytest.mark.parametrize("i", range(len(SEQ)))
def test_ring_back_to_back_and_interleaved(ring, i):
    w, c = SEQ[i]
    np.testing.assert_array_equal(ring[f"seq/{i}"], moving_average_golden(seq_input(i), w, c))


@pytest.mark.parametrize("window,channels", PACKED)
def test_ring_packed(ring, window, channels):
    got = ring[f"packed/{window}/{channels}"].view(np.int16)
    np.testing.assert_array_equal(got, moving_average_golden(packed_input(window, channels),
                                                             window, channels))


@pytest.mark.parametrize("name", list(RING_SHAPES))
def test_ring_shift_right(ring, name):
    x = ring_input(name)
    n_loc = x.shape[-1] // WORLD
    want = np.concatenate([np.zeros_like(x[..., :n_loc]), x[..., :-n_loc]], axis=-1)
    np.testing.assert_array_equal(ring[f"ring/{name}"], want)


def test_ring_misaligned_source(ring):
    shards = [np.arange(d * 1001, (d + 1) * 1001, dtype=np.int16)[1:] for d in range(WORLD)]
    want = np.concatenate([np.zeros(1000, np.int16), *shards[:-1]])
    np.testing.assert_array_equal(ring["ring/odd"], want)


def test_ring_launch_counts(ring):
    counts = ring["counts"]  # rank 0's wrappers
    b7 = len(RING_CORNERS) + len(SEQ)
    b6 = 2 * len(RING_CORNERS) + len(PACKED) + len(RING_SHAPES) + 1
    assert counts["B7"] == b7 and counts["B6"] == b6, counts


def shifted(x: np.ndarray) -> np.ndarray:
    n_loc = x.shape[-1] // WORLD
    return np.concatenate([np.zeros_like(x[..., :n_loc]), x[..., :-n_loc]], axis=-1)


@pytest.mark.parametrize("j", range(B2B_CALLS))
def test_ring_back_to_back_calls(ring, j):
    """Call j of two keys interleaved, 64 calls each with new data, every rank."""
    w, c = B2B_AVERAGER
    want = moving_average_golden(b2b_input(j), w, c)
    np.testing.assert_array_equal(ring[f"b2b/fused/{j}"], want)
    np.testing.assert_array_equal(ring[f"b2b/shift/{j}"], shifted(b2b_shift_input(j)))


def test_ring_no_host_steps_after_first_call(ring):
    """No barrier, object gather or device synchronisation on any rank between
    a key's second call and its last."""
    none = {"barrier": 0, "all_gather_object": 0, "synchronize": 0}
    assert ring["b2b/host_steps"] == [none] * WORLD


@pytest.mark.parametrize("how", list(HELD))
def test_ring_rank_held_back(ring, how):
    """One rank's stream held by a device sleep, or its host asleep, before its calls."""
    w, c = B2B_AVERAGER
    for j in range(HELD_CALLS):
        np.testing.assert_array_equal(ring[f"held/{how}/fused/{j}"],
                                      moving_average_golden(b2b_input(j), w, c))
        np.testing.assert_array_equal(ring[f"held/{how}/shift/{j}"], shifted(b2b_shift_input(j)))


@pytest.mark.parametrize("tile_samples", [None, 256])
@pytest.mark.parametrize("channels", [1, 2, 16])
@pytest.mark.parametrize("window", [1, 16, 1024])
def test_world_of_one(mesh1, window, channels, tile_samples):
    from digital_signal_processsing_tpu_torch.parallel import ring_pallas

    rng = np.random.default_rng(window + channels)
    x = torch.from_numpy(rng.integers(-32768, 32768, size=(window + 3000) * channels,
                                      dtype=np.int16)).cuda()
    reset_launch_counts()
    got = ring_pallas.fused_ring_windowed_shard(x, window, channels, mesh1,
                                                tile_samples=tile_samples)
    assert torch.equal(got, moving_average_xla(x, window, channels))
    assert torch.equal(ring_pallas.ring_shift_right_shard(x, mesh1), torch.zeros_like(x))
    # a world of one puts nothing: its one rank receives zeros and sends to none
    assert launch_counts()["B7"] == 1 and launch_counts()["B6"] == 0


@pytest.mark.parametrize("window,channels", [(700, 2), (16, 3), (1, 1), (1023, 2)])
def test_packed_seeded_matches_plain(window, channels):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(window)
    words = ps.packed_seed_words(window, channels)
    x = torch.from_numpy(rng.integers(-32768, 32768, size=2 * 40000 * channels,
                                      dtype=np.int16)).cuda()
    seed = x[: 2 * words].view(torch.int32)
    body = x[2 * words :].view(torch.int32)
    got = ps.windowed_averager_packed(body, window, channels, seed=seed)
    want = moving_average_xla(x, window, channels)[2 * words :]
    assert torch.equal(got.view(torch.int16), want)
