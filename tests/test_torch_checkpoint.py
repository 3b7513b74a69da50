"""The port's checkpoints (``utils/checkpoint.py``): resume bit for bit, the
reference's npz layout, and the refusals.

A training run checkpointed after 3 steps and resumed in a fresh
``AdaptiveFir`` replays the next 2 steps bit for bit (the reference's rule,
tests/test_harness.py:97-128); a streaming averager killed after 3000 frames
and resumed from its file continues bit for bit against the golden model
(tests/test_streaming.py:91-107). A file the JAX package's ``save_pytree``
wrote loads into the port's state, and one the port wrote into the JAX
package's. A load refuses a structure that differs from its template (naming
"leaves") and a dtype that differs (naming "dtype"), and never casts.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import streaming as jax_streaming
from digital_signal_processsing_tpu.utils import checkpoint as jax_checkpoint
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.models import adaptive
from digital_signal_processsing_tpu_torch.ops import streaming
from digital_signal_processsing_tpu_torch.utils import checkpoint


def test_training_resume_is_bit_exact(tmp_path, rng):
    x = torch.from_numpy(rng.normal(size=(2, 512)).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(2, 512)).astype(np.float32))
    fir = adaptive.AdaptiveFir.create(4, 1e-2, device="cpu")
    for _ in range(3):
        adaptive.lms_train_step(fir, x, d)
    ckpt = tmp_path / "state.npz"
    checkpoint.save_training_state(ckpt, fir.taps, fir.opt_state(), 3)
    for _ in range(2):
        adaptive.lms_train_step(fir, x, d)

    fresh = adaptive.AdaptiveFir.create(4, 1e-2, device="cpu")
    taps, state, step = checkpoint.load_training_state(ckpt, fresh.opt_state())
    assert step == 3 and isinstance(state, adaptive.AdamState) and float(state.step) == 3.0
    fresh.restore(taps, state)
    for _ in range(2):
        adaptive.lms_train_step(fresh, x, d)
    assert torch.equal(fresh.taps, fir.taps)
    for a, b in zip(fresh.opt_state(), fir.opt_state()):
        assert torch.equal(a, b)
    assert not list(tmp_path.glob("*.tmp"))  # written beside and renamed over


def test_training_state_layout_is_the_reference_s(tmp_path):
    fir = adaptive.AdaptiveFir.create(3, device="cpu")
    checkpoint.save_training_state(tmp_path / "s.npz", fir.taps, fir.opt_state(), 7)
    with np.load(tmp_path / "s.npz") as z:
        assert set(z.files) == {"taps", "step", "num_leaves", "treedef", "leaf_0", "leaf_1",
                                "leaf_2"}
        assert int(z["step"]) == 7 and int(z["num_leaves"]) == 3
        assert z["taps"].dtype == np.float32
        tag = bytes(z["treedef"].tobytes()).decode()
    assert tag == "AdamState(step=*, exp_avg=*, exp_avg_sq=*)"


def test_training_state_refusals(tmp_path):
    fir = adaptive.AdaptiveFir.create(3, device="cpu")
    path = tmp_path / "s.npz"
    checkpoint.save_training_state(path, fir.taps, fir.opt_state(), 1)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_training_state(path, (torch.zeros(3), torch.zeros(3)))

    class Other(NamedTuple):  # the same leaf count, another structure
        count: torch.Tensor
        mu: torch.Tensor
        nu: torch.Tensor

    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_training_state(path, Other(*fir.opt_state()))
    st = fir.opt_state()
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_training_state(path, st._replace(exp_avg=st.exp_avg.double()))


def test_training_files_of_the_two_packages_refuse_each_other(tmp_path):
    """Same layout, other structure tags: neither package unflattens the other's
    optimizer state into its own slots."""
    import jax.numpy as jnp
    import optax

    tx = optax.adam(1e-2)
    jax_checkpoint.save_training_state(tmp_path / "jax.npz", jnp.zeros(3), tx.init(jnp.zeros(3)), 2)
    fir = adaptive.AdaptiveFir.create(3, device="cpu")
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_training_state(tmp_path / "jax.npz", fir.opt_state())
    checkpoint.save_training_state(tmp_path / "port.npz", fir.taps, fir.opt_state(), 2)
    with pytest.raises(ValueError):
        jax_checkpoint.load_training_state(tmp_path / "port.npz", tx.init(jnp.zeros(3)))


def test_moving_average_kill_and_resume(tmp_path, rng):
    w, c = 100, 2
    x = rng.integers(-32768, 32768, size=4096 * c, dtype=np.int16)
    want = moving_average_golden(x, w, c)
    state = streaming.moving_average_init(w, c, device="cpu")
    state, y1 = streaming.moving_average_chunk(state, torch.from_numpy(x[:3000]), w, c)
    checkpoint.save_pytree(tmp_path / "stream.npz", state)
    del state  # the process ends here

    restored = checkpoint.load_pytree(tmp_path / "stream.npz",
                                      streaming.moving_average_init(w, c, device="cpu"))
    assert isinstance(restored, streaming.MovingAverageState)
    _, y2 = streaming.moving_average_chunk(restored, torch.from_numpy(x[3000:]), w, c)
    np.testing.assert_array_equal(np.concatenate([y1.numpy(), y2.numpy()]), want)


def test_pytree_files_cross_between_the_packages(tmp_path, rng):
    w, c = 16, 2
    x = rng.integers(-32768, 32768, size=512 * c, dtype=np.int16)
    jstate, _ = jax_streaming.moving_average_chunk(jax_streaming.moving_average_init(w, c), x, w, c)
    jax_checkpoint.save_pytree(tmp_path / "jax.npz", jstate)
    got = checkpoint.load_pytree(tmp_path / "jax.npz", streaming.moving_average_init(w, c,
                                                                                     device="cpu"))
    np.testing.assert_array_equal(got.tail.numpy(), np.asarray(jstate.tail))
    checkpoint.save_pytree(tmp_path / "port.npz", got)
    back = jax_checkpoint.load_pytree(tmp_path / "port.npz", jax_streaming.moving_average_init(w, c))
    np.testing.assert_array_equal(np.asarray(back.tail), np.asarray(jstate.tail))


@dataclasses.dataclass
class Carry:
    state: torch.Tensor
    gain: float
    history: list


def test_pytree_round_trip_of_the_port_s_types(tmp_path):
    tree = {
        "b": Carry(torch.arange(6, dtype=torch.int16).reshape(2, 3), 0.5,
                   [np.ones(2, np.float64), (torch.zeros(1, dtype=torch.int32), None)]),
        "a": adaptive.AdamState(torch.tensor(2.0), torch.ones(3), torch.full((3,), 2.0)),
    }
    checkpoint.save_pytree(tmp_path / "t.npz", tree)
    with np.load(tmp_path / "t.npz") as z:
        assert int(z["num_leaves"]) == 7  # keys in sorted order: "a" first
        np.testing.assert_array_equal(z["leaf_0"], 2.0)
    template = {
        "b": Carry(torch.zeros(2, 3, dtype=torch.int16), 0.0,
                   [np.zeros(2), (torch.zeros(1, dtype=torch.int32), None)]),
        "a": adaptive.AdamState(torch.tensor(0.0), torch.zeros(3), torch.zeros(3)),
    }
    got = checkpoint.load_pytree(tmp_path / "t.npz", template)
    assert isinstance(got["b"], Carry) and got["b"].gain == 0.5 and got["b"].history[1][1] is None
    assert torch.equal(got["b"].state, tree["b"].state)
    assert isinstance(got["a"], adaptive.AdamState) and torch.equal(got["a"].exp_avg_sq,
                                                                    tree["a"].exp_avg_sq)
    np.testing.assert_array_equal(got["b"].history[0], np.ones(2))


def test_pytree_refusals(tmp_path):
    checkpoint.save_pytree(tmp_path / "s.npz", {"a": np.ones(4, np.float64)})
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_pytree(tmp_path / "s.npz", {"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_pytree(tmp_path / "s.npz", {"a": torch.ones(4)})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_pytree(tmp_path / "s.npz", {"a": np.ones(4), "b": np.ones(4)})
    checkpoint.save_pytree(tmp_path / "i.npz", streaming.MovingAverageState(
        torch.zeros(8, dtype=torch.int32)))
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.load_pytree(tmp_path / "i.npz", streaming.moving_average_init(4, 2,
                                                                                 device="cpu"))
