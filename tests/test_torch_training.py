"""The port's block-LMS trainer (``models/adaptive.py``) against the JAX package.

The same seeded NumPy batches (``identify_system`` draws them in the
reference's order) go through the JAX package's trainer (optax's Adam) and the
port's on the CPU (``torch.optim.Adam``, the same update, rounded in another
order). Tolerances: taps within 1e-5 of the JAX package's after the
reference's runs (tests/test_models.py:90-108), and within 1e-6 when a JAX run
is carried over by ``opt_state_from_optax`` and both take 5 more steps; the
loss and its gradient on one batch within 1e-6 of the reference's (relative).

The sharded step runs in 8 gloo processes on a 2 x 4 (channel, time) mesh
(``tests/torch_sharded_cases.py``, suite ``training``): every rank ends with
the same taps, within 1e-5 of the single-process run and of the JAX package's
sharded step on 8 virtual devices. In a world of one it equals the single
step bit for bit (the same halo of zeros, count and sum).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from digital_signal_processsing_tpu.models import adaptive as jax_adaptive
from digital_signal_processsing_tpu.parallel import make_mesh
from digital_signal_processsing_tpu_torch.models import adaptive
from tests.torch_sharded_cases import TRAIN, run_suite


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return run_suite("training", tmp_path_factory.mktemp("training"), world=8)


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return run_suite("training", tmp_path_factory.mktemp("training1"), world=1)


@pytest.fixture(scope="module")
def jax_sharded():
    mesh = make_mesh(n_time=4, n_channel=2)
    tx = optax.adam(TRAIN["lr"])
    step = jax_adaptive.make_sharded_train_step(mesh, tx)
    return jax_adaptive.identify_system(
        np.asarray(TRAIN["true"], np.float32), steps=TRAIN["steps"], batch=TRAIN["batch"],
        train_step=step, tx=tx, seed=TRAIN["seed"],
    )


def test_identify_system_matches_jax():
    true = np.array([0.5, -0.3, 0.2, 0.1, -0.05], np.float32)
    kw = dict(steps=300, batch=(4, 2048), lr=2e-2)
    taps, loss = adaptive.identify_system(true, device="cpu", **kw)
    jtaps, _ = jax_adaptive.identify_system(true, **kw)
    assert taps.dtype == np.float32 and taps.shape == (5,)
    np.testing.assert_allclose(taps, jtaps, atol=1e-5, rtol=0)
    assert loss < 1e-4  # the reference's anchors
    np.testing.assert_allclose(taps, true, atol=2e-2)


def test_identify_system_with_more_taps_than_the_system():
    true = np.array([0.8, -0.4, 0.1], np.float32)
    kw = dict(num_taps=6, steps=40, batch=(2, 1024), lr=5e-2, seed=3)
    taps, _ = adaptive.identify_system(true, device="cpu", **kw)
    jtaps, _ = jax_adaptive.identify_system(true, **kw)
    assert taps.shape == (6,)
    np.testing.assert_allclose(taps, jtaps, atol=1e-5, rtol=0)


def test_loss_and_gradient_match_jax(rng):
    import jax

    taps = rng.normal(size=7).astype(np.float32)
    x = rng.normal(size=(3, 700)).astype(np.float32)
    d = rng.normal(size=(3, 700)).astype(np.float32)
    jl, jg = jax.value_and_grad(jax_adaptive.lms_loss)(jnp.asarray(taps), jnp.asarray(x),
                                                       jnp.asarray(d))
    t = torch.from_numpy(taps).requires_grad_()
    loss = adaptive.lms_loss(t, torch.from_numpy(x), torch.from_numpy(d))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jg)).max())
    y = adaptive._fir_batched(torch.from_numpy(x), torch.from_numpy(taps)).numpy()
    jy = np.asarray(jax_adaptive._fir_batched(jnp.asarray(x), jnp.asarray(taps)))
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-6 * np.abs(jy).max())


def test_opt_state_from_optax_continues_a_jax_run(rng):
    tx = optax.adam(1e-2)
    xs = rng.normal(size=(8, 2, 512)).astype(np.float32)
    ds = rng.normal(size=(8, 2, 512)).astype(np.float32)
    taps = jnp.zeros((4,), jnp.float32)
    state = tx.init(taps)
    for i in range(3):
        taps, state, _ = jax_adaptive.lms_train_step(taps, state, xs[i], ds[i], tx=tx)
    fir = adaptive.opt_state_from_optax(state, taps, 1e-2, device="cpu")
    assert float(fir.opt_state().step) == 3.0
    for i in range(3, 8):
        taps, state, _ = jax_adaptive.lms_train_step(taps, state, xs[i], ds[i], tx=tx)
        adaptive.lms_train_step(fir, torch.from_numpy(xs[i]), torch.from_numpy(ds[i]))
    np.testing.assert_allclose(fir.taps.detach().numpy(), np.asarray(taps), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        adaptive.opt_state_from_optax((), taps, device="cpu")


def test_adaptive_fir_defaults():
    fir = adaptive.AdaptiveFir.create(5, 3e-3, device="cpu")
    assert fir.taps.dtype == torch.float32 and not fir.taps.detach().any()
    group = fir.opt.param_groups[0]
    assert isinstance(fir.opt, torch.optim.Adam) and group["lr"] == 3e-3
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8  # optax.adam's defaults
    st = fir.opt_state()
    assert float(st.step) == 0.0 and st.exp_avg.shape == st.exp_avg_sq.shape == (5,)
    with pytest.raises(ValueError, match="num_taps"):
        adaptive.AdaptiveFir.create(0, device="cpu")


def test_sharded_step_every_rank_equal(sharded):
    by_rank = sharded["sharded/by_rank"]
    assert by_rank.shape == (8, 4)
    assert (by_rank == by_rank[0]).all(), by_rank
    assert sharded["sharded/shape"] == (4, 1024)  # this rank's (ch, t) shard


def test_sharded_step_matches_single_process(sharded):
    taps_1, _ = sharded["single"]
    np.testing.assert_allclose(sharded["sharded/by_rank"][0, :3], taps_1, atol=1e-5, rtol=0)


def test_sharded_step_matches_jax(sharded, jax_sharded):
    jtaps, _ = jax_sharded
    np.testing.assert_allclose(sharded["sharded/by_rank"][0, :3], jtaps, atol=1e-5, rtol=0)
    jtaps_1, _ = jax_adaptive.identify_system(
        np.asarray(TRAIN["true"], np.float32), steps=TRAIN["steps"], batch=TRAIN["batch"],
        lr=TRAIN["lr"], seed=TRAIN["seed"], tx=optax.adam(TRAIN["lr"]))
    np.testing.assert_allclose(sharded["single"][0], jtaps_1, atol=1e-5, rtol=0)


def test_sharded_step_refusals(sharded):
    for name in ("shapes", "halo"):
        err = sharded[f"error/{name}"]
        assert err is not None and err[1] == "ValueError" and "time >=" in err[2], err


def test_sharded_step_in_a_world_of_one_is_the_single_step(world1):
    (taps_sh, loss_sh), (taps_1, loss_1) = world1["world1/sharded"], world1["world1/single"]
    np.testing.assert_array_equal(taps_sh, taps_1)
    assert loss_sh == loss_1
