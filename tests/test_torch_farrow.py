"""The port's Farrow resampler against the JAX package and a float64 oracle.

The same NumPy inputs go through the JAX package (its segment kernel in
interpret mode on the CPU) and the port on the CPU (the plain versions).
``emulate_b21`` does what the blocks of ``csrc/farrow.cu`` do at the
wrapper's launch geometry: one int64 start a segment, the 32-bit phase
inside it, the ragged last segment.

Tolerances:
- ``segmented`` and every method against the JAX package: 2e-5 of max|y|
  (the JAX package's own bound for its segment kernel,
  tests/test_farrow.py:208-209): the cubic in power form against Lagrange
  products, and XLA's own operation order;
- ``matmul`` against ``gather``: atol 2e-6 (tests/test_farrow.py:187);
- the streaming ``farrow_chunk`` against ``gather``: bit-exact, the same
  integer schedule and float32 operations in PyTorch on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import farrow as jfw
from digital_signal_processsing_tpu_torch.ops import farrow as fw
from digital_signal_processsing_tpu_torch.utils import last_choice

TOL = 2e-5
RATES = [(7, 3), (3, 7), (160, 147), (441, 2560), 1.5, np.pi / 3, (46337, 65521)]
EDGES = [0, 1, 130, 1155, 4099, 7001, 9973]  # ragged chunks of a prime length


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t_(a):
    return torch.from_numpy(np.array(a))


def oracle64(x, up, down, m_out):
    """Float64 mirror of the exact integer schedule + Lagrange stencil."""
    ext = np.concatenate([np.zeros((x.shape[0], 4)), x.astype(np.float64)], axis=1)
    num = 4 * up + np.arange(m_out, dtype=np.int64) * down
    n = num // up
    mu = (num % up).astype(np.float64) / up
    g = [ext[:, n - 1 + j] for j in range(4)]
    w0 = -mu * (mu - 1) * (mu - 2) / 6
    w1 = (mu - 1) * (mu + 1) * (mu - 2) / 2
    w2 = -mu * (mu + 1) * (mu - 2) / 2
    w3 = mu * (mu + 1) * (mu - 1) / 6
    return w0 * g[0] + w1 * g[1] + w2 * g[2] + w3 * g[3]


@pytest.mark.parametrize("rate", RATES)
def test_methods_match_jax(rng, rate):
    x = rng.normal(size=(2, 7001)).astype(np.float32)
    up, down = fw.as_rational_rate(rate)
    assert (up, down) == jfw.as_rational_rate(rate)
    assert fw.farrow_output_len(7001, rate) == jfw.farrow_output_len(7001, rate)
    methods = ["auto", "gather", "segmented"] + (["matmul"] if up * down <= fw.MATMUL_MAX_PRODUCT else [])
    gather = None
    for method in methods:
        want = np.asarray(jfw.resample_farrow(x, rate, method=method))
        got = fw.resample_farrow(t_(x), rate, method=method)
        assert rel_err(got.numpy(), want) < TOL, method
        assert last_choice("resample_farrow") == jfw_choice(method, up, down)
        if method == "gather":
            gather = got.numpy()
        if method == "matmul":
            np.testing.assert_allclose(got.numpy(), gather, rtol=0, atol=2e-6)
    assert rel_err(gather, oracle64(x, up, down, gather.shape[1])) < TOL


def jfw_choice(method, up, down):
    if method != "auto":
        return method
    return "matmul" if up * down <= fw.MATMUL_MAX_PRODUCT else "segmented"


def test_segmented_beyond_the_envelope_matches_jax(rng):
    x = rng.normal(size=(2, 30_000)).astype(np.float32)
    rate = (46337, 65521)
    gather = np.asarray(jfw.resample_farrow(x, rate, method="gather"))
    seg = np.asarray(jfw.resample_farrow_segmented(x, rate))
    got = fw.resample_farrow_segmented(t_(x), rate).numpy()
    assert rel_err(got, gather) < TOL and rel_err(got, seg) < TOL


def test_one_channel_and_identity(rng):
    x = rng.normal(size=4096).astype(np.float32)
    y = fw.resample_farrow(t_(x), 1.0)
    np.testing.assert_array_equal(y.numpy(), x[: y.shape[0]])
    for method in ("matmul", "segmented", "gather"):
        y1 = fw.resample_farrow(t_(x), (160, 147), method=method)
        y2 = fw.resample_farrow(t_(x[None]), (160, 147), method=method)
        assert y1.dim() == 1
        np.testing.assert_array_equal(y1.numpy(), y2[0].numpy())


def test_auto_routes_follow_the_envelope(rng):
    x = t_(rng.normal(size=4096).astype(np.float32))
    fw.resample_farrow(x, (160, 147))
    assert last_choice("resample_farrow") == "matmul"
    fw.resample_farrow(x, np.pi / 3)
    assert last_choice("resample_farrow") == "segmented"
    fw.resample_farrow(x, (2048, 2048 + 1))  # 2^22 + 2^11: one past the envelope
    assert last_choice("resample_farrow") == "segmented"


def test_auto_takes_b21_on_the_card(rng, monkeypatch):
    # the routing rule alone, with the tensor taken for a CUDA one and B21's
    # wrapper replaced by its plain version
    calls = []

    def fake(x, rate):
        calls.append(rate)
        return fw.segmented_plain(x, *rate, fw.farrow_output_len(x.shape[-1], rate))

    monkeypatch.setattr(fw, "resample_farrow_segmented", fake)
    monkeypatch.setattr(fw, "_on_cuda", lambda x: True)
    x = t_(rng.normal(size=(2, 4096)).astype(np.float32))
    assert fw.MATMUL_MAX_PRODUCT_CUDA < 6  # below 3/2, the smallest product measured
    for rate in ((3, 2), (160, 147), (441, 2560), (46337, 65521)):
        fw.resample_farrow(x, rate)
        assert last_choice("resample_farrow") == "segmented"
    assert calls == [(3, 2), (160, 147), (441, 2560), (46337, 65521)]
    fw.resample_farrow(x, (441, 2560), method="matmul")  # an explicit method is kept
    assert last_choice("resample_farrow") == "matmul" and len(calls) == 4


# ---- streaming --------------------------------------------------------------------


@pytest.mark.parametrize("rate", [np.pi / 3, (160, 147), 0.731, (3, 7)])
def test_chunks_bit_exact_with_gather(rng, rate):
    x = rng.normal(size=(2, 9973)).astype(np.float32)
    want = fw.resample_farrow(t_(x), rate, method="gather").numpy()
    state = fw.farrow_init(rate, channels=2, device="cpu")
    pieces = []
    for a, b in zip(EDGES[:-1], EDGES[1:]):
        state, y, count = fw.farrow_chunk(state, t_(x[:, a:b]), rate)
        assert y.shape[-1] == fw.farrow_max_chunk_out(b - a, rate) and 0 <= count <= y.shape[-1]
        assert not y[:, count:].any()
        pieces.append(y[:, :count].numpy())
    got = np.concatenate(pieces, axis=-1)
    assert got.shape[1] >= want.shape[1] - 1  # the stencil's tail may defer one
    np.testing.assert_array_equal(got[:, : want.shape[1]], want[:, : got.shape[1]])


@pytest.mark.parametrize("rate", [(160, 147), (3, 7), (441, 2560), 1.5])
def test_matmul_chunks_and_flush_match_one_shot(rng, rate):
    x = rng.normal(size=(2, 9973)).astype(np.float32)
    want = fw.resample_farrow(t_(x), rate, method="matmul").numpy()
    state = fw.farrow_matmul_init(rate, channels=2, device="cpu")
    jstate = jfw.farrow_matmul_init(rate, channels=2)
    pieces = []
    for a, b in zip(EDGES[:-1], EDGES[1:]):
        state, y, count = fw.farrow_matmul_chunk(state, t_(x[:, a:b]), rate)
        jstate, jy, jcount = jfw.farrow_matmul_chunk(jstate, x[:, a:b], rate)
        assert y.shape == jy.shape == (2, fw.farrow_matmul_max_out(b - a, rate))
        assert count == int(jcount) and state.valid == int(jstate.valid)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=2e-6)
        pieces.append(y[:, :count].numpy())
    yf, cf = fw.farrow_matmul_flush(state, rate)
    jyf, jcf = jfw.farrow_matmul_flush(jstate, rate)
    assert yf.shape[-1] == fw.farrow_matmul_flush_cap(rate) and cf == int(jcf)
    np.testing.assert_allclose(yf.numpy(), np.asarray(jyf), rtol=0, atol=2e-6)
    got = np.concatenate(pieces + [yf[:, :cf].numpy()], axis=-1)
    assert got.shape[1] >= want.shape[1]
    np.testing.assert_allclose(got[:, : want.shape[1]], want, rtol=1e-5, atol=1e-5)


def test_states_carry_over_from_jax(rng):
    x = rng.normal(size=(2, 9973)).astype(np.float32)
    rate = (160, 147)
    # the gather spelling: two chunks in JAX, the rest in the port
    jstate = jfw.farrow_init(rate, channels=2)
    pieces = []
    for a, b in zip(EDGES[:3], EDGES[1:3]):
        jstate, y, c = jfw.farrow_chunk(jstate, x[:, a:b], rate)
        pieces.append(np.asarray(y)[:, : int(c)])
    state = fw.farrow_state_from_jax(jstate, device="cpu")
    assert state.phase_num == int(jstate.phase_num)
    for a, b in zip(EDGES[2:-1], EDGES[3:]):
        state, y, c = fw.farrow_chunk(state, t_(x[:, a:b]), rate)
        pieces.append(y[:, :c].numpy())
    got = np.concatenate(pieces, axis=-1)
    want = fw.resample_farrow(t_(x), rate, method="gather").numpy()
    n = min(got.shape[1], want.shape[1])
    np.testing.assert_allclose(got[:, :n], want[:, :n], rtol=0, atol=2e-6)
    # the matmul spelling
    jstate = jfw.farrow_matmul_init(rate, channels=2)
    pieces = []
    for a, b in zip(EDGES[:3], EDGES[1:3]):
        jstate, y, c = jfw.farrow_matmul_chunk(jstate, x[:, a:b], rate)
        pieces.append(np.asarray(y)[:, : int(c)])
    state = fw.farrow_matmul_state_from_jax(jstate, device="cpu")
    for a, b in zip(EDGES[2:-1], EDGES[3:]):
        state, y, c = fw.farrow_matmul_chunk(state, t_(x[:, a:b]), rate)
        pieces.append(y[:, :c].numpy())
    yf, cf = fw.farrow_matmul_flush(state, rate)
    got = np.concatenate(pieces + [yf[:, :cf].numpy()], axis=-1)
    want = fw.resample_farrow(t_(x), rate, method="matmul").numpy()
    np.testing.assert_allclose(got[:, : want.shape[1]], want, rtol=1e-5, atol=1e-5)


def test_refusals(rng):
    with pytest.raises(ValueError, match="positive"):
        fw.as_rational_rate(-1.0)
    with pytest.raises(ValueError, match="too short"):
        fw.resample_farrow(torch.zeros(2), 2.0)
    with pytest.raises(ValueError, match="unknown method"):
        fw.resample_farrow(torch.zeros(100), 2.0, method="mxu")
    x = t_(rng.normal(size=10_000).astype(np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        fw.resample_farrow_segmented(x, (3, 7), segment=100)
    with pytest.raises(ValueError, match="int32 phase"):
        fw.resample_farrow_segmented(x, (3, 2**30))
    with pytest.raises(ValueError, match="too short"):
        fw.resample_farrow_segmented(torch.zeros(3), (3, 7))
    with pytest.raises(ValueError, match="envelope"):
        rate = (65537 // 3, 65536)
        fw.farrow_chunk(fw.farrow_init(rate, device="cpu"), torch.zeros(1 << 20), rate)
    with pytest.raises(ValueError, match="envelope"):
        rate = (1, 2**31 - 1)
        fw.farrow_chunk(fw.farrow_init(rate, device="cpu"), torch.zeros(1 << 20), rate)
    with pytest.raises(ValueError, match="empty"):
        fw.farrow_chunk(fw.farrow_init(2.0, device="cpu"), torch.zeros(0), 2.0)


# ---- the blocks of csrc/farrow.cu (B21), in NumPy ------------------------------------


def emulate_b21(x, up, down, segment=512):
    c, t = x.shape
    m_out = fw.farrow_output_len(t, (up, down))
    blocks = -(-m_out // segment)
    # thread 0 of each block: its int64 start
    m0 = np.arange(blocks, dtype=np.int64) * segment
    num0 = 4 * up + m0 * down
    n0 = num0 // up
    rho0 = (num0 - n0 * up).astype(np.uint32)
    # every thread: the 32-bit phase inside its segment
    i = np.arange(segment, dtype=np.uint32)
    rho = rho0[:, None] + i[None, :] * np.uint32(down)
    assert int(rho0.max()) + (segment - 1) * down < 2**31  # the envelope keeps it exact
    jj = rho // np.uint32(up)
    mu_num = rho - jj * np.uint32(up)
    n = n0[:, None] + jj.astype(np.int64)
    m = m0[:, None] + i.astype(np.int64)
    live = m < m_out  # the ragged last segment
    y = np.full((c, m_out), np.nan, np.float32)
    written = np.zeros((c, m_out), np.int64)
    ext = np.concatenate([np.zeros((c, 4), np.float32), x, np.zeros((c, 4), np.float32)], axis=1)
    xm1, x0, x1, x2 = (ext[:, np.clip(n + j, 0, ext.shape[1] - 1)] for j in (-1, 0, 1, 2))
    third, sixth = np.float32(1 / 3), np.float32(1 / 6)
    v0 = x0
    v1 = -third * xm1 - np.float32(0.5) * x0 + x1 - sixth * x2
    v2 = np.float32(0.5) * (xm1 + x1) - x0
    v3 = sixth * (x2 - xm1) + np.float32(0.5) * (x0 - x1)
    mu = mu_num.astype(np.float32) * np.float32(1.0 / up)
    val = v0 + mu * (v1 + mu * (v2 + mu * v3))
    y[:, m[live]] = val[:, live]
    written[:, m[live]] += 1
    assert (written == 1).all()
    return y


@pytest.mark.parametrize(
    "rate,c,t",
    [((46337, 65521), 2, 30_000), ((46351, 65537), 1, 5), ((3, 7), 3, 100), ((48000, 44100), 2, 4),
     (np.pi / 3, 2, 20_001), ((441, 2560), 1, 70_000)],
)
def test_b21_block_algorithm(rng, rate, c, t):
    up, down = fw.as_rational_rate(rate)
    x = rng.normal(size=(c, t)).astype(np.float32)
    got = emulate_b21(x, up, down)
    want = oracle64(x, up, down, got.shape[1])
    assert rel_err(got, want) < TOL
    plain = fw.resample_farrow_segmented(t_(x), rate).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6 * np.abs(want).max())
