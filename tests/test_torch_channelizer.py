"""The port's PFB channelizer and 2x-oversampled bank against the JAX package.

The same NumPy inputs go through the JAX package (its fused Pallas kernels in
interpret mode on the CPU) and the port on the CPU (the plain versions).
``emulate_pfb`` does what the blocks of ``csrc/pfb.cu`` (B19, B20) do, with
the geometry the wrappers pass to the launch: rows a block, the look-back
reads, fft.cuh's padded slots and passes, the bit-reversed read that feeds
the store, the direct DFT for N that is not a power of two, the ragged last
block and the three output layouts.

Tolerance: 1e-5 of max|Y| (the JAX package's own bound between its fused
and composed routes, tests/test_channelizer.py:176-177): the same products
summed in another order, by FFT or by matmul.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu.ops import channelizer as jch
from digital_signal_processsing_tpu.ops import pfb_os as jos
from digital_signal_processsing_tpu.ops.fir import design_lowpass as jax_design_lowpass
from digital_signal_processsing_tpu_torch.ops import channelizer as ch
from digital_signal_processsing_tpu_torch.ops import fft_mxu as fm
from digital_signal_processsing_tpu_torch.ops import pfb_os
from digital_signal_processsing_tpu_torch.utils import last_choice
from test_torch_fir import fft_dif, slot

TOL = 1e-5
METHODS = ("auto", "fused_raw", "fused", "composed")


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def t_(a):
    return torch.from_numpy(np.array(a))


def stream(rng, t):
    return rng.normal(size=t).astype(np.float32)


# ---- pfb_channelize against the JAX package ----------------------------------------


@pytest.mark.parametrize("n,p,blocks", [(32, 8, 308), (64, 4, 100), (16, 8, 64), (48, 8, 40), (8, 1, 64)])
def test_methods_match_jax_composed(rng, n, p, blocks):
    x = stream(rng, n * blocks)
    h = jch.design_prototype(n, p)
    want = np.asarray(jch.pfb_channelize(x, n, jnp.asarray(h), method="composed"))
    for method in METHODS:
        if method == "fused_raw" and not ch.raw_envelope(x.size, n):
            continue
        got = ch.pfb_channelize(t_(x), n, h, method=method)
        assert got.dtype == torch.complex64 and got.shape == (n, blocks)
        assert rel_err(got.numpy(), want) < TOL, method
        assert last_choice("pfb_channelize") == ("composed" if method == "auto" else method)


@pytest.mark.parametrize("n,t", [(32, 128 * 77), (128, 512), (128, 1024), (256, 256 * 8)])
def test_fused_raw_matches_jax_fused_raw(rng, n, t):
    # (128, 512) and (128, 1024): streams shorter than the look-back
    x = stream(rng, t)
    h = jch.design_prototype(n, 8)
    want = np.asarray(jch.pfb_channelize(x, n, jnp.asarray(h), method="fused_raw"))
    got = ch.pfb_channelize(t_(x), n, h, method="fused_raw").numpy()
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("sign", [1, -1])
def test_fused_branch_dft_dilated_matches_jax(rng, sign):
    u = rng.normal(size=(777, 32)).astype(np.float32)
    hq = rng.normal(size=(8, 32)).astype(np.float32)
    jre, jim = jch.fused_branch_dft(jnp.asarray(u), jnp.asarray(hq), sign=sign, dilation=2)
    re, im = ch.fused_branch_dft(t_(u), t_(hq), sign=sign, dilation=2)
    scale = max(np.abs(np.asarray(jre)).max(), np.abs(np.asarray(jim)).max())
    assert np.abs(re.numpy() - np.asarray(jre)).max() < TOL * scale
    assert np.abs(im.numpy() - np.asarray(jim)).max() < TOL * scale


def test_branch_fir_and_dft_matmul_match_jax(rng):
    u = rng.normal(size=(2, 100, 16)).astype(np.float32)
    hq = rng.normal(size=(5, 16)).astype(np.float32)
    for d in (1, 2, 3):
        want = np.asarray(jch.branch_fir(jnp.asarray(u), jnp.asarray(hq), dilation=d))
        assert rel_err(ch.branch_fir(t_(u), t_(hq), dilation=d).numpy(), want) < TOL
    a, b = u[0], u[1]
    for sign in (1, -1):
        for im in (None, b):
            jw = jch.dft_matmul(jnp.asarray(a), None if im is None else jnp.asarray(im), 16, sign=sign)
            pw = ch.dft_matmul(t_(a), None if im is None else t_(im), 16, sign=sign)
            for got, want in zip(pw, jw):
                assert rel_err(got.numpy(), np.asarray(want)) < TOL


def test_layouts_agree(rng):
    x = stream(rng, 64 * 50)
    hq = ch._phase_taps(None, 64, torch.device("cpu"))
    for fn, src in ((ch.fused_pfb_raw, None), (ch.fused_branch_dft, ch.commutate(t_(x), 64))):
        args = (t_(x), 64, hq) if src is None else (src, hq)
        re, im = fn(*args)
        cre, cim = fn(*args, layout="channels")
        y = fn(*args, layout="complex")
        assert re.shape == (50, 64) and cre.shape == (64, 50) and y.shape == (64, 50)
        np.testing.assert_array_equal(cre.numpy(), re.T.numpy())
        np.testing.assert_array_equal(cim.numpy(), im.T.numpy())
        np.testing.assert_array_equal(y.numpy(), (re + 1j * im).T.numpy())


def test_planar_and_synthesis_match_jax(rng):
    n = 16
    x = stream(rng, n * 256)
    ji, jq = jch.pfb_channelize_planar(x, n)
    i, q = ch.pfb_channelize_planar(t_(x), n)
    assert rel_err(i.numpy(), np.asarray(ji)) < TOL and rel_err(q.numpy(), np.asarray(jq)) < TOL
    chans = (rng.normal(size=(8, 256)) + 1j * rng.normal(size=(8, 256))).astype(np.complex64)
    want = np.asarray(jch.pfb_synthesize(jnp.asarray(chans)))
    got = ch.pfb_synthesize(t_(chans))
    assert got.shape == (8 * 256,) and rel_err(got.numpy(), want) < TOL
    wi, wq = jch.pfb_synthesize_planar(jnp.asarray(chans.real.copy()), jnp.asarray(chans.imag.copy()))
    gi, gq = ch.pfb_synthesize_planar(t_(chans.real), t_(chans.imag))
    assert rel_err(gi.numpy(), np.asarray(wi)) < TOL and rel_err(gq.numpy(), np.asarray(wq)) < TOL


def test_design_prototype_matches_jax():
    for n, p in ((16, 8), (64, 8), (48, 4)):
        np.testing.assert_array_equal(ch.design_prototype(n, p), jch.design_prototype(n, p))


# ---- streaming ------------------------------------------------------------------------


def test_chunks_match_one_shot_and_jax(rng):
    n = 32
    x = stream(rng, n * 1024)
    want = ch.pfb_channelize(t_(x), n).numpy()
    state, jstate = ch.pfb_stream_init(n, device="cpu"), jch.pfb_stream_init(n)
    outs, planes, i = [], [], 0
    pstate = state.clone()
    for ln in (n * 4, n * 300, n * 500, n * 220):  # the first chunk shorter than the look-back
        state, y = ch.pfb_channelize_chunk(state, t_(x[i : i + ln]), n)
        jstate, jy = jch.pfb_channelize_chunk(jstate, x[i : i + ln], n)
        pstate, yi, yq = ch.pfb_channelize_chunk_planar(pstate, t_(x[i : i + ln]), n)
        assert rel_err(y.numpy(), np.asarray(jy)) < TOL
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
        outs.append(y.numpy())
        planes.append(yi.numpy() + 1j * yq.numpy())
        i += ln
    assert rel_err(np.concatenate(outs, axis=1), want) < TOL
    assert rel_err(np.concatenate(planes, axis=1), want) < TOL


def test_refusals(rng):
    with pytest.raises(ValueError, match="multiple"):
        ch.pfb_channelize(torch.zeros(100), 16)
    with pytest.raises(ValueError, match="flat"):
        ch.pfb_channelize(torch.zeros(2, 32), 16)
    with pytest.raises(ValueError, match="unknown method"):
        ch.pfb_channelize(torch.zeros(64), 16, method="mxu")
    # the raw kernel's envelope, the reference's ValueError
    for n, t in ((16, 16 * 100), (32, 32 * 5), (256, 256 * 3 + 128), (2048, 2048 * 4)):
        with pytest.raises(ValueError, match="fused_pfb_raw needs"):
            ch.fused_pfb_raw(torch.zeros(t), n, torch.zeros(8, n))
        assert not ch.raw_envelope(t, n)
    with pytest.raises(ValueError, match="fused_pfb_raw needs"):
        ch.pfb_channelize(torch.zeros(32 * 5), 32, method="fused_raw")
    with pytest.raises(ValueError, match="carried state"):
        ch.pfb_channelize_chunk(
            ch.pfb_stream_init(16, device="cpu"), torch.zeros(16 * 64), 16, ch.design_prototype(16, 16)
        )
    with pytest.raises(ValueError, match="layout"):
        ch.fused_branch_dft(torch.zeros(4, 8), torch.zeros(2, 8), layout="cols")
    with pytest.raises(ValueError, match="sign"):
        ch.fused_branch_dft(torch.zeros(4, 8), torch.zeros(2, 8), sign=2)


def test_auto_routes_on_the_card(rng, monkeypatch):
    # the routing rule alone, with every tensor taken for a CUDA one and the
    # kernels' wrappers replaced by their plain versions
    calls = []

    def fake(name, fn):
        def wrapper(*a, **k):
            calls.append(name)
            monkeypatch.setattr(ch, "_on_cuda", lambda x: False)
            try:
                return fn(*a, **k)
            finally:
                monkeypatch.setattr(ch, "_on_cuda", lambda x: True)
        return wrapper

    monkeypatch.setattr(ch, "fused_pfb_raw", fake("B19", ch.fused_pfb_raw))
    monkeypatch.setattr(ch, "fused_branch_dft", fake("B20", ch.fused_branch_dft))
    monkeypatch.setattr(ch, "_on_cuda", lambda x: True)
    cases = [
        (64, 64 * 128, None, "fused_raw", "B19"),
        (1024, 1024 * 3, None, "fused_raw", "B19"),
        (48, 48 * 32, None, "fused", "B20"),
        (16, 16 * 64, None, "fused", "B20"),
        (64, 64 * 129, None, "fused", "B20"),  # T % 128 != 0
        (64, 64 * 128, ch.design_prototype(64, 1), "composed", None),  # one tap a phase
    ]
    for n, t, taps, route, kernel in cases:
        calls.clear()
        ch.pfb_channelize(torch.zeros(t), n, taps)
        assert last_choice("pfb_channelize") == route and calls == ([kernel] if kernel else [])


# ---- the 2x-oversampled bank -------------------------------------------------------


@pytest.mark.parametrize("n", [8, 16])
def test_oversampled_bank_matches_jax(rng, n):
    d = n // 2
    x = stream(rng, d * 96)
    h = jax_design_lowpass(8 * n, 1.0 / n)
    ji, jq = jos.pfb_analyze_os(x, n, jnp.asarray(h))
    yi, yq = pfb_os.pfb_analyze_os(t_(x), n, h)
    assert yi.shape == (n, 96)
    assert rel_err(yi.numpy(), np.asarray(ji)) < TOL and rel_err(yq.numpy(), np.asarray(jq)) < TOL
    g = (h * d).astype(np.float32)
    want = np.asarray(jos.pfb_synthesize_os(ji, jq, n, jnp.asarray(g)))
    got = pfb_os.pfb_synthesize_os(yi, yq, n, g)
    assert got.shape == (96 * d,) and rel_err(got.numpy(), want) < TOL
    with pytest.raises(ValueError, match="even"):
        pfb_os.pfb_analyze_os(t_(x), n + 1, h)
    with pytest.raises(ValueError, match="multiple of N/2"):
        pfb_os.pfb_analyze_os(t_(x[:-1]), n, h)


def test_oversampled_analysis_goes_through_b20_on_the_card(rng, monkeypatch):
    seen = []
    plain = ch.fused_branch_dft

    def fake(u, hq, **kw):
        seen.append(kw)
        return plain(u, hq, **kw)

    monkeypatch.setattr(pfb_os, "fused_branch_dft", fake)
    monkeypatch.setattr(pfb_os, "_on_cuda", lambda x: True)
    x = stream(rng, 4 * 64)
    h = jax_design_lowpass(64, 1.0 / 8)
    yi, yq = pfb_os.pfb_analyze_os(t_(x), 8, h)
    assert seen == [{"sign": 1, "dilation": 2, "layout": "channels"}]
    ji, jq = jos.pfb_analyze_os(x, 8, jnp.asarray(h))
    assert rel_err(yi.numpy(), np.asarray(ji)) < TOL and rel_err(yq.numpy(), np.asarray(jq)) < TOL


# ---- the blocks of csrc/pfb.cu (B19, B20), in NumPy ----------------------------------


def emulate_pfb(src, raw, n, hq, sign, d, layout):
    """What the blocks of B19 (raw) and B20 do, at the wrappers' launch geometry."""
    m = src.size // n if raw else src.shape[0]
    p = hq.shape[0]
    rows = ch.pfb_rows(n)
    fft = n >= 2 and n & (n - 1) == 0
    logn = n.bit_length() - 1
    tw = fm._twiddles(n, "cpu").numpy()
    blocks = -(-m // rows)
    # the loads: thread (g, q) of block b sums its P taps in order, r = 0..P-1
    b, g, q = np.meshgrid(np.arange(blocks), np.arange(rows), np.arange(n), indexing="ij")
    mrow = b * rows + g
    acc = np.zeros(mrow.shape, np.float32)
    for r in range(p):
        mr = mrow - d * r
        if raw:
            idx = mr * n - q
            val = np.where(idx >= 0, src[np.clip(idx, 0, src.size - 1)], 0)
        else:
            val = np.where(mr >= 0, src[np.clip(mr, 0, m - 1), q], 0)
        acc = np.where(mrow < m, acc + hq[r, q] * val.astype(np.float32), acc).astype(np.float32)
    if fft:
        buf = np.zeros((blocks, ch.pfb_smem_bytes(n) // 8), np.complex64)
        buf[:, slot(g[0], q[0], n)] = acc.astype(np.complex64)
        fft_dif(buf, logn, rows, tw, 1)
        k = np.arange(n)
        f = buf[:, slot(np.arange(rows)[:, None], fm.bit_reverse(k, logn)[None, :], n)]
    else:
        j = (np.arange(n)[:, None] * np.arange(n)[None, :]) % n  # q*k mod N, exact
        f = np.einsum("bgq,qk->bgk", acc.astype(np.complex64), tw[j])
    # the store: each (row, k) of the real rows once, at k*sk + m*sm
    if layout == "rows":
        sk, sm, shape = 1, n, (m, n)
    else:
        sk, sm, shape = (m, 1, (n, m)) if layout == "channels" else (2 * m, 2, (n, m))
    size = shape[0] * shape[1] * (2 if layout == "complex" else 1)
    re, im = np.full(size + 1, np.nan, np.float32), np.full(size + 1, np.nan, np.float32)
    written = np.zeros(size + 1, np.int64)
    kk = np.arange(n)[None, None, :]
    o = kk * sk + mrow * sm
    live = mrow < m
    re[o[live]] = f.real[live]
    im[o[live]] = (-sign * f.imag)[live]
    np.add.at(written, o[live], 1)
    if layout == "complex":  # im sits one float past re
        y = np.full(size, np.nan, np.float32)
        y[0::2], y[1::2] = re[0:size:2], im[0:size:2]
        assert (written[0:size:2] == 1).all()
        return y.view(np.complex64).reshape(shape)
    assert (written[:size] == 1).all()
    return re[:size].reshape(shape), im[:size].reshape(shape)


def plain_planes(src, raw, n, hq, sign, d):
    u = ch.commutate(t_(src), n) if raw else t_(src)
    re, im = ch._pfb_plain(u, t_(hq), sign, d, "rows")
    return re.numpy(), im.numpy()


def formula64(src, raw, n, hq, sign, d):
    """The kernels' formula in float64."""
    u = src.reshape(-1, n) if not raw else None
    m = src.size // n if raw else src.shape[0]
    mm, qq = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    v = np.zeros((m, n))
    for r in range(hq.shape[0]):
        mr = mm - d * r
        if raw:
            idx = mr * n - qq
            val = np.where(idx >= 0, src.astype(np.float64)[np.clip(idx, 0, None)], 0)
        else:
            val = np.where(mr >= 0, u.astype(np.float64)[np.clip(mr, 0, None), qq], 0)
        v += hq[r].astype(np.float64) * val
    y = np.fft.fft(v, axis=1)
    return y.real, -sign * y.imag


@pytest.mark.parametrize(
    "n,p,d,m",
    [
        (32, 8, 1, 300),  # ragged last block
        (32, 2, 2, 128 * 3),  # whole blocks
        (64, 16, 1, 70),
        (128, 8, 2, 4),  # shorter than the look-back
        (256, 8, 1, 33),
        (512, 2, 1, 9),
        (1024, 16, 2, 9),
    ],
)
def test_b19_block_algorithm(rng, n, p, d, m):
    x = stream(rng, n * m)
    x[n * min(m - 1, ch.pfb_rows(n)) - 1] = 40.0  # a spike at a block edge
    hq = rng.normal(size=(p, n)).astype(np.float32)
    want = formula64(x, True, n, hq, 1, d)
    re, im = emulate_pfb(x, True, n, hq, 1, d, "rows")
    pre, pim = plain_planes(x, True, n, hq, 1, d)
    scale = max(np.abs(want[0]).max(), np.abs(want[1]).max())
    for got, w, pl in ((re, want[0], pre), (im, want[1], pim)):
        assert np.abs(got - w).max() < TOL * scale
        assert np.abs(got - pl).max() < TOL * scale
    y = emulate_pfb(x, True, n, hq, 1, d, "complex")
    np.testing.assert_array_equal(y, (re + 1j * im).T)
    cre, cim = emulate_pfb(x, True, n, hq, 1, d, "channels")
    np.testing.assert_array_equal(cre, re.T)


@pytest.mark.parametrize(
    "n,p,d,m,sign",
    [(48, 8, 1, 200, 1), (96, 2, 2, 50, -1), (64, 8, 2, 129, -1), (7, 3, 1, 600, 1), (1, 4, 1, 10_000, 1),
     (2, 2, 2, 5000, 1)],
)
def test_b20_block_algorithm(rng, n, p, d, m, sign):
    u = rng.normal(size=(m, n)).astype(np.float32)
    hq = rng.normal(size=(p, n)).astype(np.float32)
    want = formula64(u, False, n, hq, sign, d)
    re, im = emulate_pfb(u, False, n, hq, sign, d, "rows")
    pre, pim = plain_planes(u, False, n, hq, sign, d)
    scale = max(np.abs(want[0]).max(), np.abs(want[1]).max())
    for got, w, pl in ((re, want[0], pre), (im, want[1], pim)):
        assert np.abs(got - w).max() < TOL * scale
        assert np.abs(got - pl).max() < TOL * scale
    cre, cim = emulate_pfb(u, False, n, hq, sign, d, "channels")
    np.testing.assert_array_equal(cim, im.T)


def test_zeros_give_zeros(rng):
    hq = rng.normal(size=(8, 64)).astype(np.float32)
    re, im = emulate_pfb(np.zeros(64 * 100, np.float32), True, 64, hq, 1, 1, "rows")
    assert not re.any() and not im.any()


@pytest.mark.parametrize("n", [1, 2, 32, 48, 64, 96, 1024, 2048, 8192])
def test_pfb_geometry(n):
    rows = ch.pfb_rows(n)
    assert ch.pfb_smem_bytes(n) <= 72 * 1024 and rows * n <= 8192
    if n & (n - 1) == 0 and n >= 2:
        line, pos = np.meshgrid(np.arange(rows), np.arange(n), indexing="ij")
        s = slot(line, pos, n).ravel()
        assert np.unique(s).size == s.size and s.max() < ch.pfb_smem_bytes(n) // 8
