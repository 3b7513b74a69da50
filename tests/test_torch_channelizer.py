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

import types

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
from test_torch_fir import stockham, twiddles, warp_fft, xslot

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


# ---- the kernels of csrc/pfb.cu (B19, B20), in NumPy ---------------------------------


def wrap(s, cap):
    """csrc/pfb.cu wrap(): a slot one ring length out of range brought back."""
    s = np.where(s < 0, s + cap, s)
    return np.where(s >= cap, s - cap, s)


class Out:
    """The caller's output through the kernel's strides, each element written once."""

    def __init__(self, m, n, layout, sign):
        self.m, self.layout, self.im_sign = m, layout, np.float32(-sign)
        if layout == "rows":
            self.sk, self.sm, self.shape = 1, n, (m, n)
        else:
            self.sk, self.sm, self.shape = (m, 1, (n, m)) if layout == "channels" else (2 * m, 2, (n, m))
        self.size = m * n * (2 if layout == "complex" else 1)
        self.re = np.full(self.size + 1, np.nan, np.float32)
        self.im = np.full(self.size + 1, np.nan, np.float32)
        self.written = np.zeros(self.size + 1, np.int64)

    def put(self, k, m, y):
        """put(): Y[m, k] = y where m < M (complex64: re at o, im at o + 1)."""
        k, m, y = np.broadcast_arrays(k, m, y)
        live = m < self.m
        o = k[live] * self.sk + m[live] * self.sm
        self.re[o] = y.real[live]
        self.im[o] = self.im_sign * y.imag[live]
        np.add.at(self.written, o, 1)

    def result(self):
        n = self.size
        if self.layout == "complex":
            assert (self.written[0:n:2] == 1).all() and not self.written[1:n:2].any()
            y = np.empty(n, np.float32)
            y[0::2], y[1::2] = self.re[0:n:2], self.im[0:n:2]
            return y.view(np.complex64).reshape(self.shape)
        assert (self.written[:n] == 1).all()
        return self.re[:n].reshape(self.shape), self.im[:n].reshape(self.shape)


class Ring:
    """The blocks' rings of staged input rows (csrc/pfb.cu stage()): rows outside
    [0, M) zeros, slots never staged NaN, each slot's row recorded."""

    def __init__(self, g, rows_in, blocks):
        self.g, self.rows_in = g, rows_in
        self.slots = np.full((blocks, g.cap, g.rs), np.nan, np.float32)
        self.row_of = np.full((blocks, g.cap), np.iinfo(np.int64).min)

    def stage(self, live, first, count, slot0):
        g = self.g
        for r in range(count):
            row = first + r
            slot = slot0 + r
            assert (slot < 2 * g.cap).all()
            slot = np.where(slot >= g.cap, slot - g.cap, slot)
            ok = (row >= 0) & (row < g.m)
            vals = np.where(ok[:, None], self.rows_in[np.clip(row, 0, g.m - 1)], 0)
            b = np.flatnonzero(live)
            self.slots[b, slot[b], : g.n] = vals[b]
            self.row_of[b, slot[b]] = row[b]

    def read(self, block, f, base, delta, pos):
        """Row f + delta at pos from its slot wrap(base + delta): only the step's
        window [f - lookback, f + rows) is read, and the slot holds that row."""
        g = self.g
        assert (delta >= -g.lookback).all() and (delta < g.rows).all()
        slot = wrap(base + delta, g.cap)
        assert (self.row_of[block, slot] == f + delta).all()
        x = self.slots[block, slot, pos]
        assert not np.isnan(x).any()
        return x


def branch_input(g, ring, rows_in, block, f, base, delta, q, ring_tap):
    """in(f + delta, q): B19's commutator reads row - 1 at N - q for q > 0; the
    ring for resident taps, device memory (zeros off the stream) for the rest."""
    q = np.broadcast_to(q, np.broadcast_shapes(np.shape(q), np.shape(delta)))
    dq = np.where(g.raw & (q > 0), -1, 0)
    pos = np.where(g.raw & (q > 0), g.n - q, q)
    if ring_tap:
        return ring.read(block, f, base, delta + dq, pos)
    row = f + delta + dq
    ok = (row >= 0) & (row < g.m)
    return np.where(ok, rows_in[np.clip(row, 0, g.m - 1), pos], 0).astype(np.float32)


def fma32(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def exact_w(x1, q=1):
    """sincospif of the float32 argument x1 * q, as cos - i sin (float64 rounded)."""
    ang = np.pi * (np.asarray(x1, np.float32).astype(np.float64) * q)
    return (np.cos(ang) - 1j * np.sin(ang)).astype(np.complex64)


def w_const(n, e):
    """csrc/pfb.cu W<N, E>: exp(-2 pi i E / N) rounded once to complex64."""
    return np.complex64(np.exp(-2j * np.pi * (e % n) / n))


def w3m(e, n):
    """csrc/pfb.cu w3m(): W_N^e = W_M^(e / 3) (sincospif of 2u/M, exact) times the
    constant W_N^(e mod 3)."""
    u, w = e // 3, e % 3
    z = exact_w((u * (2.0 / (n // 3))).astype(np.float32))
    return (z * np.where(w == 0, np.complex64(1), np.where(w == 1, w_const(n, 1), w_const(n, 2)))).astype(
        np.complex64)


def radix3(z, n, t, p):
    """csrc/pfb.cu radix3(): Y[k' + Mc] from X_c[k'] (z (..., T, 3, P), k' = j + sT)."""
    j = np.arange(t)
    wj1, wj2 = w3m(j, n), w3m(2 * j, n)
    h3 = np.float32(np.sin(2 * np.pi / 3))
    half = np.float32(0.5)
    out = np.empty_like(z)
    for s in range(p):
        w1 = (wj1 * w_const(n, s * t)).astype(np.complex64)
        w2 = (wj2 * w_const(n, 2 * s * t)).astype(np.complex64)
        x0, t1, t2 = z[..., 0, s], z[..., 1, s] * w1, z[..., 2, s] * w2
        sm, df = t1 + t2, t1 - t2
        mid = x0 - half * sm
        out[..., 0, s] = x0 + sm
        out[..., 1, s] = mid + (h3 * df.imag - 1j * h3 * df.real).astype(np.complex64)
        out[..., 2, s] = mid + (-h3 * df.imag + 1j * h3 * df.real).astype(np.complex64)
    return out


def split(z, zp):
    """split_a, split_b: rows a and b from Z[k] and Z[N - k]."""
    h = np.float32(0.5)
    ya = (h * (z.real + zp.real) + 1j * (h * (z.imag - zp.imag))).astype(np.complex64)
    yb = (h * (z.imag + zp.imag) + 1j * (h * (zp.real - z.real))).astype(np.complex64)
    return ya, yb


def fft_step(g, ring, rows_in, hq, blocks, f, base, out, banks=None):
    """One step of pfb_fft_kernel for the live blocks: the FIR from the ring, the
    plan's passes, the radix-3 pass, the split and the store."""
    k3 = g.k == 3
    K, P, T, M, N = g.k, g.points, g.threads_per_transform, g.sub_n, g.n
    G = ch.PFB_THREADS // T
    b = blocks[:, None, None]
    gg = np.arange(G)[None, :, None]
    jj = np.arange(T)[None, None, :]
    fb, bb = f[:, None, None], base[:, None, None]
    v = np.zeros((blocks.size, G, T, K, P), np.complex64)
    for r in range(g.p):
        ring_tap = r < g.resident
        for c in range(K):
            for s in range(P):
                q = K * (jj + s * T) + c
                h = hq[r][q]
                xa = branch_input(g, ring, rows_in, b, fb, bb, 2 * gg - g.d * r, q, ring_tap)
                xb = branch_input(g, ring, rows_in, b, fb, bb, 2 * gg + 1 - g.d * r, q, ring_tap)
                v[..., c, s] = fma32(h, xa, v[..., c, s].real) + 1j * fma32(h, xb, v[..., c, s].imag)
    rows0 = fb + 2 * gg
    v.real[np.broadcast_to(rows0 >= g.m, v.shape[:3])] = 0  # rows past the end are zero
    v.imag[np.broadcast_to(rows0 + 1 >= g.m, v.shape[:3])] = 0
    for c in range(K):
        x = v[..., c, :]
        if g.warp:
            v[..., c, :] = warp_fft(x, M, P)
        else:
            geo = types.SimpleNamespace(nfft=M, points=P, pair_threads=T, radices=g.radices)
            v[..., c, :] = stockham(x.reshape(-1, T, P), geo, []).reshape(x.shape)
    if k3:
        v = radix3(v, N, T, P)
    if g.warp:
        store_warp(g, v, f, rows0, out)
    else:
        store_block(g, v, f, out)


def store_warp(g, z, f, rows0, out):
    """store_warp(): Z[N - k] from lane T - j (one shuffle) or the lane itself
    (j = 0); the channel-major layouts gather Mi rows x Kc channels a store."""
    K, P, T, M = g.k, g.points, g.threads_per_transform, g.sub_n
    j = np.arange(T)
    partner = (T - j) & (T - 1)
    warp_rows = 64 // T
    mi = min(warp_rows, 32)
    kc = 32 // mi
    lane = np.arange(32)
    tid = np.arange(ch.PFB_THREADS).reshape(-1, 32)  # threads by warp
    for c in range(K):
        for s in range(P):
            zz = z[..., c, s]
            loc = z[..., (K - c) % K, 0] if s == 0 else z[..., K - 1 - c, (P - s) % P]
            far = z[..., K - 1 - c, P - 1 - s][..., partner]
            ya, yb = split(zz, np.where(j == 0, loc, far))
            k0 = s * T + M * c
            if g.layout == "rows":
                out.put(k0 + j, rows0, ya)
                out.put(k0 + j, rows0 + 1, yb)
                continue
            flat_a, flat_b = ya.reshape(ya.shape[0], -1), yb.reshape(yb.shape[0], -1)
            for rc in range(warp_rows // mi):
                for jc in range(T // kc):
                    row = rc * mi + lane % mi
                    src = (row >> 1) * T + jc * kc + lane // mi
                    src_tid = tid[:, src]  # (warps, 32)
                    val = np.where(row % 2 == 1, flat_b[:, src_tid], flat_a[:, src_tid])
                    k = k0 + jc * kc + lane // mi
                    m = f[:, None, None] + np.arange(tid.shape[0])[None, :, None] * warp_rows + row
                    out.put(k, m, val)


def store_block(g, z, f, out):
    """store_block(): Z into each transform's exchange slots, then (row, k)
    elements with the row fastest (channel-major) or k fastest."""
    K, P, T, M, N = g.k, g.points, g.threads_per_transform, g.sub_n, g.n
    G = ch.PFB_THREADS // T
    xs = ch.exchange_slots(N)
    buf = np.full((z.shape[0], G, xs), np.nan, np.complex64)
    hits = np.zeros(xs, np.int64)
    j = np.arange(T)
    for c in range(K):
        for s in range(P):
            sl = xslot(j + s * T + M * c)
            buf[:, :, sl] = z[..., c, s]
            np.add.at(hits, sl, 1)
    assert hits.max() == 1 and hits.sum() == N  # every channel once, no slot shared
    R = 2 * G
    e = np.arange(R * N)
    row, k = (e // N, e % N) if g.layout == "rows" else (e % R, e // R)
    zz = buf[:, row >> 1, xslot(k)]
    zp = buf[:, row >> 1, xslot((N - k) % N)]
    assert not np.isnan(zz).any() and not np.isnan(zp).any()
    ya, yb = split(zz, zp)
    out.put(k, f[:, None] + row, np.where(row % 2 == 1, yb, ya))


def direct_step(g, ring, rows_in, hq, blocks, f, base, out):
    """One step of pfb_direct_kernel: v lines, then Y[k] for k <= N/2 from the
    staged twiddles and Y[N - k] = conj Y[k] beside it."""
    n, rows = g.n, g.rows
    b = blocks[:, None, None]
    row = np.arange(rows)[None, :, None]
    q = np.arange(n)[None, None, :]
    fb, bb = f[:, None, None], base[:, None, None]
    lines = np.zeros((blocks.size, rows, n), np.float32)
    for r in range(g.p):
        x = branch_input(g, ring, rows_in, b, fb, bb, row - g.d * r, q, r < g.resident)
        lines = fma32(hq[r][q], x, lines)
    tw = fm._twiddles(n, "cpu").numpy()
    half = n // 2 + 1
    for k in range(half):
        w = tw[(np.arange(n) * k) % n]
        y = (lines.astype(np.float64) @ w.astype(np.complex128)).astype(np.complex64)
        m = f[:, None] + np.arange(rows)[None, :]
        out.put(k, m, y)
        if k != 0 and 2 * k != n:
            out.put(n - k, m, np.conj(y))


def emulate_pfb(src, raw, n, hq, sign, d, layout):
    """What B19 (raw) and B20 compute, launch by launch, at the wrappers' geometry
    (ops/channelizer.py PfbGeometry): the blocks' walks over their steps."""
    m = src.size // n if raw else src.shape[0]
    g = ch.pfb_geometry(n, hq.shape[0], d, raw, m, layout)
    rows_in = src.reshape(m, n).astype(np.float32)
    out = Out(m, n, layout, sign)
    walk(g, rows_in, hq, out, direct_step if g.plan is None else fft_step)
    return out.result()


def walk(g, rows_in, hq, out, step):
    """csrc/pfb.cu walk(): each block's steps, a run of consecutive ones (the
    look-back kept in the ring, each step's new rows staged one step ahead or at
    its start) or interleaved ones (b, b + blocks, ...; each step staging its own
    look-back into a segment, two with prefetch)."""
    b = np.arange(g.blocks)
    if g.interleave:
        s0, ds = b, g.blocks
        steps = -(-(g.total_steps - s0) // g.blocks)
    else:
        s0, ds = b * g.steps, 1
        steps = np.minimum(g.steps, g.total_steps - s0)
    assert (steps >= 1).all()
    seg = g.lookback + g.rows
    ring = Ring(g, rows_in, g.blocks)
    every = np.ones(g.blocks, bool)
    ring.stage(every, s0 * g.rows - g.lookback, seg, np.zeros_like(b))
    base = np.full(g.blocks, g.lookback)
    for i in range(int(steps.max())):
        live = i < steps
        f = (s0 + i * ds) * g.rows
        fn = f + ds * g.rows
        nxt = wrap(base + g.rows, g.cap)
        if g.interleave:
            base = np.full(g.blocks, (i & 1) * seg * g.prefetch + g.lookback)
            nxt = np.full(g.blocks, ((i + 1) & 1) * seg * g.prefetch)
            if g.prefetch:
                ring.stage(live & (i + 1 < steps), fn - g.lookback, seg, nxt)
            elif i > 0:
                ring.stage(live, f - g.lookback, seg, np.zeros_like(b))
        elif g.prefetch:
            ring.stage(live & (i + 1 < steps), fn, g.rows, nxt)
        elif i > 0:
            ring.stage(live, f, g.rows, base)
        blocks = np.flatnonzero(live)
        step(g, ring, rows_in, hq, blocks, f[blocks], base[blocks], out)
        base = nxt


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


def check_against(src, raw, n, hq, sign, d, layouts=("rows",)):
    """The emulation against float64 and plain within TOL of max|Y|, in each layout."""
    want = formula64(src, raw, n, hq, sign, d)
    pre, pim = plain_planes(src, raw, n, hq, sign, d)
    scale = max(np.abs(want[0]).max(), np.abs(want[1]).max())
    re, im = emulate_pfb(src, raw, n, hq, sign, d, "rows")
    for got, w, pl in ((re, want[0], pre), (im, want[1], pim)):
        assert np.abs(got - w).max() < TOL * scale
        assert np.abs(got - pl).max() < TOL * scale
    if "channels" in layouts:  # the same values, stored transposed
        cre, cim = emulate_pfb(src, raw, n, hq, sign, d, "channels")
        np.testing.assert_array_equal(cre, re.T)
        np.testing.assert_array_equal(cim, im.T)
    if "complex" in layouts:
        y = emulate_pfb(src, raw, n, hq, sign, d, "complex")
        np.testing.assert_array_equal(y, (re + 1j * im).T)
    return re, im


@pytest.mark.parametrize(
    "n,p,d,m",
    [
        (32, 8, 1, 300),  # ragged last step
        (32, 2, 2, 128 * 3),  # whole steps
        (64, 16, 1, 70),
        (128, 8, 2, 4),  # shorter than the look-back
        (256, 8, 1, 33),
        (512, 2, 1, 9),
        (1024, 16, 2, 9),
    ],
)
def test_b19_block_algorithm(rng, n, p, d, m):
    x = stream(rng, n * m)
    x[n * min(m - 1, ch.pfb_rows(n)) - 1] = 40.0  # a spike at a step edge
    hq = rng.normal(size=(p, n)).astype(np.float32)
    check_against(x, True, n, hq, 1, d, ("channels", "complex"))


@pytest.mark.parametrize(
    "n,p,d,m,sign",
    [(48, 8, 1, 200, 1), (96, 2, 2, 50, -1), (64, 8, 2, 129, -1), (7, 3, 1, 600, 1), (1, 4, 1, 10_000, 1),
     (2, 2, 2, 5000, 1)],
)
def test_b20_block_algorithm(rng, n, p, d, m, sign):
    u = rng.normal(size=(m, n)).astype(np.float32)
    hq = rng.normal(size=(p, n)).astype(np.float32)
    check_against(u, False, n, hq, sign, d, ("channels",))


@pytest.mark.parametrize("raw,n,d", [(True, 128, 2), (True, 1024, 1), (False, 64, 1), (False, 48, 2)])
def test_one_row(rng, raw, n, d):
    """M = 1: the row past the end, whose look-back is live, is zeroed before it rides
    the transform beside row 0, so row 0 keeps its own precision."""
    src = stream(rng, n) if raw else rng.normal(size=(1, n)).astype(np.float32)
    hq = rng.normal(size=(8, n)).astype(np.float32)
    if raw:
        src[0] = 1e-3  # row 0 reads only x[0]; the row past it reads the rest
    else:
        hq[0] *= 1e-3  # row 0 takes tap 0 only; the row past it taps 1 and on
    check_against(src, raw, n, hq, 1, d, ("channels", "complex"))


def test_zeros_give_zeros(rng):
    hq = rng.normal(size=(8, 64)).astype(np.float32)
    re, im = emulate_pfb(np.zeros(64 * 100, np.float32), True, 64, hq, 1, 1, "rows")
    assert not re.any() and not im.any()


POW2 = [1 << e for e in range(1, 14)]
RADIX3 = [3 << e for e in range(0, 12)]


@pytest.mark.parametrize("n", POW2 + RADIX3)
def test_every_plan(rng, n):
    """Every FFT plan of B20 (a power of two 2..8192, 3 * 2^a up to 6144) over a
    few steps, a ragged last one, at dilation 2; the radix-3 route at 48, 96, 3072."""
    g = ch.pfb_geometry(n)
    assert g.plan is not None and (g.k == 3) == (n % 3 == 0)
    m = 2 * g.rows + 3
    u = rng.normal(size=(m, n)).astype(np.float32)
    u[g.rows - 1, n // 2] = 30.0  # an impulse at a step edge
    hq = rng.normal(size=(5, n)).astype(np.float32)
    check_against(u, False, n, hq, -1, 2, ("channels",) if n in (48, 96, 3072) else ())


@pytest.mark.parametrize(
    "n,p,d,raw,blocks,line",
    [
        (64, 8, 1, True, 2, 128),  # a block walks several steps, the next one prefetched
        (64, 8, 2, False, 3, 128),
        (64, 8, 2, False, 3, 4096),  # interleaved steps, prefetched
        (1024, 16, 1, True, 2, 128),  # look-back longer than a step (16 rows against 8)
        (1024, 8, 2, False, 2, 128),  # channel-major: interleaved
        (48, 8, 1, False, 2, 128),
        (48, 8, 1, False, 3, 4096),
        (8192, 8, 2, False, 2, 128),  # the look-back cut: the older taps read device memory
        (7, 5, 2, False, 2, 128),
    ],
)
def test_pfb_walk(rng, monkeypatch, n, p, d, raw, blocks, line):
    """The ring across steps: runs of several steps a block and interleaved steps,
    with and without prefetch, look-backs past one step, and a look-back cut to
    fit shared memory."""
    monkeypatch.setattr(ch, "PFB_BLOCKS", blocks)
    monkeypatch.setattr(ch, "PFB_LINE_BYTES", line)
    if line > 128:
        assert ch.pfb_geometry(n, p, d, raw, 10 ** 6, "channels").interleave
    g = ch.pfb_geometry(n, p, d, raw, 1)
    m = 5 * g.rows + 1
    g = ch.pfb_geometry(n, p, d, raw, m)
    assert g.steps > 1 and g.blocks == blocks
    if n == 8192:
        assert g.resident < p and g.lookback < g.full_lookback
    else:
        assert g.resident == p and g.lookback == g.full_lookback
    src = stream(rng, m * n) if raw else rng.normal(size=(m, n)).astype(np.float32)
    hq = rng.normal(size=(p, n)).astype(np.float32)
    check_against(src, raw, n, hq, 1, d, ("complex",) if raw else ("channels",))


@pytest.mark.parametrize("n", [1, 2, 32, 48, 64, 96, 1024, 2048, 8192])
def test_pfb_geometry(n):
    """The shared-memory budget (two blocks an SM at the main path's shapes) and
    the exchange slots, which never collide."""
    for p, d, raw in ((8, 1, n in (32, 64, 1024)), (8, 2, False), (16, 2, False)):
        g = ch.pfb_geometry(n, p, d, raw, 1 << 20)
        assert g.smem_bytes == g.extra_bytes + 4 * g.cap * g.rs <= fm.SMEM_MAX
        assert g.cap == g.lookback + (1 + g.prefetch) * g.rows and g.rows * n <= 1 << 16
        assert g.rs % 4 == 0 and g.rs >= n
        if (n, p) in ((64, 8), (48, 8)) or (n == 1024 and raw):
            assert g.smem_bytes <= ch.PFB_SMEM_TWO and g.resident == p
        if g.plan is not None and not g.warp:
            xs, t = ch.exchange_slots(n), g.threads_per_transform
            tr, pos = np.meshgrid(np.arange(ch.PFB_THREADS // t), np.arange(n), indexing="ij")
            sl = (tr * xs + xslot(pos)).ravel()
            assert np.unique(sl).size == sl.size and sl.max() < g.extra_bytes // 8
    if ch.pfb_plan(n) is None:
        assert n == 1


def test_pfb_twiddles_are_accurate():
    """Every computed twiddle of the plans within 3 float32 ulp of its exact value:
    the Stockham passes' (warp pass 2 and the shared-memory passes) and the
    radix-3 pass's W_N^(j + sT) = W_N^j W_N^(sT)."""
    for (log2m, k3), (p, radices, warp) in ch.PFB_PLANS.items():
        m = 1 << log2m
        t = m // p
        passes = [(p, t)] if warp and t > 1 else []
        ns = 1
        for r in () if warp else radices:
            if ns > 1:
                passes.append((ns, r))
            ns *= r
        for ns, r in passes:
            e = np.arange(ns)
            w = twiddles(e, ns * r, r).astype(np.complex128)
            want = np.exp(-2j * np.pi * e[:, None] * np.arange(r)[None, :] / (ns * r))
            assert np.abs(w - want).max() < 3 * 2.0**-24, (log2m, k3, ns, r)
        if k3:
            n = 3 * m
            j = np.arange(t)
            for s in range(p):
                for mult in (1, 2):
                    w = (w3m(mult * j, n) * w_const(n, mult * s * t)).astype(np.complex128)
                    want = np.exp(-2j * np.pi * mult * (j + s * t) / n)
                    assert np.abs(w - want).max() < 3 * 2.0**-24, (n, s, mult)


def bank_ways(addresses, word_bytes=4):
    """Worst count of distinct words on one bank in a warp's access: 4-byte words
    on 32 banks, or 8-byte words, each half-warp on 16 bank pairs."""
    worst = 1
    for addr in addresses:
        for w in np.asarray(addr).reshape(-1, 32):
            for part in (w,) if word_bytes == 4 else (w[:16], w[16:]):
                words = np.unique(part)
                worst = max(worst, np.bincount(words % (128 // word_bytes)).max())
    return worst


@pytest.mark.parametrize("n,raw,d", [(64, True, 1), (64, False, 2), (1024, True, 1), (48, False, 1)])
def test_pfb_exchange_banks(n, raw, d):
    """The main path's shared-memory accesses: the FIR's ring reads (each warp's
    lanes on distinct banks at n = 64 and 1024, but for B19's first point, where
    lane 0 reads q = 0 from the row itself and the others the row before, and
    at n = 48's stride-3 points: at most two-way), and n = 1024's exchanges and
    store reads (at most two-way, B8's plan at nfft 1024)."""
    g = ch.pfb_geometry(n, 8, d, raw, 1 << 20)
    k, p, t = g.k, g.points, g.threads_per_transform
    tid = np.arange(ch.PFB_THREADS)
    gg, j = tid // t, tid % t
    reads, first = [], []
    for r in range(g.resident):
        for c in range(k):
            for s in range(p):
                q = k * (j + s * t) + c
                dq = np.where(raw & (q > 0), -1, 0)
                pos = np.where(raw & (q > 0), n - q, q)
                for rowoff in (0, 1):
                    slot = wrap(g.lookback + 2 * gg + rowoff - d * r + dq, g.cap)
                    (first if raw and s == c == 0 else reads).append(slot * g.rs + pos)
    assert bank_ways(reads) == (2 if n == 48 else 1)
    assert not first or bank_ways(first) == 2
    if g.warp:
        return
    xs = ch.exchange_slots(n)
    ns, acc = 1, []
    for step, r in enumerate(g.radices):
        q_of = p // r
        if step < len(g.radices) - 1:
            for q in range(q_of):
                b = j + q * t
                dd = (b // ns) * (ns * r) + b % ns
                acc += [gg * xs + xslot(dd + kk * ns) for kk in range(r)]
            acc += [gg * xs + xslot(j + s * t) for s in range(p)]
        ns *= r
    rows = 2 * (ch.PFB_THREADS // t)
    for i in range(0, rows * n, ch.PFB_THREADS):  # the store's reads, the row fastest
        e = i + tid
        kk, row = e // rows, e % rows
        acc += [(row >> 1) * xs + xslot(kk), (row >> 1) * xs + xslot((n - kk) % n)]
    assert bank_ways(acc, 8) <= 2
