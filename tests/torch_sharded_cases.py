"""Cases of the port's sharded tests, and the worker that runs them on one rank.

    python tests/torch_sharded_cases.py SUITE RANK WORLD STORE OUT

A worker joins a gloo group of WORLD processes on the CPU (rendezvous on the
``FileStore`` STORE), runs every case of SUITE through the port's
``parallel`` package on its shards, gathers each output with the port's
sharding helpers and, on rank 0, pickles ``{case: global output, or
("error", type, message)}`` to OUT. ``run_suite`` spawns the workers.
The inputs are made from NumPy seeds by the functions below, which the tests
(``tests/test_torch_sharded*.py``) call to feed the JAX package the same
arrays. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WORLD = 4

# --- inputs ------------------------------------------------------------------

AVERAGER_CONFIGS = [(16, 2), (257, 2), (1000, 1)]
AVERAGER_METHODS = [("windowed", True), ("scan", True), ("scan", False)]
HALO_IMPLS = ("ppermute", "pallas_ring", "fused_ring")
CARRY_IMPLS = ("ladder", "allgather")
N_AVG = 32768  # samples of an averager stream: 4 shards of 8192
PACKED = [(700, 2), (16, 3), (1, 1)]  # (window, channels) of the pair-view route
N_PACKED_WORDS = 4 * 4096 * 3  # pair words: 4 shards of whole frames for C = 1, 2, 3
# calls of one ring key back to back with new data, and another key between
SEQ = [(16, 2), (1000, 1), (16, 2), (16, 2)]
GIANT = (4096, 16)  # a halo beyond the windowed kernel's envelope: the scan method
RING_SHAPES = {"f32": ((4 * 256,), np.float32), "i16_2d": ((3, 4 * 8), np.int16)}
FIR_MESHES = ("1x4", "2x2")
FIR_METHODS = ("auto", "direct", "overlap_save")
FIR_TAPS = (1, 65, 1025)
FIR_SHAPE = (4, 8192)
FIR_BIG = ((2, 32768), 4045)  # above the reference's crossover: its fused kernel
CHAINS = {
    "chain4": ("2x2", dict(channels=4, decimation=4, channel_taps=65, audio_taps=33), 1 << 14),
    "chain16": ("1x4", dict(channels=16, decimation=8, channel_taps=129, audio_taps=33), 1 << 15),
}
CASCADE = dict(stages=4, k=17, channels=2, micro=6, length=512)
TV_C, TV_N = 4, 2048
LPC = dict(streams=4, frames=6, frame_len=64, order=6)


def stream(seed: int, frames: int, channels: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-32768, 32768, size=frames * channels, dtype=np.int16)


def averager_input(window: int, channels: int) -> np.ndarray:
    return stream(10 * window + channels, N_AVG // channels, channels)


def packed_input(window: int, channels: int) -> np.ndarray:
    """int16 stream whose int32 pair view has N_PACKED_WORDS words."""
    return stream(20 * window + channels, 2 * N_PACKED_WORDS // channels, channels)


def seq_input(i: int) -> np.ndarray:
    w, c = SEQ[i]
    return stream(100 + i, N_AVG // c, c)


def giant_input() -> np.ndarray:
    w, c = GIANT
    return stream(3, 4 * 2 * w, c)  # shards of two halos


def ring_input(name: str) -> np.ndarray:
    shape, dtype = RING_SHAPES[name]
    rng = np.random.default_rng(len(name))
    return (rng.normal(size=shape) * 1000).astype(dtype)


def signal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def fir_taps(k: int) -> np.ndarray:
    return (np.random.default_rng(k).normal(size=k) / np.sqrt(k)).astype(np.float32)


def chain_input(name: str) -> np.ndarray:
    _, cfg, t = CHAINS[name]
    rng = np.random.default_rng(len(name))
    shape = (cfg["channels"], t)
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def cascade_input() -> tuple[np.ndarray, np.ndarray]:
    """((micro, channels, length) chunks of one stream, (stages, k) taps)."""
    p = CASCADE
    rng = np.random.default_rng(5)
    taps = rng.normal(size=(p["stages"], p["k"])).astype(np.float32) * 0.3
    x = rng.normal(size=(p["channels"], p["micro"] * p["length"])).astype(np.float32)
    return x.reshape(p["channels"], p["micro"], p["length"]).transpose(1, 0, 2).copy(), taps


def tv_input() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x, shared (S, T, 6) rows, per-channel (S, C, T, 6) rows)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(TV_C, TV_N)).astype(np.float32)
    r = 0.5 + 0.3 * np.sin(np.linspace(0, 4, TV_N))
    row = np.stack(
        [np.full(TV_N, 0.3), np.zeros(TV_N), np.full(TV_N, 0.05), np.ones(TV_N),
         -2 * r * 0.8, r * r], -1
    ).astype(np.float32)
    shared = np.stack([row, row * np.float32(0.9)], 0)
    per = np.stack([np.stack([row * np.float32(0.8 + 0.05 * i) for i in range(TV_C)], 0)], 0)
    return x, shared, per


def lpc_input() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    p = LPC
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(p["streams"]):
        fr = []
        for _ in range(p["frames"]):
            poles = 0.8 * np.exp(1j * rng.uniform(0.3, np.pi - 0.3, p["order"] // 2))
            fr.append(np.poly(np.concatenate([poles, poles.conj()])).real)
        rows.append(fr)
    a = np.asarray(rows, np.float32)
    gain = rng.uniform(0.5, 1.5, (p["streams"], p["frames"])).astype(np.float32)
    e = rng.normal(size=(p["streams"], p["frames"] * p["frame_len"])).astype(np.float32)
    return a, gain, e


# --- suites (run on every rank) ---------------------------------------------


def _cases_averager(par, out: dict) -> None:
    import torch

    from digital_signal_processsing_tpu_torch.utils import last_choice

    mesh = par.make_time_mesh(device="cpu")
    flat = par.time_sharding(mesh)

    def run(key, fn, sharding=flat):
        try:
            out[key] = sharding.gather(fn()).numpy()
        except Exception as err:  # noqa: BLE001 - every rank records the same refusal
            out[key] = ("error", type(err).__name__, str(err))
        out[key + "#route"] = last_choice("sharded_moving_average")

    for w, c in AVERAGER_CONFIGS:
        xs = flat.shard(torch.from_numpy(averager_input(w, c)))
        for method, use_pallas in AVERAGER_METHODS:
            for h in HALO_IMPLS:
                run(f"avg/{method}/{use_pallas}/{h}/{w}/{c}", lambda: par.sharded_moving_average(
                    xs, w, c, mesh=mesh, use_pallas=use_pallas, halo_impl=h, method=method))
        for ci in CARRY_IMPLS:
            run(f"carry/{ci}/{w}/{c}", lambda: par.sharded_moving_average(
                xs, w, c, mesh=mesh, method="scan", carry_impl=ci))
    for w, c in PACKED:
        xs = flat.shard(torch.from_numpy(packed_input(w, c)).view(torch.int32))
        for h in HALO_IMPLS:
            run(f"packed/{h}/{w}/{c}", lambda: par.sharded_moving_average(
                xs, w, c, mesh=mesh, halo_impl=h))
    xs = flat.shard(torch.from_numpy(giant_input()))
    run("giant", lambda: par.sharded_moving_average(xs, *GIANT, mesh=mesh))
    x = torch.from_numpy(averager_input(16, 2))
    xs = flat.shard(x)
    for use_pallas in (True, False):
        for ci in CARRY_IMPLS:
            run(f"cumsum/{use_pallas}/{ci}", lambda: par.sharded_cumsum(
                xs, 2, mesh=mesh, use_pallas=use_pallas, carry_impl=ci))
    run("small_shards", lambda: par.sharded_moving_average(flat.shard(x[:2048]), 3, 2, mesh=mesh))
    # back to back and interleaved: the ring's two slots and its handshake
    for i, (w, c) in enumerate(SEQ):
        xi = flat.shard(torch.from_numpy(seq_input(i)))
        run(f"seq/{i}/{w}/{c}", lambda: par.sharded_moving_average(
            xi, w, c, mesh=mesh, halo_impl="fused_ring"))
    for name in RING_SHAPES:
        xr = flat.shard(torch.from_numpy(ring_input(name)))
        run(f"ring/{name}", lambda: par.ring_shift_right(xr, mesh))
    xs = flat.shard(torch.from_numpy(averager_input(16, 2)))
    errors = {
        "halo_too_big": lambda: par.sharded_moving_average(xs[:4000], 4000, 2, mesh=mesh,
                                                           use_pallas=False),
        "carry_impl": lambda: par.sharded_moving_average(xs, 257, 2, mesh=mesh, method="scan",
                                                         carry_impl="tree?"),
        "cumsum_carry_impl": lambda: par.sharded_cumsum(xs, 2, mesh=mesh, carry_impl="tree?"),
        "packed_odd": lambda: par.sharded_moving_average(
            torch.zeros(2048, dtype=torch.int32), 16, 3, mesh=mesh),
        "packed_scan": lambda: par.sharded_moving_average(
            xs.view(torch.int32), 16, 2, mesh=mesh, method="scan"),
        "method": lambda: par.sharded_moving_average(xs, 16, 2, mesh=mesh, method="tree"),
        "halo_impl": lambda: par.sharded_moving_average(xs, 16, 2, mesh=mesh, halo_impl="rdma"),
        "frames": lambda: par.sharded_moving_average(xs[:8191], 16, 2, mesh=mesh),
        "window": lambda: par.sharded_moving_average(xs, 0, 2, mesh=mesh),
        "fused_envelope": lambda: par.fused_ring_windowed_shard(
            flat.shard(torch.from_numpy(giant_input())), *GIANT, mesh),
        "ring_axis": lambda: par.ring_shift_right_shard(xs, mesh, "ch"),
    }
    for name, fn in errors.items():
        run(f"error/{name}", fn)


def _cases_world1(par, out: dict) -> None:
    import torch

    mesh = par.make_time_mesh(device="cpu")
    x = torch.from_numpy(averager_input(257, 2))
    for method in ("windowed", "scan"):
        for h in HALO_IMPLS:
            out[f"avg/{method}/{h}"] = par.sharded_moving_average(
                x, 257, 2, mesh=mesh, method=method, halo_impl=h).numpy()
    out["ring"] = par.ring_shift_right(x, mesh).numpy()
    out["cumsum"] = par.sharded_cumsum(x, 2, mesh=mesh).numpy()
    out["topology"] = par.topology_summary()
    par.assert_same_across_hosts(1.5)


def _cases_fir(par, out: dict) -> None:
    import torch

    from digital_signal_processsing_tpu_torch.models import ChainConfig, DspChain
    from digital_signal_processsing_tpu_torch.utils import last_choice

    meshes = {
        "1x4": par.make_mesh(device="cpu"),
        "2x2": par.make_mesh(n_time=2, n_channel=2, device="cpu"),
    }

    def run(key, fn, sharding):
        try:
            out[key] = sharding.gather(fn()).numpy()
        except Exception as err:  # noqa: BLE001
            out[key] = ("error", type(err).__name__, str(err))

    x = torch.from_numpy(signal(1, FIR_SHAPE))
    for mname, mesh in meshes.items():
        planar = par.planar_sharding(mesh)
        xs = planar.shard(x)
        for method in FIR_METHODS:
            for k in FIR_TAPS:
                run(f"fir/{mname}/{method}/{k}", lambda: par.sharded_fir_filter(
                    xs, fir_taps(k), mesh=mesh, method=method), planar)
                out[f"fir/{mname}/{method}/{k}#route"] = last_choice("fir_filter")
    flat = par.time_sharding(meshes["1x4"])
    run("fir/flat", lambda: par.sharded_fir_filter(
        flat.shard(x[0]), fir_taps(129), mesh=meshes["1x4"], method="direct"), flat)
    (shape, k) = FIR_BIG
    planar = par.planar_sharding(meshes["2x2"])
    run("fir/big", lambda: par.sharded_fir_filter(
        planar.shard(torch.from_numpy(signal(2, shape))), fir_taps(k), mesh=meshes["2x2"]), planar)
    out["fir/big#route"] = last_choice("fir_filter")
    for name, (mname, cfg, _) in CHAINS.items():
        chain = DspChain(ChainConfig(**cfg), device="cpu")
        planar = par.planar_sharding(meshes[mname])
        iq = planar.shard(torch.from_numpy(chain_input(name)))
        run(name, lambda: par.sharded_chain(chain, iq, meshes[mname]), planar)
        run(name + "/planar", lambda: par.sharded_chain_planar(
            chain, iq.real.contiguous(), iq.imag.contiguous(), meshes[mname]), planar)
    chunks, taps = cascade_input()
    out["cascade"] = par.pipelined_fir_cascade(
        torch.from_numpy(chunks), taps, mesh=meshes["1x4"]).numpy()
    chain = DspChain(ChainConfig(channels=4, decimation=4, channel_taps=33, audio_taps=17),
                     device="cpu")
    errors = {
        "chain_halo": lambda: par.sharded_chain(chain, torch.zeros(2, 128, dtype=torch.complex64),
                                                meshes["2x2"]),
        "chain_channels": lambda: par.sharded_chain(
            chain, torch.zeros(3, 4096, dtype=torch.complex64), meshes["2x2"]),
        "chain_decimation": lambda: par.sharded_chain(
            chain, torch.zeros(2, 4098, dtype=torch.complex64), meshes["2x2"]),
        "fir_taps": lambda: par.sharded_fir_filter(torch.zeros(2, 64), fir_taps(66),
                                                   mesh=meshes["2x2"]),
        "fir_method": lambda: par.sharded_fir_filter(torch.zeros(2, 64), fir_taps(3),
                                                     mesh=meshes["2x2"], method="fft"),
        "cascade_stages": lambda: par.pipelined_fir_cascade(
            torch.zeros(2, 1, 8), np.zeros((3, 5), np.float32), mesh=meshes["1x4"]),
        "shard_divisible": lambda: par.planar_sharding(meshes["2x2"]).shard(torch.zeros(3, 8)),
    }
    for name, fn in errors.items():
        try:
            fn()
            out[f"error/{name}"] = None
        except Exception as err:  # noqa: BLE001
            out[f"error/{name}"] = ("error", type(err).__name__, str(err))


def _cases_tv(par, out: dict) -> None:
    import torch

    from digital_signal_processsing_tpu_torch.ops import iir, lpc

    mesh = par.make_mesh(n_time=2, n_channel=2, device="cpu")
    rows = _Rows(mesh)
    x, shared, per = tv_input()
    c0, c1 = rows.rows(TV_C)
    xs = torch.from_numpy(x[c0:c1])  # channels over ch, the whole time axis
    out["tv/shared"] = _rows_gather(mesh, par.sharded_sosfilt_tv(shared, xs, mesh=mesh))
    out["tv/per"] = _rows_gather(mesh, par.sharded_sosfilt_tv(per[:, c0:c1], xs, mesh=mesh))
    out["tv/shared/one_card"] = iir.sosfilt_tv(shared, torch.from_numpy(x)).numpy()
    out["tv/per/one_card"] = iir.sosfilt_tv(per, torch.from_numpy(x)).numpy()
    a, gain, e = lpc_input()
    c0, c1 = rows.rows(a.shape[0])
    got = par.sharded_lpc_synthesis(a[c0:c1], gain[c0:c1], torch.from_numpy(e[c0:c1]),
                                    LPC["frame_len"], mesh=mesh)
    out["lpc"] = _rows_gather(mesh, got)
    out["lpc/one_card"] = lpc.lpc_synthesis(a, gain, torch.from_numpy(e), LPC["frame_len"]).numpy()
    out["topology"] = par.topology_summary()
    par.assert_same_across_hosts(2.5, "same")
    errors = {
        "tv_ndim": lambda: par.sharded_sosfilt_tv(shared, xs[0], mesh=mesh),
        "tv_rows": lambda: par.sharded_sosfilt_tv(shared[0], xs, mesh=mesh),
        "tv_per_channel": lambda: par.sharded_sosfilt_tv(per, xs, mesh=mesh),
        "lpc_streams": lambda: par.sharded_lpc_synthesis(
            a, gain, torch.from_numpy(e[:1]), LPC["frame_len"], mesh=mesh),
        "hosts_differ": lambda: par.assert_same_across_hosts(float(mesh.rank), "rank"),
        "mesh_shape": lambda: par.make_mesh(n_time=3, device="cpu"),
        "axis": lambda: mesh.axis_size("x"),
    }
    for name, fn in errors.items():
        try:
            fn()
            out[f"error/{name}"] = None
        except Exception as err:  # noqa: BLE001
            out[f"error/{name}"] = ("error", type(err).__name__, str(err))


class _Rows:
    """This rank's rows of a channel (or stream) axis cut over ``ch``."""

    def __init__(self, mesh):
        self.mesh = mesh

    def rows(self, n: int) -> tuple[int, int]:
        per = n // self.mesh.n_channel
        return self.mesh.ch * per, (self.mesh.ch + 1) * per


def _rows_gather(mesh, y):
    """Every channel's rows, gathered over ``ch`` (ranks along ``t`` repeat them)."""
    import torch

    from digital_signal_processsing_tpu_torch.parallel.mesh import CHANNEL_AXIS, all_gather

    return torch.cat(all_gather(y, mesh, CHANNEL_AXIS), dim=0).numpy()


# the ring on one card: k x C corners, a shard of one halo, one shorter than a tile
RING_CORNERS = [(k, c, k + 777) for k in (1, 16, 1024) for c in (1, 2, 16)] + [
    (1024, 2, 1024), (16, 2, 100),
]


def ring_corner_input(i: int) -> np.ndarray:
    w, c, frames = RING_CORNERS[i]
    return stream(200 + i, WORLD * frames, c)


# calls of two ring keys interleaved back to back, new data each call, no host
# step between them: B7 at (k, C) = B2B_AVERAGER, B6 on shards of B2B_SHIFT samples
B2B_CALLS = 64
B2B_AVERAGER = (16, 2)
B2B_SHIFT = 8192
# the same after one rank's stream is held back (a device sleep) or its host sleeps
HELD_CALLS = 8
HELD = {"stream": 1, "host": 2}  # how a rank is held: the rank held
HELD_SLEEP_CYCLES = 50_000_000  # torch.cuda._sleep: about 25 ms on the H100
HELD_SLEEP_S = 0.2


def b2b_input(j: int) -> np.ndarray:
    """Call j's whole stream of B7's key (B2B_AVERAGER)."""
    w, c = B2B_AVERAGER
    return stream(500 + j, WORLD * B2B_SHIFT // c, c)


def b2b_shift_input(j: int) -> np.ndarray:
    """Call j's whole stream of B6's key."""
    return stream(700 + j, WORLD * B2B_SHIFT, 1)


def _cases_ring_gpu(par, out: dict) -> None:
    """The ring kernels (B6, B7) across processes on the card: every rank on cuda:0."""
    import torch

    from digital_signal_processsing_tpu_torch.ops import launch_counts, reset_launch_counts

    mesh = par.make_time_mesh(device="cuda")
    flat = par.time_sharding(mesh)
    dev = mesh.device

    def run(key, fn):
        out[key] = flat.gather(fn()).cpu().numpy()

    reset_launch_counts()
    for i, (w, c, _) in enumerate(RING_CORNERS):
        xs = flat.shard(torch.from_numpy(ring_corner_input(i)).to(dev))
        for h in HALO_IMPLS:
            run(f"corner/{i}/{h}", lambda: par.sharded_moving_average(xs, w, c, mesh=mesh,
                                                                      halo_impl=h))
        run(f"corner/{i}/scan_ring", lambda: par.sharded_moving_average(
            xs, w, c, mesh=mesh, method="scan", halo_impl="pallas_ring"))
    for i, (w, c) in enumerate(SEQ):
        xi = flat.shard(torch.from_numpy(seq_input(i)).to(dev))
        run(f"seq/{i}", lambda: par.sharded_moving_average(xi, w, c, mesh=mesh,
                                                           halo_impl="fused_ring"))
    for w, c in PACKED:
        xs = flat.shard(torch.from_numpy(packed_input(w, c)).to(dev).view(torch.int32))
        run(f"packed/{w}/{c}", lambda: par.sharded_moving_average(xs, w, c, mesh=mesh,
                                                                  halo_impl="pallas_ring"))
    for name in RING_SHAPES:
        xr = flat.shard(torch.from_numpy(ring_input(name)).to(dev))
        run(f"ring/{name}", lambda: par.ring_shift_right(xr, mesh))
    odd = flat.shard(torch.arange(WORLD * 1001, dtype=torch.int16, device=dev))
    run("ring/odd", lambda: par.ring_shift_right_shard(odd[1:], mesh))  # a misaligned source
    torch.cuda.synchronize()
    out["counts"] = launch_counts()

    # two keys' calls interleaved back to back, new data each call; the host
    # steps counted from each key's second call to its last
    w, c = B2B_AVERAGER
    xa = [flat.shard(torch.from_numpy(b2b_input(j)).to(dev)) for j in range(B2B_CALLS)]
    xb = [flat.shard(torch.from_numpy(b2b_shift_input(j)).to(dev)) for j in range(B2B_CALLS)]
    torch.cuda.synchronize()
    ya = [par.fused_ring_windowed_shard(xa[0], w, c, mesh)]
    yb = [par.ring_shift_right_shard(xb[0], mesh)]
    with par.HostSteps() as steps:
        for j in range(1, B2B_CALLS):
            ya.append(par.fused_ring_windowed_shard(xa[j], w, c, mesh))
            yb.append(par.ring_shift_right_shard(xb[j], mesh))
    every = [None] * WORLD
    torch.distributed.all_gather_object(every, steps.counts)
    out["b2b/host_steps"] = every
    for j in range(B2B_CALLS):
        out[f"b2b/fused/{j}"] = flat.gather(ya[j]).cpu().numpy()
        out[f"b2b/shift/{j}"] = flat.gather(yb[j]).cpu().numpy()

    # one rank's stream held back by a device sleep, or its host asleep, before its calls
    import time

    for how, held in HELD.items():
        torch.cuda.synchronize()
        torch.distributed.barrier()
        if mesh.t == held:
            if how == "stream":
                torch.cuda._sleep(HELD_SLEEP_CYCLES)
            else:
                time.sleep(HELD_SLEEP_S)
        ya = [par.fused_ring_windowed_shard(xa[j], w, c, mesh) for j in range(HELD_CALLS)]
        yb = [par.ring_shift_right_shard(xb[j], mesh) for j in range(HELD_CALLS)]
        for j in range(HELD_CALLS):
            out[f"held/{how}/fused/{j}"] = flat.gather(ya[j]).cpu().numpy()
            out[f"held/{how}/shift/{j}"] = flat.gather(yb[j]).cpu().numpy()
    torch.cuda.synchronize()
    mesh.close()


# the reference's sharded-step case (tests/test_models.py:97-108)
TRAIN = dict(true=(0.8, -0.4, 0.1), steps=60, batch=(8, 4096), lr=2e-2, seed=5)


def _cases_training(par, out: dict) -> None:
    """The block-LMS trainer's sharded step: a 2 x 4 (channel, time) mesh on 8
    ranks, or the world of one against the single step."""
    import torch
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch.models import adaptive

    true = np.asarray(TRAIN["true"], np.float32)
    kw = {k: TRAIN[k] for k in ("steps", "batch", "lr", "seed")}
    world = dist.get_world_size()
    if world == 1:
        step = adaptive.make_sharded_train_step(par.make_mesh(device="cpu"))
        out["world1/sharded"] = adaptive.identify_system(true, train_step=step, device="cpu", **kw)
        out["world1/single"] = adaptive.identify_system(true, device="cpu", **kw)
        return
    mesh = par.make_mesh(n_time=4, n_channel=2, device="cpu")
    step = adaptive.make_sharded_train_step(mesh)
    taps, loss = adaptive.identify_system(true, train_step=step, device="cpu", **kw)
    mine = torch.from_numpy(np.append(taps, np.float32(loss)))
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine)
    out["sharded/by_rank"] = torch.stack(parts).numpy()
    out["sharded/shape"] = tuple(step.sharding.shard(torch.zeros(TRAIN["batch"])).shape)
    if dist.get_rank() == 0:
        out["single"] = adaptive.identify_system(true, device="cpu", **kw)
    fir = adaptive.AdaptiveFir.create(3, device="cpu")
    z = torch.zeros(4, 1024)
    errors = {
        "shapes": lambda: step(fir, z, z[:, :-1]),
        "halo": lambda: step(adaptive.AdaptiveFir.create(2000, device="cpu"), z, z),
    }
    for name, fn in errors.items():
        try:
            fn()
            out[f"error/{name}"] = None
        except Exception as err:  # noqa: BLE001
            out[f"error/{name}"] = ("error", type(err).__name__, str(err))


# --- the multi-card surface: the dp steps, the wideband receiver, the chunk staging

# (n_time, n_channel) by the mesh's name, channels x time: the dp steps cut their
# batch over ch ("4x1", "2x2"), the wideband receiver its stream over t ("1x4", "2x2")
MC_MESHES = {"4x1": (1, 4), "1x4": (4, 1), "2x2": (2, 2)}
BATCH_MESHES = ("4x1", "2x2")
TIME_MESHES = ("1x4", "2x2")
MC_RADAR = dict(n_pulses=16, n_range=256, pulse_len=32, guard=(1, 2), train=(2, 4), pfa=1e-3)
MC_RADAR_BATCH = 8
MC_BEAM = dict(n_sensors=6, n_grid=91)
MC_BEAM_BATCH, MC_BEAM_SNAPS = 8, 128
BEAM_METHODS = ("bartlett", "mvdr", "music")
# name: (n_channels, audio_taps, squelch, kind); the stream's length by wideband_len
WIDE = {
    "ref": (16, 33, 0.1, "noise"),  # tests/test_wideband.py:51: 16 x 2048 samples
    "tight": (16, 33, 0.1, "noise"),  # shards of 1024 samples, the halo 768 of them
    "fm": (16, 33, 0.2, "fm"),  # an FM tone on channel 5: the squelch mutes the rest
}
WIDE_TIGHT_SHARD = 1024
# blocks of unequal length over the 1x4 mesh, the FM case's 32768 samples
WIDE_UNEVEN = (4096, 12288, 6144, 10240)
MC_WAV_FRAMES = (5000, 3001)  # two stereo files, the second an odd frame count
MC_CHUNK = 4096


def radar_batch(batch: int = MC_RADAR_BATCH) -> tuple[np.ndarray, np.ndarray]:
    from digital_signal_processsing_tpu_torch.models import radar

    cfg = radar.RadarConfig(**MC_RADAR)
    i = np.empty((batch, cfg.n_pulses, cfg.n_range), np.float32)
    q = np.empty_like(i)
    for b in range(batch):
        i[b], q[b] = radar.synthesize(cfg, [(40 + 20 * b, 0.25 - 0.0625 * b, 1.0), (150, 0.0, 0.5)],
                                      noise_power=0.02, seed=b)
    return i, q


def beam_batch() -> tuple[np.ndarray, np.ndarray]:
    from digital_signal_processsing_tpu_torch.models import beamform

    cfg = beamform.ArrayConfig(**MC_BEAM)
    blocks = [beamform.synthesize(cfg, [-30.0 + 7.0 * b, 25.0], MC_BEAM_SNAPS, seed=b)
              for b in range(MC_BEAM_BATCH)]
    return np.stack([b[0] for b in blocks]), np.stack([b[1] for b in blocks])


def wideband_len(name: str, n_time: int) -> int:
    return WIDE_TIGHT_SHARD * n_time if name == "tight" else WIDE[name][0] * 2048


def wideband_input(name: str, n_time: int) -> np.ndarray:
    n, _, _, kind = WIDE[name]
    t = wideband_len(name, n_time)
    if kind == "noise":
        return np.random.default_rng(0xD5B).normal(size=t).astype(np.float32)
    idx = np.arange(t)  # tests/test_wideband.py:11-16, channel 5
    msg = np.sin(2 * np.pi * 0.002 * idx)
    return np.cos(2 * np.pi * (5 / n) * idx + (0.1 / n) * 2 * np.pi * np.cumsum(msg)).astype(np.float32)


def wav_stream() -> np.ndarray:
    return stream(31, sum(MC_WAV_FRAMES), 2)


def _mc_wavs(where: Path) -> list[Path]:
    from digital_signal_processsing_tpu_torch.io import write_wav

    x, paths, at = wav_stream(), [], 0
    where.mkdir(parents=True, exist_ok=True)
    for i, frames in enumerate(MC_WAV_FRAMES):
        paths.append(where / f"in{i}.wav")
        write_wav(paths[-1], x[2 * at : 2 * (at + frames)], 8000, 2)
        at += frames
    return paths


def _mc_receivers(taps_file: Path, device: str = "cpu") -> dict:
    """The suite's receivers with the JAX package's taps (the test writes them)."""
    from digital_signal_processsing_tpu_torch.models import WidebandConfig, wideband_from_jax

    taps = np.load(taps_file)
    out = {}
    for name, (n, a, squelch, _) in WIDE.items():
        params = {"prototype": taps[f"{n}/{a}/prototype"], "audio_taps": taps[f"{n}/{a}/audio"]}
        out[name] = wideband_from_jax(params, WidebandConfig(n_channels=n, audio_taps=a,
                                                             squelch=squelch), device=device)
    return out


def _cases_multichip(par, out: dict, store: str) -> None:
    import torch
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch.harness.profile import time_phases
    from digital_signal_processsing_tpu_torch.io import WavChunkLoader, device_chunks
    from digital_signal_processsing_tpu_torch.models import beamform, radar

    meshes = {name: par.make_mesh(n_time=t, n_channel=c, device="cpu")
              for name, (t, c) in MC_MESHES.items()}
    rcfg = radar.RadarConfig(**MC_RADAR)
    ri, rq = radar_batch()
    bcfg = beamform.ArrayConfig(**MC_BEAM)
    bi, bq = beam_batch()
    for m in BATCH_MESHES:
        det, power, thresh = radar.detect_batch(rcfg, ri, rq, mesh=meshes[m])
        out[f"radar/{m}"] = (det.numpy(), power.numpy(), thresh.numpy())
        for method in BEAM_METHODS:
            out[f"beam/{method}/{m}"] = beamform.spectrum_batch(
                bcfg, bi, bq, method=method, n_sources=2, mesh=meshes[m]).numpy()
    receivers = _mc_receivers(Path(store).parent / "wideband_taps.npz")
    for m in TIME_MESHES:
        flat = par.time_sharding(meshes[m])
        for name, rx in receivers.items():
            x = torch.from_numpy(wideband_input(name, meshes[m].n_time))
            out[f"wide/{name}/{m}"] = flat.gather(par.sharded_wideband(rx, flat.shard(x),
                                                                       meshes[m])).numpy()
    mesh = meshes["1x4"]
    edges = np.cumsum((0, *WIDE_UNEVEN))
    x = torch.from_numpy(wideband_input("fm", mesh.n_time))[edges[mesh.t] : edges[mesh.t + 1]]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, par.sharded_wideband(receivers["fm"], x, mesh).numpy())
    out["wide/fm/uneven"] = np.concatenate(every, axis=1)
    paths = _mc_wavs(Path(store).parent / f"wavs{dist.get_rank()}")
    for m in TIME_MESHES:
        sharding = par.time_sharding(meshes[m])
        mine = [c.numpy() for c in device_chunks(WavChunkLoader(paths, MC_CHUNK), device="cpu",
                                                 sharding=sharding)]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out[f"chunks/{m}"] = every
    rx = receivers["tight"]
    errors = {
        "radar_uneven": lambda: radar.detect_batch(rcfg, ri[:6], rq[:6], mesh=meshes["4x1"]),
        "beam_uneven": lambda: beamform.spectrum_batch(bcfg, bi[:3], bq[:3], mesh=meshes["2x2"]),
        "not_a_mesh": lambda: radar.detect_batch(rcfg, ri, rq, mesh=object()),
        "wide_halo": lambda: par.sharded_wideband(rx, torch.zeros(512), meshes["1x4"]),
        "wide_grid": lambda: par.sharded_wideband(rx, torch.zeros(1032), meshes["1x4"]),
        "wide_flat": lambda: par.sharded_wideband(rx, torch.zeros(2, 1024), meshes["1x4"]),
        "chunks_uneven": lambda: list(device_chunks(WavChunkLoader(paths, MC_CHUNK + 2),
                                                    sharding=par.time_sharding(meshes["1x4"]))),
        "chunks_not_sharding": lambda: device_chunks(WavChunkLoader(paths, MC_CHUNK),
                                                     device="cpu", sharding=object()),
        "time_phases_cpu": lambda: time_phases(lambda v: v, np.zeros(64, np.int16),
                                               sharding=par.time_sharding(meshes["1x4"])),
    }
    for name, fn in errors.items():
        try:
            fn()
            out[f"error/{name}"] = None
        except Exception as err:  # noqa: BLE001 - every rank records the same refusal
            out[f"error/{name}"] = ("error", type(err).__name__, str(err))


# the multi-card surface on the card: every rank on cuda:0, time-slicing it
MC_GPU_AVG = (1 << 22, 1024, 2)  # samples, window, channels
MC_GPU_WIDE = (64, 1 << 18)  # channels (B19's envelope), samples


def _cases_multichip_gpu(par, out: dict, store: str) -> None:
    import torch
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch.harness.profile import time_phases
    from digital_signal_processsing_tpu_torch.io import WavChunkLoader, device_chunks
    from digital_signal_processsing_tpu_torch.models import WidebandConfig, WidebandFmReceiver, radar
    from digital_signal_processsing_tpu_torch.ops import launch_counts, reset_launch_counts

    mesh = par.make_mesh(device="cuda")
    mesh22 = par.make_mesh(n_time=2, n_channel=2, device="cuda")
    flat, dev = par.time_sharding(mesh), mesh.device
    n, k, c = MC_GPU_AVG
    x = stream(41, n // c, c)
    reset_launch_counts()
    res = time_phases(lambda v: par.sharded_moving_average(v, k, c, mesh=mesh,
                                                           halo_impl="fused_ring"),
                      x, sharding=flat, warmup=1, rounds=3)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, dataclasses.asdict(res))
    out["time_phases"] = every
    out["avg"] = flat.gather(par.sharded_moving_average(flat.shard(torch.from_numpy(x).to(dev)),
                                                        k, c, mesh=mesh)).cpu().numpy()
    ri, rq = radar_batch()
    rcfg = radar.RadarConfig(**MC_RADAR)
    out["radar"] = [v.cpu().numpy() for v in radar.detect_batch(rcfg, ri, rq, mesh=mesh22)]
    out["radar/one_card"] = [v.cpu().numpy() for v in radar.detect_batch(rcfg, ri, rq, device=dev)]
    nw, tw = MC_GPU_WIDE
    rx = WidebandFmReceiver(WidebandConfig(n_channels=nw), device=dev)
    xw = torch.from_numpy(np.random.default_rng(9).normal(size=tw).astype(np.float32)).to(dev)
    out["wide"] = flat.gather(par.sharded_wideband(rx, flat.shard(xw), mesh)).cpu().numpy()
    out["wide/one_card"] = rx(xw).cpu().numpy()
    paths = _mc_wavs(Path(store).parent / f"wavs{dist.get_rank()}")
    out["chunks"] = [flat.gather(ch).cpu().numpy() for ch in device_chunks(
        WavChunkLoader(paths, MC_CHUNK), sharding=flat)]
    torch.cuda.synchronize()
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, launch_counts())
    out["counts"] = every
    mesh.close()


SUITES = {
    "averager": _cases_averager,
    "training": _cases_training,
    "ring_gpu": _cases_ring_gpu,
    "world1": _cases_world1,
    "fir": _cases_fir,
    "tv": _cases_tv,
    "multichip": _cases_multichip,
    "multichip_gpu": _cases_multichip_gpu,
}
# suites that also take the path of the FileStore (their inputs lie beside it)
WITH_STORE = ("multichip", "multichip_gpu")


def main(argv: list[str]) -> None:
    suite, rank, world, store, out_path = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    if suite.endswith("_gpu"):
        torch.cuda.set_device(0)  # every rank on the one card
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=120))
    from digital_signal_processsing_tpu_torch import parallel as par

    out: dict = {}
    if suite in WITH_STORE:
        SUITES[suite](par, out, store)
    else:
        SUITES[suite](par, out)
    if rank == 0:
        with open(out_path, "wb") as f:
            pickle.dump(out, f)
    dist.destroy_process_group()


def run_suite(suite: str, tmp: Path, world: int = WORLD, timeout: float = 240) -> dict:
    """Spawn ``world`` workers of ``suite`` and return rank 0's results."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["OMP_NUM_THREADS"] = "1"
    store, out = tmp / f"{suite}.store", tmp / f"{suite}.pkl"
    procs = [
        subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), suite, str(r), str(world),
             str(store), str(out)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    if failed:
        raise AssertionError(f"sharded workers failed: {failed}")
    with open(out, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    main(sys.argv[1:])
