"""Entry points of the port: the flagship forward and the multi-card dry runs.

Counterpart of the repository's root ``__graft_entry__.py`` (the JAX
package's entry file, which stays as it is):

- :func:`entry`: the flagship receiver chain's forward on 2^16 planar samples;
- :func:`dryrun_multichip`: one process a rank, every sharded axis of the
  framework on tiny shapes, each held against the one-process result;
- :func:`dryrun_multiprocess`: the multi-host worker list over
  ``parallel.initialize_multihost``.

A dry run spawns its ranks as ``python -m
digital_signal_processsing_tpu_torch.graft_entry KIND RANK WORLD STORE DEVICE
BACKEND OUT`` (they meet on a ``FileStore`` in a temporary directory). With
``device="cuda"`` the process group is NCCL with one card a rank where the
host has a card for every rank, else gloo with every rank on the one card
(the ranks time-slice it; the ring kernels move the halos through CUDA IPC);
``device="cpu"`` is gloo on the CPU, where every kernel wrapper takes its
plain version. A rank that fails fails the run: the parent raises with its
output, and stops every rank it started.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from .utils.device import resolve_device

PACKAGE_PARENT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 600


def entry(*, device="cuda"):
    """(fn, example_args): the forward step of the flagship model.

    The flagship is the multi-channel FM receiver chain (``models/chain.py``):
    16-channel complex baseband -> LO mix -> channel-select FIR -> polyphase
    decimate -> FM discriminator -> audio FIR, fed as separate float32 I/Q
    planes of 2^16 samples on ``device`` (the card unless the caller asks
    for the CPU).
    """
    from .models import ChainConfig, DspChain

    chain = DspChain(ChainConfig(channels=16, decimation=8), device=device)
    i, q = chain.example_planar_input(t=1 << 16)
    dev = chain.lo.device
    return chain.forward_planar, (torch.from_numpy(i).to(dev), torch.from_numpy(q).to(dev))


def _backend(n: int, device) -> str:
    """NCCL with a card a rank where the host has enough, gloo otherwise."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl"
    return "gloo"


def _spawn(kind: str, n: int, device) -> list[dict]:
    """Run ``n`` ranks of ``kind``; each rank's JSON record, in rank order."""
    if n < 1:
        raise ValueError(f"need at least one rank, got {n}")
    dev = resolve_device(device)
    backend = _backend(n, dev)
    if dev.type == "cuda":
        from . import _build

        _build.build()  # once, here: the ranks load it
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PACKAGE_PARENT), *filter(None, [os.environ.get("PYTHONPATH")])])
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.json" for r in range(n)]
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", __name__, kind, str(r), str(n), f"{tmp}/store",
                 dev.type, backend, str(outs[r])],
                cwd=PACKAGE_PARENT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            for r in range(n)
        ]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [f"rank {r} (exit {p.returncode}):\n{log[-3000:]}"
                  for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"{kind} dry run failed on {len(failed)} of {n} ranks:\n"
                               + "\n".join(failed))
        return [json.loads(o.read_text()) for o in outs]


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """One full sharded step of every parallel axis over ``n_devices`` ranks.

    Each rank runs the reference's list at its tiny shapes on a (ch, t) mesh
    (2 x n/2 for an even count, else 1 x n), each output gathered and held
    against the same function in one process: the scan averager with its
    carry and halo (plain and B4), the fused-ring windowed averager and the
    packed pair view on a time mesh (B7, B2), ``sharded_fir_filter``,
    ``sharded_chain``, ``sharded_wideband``, ``sharded_sosfilt_tv``,
    ``detect_batch(mesh=)``, ``spectrum_batch(method="music", mesh=)``, MFCC
    on a ``ch``-sharded batch, and two steps of ``make_sharded_train_step``.
    Prints the reference's summary line; returns rank 0's record with every
    rank's seconds and launch counts (the sharded calls' own: the one-process
    calls they are held against are left out).
    """
    ranks = _spawn("multichip", n_devices, device)
    r0 = ranks[0]
    n_ch, n_t = r0["mesh"]
    print(
        f"dryrun_multichip OK: mesh=({n_ch}x{n_t}) scan+fused_ring+packed+tv+"
        f"fir+chain+wideband+radar+beamform+mfcc+train steps ran; "
        f"lms loss {r0['loss0']:.4f} -> {r0['loss2']:.4f}"
    )
    return {**r0, "seconds": [r["seconds"] for r in ranks],
            "launches": [r["launches"] for r in ranks]}


def dryrun_multiprocess(n_processes: int = 4, *, device="cuda") -> dict:
    """The multi-host worker list over ``n_processes`` processes, one rank each,
    through ``parallel.initialize_multihost``: the averager with both halos
    (ppermute and the fused ring) and the scan carry ladder, the combined-halo
    receiver chain, and the LMS step with the cross-host agreement check."""
    ranks = _spawn("multiprocess", n_processes, device)
    print(f"dryrun_multiprocess OK: {n_processes} processes x 1 rank "
          f"({ranks[0]['backend']}, {ranks[0]['device']})")
    return {**ranks[0], "seconds": [r["seconds"] for r in ranks],
            "launches": [r["launches"] for r in ranks]}


# --- the ranks ---------------------------------------------------------------


class _Uncounted:
    """Runs the one-process calls a rank holds its sharded outputs against, and
    keeps their kernel launches apart, so that the rank's counts are those of
    the sharded calls alone."""

    def __init__(self):
        self.launches: dict[str, int] = {}

    def __call__(self, fn, *args, **kwargs):
        from .ops import launch_counts

        before = launch_counts()
        out = fn(*args, **kwargs)
        for k, v in launch_counts().items():
            self.launches[k] = self.launches.get(k, 0) + v - before[k]
        return out


def _close(got, want, rtol: float, atol: float, what: str) -> None:
    np.testing.assert_allclose(got.detach().cpu().numpy(), want.detach().cpu().numpy(),
                               rtol=rtol, atol=atol, err_msg=what)


def _same(got, want, what: str) -> None:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = want.cpu().numpy() if isinstance(want, torch.Tensor) else want
    np.testing.assert_array_equal(got, want, err_msg=what)


def _multichip_rank(device: str, ref: _Uncounted) -> dict:
    import torch.distributed as dist

    from . import parallel as par
    from .golden import moving_average_golden
    from .models import (
        ArrayConfig,
        ChainConfig,
        DspChain,
        RadarConfig,
        WidebandConfig,
        WidebandFmReceiver,
        beamform,
        radar,
    )
    from .models.adaptive import AdaptiveFir, lms_loss, make_sharded_train_step
    from .ops import iir, mel
    from .ops.fir import design_lowpass, fir_direct

    n = dist.get_world_size()
    n_ch = 2 if n % 2 == 0 and n > 1 else 1
    mesh = par.make_mesh(n_time=n // n_ch, n_channel=n_ch, device=device)
    n_t, dev = mesh.n_time, mesh.device
    flat, planar, batch = par.time_sharding(mesh), par.planar_sharding(mesh), par.batch_sharding(mesh)
    rng = np.random.default_rng(0)  # the same global data on every rank

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    # sp: the time-sharded scan averager, its carry ladder and its halo
    channels, window = 2, 16
    x = rng.integers(-32768, 32768, size=256 * n_t * channels, dtype=np.int16)
    want = moving_average_golden(x, window, channels)
    for use_pallas in (False, True):
        got = par.sharded_moving_average(flat.shard(on(x)), window, channels, mesh=mesh,
                                         method="scan", use_pallas=use_pallas)
        _same(flat.gather(got), want, f"scan averager use_pallas={use_pallas}")

    # sp: the fused-ring windowed averager and the packed pair view on a time mesh
    tmesh = par.make_time_mesh(device=device)
    tflat = par.time_sharding(tmesh)
    w2, c2 = 700, 2
    x2 = rng.integers(-32768, 32768, size=n * (1 << 15), dtype=np.int16)
    want2 = moving_average_golden(x2, w2, c2)
    got = par.sharded_moving_average(tflat.shard(on(x2)), w2, c2, mesh=tmesh,
                                     halo_impl="fused_ring")
    _same(tflat.gather(got), want2, "fused ring")
    got = par.sharded_moving_average(tflat.shard(on(x2).view(torch.int32)), w2, c2, mesh=tmesh)
    _same(tflat.gather(got).view(torch.int16), want2, "packed pair view")

    # dp + sp: the overlap-save FIR on the (ch, t) mesh
    sig = rng.normal(size=(2 * n_ch, 512 * n_t)).astype(np.float32)
    taps = design_lowpass(33, 0.25)
    got = par.sharded_fir_filter(planar.shard(on(sig)), taps, mesh=mesh, method="direct")
    _close(planar.gather(got), ref(fir_direct, on(sig), taps), 1e-4, 1e-5, "sharded_fir_filter")

    # (ch, t): the receiver chain with its one combined raw halo
    cfg = ChainConfig(channels=2 * n_ch, decimation=4, channel_taps=33, audio_taps=17)
    chain = DspChain(cfg, device=dev)
    t_chain = 512 * n_t
    iq = (rng.normal(size=(cfg.channels, t_chain))
          + 1j * rng.normal(size=(cfg.channels, t_chain))).astype(np.complex64)
    want_c = ref(chain, on(iq))
    got_c = planar.gather(par.sharded_chain(chain, planar.shard(on(iq)), mesh))
    ramp = (cfg.channel_taps + 8 * cfg.decimation) // cfg.decimation + cfg.audio_taps
    _close(got_c[:, ramp:], want_c[:, ramp:], 1e-3, 1e-4, "sharded_chain")

    # t: the wideband PFB receiver on a time-sharded stream
    wrx = WidebandFmReceiver(WidebandConfig(n_channels=8, audio_taps=17), device=dev)
    wx = rng.normal(size=8 * 128 * n_t).astype(np.float32)
    got = flat.gather(par.sharded_wideband(wrx, flat.shard(on(wx)), mesh))
    _close(got, ref(wrx, on(wx)), 1e-4, 1e-5, "sharded_wideband")

    # dp: the time-varying SOS cascade with channels over ch
    tvc, tvn = 2 * n_ch, 512
    tvx = rng.normal(size=(tvc, tvn)).astype(np.float32)
    rr = 0.5 + 0.3 * np.sin(np.linspace(0, 4, tvn))
    tvrow = np.stack([np.full(tvn, 0.3), np.zeros(tvn), np.full(tvn, 0.05), np.ones(tvn),
                      -1.6 * rr, rr * rr], -1).astype(np.float32)
    tvsos = np.stack([tvrow, tvrow * np.float32(0.9)], 0)
    got = batch.gather(par.sharded_sosfilt_tv(tvsos, batch.shard(on(tvx)), mesh=mesh))
    _same(got, ref(iir.sosfilt_tv, tvsos, on(tvx)), "sharded_sosfilt_tv")

    # dp: a batch of radar CPIs over ch
    rcfg = RadarConfig(n_pulses=8, n_range=256, pulse_len=32, guard=(1, 1), train=(2, 3))
    rb = max(n_ch, 2)
    r_i = np.empty((rb, rcfg.n_pulses, rcfg.n_range), np.float32)
    r_q = np.empty_like(r_i)
    for b in range(rb):
        r_i[b], r_q[b] = radar.synthesize(rcfg, [(30 * (b + 1), 0.1 * b, 1.0)],
                                          noise_power=0.01, seed=b)
    det_b, _, _ = radar.detect_batch(rcfg, r_i, r_q, mesh=mesh)
    for b in range(rb):
        det_s, power_s, thresh_s = ref(radar.detect, rcfg, on(r_i[b]), on(r_q[b]))
        clear = ~radar.near_threshold(power_s, thresh_s)
        _same(det_b[b][clear], det_s[clear], f"detect_batch CPI {b} outside the margin")

    # dp: a batch of beamforming snapshot blocks over ch
    bcfg = ArrayConfig(n_sensors=4, n_grid=61)
    bb = max(n_ch, 2)
    b_i = np.empty((bb, bcfg.n_sensors, 64), np.float32)
    b_q = np.empty_like(b_i)
    for b in range(bb):
        b_i[b], b_q[b] = beamform.synthesize(bcfg, [20.0 * b - 10.0], 64, seed=b)
    spec_b = beamform.spectrum_batch(bcfg, b_i, b_q, method="music", mesh=mesh)
    for b in range(bb):
        spec_s = ref(beamform.spatial_spectrum, bcfg, on(b_i[b]), on(b_q[b]), method="music")
        _close(spec_b[b], spec_s, 1e-3, 1e-5, f"spectrum_batch music block {b}")

    # dp: MFCC features of a ch-sharded batch
    mx = rng.normal(size=(2 * n_ch, 4096)).astype(np.float32)

    def mfcc(v):
        return mel.mfcc(v, sample_rate=16000.0, n_mfcc=13, nfft=512, hop=256, n_mels=40)

    _close(batch.gather(mfcc(batch.shard(on(mx)))), ref(mfcc, on(mx)), 1e-4, 1e-4, "mfcc")

    # a training step: block-LMS on the (ch, t)-sharded batch, then one more
    step = make_sharded_train_step(mesh)
    fir = AdaptiveFir.create(8, 1e-2, device=dev)
    bx = rng.normal(size=(4 * n_ch, 256 * n_t)).astype(np.float32)
    bd = rng.normal(size=(4 * n_ch, 256 * n_t)).astype(np.float32)
    xs, ds = planar.shard(on(bx)), planar.shard(on(bd))
    loss = float(step(fir, xs, ds))
    loss0 = float(ref(lms_loss, torch.zeros(8, device=dev), on(bx), on(bd)))
    if not (np.isfinite(loss) and abs(loss - loss0) < 1e-3):
        raise AssertionError(f"first step's loss {loss} against {loss0} in one process")
    loss2 = float(step(fir, xs, ds))
    if not loss2 <= loss + 1e-6:
        raise AssertionError(f"second step's loss {loss2} above the first's {loss}")
    tmesh.close()
    mesh.close()
    return {"mesh": [n_ch, n_t], "loss0": loss0, "loss2": loss2}


def _multiprocess_rank(device: str, ref: _Uncounted) -> dict:
    from . import parallel as par
    from .golden import moving_average_golden
    from .models import ChainConfig, DspChain
    from .models.adaptive import AdaptiveFir, make_sharded_train_step

    n = torch.distributed.get_world_size()
    n_ch = 2 if n % 2 == 0 and n > 1 else 1
    mesh = par.make_mesh(n_time=n // n_ch, n_channel=n_ch, device=device)
    dev, flat, planar = mesh.device, par.time_sharding(mesh), par.planar_sharding(mesh)
    rng = np.random.default_rng(0)  # the same seed in every process: the global data

    def on(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    # the averager across processes: the ppermute halo, then the scan carry ladder
    w, c = 64, 2
    x = rng.integers(-32768, 32768, size=4 * n * 8192, dtype=np.int16)
    want = moving_average_golden(x, w, c)
    xs = flat.shard(on(x))
    _same(flat.gather(par.sharded_moving_average(xs, w, c, mesh=mesh)), want, "averager")
    got = par.sharded_moving_average(xs, w, c, mesh=mesh, method="scan", carry_impl="ladder")
    _same(flat.gather(got), want, "scan ladder")

    # the fused-ring halo on a time mesh across processes
    tmesh = par.make_time_mesh(device=device)
    tflat = par.time_sharding(tmesh)
    w2, c2 = 700, 2
    x2 = rng.integers(-32768, 32768, size=4 * n * (1 << 13), dtype=np.int16)
    got = par.sharded_moving_average(tflat.shard(on(x2)), w2, c2, mesh=tmesh,
                                     halo_impl="fused_ring")
    _same(tflat.gather(got), moving_average_golden(x2, w2, c2), "fused ring")

    # the (ch, t)-sharded receiver chain: the combined-halo path
    ccfg = ChainConfig(channels=2, decimation=4, channel_taps=33, audio_taps=17)
    chain = DspChain(ccfg, device=dev)
    t_chain = 512 * mesh.n_time
    iq = (rng.normal(size=(ccfg.channels, t_chain))
          + 1j * rng.normal(size=(ccfg.channels, t_chain))).astype(np.complex64)
    got_c = planar.gather(par.sharded_chain(chain, planar.shard(on(iq)), mesh))
    ramp = (ccfg.channel_taps + 8 * ccfg.decimation) // ccfg.decimation + ccfg.audio_taps
    _close(got_c[:, ramp:], ref(chain, on(iq))[:, ramp:], 1e-3, 1e-4, "sharded_chain")

    # the LMS step with gradients summed across processes, and the hosts' agreement
    step = make_sharded_train_step(mesh)
    fir = AdaptiveFir.create(8, 1e-2, device=dev)
    bshape = (8, 2048 * n)
    bx = rng.normal(size=bshape).astype(np.float32)
    bd = rng.normal(size=bshape).astype(np.float32)
    loss = float(step(fir, planar.shard(on(bx)), planar.shard(on(bd))))
    if not np.isfinite(loss):
        raise AssertionError(f"LMS loss {loss}")
    par.assert_same_across_hosts(loss, "lms_loss")
    tmesh.close()
    mesh.close()
    return {"loss": loss}


RANKS = {"multichip": _multichip_rank, "multiprocess": _multiprocess_rank}


def _rank_main(argv: list[str]) -> None:
    kind, rank, world, store, device, backend, out = argv
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    from . import parallel as par
    from .ops import launch_counts, reset_launch_counts

    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count() if backend == "nccl" else 0)
    else:
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    if kind == "multiprocess":
        topo = par.initialize_multihost(f"file://{store}", world, rank, backend=backend)
        if topo["process_count"] != world or topo["process_index"] != rank:
            raise AssertionError(f"topology {topo}")
    else:
        dist.init_process_group(backend, store=dist.FileStore(store, world), rank=rank,
                                world_size=world, timeout=timedelta(seconds=RANK_TIMEOUT_S))
    reset_launch_counts()
    ref = _Uncounted()
    record = RANKS[kind](device, ref)
    if device == "cuda":
        torch.cuda.synchronize()
    launches = {k: v - ref.launches.get(k, 0) for k, v in launch_counts().items()}
    record.update(backend=backend, device=device, launches=launches,
                  seconds=time.perf_counter() - t0)
    dist.destroy_process_group()
    Path(out).write_text(json.dumps(record))


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
