"""Multi-target tracking over the radar detection stream.

Counterpart of ``digital_signal_processsing_tpu/models/tracking.py``: a
stream of range-Doppler detection maps (``models/radar.py``) becomes
confirmed constant-velocity tracks through measurement extraction, gated
association, batched Kalman filtering and M-of-N track management.

As in the reference, every shape is static and the state stays on the
device: a fixed array of track slots (``TrackerState``), an 8-neighbour
local-max test and ``torch.topk`` for the measurements, a greedy
global-argmin assignment whose ``max_tracks`` steps are a Python loop over
device tensors (no host read, no branch on a value), one-hot matrix routing
of measurements to tracks and rank matching of new tracks to free slots.
Every contraction runs in IEEE float32 (``ieee_fp32_matmul``), the
reference's ``Precision.HIGHEST``. The reference's ``lax.scan`` over CPIs is
a loop over CPIs; a JAX state continues here through
:func:`tracker_state_from_jax`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops.fir import ieee_fp32_matmul
from ..utils.device import as_tensor, resolve_device

__all__ = [
    "TrackerConfig",
    "TrackerState",
    "tracker_init",
    "tracker_state_from_jax",
    "extract_measurements",
    "tracker_step",
    "track_cpis",
    "track_detections",
]

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Constant-velocity tracker over (range, velocity) measurements.

    ``gate`` is a squared-Mahalanobis gate (chi-square with 2 dof: 9.21 is
    the 99% point). ``vel_scale`` converts Doppler in cycles/PRI to
    velocity in range-bins/CPI. ``confirm_hits``/``max_misses`` are the
    M-of-N manager: a track is confirmed after ``confirm_hits`` total hits
    and dropped after ``max_misses`` consecutive misses.
    """

    max_tracks: int = 16
    max_meas: int = 16
    dt: float = 1.0  # CPI interval, the state time unit
    sigma_r: float = 0.5  # range measurement std (bins)
    sigma_v: float = 0.1  # velocity measurement std (bins/CPI)
    accel_var: float = 0.01  # CV white-acceleration variance
    gate: float = 9.21
    confirm_hits: int = 3
    max_misses: int = 2
    init_pos_var: float = 4.0  # new-track position variance
    init_vel_var: float = 1.0  # new-track velocity variance
    vel_scale: float = 1.0  # bins/CPI per cycles/PRI

    def __post_init__(self):
        if self.max_tracks < 1 or self.max_meas < 1:
            raise ValueError("max_tracks and max_meas must be >= 1")
        if self.gate <= 0.0:
            raise ValueError(f"gate must be > 0, got {self.gate}")


class TrackerState(NamedTuple):
    """Fixed-size track slots, tensors on one device."""

    x: torch.Tensor  # (T, 2) [range_bin, velocity]
    cov: torch.Tensor  # (T, 2, 2)
    active: torch.Tensor  # (T,) bool
    hits: torch.Tensor  # (T,) int32 total hits
    misses: torch.Tensor  # (T,) int32 consecutive misses
    tid: torch.Tensor  # (T,) int32 track id (0 = slot never used)
    next_id: torch.Tensor  # () int32


_STATE_DTYPES = (
    torch.float32, torch.float32, torch.bool, torch.int32, torch.int32, torch.int32, torch.int32
)


def tracker_init(cfg: TrackerConfig, *, device="cuda") -> TrackerState:
    dev = resolve_device(device)
    t = cfg.max_tracks
    return TrackerState(
        x=torch.zeros((t, 2), device=dev),
        cov=torch.zeros((t, 2, 2), device=dev),
        active=torch.zeros((t,), dtype=torch.bool, device=dev),
        hits=torch.zeros((t,), dtype=torch.int32, device=dev),
        misses=torch.zeros((t,), dtype=torch.int32, device=dev),
        tid=torch.zeros((t,), dtype=torch.int32, device=dev),
        next_id=torch.ones((), dtype=torch.int32, device=dev),
    )


def tracker_state_from_jax(state, *, device="cuda") -> TrackerState:
    """A reference ``TrackerState`` (its seven fields as NumPy arrays, or
    anything ``np.asarray`` takes) as the port's state on ``device``, so a
    JAX track stream continues here."""
    dev = resolve_device(device)
    return TrackerState(
        *(
            torch.as_tensor(np.array(v), device=dev).to(dt)
            for v, dt in zip(tuple(state), _STATE_DTYPES, strict=True)
        )
    )


def extract_measurements(
    det,
    power,
    *,
    max_meas: int,
    vel_scale: float = 1.0,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Detection map -> up to ``max_meas`` point measurements.

    ``det``/``power``: (..., n_dopplers, n_ranges) from ``radar.detect``. A
    CFAR blob around one target collapses to its peak cell by an
    8-neighbour strict local-max test; the ``max_meas`` strongest peaks
    survive through ``torch.topk``. Doppler rows are fftshifted (row d =
    (d - D//2)/D cycles/PRI). Returns ``(z, valid)`` with ``z`` of shape
    ``(..., max_meas, 2)`` = (range bin, velocity in bins/CPI).
    """
    p = as_tensor(power, device).to(torch.float32)
    det = as_tensor(det, p.device).to(p.device)
    n_dop, n_rng = p.shape[-2:]
    pp = torch.nn.functional.pad(p, (1, 1, 1, 1), value=-_INF)
    neigh = torch.stack(
        [
            pp[..., 1 + di : 1 + di + n_dop, 1 + dj : 1 + dj + n_rng]
            for di in (-1, 0, 1)
            for dj in (-1, 0, 1)
            if (di, dj) != (0, 0)
        ]
    ).amax(dim=0)
    score = torch.where(det & (p > neigh), p, -_INF)
    vals, idx = torch.topk(score.reshape(score.shape[:-2] + (-1,)), max_meas, dim=-1)
    valid = torch.isfinite(vals)
    row = torch.div(idx, n_rng, rounding_mode="floor").to(torch.float32)
    col = (idx % n_rng).to(torch.float32)
    doppler = (row - n_dop // 2) / n_dop  # cycles/PRI
    z = torch.stack([col, doppler * vel_scale], dim=-1)
    return torch.where(valid[..., None], z, 0.0), valid


def _model_mats(cfg: TrackerConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Constant-velocity F, discrete white-acceleration Q, measurement R."""
    dt = cfg.dt
    f = np.array([[1.0, dt], [0.0, 1.0]], np.float32)
    q = cfg.accel_var * np.array([[dt**4 / 4.0, dt**3 / 2.0], [dt**3 / 2.0, dt**2]], np.float32)
    r = np.diag([cfg.sigma_r**2, cfg.sigma_v**2]).astype(np.float32)
    return f, q, r


def _inv2(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 inverse, (..., 2, 2)."""
    a = m[..., 0, 0]
    b = m[..., 0, 1]
    c = m[..., 1, 0]
    d = m[..., 1, 1]
    det = a * d - b * c
    inv = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)], -2)
    return inv / det[..., None, None]


def _greedy_assign(cost: torch.Tensor, n_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy global-argmin assignment on a (T, M) cost matrix.

    Infeasible pairs carry +inf. Returns ``(assign, used)``: each track's
    measurement index (-1 = unassigned) and the used-measurement mask. Each
    of the ``n_steps`` steps claims the current global minimum (the first
    in row-major order, as ``jnp.argmin``) and masks its row and column;
    the loop reads nothing back to the host.
    """
    n_t, n_m = cost.shape
    t_ids = torch.arange(n_t, device=cost.device)
    m_ids = torch.arange(n_m, device=cost.device)
    c = cost
    assign = torch.full((n_t,), -1, dtype=torch.int32, device=cost.device)
    used = torch.zeros((n_m,), dtype=torch.bool, device=cost.device)
    for _ in range(n_steps):
        flat = torch.argmin(c.reshape(-1))
        val = c.reshape(-1)[flat]
        t = torch.div(flat, n_m, rounding_mode="floor")
        m = flat % n_m
        ok = torch.isfinite(val)
        assign = torch.where(ok & (t_ids == t), m.to(torch.int32), assign)
        used = used | (ok & (m_ids == m))
        c = torch.where(ok & ((t_ids[:, None] == t) | (m_ids[None, :] == m)), _INF, c)
    return assign, used


def tracker_step(
    cfg: TrackerConfig,
    state: TrackerState,
    z: torch.Tensor,
    valid: torch.Tensor,
) -> tuple[TrackerState, dict]:
    """One CPI: predict -> gate/associate -> update -> manage -> spawn.

    ``z``: (max_meas, 2) measurements, ``valid`` their mask, on the state's
    device. Returns the new state and a per-slot snapshot dict (x, active,
    confirmed, tid) taken after spawn/drop.
    """
    dev = state.x.device
    f_np, q_np, r_np = _model_mats(cfg)
    f, q, r = (torch.from_numpy(a).to(dev) for a in (f_np, q_np, r_np))
    eye = torch.eye(2, device=dev)
    z = z.to(dev, torch.float32)
    valid = valid.to(dev)
    with ieee_fp32_matmul():
        # predict (batched over slots; inactive slots are masked out of the cost)
        x = state.x @ f.T
        cov = torch.einsum("ij,tjk,lk->til", f, state.cov, f) + q

        # gated Mahalanobis cost, (T, M); H = I so S = P + R
        s_inv = _inv2(cov + r)
        y = z[None, :, :] - x[:, None, :]  # (T, M, 2)
        d2 = torch.einsum("tmi,tij,tmj->tm", y, s_inv, y)
        feasible = state.active[:, None] & valid[None, :] & (d2 <= cfg.gate)
        cost = torch.where(feasible, d2, _INF)

        assign, used = _greedy_assign(cost, min(cfg.max_tracks, cfg.max_meas))
        assigned = assign >= 0

        # route each track's measurement with a one-hot product
        onehot = (
            (assign[:, None] == torch.arange(cfg.max_meas, device=dev)[None, :]) & assigned[:, None]
        ).to(torch.float32)
        innov = onehot @ z - x  # zeros routed where unassigned
        gain = torch.einsum("tij,tjk->tik", cov, s_inv)
        x_upd = x + torch.einsum("tij,tj->ti", gain, innov)
        cov_upd = torch.einsum("tij,tjk->tik", eye[None] - gain, cov)
        x = torch.where(assigned[:, None], x_upd, x)
        cov = torch.where(assigned[:, None, None], cov_upd, cov)

        # M-of-N management
        hits = torch.where(assigned, state.hits + 1, state.hits)
        misses = torch.where(
            assigned, 0, torch.where(state.active, state.misses + 1, state.misses)
        ).to(torch.int32)
        active = state.active & (misses <= cfg.max_misses)

        # spawn: the i-th free slot claims the i-th leftover measurement
        leftover = valid & ~used
        free = ~active
        free_rank = torch.cumsum(free.to(torch.int32), 0)
        meas_rank = torch.cumsum(leftover.to(torch.int32), 0)
        match = free[:, None] & leftover[None, :] & (free_rank[:, None] == meas_rank[None, :])
        spawned = match.any(dim=1)
        z_new = match.to(torch.float32) @ z
    p_new = torch.diag(torch.tensor([cfg.init_pos_var, cfg.init_vel_var], device=dev))
    x = torch.where(spawned[:, None], z_new, x)
    cov = torch.where(spawned[:, None, None], p_new[None], cov)
    hits = torch.where(spawned, 1, hits).to(torch.int32)
    misses = torch.where(spawned, 0, misses).to(torch.int32)
    spawn_rank = torch.cumsum(spawned.to(torch.int32), 0)
    tid = torch.where(spawned, state.next_id - 1 + spawn_rank, state.tid).to(torch.int32)
    next_id = (state.next_id + spawned.sum(dtype=torch.int32)).to(torch.int32)
    active = active | spawned

    new_state = TrackerState(x, cov, active, hits, misses, tid, next_id)
    out = {
        "x": x,
        "active": active,
        "confirmed": active & (hits >= cfg.confirm_hits),
        "tid": tid,
    }
    return new_state, out


def track_cpis(
    cfg: TrackerConfig, zs, valids, *, state: TrackerState | None = None, device="cuda"
) -> tuple[TrackerState, dict]:
    """Run the tracker over a measurement stream.

    ``zs``: (n_cpis, max_meas, 2), ``valids``: (n_cpis, max_meas). Starts
    from ``state`` (a fresh :func:`tracker_init` on the inputs' device by
    default). Returns the final state and the stacked per-CPI snapshots
    (each leading axis n_cpis).
    """
    zs = as_tensor(zs, device)
    valids = as_tensor(valids, zs.device).to(zs.device)
    if state is None:
        state = tracker_init(cfg, device=zs.device)
    outs = []
    for k in range(zs.shape[0]):
        state, out = tracker_step(cfg, state, zs[k], valids[k])
        outs.append(out)
    hist = {key: torch.stack([o[key] for o in outs]) for key in ("x", "active", "confirmed", "tid")}
    return state, hist


def track_detections(rcfg, tcfg: TrackerConfig, i, q, *, device="cuda"):
    """End-to-end: a time-ordered stack of CPIs -> track history.

    ``i``/``q``: (n_cpis, n_pulses, n_range) planar echoes. Detection and
    measurement extraction are one batched call over the CPIs; only the
    tracker loop is sequential, as the recursion demands.
    """
    from . import radar

    det, power, _ = radar.detect_batch(rcfg, i, q, device=device)
    zs, valids = extract_measurements(det, power, max_meas=tcfg.max_meas, vel_scale=tcfg.vel_scale)
    return track_cpis(tcfg, zs, valids)
