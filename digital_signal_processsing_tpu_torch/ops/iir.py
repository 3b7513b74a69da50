"""IIR filtering on the card: first-order recurrences and second-order sections.

Counterpart of ``digital_signal_processsing_tpu/ops/iir.py``, its
time-invariant part and its time-varying sections (``sosfilt_tv*``, at the
end of this module with their kernels B16-B18). Coefficients follow scipy's
layout (``sos`` rows ``b0 b1 b2 a0 a1 a2`` with ``a0 == 1``); every section is
direct form II transposed::

    y = b0*x + s1;  s1' = b1*x - a1*y + s2;  s2' = b2*x - a2*y

over the last axis, leading axes independent streams. The state of a cascade
is ``(n_sections, *batch, 2)`` float32, ``(s1, s2)`` a section.

Kernels (``csrc/iir.cu``; see the source notes). B12 and B13 are one launch
with a fixed-depth look-back between tiles; the others take three launches each:
zero-state tile end states, a scan of those over the tiles, a seeded re-run.

- :func:`iir1_block_scan`      B10, ``y = a*y + b*x`` with scalar a, b;
- :func:`sos_cascade`          B12, the whole cascade in one pass, a runtime
  loop over sections, seeded or not: the ``auto`` route of ``sosfilt`` and
  ``sosfilt_chunk``;
- :func:`sos_cascade_unrolled` B13, B12's one pass with 1..8 sections fixed
  at compile time, from zero state (``unroll_sections=True``);
- :func:`sos_sections`         B15, one section a launch, each through device
  memory (``method="pallas"``, the A/B anchor);
- :func:`iir1_affine_scan`     B11, B10's function as composed affine maps
  (``iir_first_order_pallas(kernel="tile")``, an A/B anchor);
- :func:`sos_cascade_mxu`      B14, B12's function with the in-segment pass a
  float64 tensor-core product (``sosfilt_pallas_fused(lane_pass="mxu")``, an
  A/B anchor).

Each takes its plain version for a tensor on the CPU: the same three steps in
PyTorch, a loop over the PLAIN_TILE samples of a tile vectorised over
channels x tiles, then the tile carry, then the seeded loop. ``xla_scan`` is
that plain version on any device. For a CUDA tensor a wrapper launches its
kernel, adds one to its ``launches`` count, and raises if the build or the
launch fails. The NumPy designers and scipy helpers are copies of the
reference's.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..utils.device import resolve_device
from ..utils.dispatch import record_choice, refuse_grad
from ..utils.layout import cdiv
from .iir_design import iirfilter
from .pallas_scan import _on_cuda, _stream

# T from which `auto` takes the kernels (B10, B12) instead of the plain
# version. The reference's 65536 came from XLA's associative scan, which would
# not compile at long T on the TPU. On an H100 (chip_smoke.py phase 5, 16
# channels, PERF.md) the kernels (B12 one launch, B10 three) beat the plain
# versions' thousands of small launches at every T measured, from T = 1 to
# 2^22 (16.7x and 4.7x at T = 1, 694x and 150x at 2^22): `auto` takes them
# whenever there is a sample.
PALLAS_IIR_MIN_T = 1

# csrc/iir.cu, the three-launch kernels (B10, B14, B15): a block's threads, a
# thread's consecutive samples, a sub-tile, the floats of a section's table and
# of the first-order table; the most sections a launch of B12 and B14 (2S
# state lanes of one warp) and of B13 takes: their wrappers chain groups of at
# most that many (section_groups).
THREADS = 256
SEG = 16
SUB_TILE = THREADS * SEG
TAB = 144
TAB1 = 40
MAX_SECTIONS = 16
MAX_UNROLLED = 8
# Tiles a launch aims for when picking the tile: four waves of eight blocks
# on each of the H100's 132 SMs. Longer tiles mean fewer tiles to chain in
# launch 2, shorter ones more blocks to spread.
TARGET_BLOCKS = 4 * 8 * 132
MAX_TILE_SUBS = 64
# Samples of a tile of the plain versions: their loops run PLAIN_TILE
# vectorised steps a pass.
PLAIN_TILE = 512
# csrc/iir.cu, B12 (sos_lookback_kernel): a block's threads, a thread's
# consecutive samples, a sub-tile, the floats of a section's row and where its
# warp powers start, and the sub-tiles a block holds in shared memory
# (kHoldBytes); a longer tile streams the rest, read twice. B12 picks tiles of
# at most that many, and of at least LB_MIN_SUBS (lookback_tile).
LB_THREADS = 256
LB_SEG = 16
LB_SUB = LB_THREADS * LB_SEG
TAB_LB = 176
_LB_WARP_POW = 140
LB_HOLD_SUBS = 65536 // (4 * LB_SUB)
LB_MIN_SUBS = 3


# --- geometry and tables -------------------------------------------------------


def pick_tile(channels: int, t: int, tile_rows: int | None = None) -> int:
    """Samples of a kernel tile (a multiple of SUB_TILE).

    ``tile_rows`` (rows of 128 samples, the reference's knob) fixes it and must
    be a multiple of SUB_TILE // 128; None picks the fewest sub-tiles a tile
    that still give about TARGET_BLOCKS blocks.
    """
    if tile_rows is not None:
        if tile_rows < 1 or (tile_rows * 128) % SUB_TILE:
            raise ValueError(
                f"tile_rows must be a positive multiple of {SUB_TILE // 128} on the card, "
                f"got {tile_rows}"
            )
        return tile_rows * 128
    subs = max(1, min(MAX_TILE_SUBS, channels * cdiv(max(t, 1), SUB_TILE) // TARGET_BLOCKS))
    return subs * SUB_TILE


def lookback_tile(channels: int, t: int, tile_rows: int | None = None) -> int:
    """Samples of a B12 tile: ``tile_rows`` as :func:`pick_tile` takes it, else
    pick_tile's choice between LB_MIN_SUBS and the sub-tiles a block holds.
    Fewer, longer tiles shorten the look-back's chain: on an H100
    (tools/ab_lookback_direct.py, PERF.md) 16 x 2^22 and the 2 x 2^19 and
    2 x 2^20 serving chunks all ran fastest at three sub-tiles, where
    pick_tile takes three and one."""
    if tile_rows is not None:
        return pick_tile(channels, t, tile_rows)
    subs = pick_tile(channels, t) // SUB_TILE
    return min(max(subs, LB_MIN_SUBS), LB_HOLD_SUBS) * LB_SUB


def lookback_depth(sections: int) -> int:
    """B12's look-back depth L for S sections (csrc/iir.cu lookback_depth)."""
    return 8 if sections <= 8 else 4


def _phi(a1: float, a2: float) -> np.ndarray:
    """A section's zero-input state transition: s' = Phi s."""
    return np.array([[-a1, 1.0], [-a2, 0.0]])


def section_table(rows: np.ndarray) -> np.ndarray:
    """(S, TAB) float32: b0 b1 b2 a1 a2, then Phi^(SEG m) for m = 0..32 at 8 + 4m.

    Taken in float64 from the float32 coefficients and rounded once.
    """
    r64 = np.asarray(rows, np.float32).astype(np.float64).reshape(-1, 6)
    tab = np.zeros((r64.shape[0], TAB))
    for k, (b0, b1, b2, _, a1, a2) in enumerate(r64):
        tab[k, :5] = b0, b1, b2, a1, a2
        step = np.linalg.matrix_power(_phi(a1, a2), SEG)
        p = np.eye(2)
        for m in range(33):
            tab[k, 8 + 4 * m : 12 + 4 * m] = p.ravel()
            p = step @ p
    return tab.astype(np.float32)


def iir1_table(a: float, b: float) -> np.ndarray:
    """(TAB1,) float32: a, b, then a^(SEG m) for m = 0..32 at 4 + m."""
    a64 = float(np.float32(a))
    tab = np.zeros(TAB1)
    tab[0], tab[1] = a64, float(np.float32(b))
    tab[4 : 4 + 33] = a64 ** (SEG * np.arange(33, dtype=np.float64))
    return tab.astype(np.float32)


def cascade_transition(rows: np.ndarray) -> np.ndarray:
    """(2S, 2S) float64: the cascade's state transition over one zero-input sample.

    State index 2k + j is section k's s1 (j = 0) or s2 (j = 1). Section k's
    zero-input output drives section k+1, so the matrix is block lower
    triangular; its power over a tile is the M of the kernels' carry scan.
    """
    r64 = np.asarray(rows, np.float32).astype(np.float64).reshape(-1, 6)
    d = 2 * r64.shape[0]
    g = np.zeros((d, d))
    for col in range(d):
        s = np.zeros(d)
        s[col] = 1.0
        u = 0.0
        for k, (b0, b1, b2, _, a1, a2) in enumerate(r64):
            y = b0 * u + s[2 * k]
            g[2 * k, col] = b1 * u - a1 * y + s[2 * k + 1]
            g[2 * k + 1, col] = b2 * u - a2 * y
            u = y
    return g


def lookback_table(rows: np.ndarray) -> np.ndarray:
    """(S, TAB_LB) float32: b0 b1 b2 a1 a2, Phi^(LB_SEG m) for m = 0..32 at 8 + 4m,
    Phi^(32 LB_SEG m) for m = 0..8 at 140 + 4m. Taken in float64, rounded once."""
    r64 = np.asarray(rows, np.float32).astype(np.float64).reshape(-1, 6)
    tab = np.zeros((r64.shape[0], TAB_LB))
    for k, (b0, b1, b2, _, a1, a2) in enumerate(r64):
        tab[k, :5] = b0, b1, b2, a1, a2
        phi = _phi(a1, a2)
        for m in range(33):
            tab[k, 8 + 4 * m : 12 + 4 * m] = np.linalg.matrix_power(phi, LB_SEG * m).ravel()
        for m in range(9):
            tab[k, _LB_WARP_POW + 4 * m : _LB_WARP_POW + 4 + 4 * m] = np.linalg.matrix_power(
                phi, 32 * LB_SEG * m).ravel()
    return tab.astype(np.float32)


def cascade_input(rows: np.ndarray) -> np.ndarray:
    """(2S,) float64: the cascade's state after one sample of input 1 from zero state."""
    r64 = np.asarray(rows, np.float32).astype(np.float64).reshape(-1, 6)
    out = np.zeros(2 * r64.shape[0])
    u = 1.0
    for k, (b0, b1, b2, _, a1, a2) in enumerate(r64):
        y = b0 * u
        out[2 * k], out[2 * k + 1] = b1 * u - a1 * y, b2 * u - a2 * y
        u = y
    return out


def lookback_matrices(rows: np.ndarray, tile: int) -> dict:
    """B12's linear maps in float64 (D = 2S, G the cascade's one-sample zero-input
    transition): ``K`` (D, LB_SEG), a segment's end state from zero state;
    ``W`` (32, D, LB_SEG), lane l's M_seg^(31-l) K with M_seg = G^LB_SEG; ``sub``
    M_seg^LB_THREADS (a sub-tile); ``warp`` (8, D, D) M_seg^(32 e); ``tile`` (L + 1, D, D)
    the powers M^m of the tile's transition M = G^tile."""
    g = cascade_transition(rows)
    bv = cascade_input(rows)
    k = np.stack([np.linalg.matrix_power(g, LB_SEG - 1 - i) @ bv for i in range(LB_SEG)], 1)
    mseg = np.linalg.matrix_power(g, LB_SEG)
    w = np.stack([np.linalg.matrix_power(mseg, 31 - lane) @ k for lane in range(32)])
    m = np.linalg.matrix_power(g, tile)
    depth = lookback_depth(g.shape[0] // 2)
    return {
        "K": k, "W": w, "sub": np.linalg.matrix_power(mseg, LB_THREADS),
        "warp": np.stack([np.linalg.matrix_power(mseg, 32 * e) for e in range(8)]),
        "tile": np.stack([np.linalg.matrix_power(m, e) for e in range(depth + 1)]),
    }


def lookback_mats(rows: np.ndarray, tile: int) -> np.ndarray:
    """B12's device table, float32: W with lane l's weights of component q,
    samples 4 i4 .. 4 i4 + 3, at float4 (q LB_SEG / 4 + i4) 32 + l; then M_sub,
    M_warp^e (e < 8) and M^m (m <= L), each D x D stored transposed ([q][r])."""
    mt = lookback_matrices(rows, tile)
    d = mt["K"].shape[0]
    w = mt["W"].reshape(32, d, LB_SEG // 4, 4).transpose(1, 2, 0, 3)
    mats = [mt["sub"][None], mt["warp"], mt["tile"]]
    return np.concatenate(
        [w.ravel()] + [np.swapaxes(a, 1, 2).ravel() for a in mats]
    ).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _lookback_tables(key: bytes, tile: int, device: str):
    rows = np.frombuffer(key, np.float32).reshape(-1, 6)
    return (
        torch.from_numpy(lookback_table(rows)).to(device),
        torch.from_numpy(lookback_mats(rows, tile)).to(device),
    )


@functools.lru_cache(maxsize=64)
def _cascade_tables(key: bytes, tile: int, device: str, per_section: bool):
    """The section table and the tile transition M on ``device``.

    ``per_section``: M is each section's own (S, 2, 2) Phi^tile (B15); else
    the cascade's (2S, 2S) transition (B14).
    """
    rows = np.frombuffer(key, np.float32).reshape(-1, 6)
    if per_section:
        m = np.stack([
            np.linalg.matrix_power(_phi(float(r[4]), float(r[5])), tile)
            for r in rows.astype(np.float64)
        ])
    else:
        m = np.linalg.matrix_power(cascade_transition(rows), tile)
    return (
        torch.from_numpy(section_table(rows)).to(device),
        torch.from_numpy(m.astype(np.float32)).to(device),
    )


@functools.lru_cache(maxsize=64)
def _iir1_tables(a: float, b: float, tile: int, device: str):
    a64 = float(np.float32(a))
    m = np.array([a64**tile], np.float32)
    return torch.from_numpy(iir1_table(a, b)).to(device), torch.from_numpy(m).to(device)


@functools.lru_cache(maxsize=64)
def _plain_powers(key: bytes, first_order: bool, tile: int, levels: int, device: str):
    """M^(2^i), i < levels, float64 on ``device``: the plain versions' tile scan."""
    if first_order:
        a = float(np.frombuffer(key, np.float32)[0])
        m = np.array([[a]]) ** tile
    else:
        m = np.linalg.matrix_power(cascade_transition(np.frombuffer(key, np.float32)), tile)
    out = []
    for _ in range(levels):
        out.append(torch.from_numpy(m.copy()).to(device))
        m = m @ m
    return out


# --- plain versions --------------------------------------------------------------


def _tiles(x2: torch.Tensor, tile: int) -> torch.Tensor:
    """(C, T) -> (tile, C, nt): sample j of every tile as one contiguous (C, nt) slab."""
    c, t = x2.shape
    nt = cdiv(t, tile)
    return F.pad(x2, (0, nt * tile - t)).view(c, nt, tile).permute(2, 0, 1).contiguous()


def _untiles(yt: torch.Tensor, t: int) -> torch.Tensor:
    tile, c, nt = yt.shape
    return yt.permute(1, 2, 0).reshape(c, nt * tile)[:, :t].contiguous()


def _scan_tiles(z: torch.Tensor, s0: torch.Tensor, powers: list) -> torch.Tensor:
    """Start states s_t of the tiles, float64: s_0 = s0, s_{t+1} = M s_t + z_t.

    z: (D, N, nt) end states of the tiles from zero state; s0: (D, N);
    powers[i] = M^(2^i). A Hillis-Steele scan over the tiles in place of the
    kernels' walk of one warp: the same states, summed in another order.
    """
    q = torch.cat([s0[:, :, None], z[:, :, :-1]], dim=2)
    d = 1
    for p in powers:
        if d >= q.shape[2]:
            break
        q = torch.cat([q[:, :, :d], q[:, :, d:] + torch.einsum("ij,jnt->int", p, q[:, :, :-d])], 2)
        d *= 2
    return q


def _run_sections(xt, coef, states, yt=None, snap_at=-1):
    """The cascade over the rows of ``xt`` (tile, C, nt), states[k] = (s1, s2).

    Writes each sample's output to ``yt`` when given; returns the states after
    the last row and, at row ``snap_at``, the last tile's states.
    """
    snap = None
    for j in range(xt.shape[0]):
        u = xt[j]
        for k, (b0, b1, b2, a1, a2) in enumerate(coef):
            s1, s2 = states[k]
            yk = torch.add(s1, u, alpha=b0)
            states[k] = (
                torch.add(s2, u, alpha=b1).sub_(yk, alpha=a1),
                torch.mul(u, b2).sub_(yk, alpha=a2),
            )
            u = yk
        if yt is not None:
            yt[j] = u
        if j == snap_at:
            snap = [(s1[:, -1].clone(), s2[:, -1].clone()) for s1, s2 in states]
    return states, snap


def _sos_plain(x2: torch.Tensor, rows: np.ndarray, state: torch.Tensor | None):
    """Plain version of B12/B13: (C, T) float32 -> (y, end state (S, C, 2))."""
    c, t = x2.shape
    s = rows.shape[0]
    if state is None:
        state = x2.new_zeros((s, c, 2))
    if t == 0:
        return x2.new_zeros((c, 0)), state.clone()
    tile = min(PLAIN_TILE, t)
    xt = _tiles(x2, tile)
    nt = xt.shape[2]
    coef = [(float(r[0]), float(r[1]), float(r[2]), float(r[4]), float(r[5])) for r in rows]
    zero = x2.new_zeros((c, nt))
    # 1. each tile from zero state: its end state
    ends, _ = _run_sections(xt, coef, [(zero, zero) for _ in range(s)])
    z = torch.stack([v for pair in ends for v in pair]).double()  # (2S, C, nt)
    # 2. the state entering each tile
    s0 = state.permute(0, 2, 1).reshape(2 * s, c).double()
    powers = _plain_powers(rows.tobytes(), False, tile, max(1, (nt - 1).bit_length()),
                           str(x2.device))
    starts = _scan_tiles(z, s0, powers).float()
    # 3. each tile from its state, and the state after sample t-1
    yt = torch.empty_like(xt)
    _, snap = _run_sections(
        xt, coef, [(starts[2 * k], starts[2 * k + 1]) for k in range(s)], yt, (t - 1) % tile
    )
    new_state = torch.stack([torch.stack(pair, dim=-1) for pair in snap])
    return _untiles(yt, t), new_state


def _sections_plain(x2: torch.Tensor, rows: np.ndarray, state: torch.Tensor | None):
    """Plain version of B15: the plain cascade one section at a time."""
    y, ends = x2, []
    for k in range(rows.shape[0]):
        y, end = _sos_plain(y, rows[k : k + 1], None if state is None else state[k : k + 1])
        ends.append(end)
    return y, torch.cat(ends)


def _iir1_plain(x2: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """Plain version of B10: y = a*y + b*x, zero initial state, (C, T) float32."""
    c, t = x2.shape
    if t == 0:
        return x2.new_zeros((c, 0))
    a, b = float(np.float32(a)), float(np.float32(b))
    tile = min(PLAIN_TILE, t)
    xt = _tiles(x2, tile)
    nt = xt.shape[2]
    s = x2.new_zeros((c, nt))
    for j in range(tile):
        s = torch.add(s * a, xt[j], alpha=b)
    powers = _plain_powers(np.float32(a).tobytes(), True, tile, max(1, (nt - 1).bit_length()),
                           str(x2.device))
    s = _scan_tiles(s.double()[None], x2.new_zeros((1, c), dtype=torch.float64), powers)[0]
    s = s.float()
    yt = torch.empty_like(xt)
    for j in range(tile):
        s = torch.add(s * a, xt[j], alpha=b)
        yt[j] = s
    return _untiles(yt, t)


# --- kernel wrappers ---------------------------------------------------------------


def _check(x2, state, sections: int, name: str, tile_rows: int | None) -> None:
    if tile_rows is not None:
        pick_tile(1, 1, tile_rows)  # raises on a tile the kernels cannot take
    if not isinstance(x2, torch.Tensor) or x2.dim() != 2:
        raise ValueError(f"{name}: x must be a (channels, time) tensor")
    if x2.dtype != torch.float32:
        raise TypeError(f"{name}: x must be float32, got {x2.dtype}")
    if state is not None:
        want = (sections, x2.shape[0], 2)
        if tuple(state.shape) != want or state.dtype != torch.float32:
            raise ValueError(
                f"{name}: state must be float32 {want}, got {state.dtype} {tuple(state.shape)}"
            )
        if state.device != x2.device:
            raise ValueError(f"{name}: state on {state.device}, x on {x2.device}")
    if x2.device.type == "cuda":
        if not x2.is_contiguous() or (state is not None and not state.is_contiguous()):
            raise ValueError(f"{name}: x and state must be contiguous")
        if x2.shape[0] > 65535:
            raise ValueError(f"{name}: at most 65535 channels on the card, got {x2.shape[0]}")


def _launch_unrolled(x2, rows, tile_rows):
    c, t = x2.shape
    s = rows.shape[0]
    y = torch.empty_like(x2)
    tile = lookback_tile(c, t, tile_rows)
    tab, mats = _lookback_tables(rows.tobytes(), tile, str(x2.device))
    rec = torch.empty(1 + 2 * c * cdiv(t, tile) * 2 * s, dtype=torch.int64, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dsp_sos_unrolled(
            x2.data_ptr(), y.data_ptr(), tab.data_ptr(), mats.data_ptr(), rec.data_ptr(),
            t, c, s, tile, _stream(x2),
        )
    _build.check(err, "sos_cascade_unrolled")
    return y


def _launch_lookback(x2, rows, state, tile_rows):
    c, t = x2.shape
    s = rows.shape[0]
    y = torch.empty_like(x2)
    new_state = None if state is None else torch.empty_like(state)
    tile = lookback_tile(c, t, tile_rows)
    tab, mats = _lookback_tables(rows.tobytes(), tile, str(x2.device))
    # the ticket, then each tile's z and s records (2S words each a channel)
    rec = torch.empty(1 + 2 * c * cdiv(t, tile) * 2 * s, dtype=torch.int64, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dsp_sos_lookback(
            x2.data_ptr(), y.data_ptr(), tab.data_ptr(), mats.data_ptr(),
            None if state is None else state.data_ptr(),
            None if new_state is None else new_state.data_ptr(),
            rec.data_ptr(), t, c, s, tile, _stream(x2),
        )
    _build.check(err, "sos_cascade")
    return y, new_state


def cascade_kernel_attrs(sections: int, tile: int | None = None, unrolled: bool = False) -> tuple:
    """What the compiler gave B12's kernel (B13's when ``unrolled``), and its
    blocks an SM at ``sections`` sections and a tile of ``tile`` samples (the
    card only; None: the tile of the IIR main path, 16 x 2^22): (registers a
    thread, local bytes a thread, shared bytes a block, blocks an SM)."""
    if tile is None:
        tile = lookback_tile(16, 1 << 22)
    lib = _build.library()
    out = (ctypes.c_int64 * 4)()
    _build.check(lib.dsp_sos_attrs(sections, tile, int(unrolled), ctypes.addressof(out)),
                 "cascade_kernel_attrs")
    return tuple(out)


def section_groups(sections: int, most: int) -> list[tuple[int, int]]:
    """Sections ``[g0, g1)`` of each group a cascade wrapper launches: consecutive
    groups of at most ``most`` sections, the kernel's largest instance. Group
    g + 1 filters group g's output, from its own slice ``state[g0:g1]`` of the
    state."""
    return [(g0, min(g0 + most, sections)) for g0 in range(0, sections, most)]


def sos_cascade(x2: torch.Tensor, rows: np.ndarray, state: torch.Tensor | None = None, *,
                tile_rows: int | None = None):
    """The SOS cascade of (C, T) float32 by B12: (y, end state or None).

    ``rows``: (S, 6) float32, any S: groups of MAX_SECTIONS sections
    (:func:`section_groups`), one launch each. ``state``: the (S, C, 2)
    state entering the chunk (zero when None); the end state comes back only
    for a seeded call.
    """
    rows = _sos_rows(rows)
    s = rows.shape[0]
    if s < 1:
        raise ValueError("sos_cascade (B12) needs at least one section")
    _check(x2, state, s, "sos_cascade", tile_rows)
    if _on_cuda(x2) and x2.shape[1] == 0:
        return torch.empty_like(x2), None if state is None else state.clone()
    if _on_cuda(x2):
        refuse_grad("sos_cascade (B12)", x2, state)
    y, ends = x2, []
    for g0, g1 in section_groups(s, MAX_SECTIONS):
        st = None if state is None else state[g0:g1]
        if _on_cuda(x2):
            y, end = _launch_lookback(y, rows[g0:g1], st, tile_rows)
            sos_cascade.launches += 1
        else:
            y, end = _sos_plain(y, rows[g0:g1], st)
        ends.append(end)
    return y, None if state is None else torch.cat(ends)


sos_cascade.launches = 0


def sos_cascade_unrolled(x2: torch.Tensor, rows: np.ndarray, *,
                         tile_rows: int | None = None) -> torch.Tensor:
    """The SOS cascade of (C, T) float32 from zero state by B13, any S: groups
    of MAX_UNROLLED sections (:func:`section_groups`), one launch each."""
    rows = _sos_rows(rows)
    s = rows.shape[0]
    if s < 1:
        raise ValueError("sos_cascade_unrolled (B13) needs at least one section")
    _check(x2, None, s, "sos_cascade_unrolled", tile_rows)
    if _on_cuda(x2):
        refuse_grad("sos_cascade_unrolled (B13)", x2)
    if _on_cuda(x2) and x2.shape[1] == 0:
        return torch.empty_like(x2)
    y = x2
    for g0, g1 in section_groups(s, MAX_UNROLLED):
        if _on_cuda(x2):
            y = _launch_unrolled(y, rows[g0:g1], tile_rows)
            sos_cascade_unrolled.launches += 1
        else:
            y = _sos_plain(y, rows[g0:g1], None)[0]
    return y


sos_cascade_unrolled.launches = 0


def sos_sections(x2: torch.Tensor, rows: np.ndarray, state: torch.Tensor | None = None, *,
                 tile_rows: int | None = None):
    """The SOS cascade of (C, T) float32 by B15, one section a launch: (y, end state or None)."""
    rows = _sos_rows(rows)
    s = rows.shape[0]
    if s < 1:
        raise ValueError("sos_sections (B15) needs at least one section")
    _check(x2, state, s, "sos_sections", tile_rows)
    if not _on_cuda(x2):
        y, end = _sections_plain(x2, rows, state)
        return y, None if state is None else end
    refuse_grad("sos_sections (B15)", x2, state)
    c, t = x2.shape
    if t == 0:
        return torch.empty_like(x2), None if state is None else state.clone()
    y = torch.empty_like(x2)
    scratch = torch.empty_like(x2) if s > 1 else None
    new_state = None if state is None else torch.empty_like(state)
    tile = pick_tile(c, t, tile_rows)
    tab, m = _cascade_tables(rows.tobytes(), tile, str(x2.device), True)
    carry = torch.empty(c * cdiv(t, tile) * 2, dtype=torch.float32, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dsp_sos_sections(
            x2.data_ptr(), y.data_ptr(), None if scratch is None else scratch.data_ptr(),
            tab.data_ptr(), carry.data_ptr(), m.data_ptr(),
            None if state is None else state.data_ptr(),
            None if new_state is None else new_state.data_ptr(),
            t, c, s, tile, _stream(x2),
        )
    _build.check(err, "sos_sections")
    sos_sections.launches += 1
    return y, new_state


sos_sections.launches = 0


def iir1_block_scan(x2: torch.Tensor, a: float, b: float = 1.0, *,
                    tile_rows: int | None = None) -> torch.Tensor:
    """y = a*y + b*x over (C, T) float32 from zero state by B10."""
    _check(x2, None, 1, "iir1_block_scan", tile_rows)
    if not _on_cuda(x2):
        return _iir1_plain(x2, a, b)
    refuse_grad("iir1_block_scan (B10)", x2)
    c, t = x2.shape
    y = torch.empty_like(x2)
    if t == 0:
        return y
    tile = pick_tile(c, t, tile_rows)
    tab, m = _iir1_tables(float(a), float(b), tile, str(x2.device))
    carry = torch.empty(c * cdiv(t, tile), dtype=torch.float32, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dsp_iir1(
            x2.data_ptr(), y.data_ptr(), tab.data_ptr(), carry.data_ptr(), m.data_ptr(),
            t, c, tile, _stream(x2),
        )
    _build.check(err, "iir1_block_scan")
    iir1_block_scan.launches += 1
    return y


iir1_block_scan.launches = 0


# --- the reference's A/B anchors: B11 and B14 ---------------------------------------
#
# Other spellings of B10's and B12's functions, kept by the reference to time
# one design against the other; each serves one entry point
# (iir_first_order_pallas(kernel="tile"), sosfilt_pallas_fused(lane_pass="mxu"))
# and takes B10's or B12's plain version for a CPU tensor.

# csrc/iir.cu, B14: samples a segment (a row of its lane pass), a warp's
# sub-tile (32 segments), warps a block, the (n-tile, k-step) blocks of T it
# keeps and their order, the doubles of a section's fragments, the floats of
# its table
MXU_SEG = 32
MXU_SUB = 32 * MXU_SEG
MXU_WARPS = 8
MXU_BLOCKS = tuple((q, kk) for q in range(MXU_SEG // 8) for kk in range(2 * q + 2))
MXU_SEC = 32 * len(MXU_BLOCKS) + 4
# FP64 multiply-adds a segment and section: each kept block is 8 x 4 of T
MXU_MACS = 32 * len(MXU_BLOCKS)
TAB_MXU = 272
_MXU_POW_L = 8 + 4 * 33


def mxu_tables(rows) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """B14's tables: ((S, TAB_MXU) float32, (S, MXU_SEG, MXU_SEG) float64 T,
    (S, MXU_SEC) float64 fragments).

    The table holds b0 b1 b2 a1 a2, then k1 = b1 - a1 b0 and k2 = b2 - a2 b0
    at 5, 6, Phi^(MXU_SEG m) for m = 0..32 at 8 + 4m and A^l for l < MXU_SEG
    at 140 + 4l (A = Phi), taken in float64 from the float32 coefficients and
    rounded once. T maps a segment's samples u (row j: sample j) to s_ex1 of
    lane l in column l: T[j, l] = (A^(l-1-j))_00 k1 + (A^(l-1-j))_01 k2 for
    j < l, else 0. T stays float64. The fragments are T in the order the
    kernel's lanes read it, block (q, kk) of MXU_BLOCKS (n-tile q, k-step kk,
    the blocks kk < 2q + 2 that are not all zeros) at 32 * its index, lane i
    taking T[4 kk + i % 4, 8 q + i // 4]; then a1, a2, k1, k2 in float64.
    """
    r64 = np.asarray(rows, np.float32).astype(np.float64).reshape(-1, 6)
    s = r64.shape[0]
    tab = np.zeros((s, TAB_MXU))
    tmat = np.zeros((s, MXU_SEG, MXU_SEG))
    frags = np.zeros((s, MXU_SEC))
    lane = np.arange(32)
    for k, (b0, b1, b2, _, a1, a2) in enumerate(r64):
        phi = _phi(a1, a2)
        k1, k2 = b1 - a1 * b0, b2 - a2 * b0
        tab[k, :7] = b0, b1, b2, a1, a2, k1, k2
        pw = [np.eye(2)]
        for _ in range(MXU_SEG):
            pw.append(phi @ pw[-1])
        for l in range(MXU_SEG):
            tab[k, _MXU_POW_L + 4 * l : _MXU_POW_L + 4 * l + 4] = pw[l].ravel()
        step, p = pw[MXU_SEG], np.eye(2)
        for m in range(33):
            tab[k, 8 + 4 * m : 12 + 4 * m] = p.ravel()
            p = step @ p
        for j in range(MXU_SEG):
            for l in range(j + 1, MXU_SEG):
                tmat[k, j, l] = pw[l - 1 - j][0, 0] * k1 + pw[l - 1 - j][0, 1] * k2
        for i, (q, kk) in enumerate(MXU_BLOCKS):
            frags[k, 32 * i : 32 * i + 32] = tmat[k, 4 * kk + lane % 4, 8 * q + lane // 4]
        frags[k, 32 * len(MXU_BLOCKS) :] = a1, a2, k1, k2
    return tab.astype(np.float32), tmat, frags


@functools.lru_cache(maxsize=64)
def _mxu_device_tables(key: bytes, tile: int, device: str):
    tab, _, frags = mxu_tables(np.frombuffer(key, np.float32).reshape(-1, 6))
    _, m = _cascade_tables(key, tile, device, False)
    return torch.from_numpy(tab).to(device), torch.from_numpy(frags).to(device), m


def mxu_kernel_attrs(sections: int) -> tuple:
    """What the compiler gave B14's tile kernel, and its blocks an SM at
    ``sections`` sections (the card only): (registers a thread, local bytes a
    thread, shared bytes a block, blocks an SM, warps a block)."""
    lib = _build.library()
    out = (ctypes.c_int64 * 5)()
    _build.check(lib.dsp_mxu_attrs(sections, ctypes.addressof(out)), "mxu_kernel_attrs")
    return tuple(out)


def iir1_affine_scan(x2: torch.Tensor, a: float, b: float = 1.0, *,
                     tile_rows: int | None = None) -> torch.Tensor:
    """y = a*y + b*x over (C, T) float32 from zero state by B11.

    B10's function composed as per-sample affine maps (y -> a y + b x) with
    no table of powers; the kernel gets a and b alone.
    """
    _check(x2, None, 1, "iir1_affine_scan", tile_rows)
    if not _on_cuda(x2):
        return _iir1_plain(x2, a, b)
    refuse_grad("iir1_affine_scan (B11)", x2)
    c, t = x2.shape
    y = torch.empty_like(x2)
    if t == 0:
        return y
    tile = pick_tile(c, t, tile_rows)
    carry = torch.empty(c * cdiv(t, tile) * 2, dtype=torch.float32, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dsp_iir1_affine(
            x2.data_ptr(), y.data_ptr(), carry.data_ptr(), float(np.float32(a)),
            float(np.float32(b)), t, c, tile, _stream(x2),
        )
    _build.check(err, "iir1_affine_scan")
    iir1_affine_scan.launches += 1
    return y


iir1_affine_scan.launches = 0


def sos_cascade_mxu(x2: torch.Tensor, rows: np.ndarray, *,
                    tile_rows: int | None = None) -> torch.Tensor:
    """The SOS cascade of (C, T) float32 from zero state by B14.

    B12's function with each section's in-segment pass a float64
    tensor-core product of the samples against the section's T
    (:func:`mxu_tables`); ``rows``: (S, 6) float32, any S: groups of
    MAX_SECTIONS sections (:func:`section_groups`), one launch each.
    """
    rows = _sos_rows(rows)
    s = rows.shape[0]
    if s < 1:
        raise ValueError("sos_cascade_mxu (B14) needs at least one section")
    _check(x2, None, s, "sos_cascade_mxu", tile_rows)
    if _on_cuda(x2):
        refuse_grad("sos_cascade_mxu (B14)", x2)
    if _on_cuda(x2) and x2.shape[1] == 0:
        return torch.empty_like(x2)
    y = x2
    for g0, g1 in section_groups(s, MAX_SECTIONS):
        if _on_cuda(x2):
            y = _launch_mxu(y, rows[g0:g1], tile_rows)
            sos_cascade_mxu.launches += 1
        else:
            y = _sos_plain(y, rows[g0:g1], None)[0]
    return y


def _launch_mxu(x2, rows, tile_rows):
    c, t = x2.shape
    s = rows.shape[0]
    y = torch.empty_like(x2)
    tile = pick_tile(c, t, tile_rows)
    tab, frags, m = _mxu_device_tables(rows.tobytes(), tile, str(x2.device))
    carry = torch.empty(c * cdiv(t, tile) * 2 * s, dtype=torch.float32, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dsp_sos_cascade_mxu(
            x2.data_ptr(), y.data_ptr(), tab.data_ptr(), frags.data_ptr(), carry.data_ptr(),
            m.data_ptr(), t, c, s, tile, _stream(x2),
        )
    _build.check(err, "sos_cascade_mxu")
    return y


sos_cascade_mxu.launches = 0


# --- shapes -----------------------------------------------------------------------


def _sos_rows(sos) -> np.ndarray:
    """The sos rows as (S, 6) float32 NumPy (a tensor is copied to the host)."""
    if isinstance(sos, torch.Tensor):
        sos = sos.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(sos, np.float32).reshape(-1, 6))


def _planar(x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
    """(..., T) -> contiguous (C, T) float32 and the batch shape."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() == 0:
        raise ValueError("expected at least one axis (time)")
    batch = tuple(x.shape[:-1])
    return x.to(torch.float32).reshape(int(np.prod(batch)), x.shape[-1]).contiguous(), batch


def _state_planar(state: torch.Tensor, sections: int, channels: int) -> torch.Tensor:
    if not isinstance(state, torch.Tensor):
        raise TypeError(f"state must be a torch.Tensor, got {type(state).__name__}")
    if state.shape[0] != sections or state.shape[-1] != 2 or state.numel() != sections * channels * 2:
        raise ValueError(
            f"state of shape {tuple(state.shape)} for {sections} sections and {channels} streams"
        )
    return state.to(torch.float32).reshape(sections, channels, 2).contiguous()


# --- the reference's entry points -------------------------------------------------


def iir_first_order(x: torch.Tensor, a, b=1.0, *, method: str = "auto") -> torch.Tensor:
    """y[t] = a*y[t-1] + b*x[t] over the last axis, zero initial state.

    ``auto`` takes B10 (``pallas``) from PALLAS_IIR_MIN_T samples with scalar
    coefficients, else the plain version (``xla_scan``). Per-sample (array)
    coefficients, broadcast against ``x``, always take ``xla_scan``, as the
    reference sends them to its XLA scan.
    """
    scalar = np.ndim(a) == 0 and np.ndim(b) == 0
    if method == "auto":
        method = "pallas" if scalar and x.shape[-1] >= PALLAS_IIR_MIN_T else "xla_scan"
    record_choice("iir_first_order", method)
    if method == "pallas":
        if not scalar:
            raise ValueError("method='pallas' takes scalar coefficients; arrays take 'xla_scan'")
        return iir_first_order_pallas(x, a, b)
    if method != "xla_scan":
        raise ValueError(f"unknown method {method!r}; options ('auto', 'pallas', 'xla_scan')")
    return _iir_first_order_xla(x, a, b)


def _iir_first_order_xla(x: torch.Tensor, a, b=1.0) -> torch.Tensor:
    if np.ndim(a) == 0 and np.ndim(b) == 0:
        x2, batch = _planar(x)
        return _iir1_plain(x2, float(a), float(b)).reshape(batch + (x2.shape[1],))
    return _iir1_scan(x, a, b)


def _iir1_scan(x: torch.Tensor, a, b) -> torch.Tensor:
    """y = a*y + b*x with per-sample coefficients: log2(T) doubling steps.

    The reference's associative scan of the maps y -> a y + b x, composed
    (a2 a1, a2 b1 + b2) in Hillis-Steele order; float32 throughout.
    """
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    xf = x.to(torch.float32)
    av = _coef(a, x.device)
    bx = _coef(b, x.device) * xf
    av, bx = torch.broadcast_tensors(av, bx)
    av, bx = av.contiguous(), bx.contiguous()
    t = xf.shape[-1]
    d = 1
    while d < t:
        bx = torch.cat([bx[..., :d], av[..., d:] * bx[..., :-d] + bx[..., d:]], -1)
        av = torch.cat([av[..., :d], av[..., d:] * av[..., :-d]], -1)
        d *= 2
    return bx


def iir_first_order_pallas(
    x: torch.Tensor,
    a: float,
    b: float = 1.0,
    *,
    tile_rows: int | None = None,
    kernel: str = "scalar",
    row_pass: str = "bcast",
) -> torch.Tensor:
    """y[t] = a*y[t-1] + b*x[t] by B10 (``kernel='scalar'``) or B11 (``kernel='tile'``).

    ``row_pass='compact'`` is a TPU relayout of B10 with no meaning on
    Hopper: validated as the reference does, then B10 runs. B11 takes
    ``row_pass='bcast'`` only, as the reference's ``kernel='tile'`` does.
    """
    if kernel == "scalar":
        if row_pass not in ("bcast", "compact"):
            raise ValueError(f"unknown row_pass {row_pass!r}; options ('bcast', 'compact')")
        if row_pass == "compact" and tile_rows is not None and tile_rows % 128 != 0:
            raise ValueError(f"row_pass='compact' needs tile_rows % 128 == 0, got {tile_rows}")
        scan = iir1_block_scan
    elif kernel == "tile":
        if row_pass != "bcast":
            raise ValueError("kernel='tile' supports row_pass='bcast' only")
        scan = iir1_affine_scan
    else:
        raise ValueError(f"unknown kernel {kernel!r}; options ('tile', 'scalar')")
    x2, batch = _planar(x)
    y = scan(x2, float(a), float(b), tile_rows=tile_rows)
    return y.reshape(batch + (x2.shape[1],))


def sosfilt(sos, x: torch.Tensor, *, method: str = "auto") -> torch.Tensor:
    """Cascade of second-order sections over the last axis, zero initial state.

    ``auto`` takes B12 (``pallas_fused``) from PALLAS_IIR_MIN_T samples, else
    the plain version (``xla_scan``); ``pallas`` is B15, one section a launch.
    """
    if method == "auto":
        method = "xla_scan" if x.shape[-1] < PALLAS_IIR_MIN_T else "pallas_fused"
    record_choice("sosfilt", method)
    if method == "pallas_fused":
        return sosfilt_pallas_fused(sos, x)
    if method == "pallas":
        return sosfilt_pallas(sos, x)
    if method != "xla_scan":
        raise ValueError(
            f"unknown method {method!r}; options ('auto', 'pallas_fused', 'pallas', 'xla_scan')"
        )
    return _sosfilt_xla(sos, x)


def _sosfilt_xla(sos, x: torch.Tensor) -> torch.Tensor:
    x2, batch = _planar(x)
    return _sos_plain(x2, _sos_rows(sos), None)[0].reshape(batch + (x2.shape[1],))


def sosfilt_init(sos, batch_shape=(), *, device="cuda") -> torch.Tensor:
    """Zero streaming state for :func:`sosfilt_chunk`: (n_sections, *batch, 2) on ``device``."""
    n = _sos_rows(sos).shape[0]
    return torch.zeros(
        (n,) + tuple(batch_shape) + (2,), dtype=torch.float32, device=resolve_device(device)
    )


def sos_state_from_jax(state, *, device="cuda") -> torch.Tensor:
    """A state of the reference's ``sosfilt_init``/``sosfilt_chunk``, carried over.

    ``state`` is ``np.asarray`` of the reference's (n_sections, *batch, 2)
    float32 array; the stream continues here from the same per-section state.
    """
    st = np.asarray(state)
    if st.dtype != np.float32 or st.ndim < 2 or st.shape[-1] != 2:
        raise ValueError(f"expected a float32 (n_sections, ..., 2) state, got {st.dtype} {st.shape}")
    return torch.from_numpy(st.copy()).to(resolve_device(device))


def sosfilt_chunk(
    state: torch.Tensor, sos, x: torch.Tensor, *, method: str = "auto"
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the SOS cascade with carried per-section state: (new state, y).

    Chunked output is one-shot :func:`sosfilt` of the concatenated stream up
    to float32 rounding. ``auto``: B12 seeded from PALLAS_IIR_MIN_T samples.
    """
    if method == "auto":
        method = "pallas_fused" if x.shape[-1] >= PALLAS_IIR_MIN_T else "xla_scan"
    record_choice("sosfilt_chunk", method)
    if method == "pallas_fused":
        return sosfilt_chunk_pallas_fused(state, sos, x)
    if method == "pallas":
        return sosfilt_chunk_pallas(state, sos, x)
    if method != "xla_scan":
        raise ValueError(
            f"unknown method {method!r}; options ('auto', 'pallas_fused', 'pallas', 'xla_scan')"
        )
    return _sosfilt_chunk_xla(state, sos, x)


def _chunk_call(fn, state, sos, x, **kw):
    rows = _sos_rows(sos)
    x2, batch = _planar(x)
    st = _state_planar(state, rows.shape[0], x2.shape[0])
    y, end = fn(x2, rows, st, **kw)
    return end.reshape(tuple(state.shape)), y.reshape(batch + (x2.shape[1],))


def _sosfilt_chunk_xla(state, sos, x):
    return _chunk_call(_sos_plain, state, sos, x)


def sosfilt_pallas(sos, x: torch.Tensor, *, tile_rows: int | None = None) -> torch.Tensor:
    """SOS cascade by B15: one section's block scan a launch, through device memory."""
    x2, batch = _planar(x)
    y, _ = sos_sections(x2, _sos_rows(sos), None, tile_rows=tile_rows)
    return y.reshape(batch + (x2.shape[1],))


def sosfilt_chunk_pallas(
    state: torch.Tensor, sos, x: torch.Tensor, *, tile_rows: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """A streaming chunk by B15, seeded from ``state``: (new state, y).

    The kernel masks the chunk's ragged tail itself and returns the state
    after the chunk's last sample, so no sub-tile tail takes another route.
    """
    return _chunk_call(sos_sections, state, sos, x, tile_rows=tile_rows)


def _fused_checks(lane_pass: str, row_pass: str, tile_rows, unroll_sections: bool) -> None:
    if row_pass not in ("bcast", "compact"):
        raise ValueError(f"unknown row_pass {row_pass!r}; options ('bcast', 'compact')")
    # row_pass='compact' is a TPU relayout of the row scan: validated as the
    # reference does, then the same kernel runs
    if row_pass == "compact" and tile_rows is not None and tile_rows % 128 != 0:
        raise ValueError(f"row_pass='compact' needs tile_rows % 128 == 0, got {tile_rows}")
    if lane_pass not in ("vpu", "mxu"):
        raise ValueError(f"unknown lane_pass {lane_pass!r}; options ('vpu', 'mxu')")
    if lane_pass == "vpu" and unroll_sections and row_pass != "bcast":
        raise ValueError("unroll_sections supports row_pass='bcast' only")


def sosfilt_pallas_fused(
    sos,
    x: torch.Tensor,
    *,
    tile_rows: int | None = None,
    unroll_sections: bool = False,
    lane_pass: str = "vpu",
    row_pass: str = "bcast",
) -> torch.Tensor:
    """SOS cascade by B12, B13 with ``unroll_sections=True``, or B14 with
    ``lane_pass='mxu'`` (which, as the reference, ignores ``unroll_sections``);
    zero initial state.
    """
    _fused_checks(lane_pass, row_pass, tile_rows, unroll_sections)
    x2, batch = _planar(x)
    rows = _sos_rows(sos)
    if lane_pass == "mxu":
        y = sos_cascade_mxu(x2, rows, tile_rows=tile_rows)
    elif unroll_sections:
        y = sos_cascade_unrolled(x2, rows, tile_rows=tile_rows)
    else:
        y, _ = sos_cascade(x2, rows, None, tile_rows=tile_rows)
    return y.reshape(batch + (x2.shape[1],))


def sosfilt_chunk_pallas_fused(
    state: torch.Tensor,
    sos,
    x: torch.Tensor,
    *,
    tile_rows: int | None = None,
    row_pass: str = "bcast",
) -> tuple[torch.Tensor, torch.Tensor]:
    """A streaming chunk by B12 seeded from ``state``: (new state, y).

    The kernel masks the ragged tail itself (see :func:`sosfilt_chunk_pallas`).
    """
    _fused_checks("vpu", row_pass, tile_rows, False)
    return _chunk_call(sos_cascade, state, sos, x, tile_rows=tile_rows)


# --- the scipy-compatible surface -------------------------------------------------


def ba_to_sos(b, a) -> np.ndarray:
    """Transfer-function (b, a) -> second-order sections (scipy tf2sos-like).

    Pairs conjugate (or nearest-real) zeros/poles into biquads, real ones
    together, distributing the overall gain across the sections' numerators.
    A pure delay (leading zeros of b) is kept as right-shifted numerators, as
    scipy.signal.lfilter keeps it. Host-side float64.
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b, a = b / a[0], a / a[0]
    nonzero = np.nonzero(b)[0]
    if nonzero.size == 0:
        # identically-zero numerator: output is zero for any input
        return np.zeros((1, 6), np.float32) + np.array([0, 0, 0, 1, 0, 0], np.float32)
    delay = int(nonzero[0])
    bt = b[delay:]
    gain = bt[0]
    zeros = np.roots(bt) if bt.size > 1 else np.array([], complex)
    poles = np.roots(a) if a.size > 1 else np.array([], complex)
    n_sec = max((max(zeros.size + delay, poles.size) + 1) // 2, 1)
    zeros = np.concatenate([zeros, np.zeros(2 * n_sec - zeros.size)])
    poles = np.concatenate([poles, np.zeros(2 * n_sec - poles.size)])

    def pair(roots):
        # conjugates together; leftover reals paired by magnitude
        cplx = sorted((r for r in roots if r.imag > 1e-12), key=lambda r: abs(r))
        reals = sorted(r.real for r in roots if abs(r.imag) <= 1e-12)
        pairs = [(r, np.conj(r)) for r in cplx]
        pairs += [(reals[i], reals[i + 1]) for i in range(0, len(reals) - 1, 2)]
        if len(reals) % 2:
            pairs.append((reals[-1], 0.0))
        return pairs

    zp, pp = pair(zeros), pair(poles)
    while len(zp) < n_sec:
        zp.append((0.0, 0.0))
    while len(pp) < n_sec:
        pp.append((0.0, 0.0))
    rows = []
    g = abs(gain) ** (1.0 / n_sec) * np.sign(gain)
    for (z1, z2), (p1, p2) in zip(zp, pp):
        bb = np.array([1.0, -(z1 + z2).real, (z1 * z2).real]) * g
        aa = np.array([1.0, -(p1 + p2).real, (p1 * p2).real])
        rows.append(np.concatenate([bb, aa]))
    # distribute the pure delay through the numerators' trailing-zero slots
    remaining = delay
    for row in rows:
        while remaining and row[2] == 0.0:
            row[1], row[2] = row[0], row[1]
            row[0] = 0.0
            remaining -= 1
    assert remaining == 0, "delay slots exhausted (internal invariant)"
    return np.asarray(rows, np.float32)


def lfilter(b, a, x: torch.Tensor, *, method: str = "auto") -> torch.Tensor:
    """scipy.signal.lfilter-compatible filtering over the last axis.

    Pure-FIR coefficients (a reduces to a scalar) go to ``fir_filter`` (a
    (time,) or (channels, time) signal); everything else converts to an SOS
    cascade and runs through :func:`sosfilt`.
    """
    a_np = np.atleast_1d(np.asarray(a, np.float64))
    b_np = np.atleast_1d(np.asarray(b, np.float64))
    if a_np.size == 1:
        from .fir import fir_filter

        return fir_filter(x, (b_np / a_np[0]).astype(np.float32))
    return sosfilt(ba_to_sos(b_np, a_np), x, method=method)


def sosfiltfilt(sos, x: torch.Tensor, *, method: str = "auto") -> torch.Tensor:
    """Zero-phase forward-backward SOS filtering (scipy.signal.sosfiltfilt).

    scipy's edge recipe: odd-reflection padding of 3x the cascade's effective
    order, and each pass seeded with the steady-state :func:`sosfilt_zi`
    scaled by the pass's first sample. Both passes are :func:`sosfilt_chunk`
    calls (B12 seeded at production lengths).
    """
    sos_np = np.asarray(sos.detach().cpu().numpy() if isinstance(sos, torch.Tensor) else sos,
                        np.float64).reshape(-1, 6)
    pad = 3 * (
        2 * sos_np.shape[0]
        + 1
        - min(int((sos_np[:, 2] == 0).sum()), int((sos_np[:, 5] == 0).sum()))
    )
    t = x.shape[-1]
    if t <= pad:
        raise ValueError(f"input of {t} samples is shorter than the edge padding {pad + 1}")
    xf = x.to(torch.float32)
    # odd reflection: 2*x[0] - x[pad..1], signal, 2*x[-1] - x[-2..-pad-1]
    left = 2.0 * xf[..., :1] - torch.flip(xf[..., 1 : pad + 1], [-1])
    right = 2.0 * xf[..., -1:] - torch.flip(xf[..., t - pad - 1 : t - 1], [-1])
    ext = torch.cat([left, xf, right], dim=-1)
    zi = torch.from_numpy(sosfilt_zi(sos_np).astype(np.float32)).to(x.device)  # (n, 2)
    batch = ext.shape[:-1]
    zi_b = zi.reshape((zi.shape[0],) + (1,) * len(batch) + (2,))
    _, y = sosfilt_chunk(zi_b * ext[None, ..., :1], sos_np, ext, method=method)
    _, y = sosfilt_chunk(zi_b * y[None, ..., -1:], sos_np, torch.flip(y, [-1]), method=method)
    return torch.flip(y, [-1])[..., pad : pad + t]


def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state initial conditions for :func:`lfilter` (scipy semantics).

    Solves ``(I - A^T) zi = b[1:] - a[1:] b[0]`` for the DF2T companion-form
    state. Host-side float64.
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b, a = b / a[0], a / a[0]
    n = max(len(a), len(b))
    if n < 2:
        return np.zeros(0)
    a = np.concatenate([a, np.zeros(n - len(a))])
    b = np.concatenate([b, np.zeros(n - len(b))])
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - A, B)


def sosfilt_zi(sos) -> np.ndarray:
    """Steady-state per-section initial conditions for :func:`sosfilt`, (n_sections, 2)."""
    sos_np = np.asarray(sos, np.float64).reshape(-1, 6)
    zi = np.zeros((sos_np.shape[0], 2))
    scale = 1.0
    for i, row in enumerate(sos_np):
        zi[i] = scale * lfilter_zi(row[:3], row[3:])
        scale *= row[:3].sum() / row[3:].sum()  # section DC gain
    return zi


def decimate_iir(
    x: torch.Tensor,
    factor: int,
    *,
    order: int = 8,
    ripple_db: float = 0.05,
    method: str = "auto",
) -> torch.Tensor:
    """IIR decimation, scipy.signal.decimate(ftype='iir')-style.

    An order-``order`` Chebyshev type I lowpass at 0.8/factor Nyquist applied
    with :func:`sosfiltfilt` (zero phase), then every ``factor``-th sample.
    """
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if factor == 1:
        return x.to(torch.float32)
    sos = design_chebyshev1(order, ripple_db, 0.8 / factor)
    return sosfiltfilt(sos, x, method=method)[..., ::factor].contiguous()


def filtfilt(b, a, x: torch.Tensor, *, method: str = "auto") -> torch.Tensor:
    """Zero-phase forward-backward (b, a) filtering: :func:`sosfiltfilt` of :func:`ba_to_sos`."""
    return sosfiltfilt(ba_to_sos(b, a), x, method=method)


def freqz(b, a=1.0, worN: int = 512):
    """(w, H) frequency response of a (b, a) filter on scipy's one-sided grid."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    w = np.linspace(0, np.pi, worN, endpoint=False)
    z = np.exp(-1j * w)
    return w, np.polyval(b[::-1], z) / np.polyval(a[::-1], z)


def sosfreqz(sos, worN: int = 512):
    """(w, H) frequency response of an SOS cascade (scipy.signal.sosfreqz)."""
    sos_np = np.asarray(sos, np.float64).reshape(-1, 6)
    w = np.linspace(0, np.pi, worN, endpoint=False)
    h = np.ones_like(w, dtype=complex)
    for row in sos_np:
        h *= freqz(row[:3], row[3:], worN)[1]
    return w, h


def group_delay(b, a=1.0, worN: int = 512):
    """(w, gd) group delay in samples (Shpak's method, scipy.signal.group_delay's grid)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    c = np.convolve(b, a[::-1])
    cr = c * np.arange(c.size)
    w = np.linspace(0, np.pi, worN, endpoint=False)
    z = np.exp(-1j * w)
    den = np.polyval(c[::-1], z)
    num = np.polyval(cr[::-1], z)
    small = np.abs(den) < 1e-12
    gd = np.where(small, 0.0, np.real(num / np.where(small, 1.0, den)) - (a.size - 1))
    return w, gd


def sos_group_delay(sos, worN: int = 512):
    """(w, gd) group delay of an SOS cascade: the sum of the sections' delays."""
    sos_np = np.asarray(sos, np.float64).reshape(-1, 6)
    w = np.linspace(0, np.pi, worN, endpoint=False)
    gd = np.zeros_like(w)
    for row in sos_np:
        gd += group_delay(row[:3], row[3:], worN)[1]
    return w, gd


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """DF2T initial state from past outputs ``y`` and inputs ``x``, most recent
    first (scipy.signal.lfiltic)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    n = max(a.size, b.size) - 1
    if a[0] != 1.0:
        if a[0] == 0.0:
            raise ValueError("a[0] must be nonzero")
        b, a = b / a[0], a / a[0]
    y = np.asarray(y, np.float64)
    x = np.zeros(0) if x is None else np.asarray(x, np.float64)
    y = np.concatenate([y, np.zeros(max(0, n - y.size))])[:n]
    x = np.concatenate([x, np.zeros(max(0, n - x.size))])[:n]
    bp = np.concatenate([b, np.zeros(max(0, n + 1 - b.size))])
    ap = np.concatenate([a, np.zeros(max(0, n + 1 - a.size))])
    zi = np.zeros(n)
    for m in range(n, 0, -1):
        acc = 0.0
        for j in range(m, n + 1):
            acc += bp[j] * x[j - m] - ap[j] * y[j - m]
        zi[m - 1] = acc
    return zi


# --- time-varying second-order sections --------------------------------------------
#
# Coefficients that change along the stream (LPC synthesis, the tracking
# notch, automated filters), the standard time-varying DF2T with every row
# divided by its own a0:
#     y[t]  = b0[t] x[t] + s1[t-1]
#     s1[t] = b1[t] x[t] - a1[t] y[t] + s2[t-1]
#     s2[t] = b2[t] x[t] - a2[t] y[t]
# Inside the port rows are a (S, Cc, F, 6) float32 tensor on the signal's
# device: Cc = 1 for rows shared by the C channels (the kernels read them with
# a channel stride of 0; they are never copied a channel), or Cc = C; F = T
# rows, one a sample, or one a frame of ``frame_len`` samples.
#
# Kernels (csrc/iir_tv.cu, three launches each: every tile's zero-state end
# state and 2S x 2S transition, a float64 chain of those a channel, a seeded
# re-run; see the source note):
#
# - :func:`tv_cascade`         B16, every section a tile (``sosfilt_tv`` auto
#   for S > 1, ``sosfilt_tv_fused``, the ``expand`` route of the frames);
# - :func:`tv_section`         B17, one section, seeded or not
#   (``method="scan"``, one launch a section; ``sosfilt_tv_chunk``);
# - :func:`tv_frames_cascade`  B18, every section with a row a frame
#   (``sosfilt_tv_frames``, its chunk call, the factored LPC engine, the
#   tracking notch).
#
# ``tile_rows`` (rows of 128 samples) keeps the reference's meaning only for
# routes and refusals: the frames envelope, ``method="frames"``'s ValueError,
# the ``row_pass`` checks and the frames chunk call's route. The kernels' own
# tile is :func:`pick_tile`'s, and they take any T seeded: a chunk call runs
# its whole chunk through its kernel, where the reference splits off a
# sub-tile tail for its XLA sample scan.

MAX_TV_GROUP = 16  # sections a pass of B16/B18: 2S state lanes of launch 2's warp
TV_SEG = 8  # csrc/iir_tv.cu: consecutive samples a thread; a sub-tile is THREADS * TV_SEG
TV_SPAN = 32 * TV_SEG  # a warp's samples: B18 scans the state alone where frames hold whole spans
# csrc/iir_tv.cu's tile kernels by kind, as dsp_tv_cascade and dsp_tv_attrs number them
TV_KINDS = ("B16 rows", "B17 rows", "B18 compose", "B18 state")


def tv_frames_route(frame_len: int) -> str:
    """B18's route at ``frame_len``: ``state`` where every warp's TV_SPAN samples
    lie in one frame (a multiple of TV_SPAN: each section is time-invariant
    across a warp, which scans the state alone with powers of its Phi), else
    ``compose`` (every lane composes its own map)."""
    return "state" if frame_len % TV_SPAN == 0 else "compose"


def tv_kernel_attrs(sections: int, shared: bool = True) -> dict:
    """What the compiler gave each tile kernel of csrc/iir_tv.cu, and its blocks at
    ``sections`` sections of rows ``shared`` by the channels or not (the card only):
    {kind: (registers a thread, local bytes a thread, shared bytes a block,
    blocks an SM, columns a block)}."""
    lib = _build.library()
    out = (ctypes.c_int64 * 5)()
    attrs = {}
    for kind, name in enumerate(TV_KINDS):
        s = 1 if kind == 1 else sections
        _build.check(lib.dsp_tv_attrs(kind, s, 1 if shared else 2, ctypes.addressof(out)),
                     "tv_kernel_attrs")
        attrs[name] = tuple(out)
    return attrs


def _coef(v, device) -> torch.Tensor:
    """Coefficients (a tensor, an array or a number) as float32 on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v, np.float32))).to(device)


def _tv_rows(sos, batch: tuple, device, n: int | None = None, what: str = "sos_t"):
    """``(n, 6)``, ``(S, n, 6)`` or ``(S, *batch, n, 6)`` rows -> (S, Cc, F, 6).

    ``n``: the rows a per-sample schedule must have; None for frames.
    """
    r = _coef(sos, device)
    if r.dim() == 2:
        r = r[None]
    if r.dim() < 3 or r.shape[-1] != 6 or (n is not None and r.shape[-2] != n):
        want = "n" if n is None else f"n={n}"
        raise ValueError(f"{what} must end in ({want}, 6), got {tuple(r.shape[-2:])}")
    s, f = r.shape[0], r.shape[-2]
    mid = tuple(r.shape[1:-2])
    if mid == ():
        return r.reshape(s, 1, f, 6).contiguous()
    nch = int(np.prod(batch)) if batch else 1
    r = r.reshape(s, -1, f, 6)
    if r.shape[1] != nch:
        raise ValueError(f"{what} batch dims {mid} do not match signal batch {batch}")
    return r.contiguous()


def _tv_planes(rows4: torch.Tensor, frame_len: int, t0: int, t1: int) -> torch.Tensor:
    """The rows of samples [t0, t1) divided by their a0: (S, Cc, t1 - t0, 5) b0 b1 b2 a1 a2.

    As the kernels divide: one reciprocal of a0 a row, then five products.
    """
    f0 = t0 // frame_len
    r = rows4[:, :, f0 : cdiv(t1, frame_len)]
    p = torch.cat([r[..., 0:3], r[..., 4:6]], -1) * (1.0 / r[..., 3:4])
    if frame_len > 1:
        off = t0 - f0 * frame_len
        p = p.repeat_interleave(frame_len, dim=2)[:, :, off : off + t1 - t0]
    return p


def _tv_run(xt, pt, states, yt=None, snap_at: int = -1):
    """The time-varying cascade over the rows of ``xt`` (tile, N, nt), or zero
    input when None; ``pt``: (tile, S, Cc, nt, 5) planes; states[k] = (s1, s2).

    Writes each sample's output to ``yt`` when given; returns the states after
    the last row and, at row ``snap_at``, the last tile's states.
    """
    zero = pt.new_zeros(())
    snap = None
    for j in range(pt.shape[0]):
        u = zero if xt is None else xt[j]
        for k in range(len(states)):
            b0, b1, b2, a1, a2 = pt[j, k].unbind(-1)
            s1, s2 = states[k]
            yk = b0 * u + s1
            states[k] = (b1 * u - a1 * yk + s2, b2 * u - a2 * yk)
            u = yk
        if yt is not None:
            yt[j] = u
        if j == snap_at:
            snap = [(s1[:, -1].clone(), s2[:, -1].clone()) for s1, s2 in states]
    return states, snap


def _tv_scan(m: torch.Tensor, z: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """States entering the tiles, float64: s_0 = s0, s_{t+1} = M_t s_t + z_t.

    m: (1 or C, nt, D, D) the tiles' transitions; z: (C, nt, D) their
    zero-state end states; s0: (C, D). A Hillis-Steele scan over the tiles in
    place of the kernels' walk of one warp a channel.
    """
    mm, zz = m[:, :-1], z[:, :-1]
    d = 1
    while d < mm.shape[1]:
        zz = torch.cat([zz[:, :d], (mm[:, d:] @ zz[:, :-d, :, None])[..., 0] + zz[:, d:]], 1)
        mm = torch.cat([mm[:, :d], mm[:, d:] @ mm[:, :-d]], 1)
        d *= 2
    incl = (mm @ s0[:, None, :, None])[..., 0] + zz
    return torch.cat([s0[:, None], incl], 1)


def _tv_plain(x2: torch.Tensor, rows4: torch.Tensor, frame_len: int,
              state: torch.Tensor | None):
    """Plain version of B16/B18 (and B17 at S = 1): (C, T) -> (y, end state (S, C, 2)).

    The kernels' three steps in PyTorch over tiles of PLAIN_TILE samples:
    each tile's zero-state end state and its transition (the zero-input
    cascade from the 2S unit states), the float64 chain of those, and the
    seeded run. A float64 ``x2`` runs the recurrence in float64 on the same
    float32 rows: the float64 reference of the kernels.
    """
    c, t = x2.shape
    s, cc = rows4.shape[:2]
    if state is None:
        state = x2.new_zeros((s, c, 2))
    if t == 0:
        return x2.new_zeros((c, 0)), state.clone()
    tile = min(PLAIN_TILE, t)
    nt = cdiv(t, tile)
    d = 2 * s
    planes = F.pad(_tv_planes(rows4, frame_len, 0, t), (0, 0, 0, nt * tile - t))
    pt = planes.view(s, cc, nt, tile, 5).permute(3, 0, 1, 2, 4)
    xt = _tiles(x2, tile)
    # 1. each tile from zero state, and from each unit state with zero input
    zero = x2.new_zeros((c, nt))
    ends, _ = _tv_run(xt, pt, [(zero, zero)] * s)
    z = torch.stack([v for pair in ends for v in pair], -1).double()  # (C, nt, D)
    eye = torch.eye(d, dtype=x2.dtype, device=x2.device)[:, :, None, None].expand(d, d, cc, nt)
    cols, _ = _tv_run(None, pt, [(eye[:, 2 * k], eye[:, 2 * k + 1]) for k in range(s)])
    m = torch.stack([v for pair in cols for v in pair], 1)  # (D col, D row, Cc, nt)
    m = m.permute(2, 3, 1, 0).double()
    # 2. the state entering each tile
    s0 = state.permute(1, 0, 2).reshape(c, d).double()
    starts = _tv_scan(m, z, s0).to(x2.dtype)
    # 3. each tile from its state, and the state after sample t-1
    yt = torch.empty_like(xt)
    _, snap = _tv_run(
        xt, pt, [(starts[..., 2 * k], starts[..., 2 * k + 1]) for k in range(s)], yt,
        (t - 1) % tile,
    )
    new_state = torch.stack([torch.stack(pair, dim=-1) for pair in snap])
    return _untiles(yt, t), new_state


def _tv_check(x2, rows4, state, frame_len: int, name: str, tile_rows) -> torch.Tensor:
    """Validate a TV kernel call; return the rows as the kernel reads them."""
    if not isinstance(rows4, torch.Tensor) or rows4.dim() != 4 or rows4.shape[-1] != 6:
        raise ValueError(f"{name}: rows must be a (S, Cc, F, 6) tensor")
    s, cc, f = rows4.shape[:3]
    if s < 1:
        raise ValueError(f"{name}: needs at least one section")
    _check(x2, state, s, name, tile_rows)
    if rows4.dtype != torch.float32 or rows4.device != x2.device:
        raise ValueError(f"{name}: rows must be float32 on {x2.device}, got {rows4.dtype} "
                         f"on {rows4.device}")
    if cc not in (1, x2.shape[0]):
        raise ValueError(f"{name}: rows for {cc} channels, x has {x2.shape[0]}")
    if frame_len < 1 or f * frame_len < x2.shape[1]:
        raise ValueError(f"{name}: {f} rows x {frame_len} samples < {x2.shape[1]} samples")
    if x2.device.type == "cuda":
        rows4 = rows4.contiguous()
        if rows4.data_ptr() % 8:
            rows4 = rows4.clone()
    return rows4


def _launch_tv(kind: int, x2, rows4, frame_len, state, tile_rows):
    c, t = x2.shape
    if kind == 2 and tv_frames_route(frame_len) == "state":
        kind = 3
    s, cc, f = rows4.shape[:3]
    y = torch.empty_like(x2)
    new_state = None if state is None else torch.empty_like(state)
    tile = pick_tile(c, t, tile_rows)
    ntiles = cdiv(t, tile)
    d = 2 * min(s, MAX_TV_GROUP)
    carry = torch.empty(c * ntiles * d, dtype=torch.float32, device=x2.device)
    trans = torch.empty(max(1, cc * (ntiles - 1) * d * d), dtype=torch.float32, device=x2.device)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = lib.dsp_tv_cascade(
            x2.data_ptr(), y.data_ptr(), rows4.data_ptr(), cc * f * 6, f * 6 if cc > 1 else 0,
            frame_len, carry.data_ptr(), trans.data_ptr(),
            None if state is None else state.data_ptr(),
            None if new_state is None else new_state.data_ptr(),
            t, c, cc, s, tile, kind, _stream(x2),
        )
    _build.check(err, ("tv_cascade", "tv_section", "tv_frames_cascade", "tv_frames_cascade")[kind])
    return y, new_state


def _tv_kernel(kind: int, fn, x2, rows4, frame_len, state, tile_rows):
    rows4 = _tv_check(x2, rows4, state, frame_len, fn.__name__, tile_rows)
    if not _on_cuda(x2):
        y, end = _tv_plain(x2, rows4, frame_len, state)
        return y, None if state is None else end
    refuse_grad(f"{fn.__name__} (B{16 + kind})", x2, rows4, state)
    if x2.shape[1] == 0:
        return torch.empty_like(x2), None if state is None else state.clone()
    y, end = _launch_tv(kind, x2, rows4, frame_len, state, tile_rows)
    fn.launches += 1
    if kind == 2:
        tv_frames_cascade.route = tv_frames_route(frame_len)
    return y, end


def tv_cascade(x2: torch.Tensor, rows4: torch.Tensor, state: torch.Tensor | None = None, *,
               tile_rows: int | None = None):
    """Every time-varying section over (C, T) float32 by B16: (y, end state or None).

    ``rows4``: (S, Cc, T, 6) per-sample rows, any S (groups of MAX_TV_GROUP
    sections through device memory). ``state``: the (S, C, 2) state entering
    the chunk; the end state comes back only for a seeded call.
    """
    return _tv_kernel(0, tv_cascade, x2, rows4, 1, state, tile_rows)


tv_cascade.launches = 0


def tv_section(x2: torch.Tensor, rows4: torch.Tensor, state: torch.Tensor | None = None, *,
               tile_rows: int | None = None):
    """One time-varying section over (C, T) float32 by B17: (y, end state or None)."""
    if isinstance(rows4, torch.Tensor) and rows4.dim() == 4 and rows4.shape[0] != 1:
        raise ValueError(f"tv_section (B17) runs one section, got {rows4.shape[0]}")
    return _tv_kernel(1, tv_section, x2, rows4, 1, state, tile_rows)


tv_section.launches = 0


def tv_frames_cascade(x2: torch.Tensor, rows4: torch.Tensor, frame_len: int,
                      state: torch.Tensor | None = None, *, tile_rows: int | None = None):
    """Every time-varying section by B18, a row a frame: (y, end state or None).

    ``rows4``: (S, Cc, F, 6), frame f governing samples [f frame_len,
    (f+1) frame_len); any ``frame_len``, F * frame_len >= T. The route
    (:func:`tv_frames_route`) of the last launch is left in
    ``tv_frames_cascade.route``.
    """
    return _tv_kernel(2, tv_frames_cascade, x2, rows4, int(frame_len), state, tile_rows)


tv_frames_cascade.launches = 0
tv_frames_cascade.route = None


def sosfilt_tv(sos_t, x: torch.Tensor, *, tile_rows: int = 256,
               method: str = "auto") -> torch.Tensor:
    """Time-varying SOS cascade over the last axis, zero initial state.

    ``sos_t``: per-sample scipy-layout rows ``(S, n, 6)`` (shared across
    channels), ``(n, 6)`` (one section) or ``(S, *batch, n, 6)``; ``a0`` may
    vary and is divided out per sample. ``method``: ``auto`` runs the fused
    cascade (B16, :func:`sosfilt_tv_fused`) for more than one section, else
    ``scan``, B17 launched once a section with the signal through device
    memory (the reference's A/B anchor).
    """
    if method not in ("auto", "fused", "scan"):
        raise ValueError(f"unknown method {method!r}")
    nsec = 1 if np.ndim(sos_t) == 2 else np.shape(sos_t)[0]
    if method == "fused" or (method == "auto" and nsec > 1):
        record_choice("sosfilt_tv", "fused")
        return sosfilt_tv_fused(sos_t, x, tile_rows=tile_rows)
    record_choice("sosfilt_tv", "scan")
    x2, batch = _planar(x)
    rows4 = _tv_rows(sos_t, batch, x2.device, x2.shape[1])
    for k in range(rows4.shape[0]):
        x2, _ = tv_section(x2, rows4[k : k + 1])
    return x2.reshape(batch + (x2.shape[1],))


def _tv_frames_envelope_ok(frame_len: int, tile_rows: int) -> bool:
    """Whether the reference's frame-aware kernel takes this (frame_len, tile_rows).

    Whole 128-lane rows a frame, frame and tile boundaries nesting, and
    tile_rows within the compact row pass's bounds. B18 takes any frame_len;
    the rule stays the reference's because it decides the route.
    """
    if frame_len % 128 != 0 or tile_rows % 128 != 0:
        return False
    if not (128 <= tile_rows <= 16384):
        return False
    fl_rows = frame_len // 128
    return tile_rows % fl_rows == 0 or fl_rows % tile_rows == 0


def _frame_rows(sos_frames, x: torch.Tensor, frame_len: int, what: str = "sos_frames"):
    """(planar x, batch, (S, Cc, F, 6) rows), refusing a schedule shorter than x."""
    x2, batch = _planar(x)
    rows4 = _tv_rows(sos_frames, batch, x2.device, None, what)
    n, nf = x2.shape[1], rows4.shape[2]
    if nf * frame_len < n:
        raise ValueError(f"{nf} frames x {frame_len} < signal length {n}")
    return x2, batch, rows4


def sosfilt_tv_frames(sos_frames, x: torch.Tensor, frame_len: int, *, tile_rows: int = 256,
                      method: str = "auto", row_pass: str = "compact") -> torch.Tensor:
    """Step-wise time-varying SOS: one coefficient row a frame.

    ``sos_frames``: ``(S, n_frames, 6)``, ``(n_frames, 6)`` or ``(S, *batch,
    n_frames, 6)``; frame f governs samples [f frame_len, (f+1) frame_len).
    ``method``: ``frames`` runs B18, which reads a sample's row by its frame
    index (the reference's envelope, :func:`_tv_frames_envelope_ok`, decides
    the route and the refusal); ``expand`` materializes per-sample rows and
    runs :func:`sosfilt_tv`; ``auto`` is frames inside the envelope, else
    expand. ``row_pass`` is a TPU relayout of the row-level composition with
    no meaning here (the reference does not check it either).
    """
    x2, batch, rows4 = _frame_rows(sos_frames, x, frame_len)
    n = x2.shape[1]
    if method not in ("auto", "frames", "expand"):
        raise ValueError(f"unknown method {method!r}")
    frames_ok = _tv_frames_envelope_ok(frame_len, tile_rows)
    if method == "frames" and not frames_ok:
        raise ValueError(
            f"method='frames' needs frame_len % 128 == 0 and frame/tile "
            f"nesting; got frame_len={frame_len}, tile_rows={tile_rows}"
        )
    if method == "auto":
        method = "frames" if frames_ok else "expand"
    record_choice("sosfilt_tv_frames", method)
    if method == "frames":
        y, _ = tv_frames_cascade(x2, rows4, frame_len)
        return y.reshape(batch + (n,))
    expanded = rows4.repeat_interleave(frame_len, dim=2)[:, :, :n]
    shared = rows4.shape[1] == 1
    expanded = expanded[:, 0] if shared else expanded.reshape((rows4.shape[0],) + batch + (n, 6))
    return sosfilt_tv(expanded, x2.reshape(batch + (n,)), tile_rows=tile_rows)


def sosfilt_tv_frames_chunk(state: torch.Tensor, sos_frames, x: torch.Tensor, frame_len: int, *,
                            tile_rows: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming frame-wise TV SOS chunk: (new state, y), the state contract of
    :func:`sosfilt_chunk` (``(S, *batch, 2)``).

    Chunks start on frame boundaries: ``sos_frames`` covers this chunk from
    its first sample. Inside the reference's frames envelope the whole chunk,
    of any length, runs B18 seeded; outside it the rows are expanded and the
    chunk goes to :func:`sosfilt_tv_chunk`'s route, as in the reference.
    """
    x2, batch, rows4 = _frame_rows(sos_frames, x, frame_len)
    n = x2.shape[1]
    if not _tv_frames_envelope_ok(frame_len, tile_rows):
        expanded = rows4.repeat_interleave(frame_len, dim=2)[:, :, :n]
        return _tv_chunk(state, expanded, x2, batch)
    st = _state_planar(state, rows4.shape[0], x2.shape[0])
    y, end = tv_frames_cascade(x2, rows4, frame_len, st)
    return end.reshape(tuple(state.shape)), y.reshape(batch + (n,))


def _tv_chunk(state, rows4, x2, batch):
    """The chunk of :func:`sosfilt_tv_chunk` on planar x and (S, Cc, n, 6) rows:
    B17 seeded a section a launch, the signal through device memory."""
    st = _state_planar(state, rows4.shape[0], x2.shape[0])
    y, ends = x2, []
    for k in range(rows4.shape[0]):
        y, e = tv_section(y, rows4[k : k + 1], st[k : k + 1].contiguous())
        ends.append(e)
    return torch.cat(ends).reshape(tuple(state.shape)), y.reshape(batch + (x2.shape[1],))


def sosfilt_tv_chunk(state: torch.Tensor, sos_t, x: torch.Tensor, *,
                     tile_rows: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming time-varying SOS chunk: (new state, y), the state contract of
    :func:`sosfilt_chunk` (``(S, *batch, 2)``).

    The whole chunk, of any length, runs B17 seeded, a section a launch. The
    reference splits off a sub-tile tail for its XLA sample scan because its
    kernel takes whole tiles; B17 takes any length, so ``tile_rows`` changes
    nothing here.
    """
    x2, batch = _planar(x)
    rows4 = _tv_rows(sos_t, batch, x2.device, x2.shape[1])
    return _tv_chunk(state, rows4, x2, batch)


def sosfilt_tv_fused(sos_t, x: torch.Tensor, *, tile_rows: int = 256,
                     row_pass: str | None = None) -> torch.Tensor:
    """Fused-cascade spelling of :func:`sosfilt_tv` (B16, every section a tile).

    ``row_pass`` is a TPU relayout of the row-level composition with no
    meaning here: validated as the reference does, then B16 runs.
    """
    compact_ok = tile_rows % 128 == 0 and 128 <= tile_rows <= 16384
    if row_pass is None:
        row_pass = "compact" if compact_ok else "bcast"
    if row_pass == "compact" and not compact_ok:
        raise ValueError(
            "row_pass='compact' needs tile_rows % 128 == 0 and "
            f"128 <= tile_rows <= 16384, got {tile_rows}"
        )
    x2, batch = _planar(x)
    y, _ = tv_cascade(x2, _tv_rows(sos_t, batch, x2.device, x2.shape[1]))
    return y.reshape(batch + (x2.shape[1],))


# --- designers (host NumPy, copied from the reference) -----------------------------


def design_biquad_lowpass(cutoff: float, q: float = 0.7071) -> np.ndarray:
    """RBJ cookbook lowpass biquad; cutoff in (0, 1) Nyquist; one SOS row (1, 6)."""
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0,1) of Nyquist, got {cutoff}")
    w0 = np.pi * cutoff
    alpha = np.sin(w0) / (2 * q)
    cw = np.cos(w0)
    b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return np.concatenate([b / a[0], a / a[0]]).astype(np.float32)[None, :]


def design_biquad_highpass(cutoff: float, q: float = 0.7071) -> np.ndarray:
    """RBJ cookbook highpass biquad; one SOS row (1, 6)."""
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0,1) of Nyquist, got {cutoff}")
    w0 = np.pi * cutoff
    alpha = np.sin(w0) / (2 * q)
    cw = np.cos(w0)
    b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return np.concatenate([b / a[0], a / a[0]]).astype(np.float32)[None, :]


def design_biquad_bandpass(center: float, q: float = 1.0) -> np.ndarray:
    """RBJ cookbook constant-peak bandpass biquad (gain 1 at ``center``)."""
    if not 0.0 < center < 1.0:
        raise ValueError(f"center must be in (0,1) of Nyquist, got {center}")
    w0 = np.pi * center
    alpha = np.sin(w0) / (2 * q)
    cw = np.cos(w0)
    b = np.array([alpha, 0.0, -alpha])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return np.concatenate([b / a[0], a / a[0]]).astype(np.float32)[None, :]


def _pair_poles(z_poles: np.ndarray) -> list[np.ndarray]:
    """Group digital poles into conjugate (or real-real) biquad pairs."""
    eps = 1e-9
    cplx = [p for p in z_poles if p.imag > eps]
    reals = sorted(p.real for p in z_poles if abs(p.imag) <= eps)
    pairs = [np.array([p, np.conj(p)]) for p in cplx]
    for i in range(0, len(reals) - 1, 2):
        pairs.append(np.array([reals[i], reals[i + 1]], dtype=complex))
    if len(reals) % 2:  # lone real pole -> first-order section
        pairs.append(np.array([reals[-1], 0.0], dtype=complex))
    return pairs


def design_butterworth_band(
    order: int, low: float, high: float, btype: str = "bandpass"
) -> np.ndarray:
    """Butterworth bandpass/bandstop as an SOS cascade (scipy layout), digital order 2*order."""
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if not 0.0 < low < high < 1.0:
        raise ValueError(f"need 0 < low < high < 1 (Nyquist), got {low}, {high}")
    if btype not in ("bandpass", "bandstop"):
        raise ValueError(f"btype must be bandpass or bandstop, got {btype!r}")
    w1, w2 = np.tan(np.pi * low / 2), np.tan(np.pi * high / 2)
    w0 = np.sqrt(w1 * w2)
    bw = w2 - w1
    k = np.arange(order)
    proto = np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))  # Re < 0
    s_poles = []
    for p in proto:
        b = bw * p / 2.0 if btype == "bandpass" else bw / (2.0 * p)
        disc = np.sqrt(b**2 - w0**2 + 0j)
        s_poles += [b + disc, b - disc]
    z_poles = np.array([(1 + s) / (1 - s) for s in s_poles])
    if btype == "bandpass":
        sec_b = np.array([1.0, 0.0, -1.0])  # zeros at z = +1 and z = -1
        ref = np.exp(2j * np.arctan(w0))  # unity at the warped analog center
    else:
        zc = (1 + 1j * w0) / (1 - 1j * w0)  # zeros at the notch frequency
        sec_b = np.array([1.0, -2.0 * zc.real, 1.0])
        ref = 1.0 + 0.0j  # unity at DC
    rows = []
    gain = 1.0
    for pp in _pair_poles(z_poles):
        a = np.array([1.0, -(pp[0] + pp[1]).real, (pp[0] * pp[1]).real])
        num = sec_b[0] * ref**2 + sec_b[1] * ref + sec_b[2]
        den = ref**2 + a[1] * ref + a[2]
        gain *= abs(den / num)
        rows.append(np.concatenate([sec_b.copy(), a]))
    rows = np.asarray(rows, dtype=np.float64)
    rows[:, :3] *= gain ** (1.0 / len(rows))  # distribute gain evenly
    return rows.astype(np.float32)


def design_butterworth(order: int, cutoff: float, btype: str = "lowpass") -> np.ndarray:
    """Butterworth digital filter as an SOS cascade (scipy layout, (n, 6))."""
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0,1) of Nyquist, got {cutoff}")
    if btype not in ("lowpass", "highpass"):
        raise ValueError(f"btype must be lowpass or highpass, got {btype!r}")
    warped = np.tan(np.pi * cutoff / 2.0)
    k = np.arange(order)
    unit = np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order))  # Re < 0
    s_poles = warped * unit if btype == "lowpass" else warped / unit
    z_poles = (1 + s_poles) / (1 - s_poles)
    zero = -1.0 if btype == "lowpass" else 1.0
    ref = 1.0 if btype == "lowpass" else -1.0  # unity-gain evaluation point
    return _rows_from_poles(z_poles, zero, ref).astype(np.float32)


def _rows_from_poles(z_poles, zero: float, ref: float) -> np.ndarray:
    """Conjugate pole pairs as biquads, real poles as first-order rows, each
    with its zeros at ``zero`` and unity gain at ``ref`` (float64)."""
    upper = [p for p in z_poles if p.imag > 1e-12]
    real = [p.real for p in z_poles if abs(p.imag) <= 1e-12]
    rows = []
    for p in upper:
        a = np.array([1.0, -2 * p.real, abs(p) ** 2])
        b = np.array([1.0, -2 * zero, 1.0])
        g = np.polyval(a, ref) / np.polyval(b, ref)
        rows.append(np.concatenate([b * g, a]))
    for r in real:  # first-order remainder as a degenerate biquad
        a = np.array([1.0, -r, 0.0])
        b = np.array([1.0, -zero, 0.0])
        g = np.polyval(a[:2], ref) / np.polyval(b[:2], ref)
        rows.append(np.concatenate([b * g, a]))
    return np.asarray(rows, np.float64)


def design_chebyshev1(
    order: int, ripple_db: float, cutoff: float, btype: str = "lowpass"
) -> np.ndarray:
    """Chebyshev type-I digital filter as an SOS cascade (scipy layout).

    Passband ripple ``ripple_db`` dB; lowpass and highpass in closed form,
    band types through :func:`.iir_design.iirfilter`.
    """
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if ripple_db <= 0:
        raise ValueError(f"ripple_db must be > 0, got {ripple_db}")
    if btype in ("bandpass", "bandstop"):
        return iirfilter(order, cutoff, btype=btype, ftype="cheby1", rp=ripple_db)
    if not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0,1) of Nyquist, got {cutoff}")
    if btype not in ("lowpass", "highpass"):
        raise ValueError(f"btype must be lowpass or highpass, got {btype!r}")
    eps = np.sqrt(10.0 ** (ripple_db / 10.0) - 1.0)
    mu = np.arcsinh(1.0 / eps) / order
    k = np.arange(order)
    theta = np.pi * (2 * k + 1) / (2 * order)
    proto = -np.sinh(mu) * np.sin(theta) + 1j * np.cosh(mu) * np.cos(theta)
    warped = np.tan(np.pi * cutoff / 2.0)
    s_poles = warped * proto if btype == "lowpass" else warped / proto
    z_poles = (1 + s_poles) / (1 - s_poles)
    sos = _rows_from_poles(
        z_poles, -1.0 if btype == "lowpass" else 1.0, 1.0 if btype == "lowpass" else -1.0
    )
    if order % 2 == 0:
        # even order: gain at the DC/Nyquist reference is 1/sqrt(1+eps^2)
        sos[0, :3] *= 1.0 / np.sqrt(1.0 + eps**2)
    return sos.astype(np.float32)


def design_chebyshev2(
    order: int, atten_db: float, cutoff: float, btype: str = "lowpass"
) -> np.ndarray:
    """Chebyshev type-II SOS cascade (scipy layout): flat passband, equiripple
    stopband at ``-atten_db`` from ``cutoff``; every band type through the zpk
    pipeline (:func:`.iir_design.iirfilter`)."""
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if atten_db <= 0:
        raise ValueError(f"atten_db must be > 0, got {atten_db}")
    if btype not in ("lowpass", "highpass", "bandpass", "bandstop"):
        raise ValueError(f"unknown btype {btype!r}")
    if btype in ("lowpass", "highpass") and not 0.0 < cutoff < 1.0:
        raise ValueError(f"cutoff must be in (0,1) of Nyquist, got {cutoff}")
    return iirfilter(order, cutoff, btype=btype, ftype="cheby2", rs=atten_db)


__all__ = [
    "PALLAS_IIR_MIN_T",
    "pick_tile",
    "section_table",
    "iir1_table",
    "cascade_transition",
    "iir1_block_scan",
    "iir1_affine_scan",
    "mxu_tables",
    "sos_cascade_mxu",
    "sos_cascade",
    "sos_cascade_unrolled",
    "sos_sections",
    "iir_first_order",
    "iir_first_order_pallas",
    "sosfilt",
    "sosfilt_init",
    "sosfilt_chunk",
    "sos_state_from_jax",
    "sosfilt_pallas",
    "sosfilt_chunk_pallas",
    "sosfilt_pallas_fused",
    "sosfilt_chunk_pallas_fused",
    "MAX_TV_GROUP",
    "TV_SPAN",
    "tv_frames_route",
    "tv_kernel_attrs",
    "tv_cascade",
    "tv_section",
    "tv_frames_cascade",
    "sosfilt_tv",
    "sosfilt_tv_fused",
    "sosfilt_tv_chunk",
    "sosfilt_tv_frames",
    "sosfilt_tv_frames_chunk",
    "ba_to_sos",
    "lfilter",
    "sosfiltfilt",
    "lfilter_zi",
    "sosfilt_zi",
    "decimate_iir",
    "filtfilt",
    "freqz",
    "sosfreqz",
    "group_delay",
    "sos_group_delay",
    "lfiltic",
    "design_biquad_lowpass",
    "design_biquad_highpass",
    "design_biquad_bandpass",
    "design_butterworth_band",
    "design_butterworth",
    "design_chebyshev1",
    "design_chebyshev2",
]
