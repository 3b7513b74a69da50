"""LTI system representations, discretization and simulation.

State-space, transfer-function and zpk conversions, continuous-to-discrete
transforms, partial-fraction expansion and frequency responses are host-side
NumPy float64 design functions, as in the reference package
(``digital_signal_processsing_tpu/ops/lti.py``; this module keeps its own
copy). Simulation (``dlsim``, ``dstep``, ``dimpulse``, and through them
``lsim``, ``impulse`` and ``step``) is one launch of the hand recursion
kernel S3 on the card (``csrc/lti.cu``, :func:`dlsim_scan`), where the
reference runs one ``lax.scan`` that keeps the state on the device; a CPU
tensor takes S3's plain version, the per-step loop of matrix-vector products.
For a long stream with a scalar output, SOS (``iir_design.zpk2sos`` and
``iir.sosfilt``) is the throughput spelling.

Input that is not a tensor goes to ``device`` (the card by default). The
LTI classes hold only NumPy matrices.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from .. import _build
from ..utils.device import as_tensor
from ..utils.dispatch import refuse_grad
from .fir import ieee_fp32_matmul
from .pallas_scan import SMEM_MAX, _on_cuda, _stream


# --- representation conversions (scipy.signal.tf2ss etc.) ----------------------


def tf2ss(b, a):
    """Transfer function -> controller-canonical state space
    (scipy.signal.tf2ss)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a[0] == 0:
        raise ValueError("a[0] must be nonzero")
    b = b / a[0]
    a = a / a[0]
    n = a.size - 1
    b = np.concatenate([np.zeros(max(0, a.size - b.size)), b])
    if b.size > a.size:
        raise ValueError("improper transfer function (deg b > deg a)")
    if n == 0:
        return (
            np.zeros((0, 0)),
            np.zeros((0, 1)),
            np.zeros((1, 0)),
            np.atleast_2d(b[0]),
        )
    A = np.vstack([-a[1:], np.eye(n - 1, n)])
    B = np.eye(n, 1)
    C = (b[1:] - b[0] * a[1:])[None, :]
    D = np.atleast_2d(b[0])
    return A, B, C, D


def ss2tf(A, B, C, D, input: int = 0):
    """State space -> transfer function (scipy.signal.ss2tf)."""
    A = np.atleast_2d(np.asarray(A, np.float64))
    B = np.atleast_2d(np.asarray(B, np.float64))
    C = np.atleast_2d(np.asarray(C, np.float64))
    D = np.atleast_2d(np.asarray(D, np.float64))
    if A.size == 0:
        return D.copy(), np.ones(1)
    B = B[:, input : input + 1]
    D = D[:, input : input + 1]
    den = np.poly(A)
    nout = C.shape[0]
    num = np.zeros((nout, den.size))
    for i in range(nout):
        num[i] = np.poly(A - B @ C[i : i + 1, :]) + (D[i, 0] - 1.0) * den
    return num, den


def zpk2ss(z, p, k):
    """Zeros/poles/gain -> state space (scipy.signal.zpk2ss)."""
    from .iir_design import zpk2tf

    b, a = zpk2tf(z, p, k)
    return tf2ss(b, a)


def ss2zpk(A, B, C, D, input: int = 0):
    """State space -> zeros/poles/gain (scipy.signal.ss2zpk)."""
    from .iir_design import tf2zpk

    num, den = ss2tf(A, B, C, D, input=input)
    return tf2zpk(num[0], den)


def abcd_normalize(A=None, B=None, C=None, D=None):
    """Fill in compatibly-shaped zero matrices for missing state-space
    members (scipy.signal.abcd_normalize)."""
    given = {
        "A": None if A is None else np.atleast_2d(np.asarray(A, np.float64)),
        "B": None if B is None else np.atleast_2d(np.asarray(B, np.float64)),
        "C": None if C is None else np.atleast_2d(np.asarray(C, np.float64)),
        "D": None if D is None else np.atleast_2d(np.asarray(D, np.float64)),
    }
    n = p = q = None  # states, inputs, outputs
    if given["A"] is not None:
        n = given["A"].shape[0]
    if given["B"] is not None:
        n = given["B"].shape[0] if n is None else n
        p = given["B"].shape[1]
    if given["C"] is not None:
        n = given["C"].shape[1] if n is None else n
        q = given["C"].shape[0]
    if given["D"] is not None:
        q = given["D"].shape[0] if q is None else q
        p = given["D"].shape[1] if p is None else p
    if n is None or p is None or q is None:
        raise ValueError("not enough information to infer system shapes")
    A = np.zeros((n, n)) if given["A"] is None else given["A"]
    B = np.zeros((n, p)) if given["B"] is None else given["B"]
    C = np.zeros((q, n)) if given["C"] is None else given["C"]
    D = np.zeros((q, p)) if given["D"] is None else given["D"]
    if A.shape != (n, n) or B.shape != (n, p) or C.shape != (q, n) or D.shape != (q, p):
        raise ValueError(
            f"inconsistent shapes A{A.shape} B{B.shape} C{C.shape} D{D.shape}"
        )
    return A, B, C, D


# --- continuous -> discrete (scipy.signal.cont2discrete) -----------------------


def _expm(m: np.ndarray) -> np.ndarray:
    import scipy.linalg as sla

    return sla.expm(m)


def cont2discrete(system, dt: float, method: str = "zoh", alpha=None):
    """Discretize a continuous state-space (A, B, C, D)
    (scipy.signal.cont2discrete; pass tf/zpk through the converters).

    Methods: ``zoh``, ``foh``, ``impulse``, ``gbt`` (with ``alpha``),
    ``bilinear``/``tustin`` (gbt 1/2), ``euler``/``forward_diff``
    (gbt 0), ``backward_diff`` (gbt 1).
    """
    if len(system) == 2:
        system = tf2ss(*system)
    elif len(system) == 3:
        system = zpk2ss(*system)
    elif len(system) != 4:
        raise ValueError("system must be (b,a), (z,p,k) or (A,B,C,D)")
    A, B, C, D = (np.atleast_2d(np.asarray(m, np.float64)) for m in system)
    n, p = A.shape[0], B.shape[1]

    if method == "gbt":
        if alpha is None or not 0.0 <= alpha <= 1.0:
            raise ValueError("gbt needs alpha in [0, 1]")
    elif method in ("bilinear", "tustin"):
        method, alpha = "gbt", 0.5
    elif method in ("euler", "forward_diff"):
        method, alpha = "gbt", 0.0
    elif method == "backward_diff":
        method, alpha = "gbt", 1.0

    if method == "gbt":
        ima = np.eye(n) - alpha * dt * A
        Ad = np.linalg.solve(ima, np.eye(n) + (1.0 - alpha) * dt * A)
        Bd = np.linalg.solve(ima, dt * B)
        Cd = np.linalg.solve(ima.T, C.T).T
        Dd = D + alpha * (C @ Bd)
    elif method == "zoh":
        em = np.zeros((n + p, n + p))
        em[:n, :n] = A * dt
        em[:n, n:] = B * dt
        ms = _expm(em)
        Ad, Bd, Cd, Dd = ms[:n, :n], ms[:n, n:], C.copy(), D.copy()
    elif method == "foh":
        em = np.zeros((n + 2 * p, n + 2 * p))
        em[:n, :n] = A * dt
        em[:n, n : n + p] = B * dt
        em[n : n + p, n + p :] = np.eye(p)
        ms = _expm(em)
        phi = ms[:n, :n]
        g1 = ms[:n, n : n + p]
        g2 = ms[:n, n + p :]
        Ad = phi
        Bd = g1 + phi @ g2 - g2
        Cd = C.copy()
        Dd = D + C @ g2
    elif method == "impulse":
        if not np.allclose(D, 0):
            raise ValueError("impulse method requires D == 0")
        Ad = _expm(A * dt)
        Bd = Ad @ B * dt
        Cd = C.copy()
        Dd = C @ B * dt
    else:
        raise ValueError(f"unknown method {method!r}")
    return Ad, Bd, Cd, Dd, dt


# --- discrete-time simulation: kernel S3 -----------------------------------------

DLSIM_WARP_STATES = 32  # the warp route: a lane a state row and an output row
DLSIM_WARP_INPUTS = 64  # ... and u, B u, D u, x_t and y_t staged beside each other
DLSIM_WARP_CHUNK = 256  # steps the warp route stages
DLSIM_WARP_SLOTS = (2, 4, 8, 16, 32)  # the warp route's state registers (csrc/lti.cu kWarpSlots)
DLSIM_SLOTS = (1, 2, 3, 4, 6, 8, 10, 12, 16)  # the rows route's, n <= 32 slots (kSlots), else 0
DLSIM_CLUSTER_MAX = 16  # the rows route: CTAs of one cluster, on neighbouring SMs (past 8
# the H100's non-portable cluster sizes)
DLSIM_REG_WARPS = 16  # the rows route with state slots: warps a CTA, two rows of M each in
# registers (csrc/lti.cu kRegThreads)
DLSIM_CHUNK = 256  # steps of B u and D u the rows route computes at a time
DLSIM_BUS_FLOATS = 16384  # ... at most this many floats of them a CTA
DLSIM_ROUTES = ("warp", "rows in shared memory", "rows in device memory")


@dataclasses.dataclass(frozen=True)
class DlsimGeometry:
    """S3's launch for n states, p inputs and q outputs: the route (0 the warp,
    1 the rows of M in the cluster's shared memory, 2 the rows read from device
    memory), CTAs in the cluster and rows of M each, state registers a lane,
    steps a stage (the warp route's u, the rows route's B u), threads and
    dynamic shared bytes a CTA."""

    route: int
    cluster: int
    rows_cta: int
    slots: int
    chunk: int
    threads: int
    smem_bytes: int

    @property
    def name(self) -> str:
        return DLSIM_ROUTES[self.route]


def dlsim_geometry(n: int, p: int, q: int) -> DlsimGeometry:
    """S3's geometry for n states, p inputs and q outputs: the rows route takes the
    fewest CTAs that hold every row in registers. Raises past about 14,080 states,
    where three copies of the state and a chunk of B u leave no room in shared
    memory (a difference by design: the reference's ``lax.scan`` has no cap)."""
    if n <= DLSIM_WARP_STATES and q <= DLSIM_WARP_STATES and p <= DLSIM_WARP_INPUTS:
        chunk = DLSIM_WARP_CHUNK
        slots = next(s for s in DLSIM_WARP_SLOTS if n <= s)
        return DlsimGeometry(0, 1, n + q, slots, chunk, 32, 4 * chunk * (p + 66 + n + q))
    slots = next((s for s in DLSIM_SLOTS if n <= 32 * s), 0)
    cluster = 1
    while cluster < DLSIM_CLUSTER_MAX and (slots == 0 or
                                           _rows_share(n + q, cluster) > 2 * DLSIM_REG_WARPS):
        cluster *= 2
    return _rows_geometry(n, p, q, slots, cluster)


def _rows_share(rows: int, cluster: int) -> int:
    """A CTA's rows of M over ``cluster`` CTAs: a multiple of 4, so its block is 16 bytes."""
    return 4 * -(-rows // (4 * cluster))


def _rows_geometry(n: int, p: int, q: int, slots: int, cluster: int) -> DlsimGeometry:
    """The rows route over ``cluster`` CTAs with ``slots`` state registers a lane."""
    rows_cta = _rows_share(n + q, cluster)
    chunk = max(1, min(DLSIM_CHUNK, DLSIM_BUS_FLOATS // rows_cta))
    base = 32 + 4 * (3 * 4 * -(-n // 4) + rows_cta * chunk)  # mbarriers; x; B u
    if base > SMEM_MAX:
        raise ValueError(f"dlsim on the card (S3): {n} states need {base} bytes of shared "
                         f"memory for the state and B u, more than {SMEM_MAX}")
    route = 1 if base + 4 * rows_cta * (n + p) <= SMEM_MAX else 2
    warps = (min(DLSIM_REG_WARPS, -(-rows_cta // 2)) if slots else min(32, rows_cta))
    smem = base + (4 * rows_cta * (n + p) if route == 1 else 0)
    return DlsimGeometry(route, cluster, rows_cta, slots, chunk, 32 * warps, smem)


def _dlsim_plain(a, b, c, d, u, x0):
    """S3's plain version: the reference's step, y_t = C x_t + D u_t and
    x_{t+1} = A x_t + B u_t, one step at a time (IEEE float32 products)."""
    ys, xs = [], []
    x = x0
    with ieee_fp32_matmul():
        for t in range(u.shape[0]):
            ut = u[t]
            ys.append(c @ x + d @ ut)
            xs.append(x)
            x = a @ x + b @ ut
    if not ys:
        return u.new_empty((0, c.shape[0])), u.new_empty((0, a.shape[0]))
    return torch.stack(ys), torch.stack(xs)


def dlsim_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor,
               u: torch.Tensor, x0: torch.Tensor):
    """The state-space recursion over (T, p) inputs by S3: ``(y (T, q), x (T, n))``,
    x the state before each step's update.

    ``a`` (n, n), ``b`` (n, p), ``c`` (q, n), ``d`` (q, p), ``x0`` (n,), all
    float32 on one device. A CPU tensor takes the plain per-step loop; a CUDA
    tensor one launch of S3 (``csrc/lti.cu``) on the route :func:`dlsim_geometry`
    picks, counted in ``launches``, or raises.
    """
    n, p, q, t = a.shape[0], b.shape[1], c.shape[0], u.shape[0]
    shapes = {"a": (n, n), "b": (n, p), "c": (q, n), "d": (q, p), "u": (t, p), "x0": (n,)}
    for name, v in zip(shapes, (a, b, c, d, u, x0)):
        if tuple(v.shape) != shapes[name] or v.device != u.device:
            raise ValueError(
                "dlsim_scan: a (n, n), b (n, p), c (q, n), d (q, p), u (T, p) and x0 (n,) on "
                f"one device; got {name} {tuple(v.shape)} on {v.device} for n={n}, p={p}, "
                f"q={q}, T={t} on {u.device}"
            )
    a, b, c, d, u, x0 = (v.to(torch.float32) for v in (a, b, c, d, u, x0))
    if not _on_cuda(u):
        return _dlsim_plain(a, b, c, d, u, x0)
    refuse_grad("dlsim_scan (S3)", a, b, c, d, u, x0)
    g = dlsim_geometry(n, p, q)
    y = u.new_empty((t, q))
    xs = u.new_empty((t, n))
    if t == 0:
        return y, xs
    m = torch.cat([torch.cat([a, b], 1), torch.cat([c, d], 1)], 0).contiguous()  # [[A B]; [C D]]
    u, x0 = u.contiguous(), x0.contiguous()
    lib = _build.library()
    with torch.cuda.device(u.device):
        err = lib.dsp_dlsim(
            m.data_ptr(), u.data_ptr(), x0.data_ptr(), y.data_ptr(), xs.data_ptr(), t, n, p, q,
            g.route, g.cluster, g.rows_cta, g.slots, g.chunk, g.threads, g.smem_bytes, _stream(u),
        )
    _build.check(err, "dlsim_scan")
    dlsim_scan.launches += 1
    return y, xs


dlsim_scan.launches = 0


def dlsim_kernel_attrs(n: int, p: int, q: int) -> tuple:
    """What the compiler gave S3's kernel for n states, p inputs and q outputs
    (the card only): (registers a thread, local bytes a thread, static shared
    bytes, most threads a block)."""
    g = dlsim_geometry(n, p, q)
    out = (ctypes.c_int64 * 4)()
    with torch.cuda.device(torch.cuda.current_device()):
        err = _build.library().dsp_dlsim_attrs(g.route, g.slots, ctypes.addressof(out))
    _build.check(err, "dlsim_kernel_attrs")
    return tuple(out)


def _matrix(m, dev) -> torch.Tensor:
    return torch.atleast_2d(as_tensor(m, dev).to(dev, torch.float32))


def dlsim(system, u, x0=None, *, device="cuda"):
    """Simulate (A, B, C, D[, dt]) on input ``u`` (T, p): ``(y (T, q), x (T, n))``
    as float32 tensors on ``u``'s device (``device`` for NumPy input), x the
    state before each step. One launch of S3 on the card.

    As in the reference, a 1-D ``u`` of a single-input system is one sample a
    step, and ``x0`` is reshaped to (n,).
    """
    if len(system) == 5:
        system = system[:4]
    u = torch.atleast_2d(as_tensor(u, device).to(torch.float32))
    A, B, C, D = (_matrix(m, u.device) for m in system)
    if u.dim() == 2 and u.shape[0] == 1 and B.shape[1] == 1:
        u = u.T
    n = A.shape[0]
    if x0 is None:
        x0 = u.new_zeros(n)
    else:
        x0 = as_tensor(x0, u.device).to(u.device, torch.float32)
        if x0.numel() != n:
            raise ValueError(f"x0 has {x0.numel()} entries for a system of {n} states")
        x0 = x0.reshape(n)
    return dlsim_scan(A, B, C, D, u, x0)


def _as_dss(system):
    """Normalize a discrete-system tuple to ((A, B, C, D), dt).

    Accepted: ``(b, a)``, ``(b, a, dt)``, ``(A, B, C, D)``,
    ``(A, B, C, D, dt)``, ``(z, p, k, dt)`` (the 4-tuple is
    disambiguated by whether the second element is a matrix).
    """
    sys = tuple(system)
    if len(sys) == 2:
        return tf2ss(*sys), 1.0
    if len(sys) == 3:
        return tf2ss(sys[0], sys[1]), float(sys[2])
    if len(sys) == 4:
        if np.ndim(sys[1]) == 2:
            return tuple(sys), 1.0
        return zpk2ss(*sys[:3]), float(sys[3])
    if len(sys) == 5:
        return tuple(sys[:4]), float(sys[4])
    raise ValueError("unsupported discrete system tuple")


def dimpulse(system, n: int, *, device="cuda"):
    """Discrete impulse response, ``n`` samples (scipy.signal.dimpulse with one
    input): ``(t, y)``, t NumPy and y a tensor on ``device``."""
    sys4, dt = _as_dss(system)
    p = np.atleast_2d(sys4[1]).shape[1]
    u = np.zeros((n, p), np.float32)
    if n:
        u[0] = 1.0
    y, _ = dlsim(sys4, u, device=device)
    return np.arange(n) * dt, y


def dstep(system, n: int, *, device="cuda"):
    """Discrete step response, ``n`` samples (scipy.signal.dstep with one input):
    ``(t, y)``, t NumPy and y a tensor on ``device``."""
    sys4, dt = _as_dss(system)
    p = np.atleast_2d(sys4[1]).shape[1]
    y, _ = dlsim(sys4, np.ones((n, p), np.float32), device=device)
    return np.arange(n) * dt, y


# --- partial fractions (scipy.signal.residue/residuez) -------------------------


def unique_roots(p, tol: float = 1e-3, rtype: str = "min"):
    """Group nearby roots (scipy.signal.unique_roots): returns
    (representatives, multiplicities)."""
    p = np.asarray(p)
    if rtype not in ("max", "min", "avg", "mean", "maximum", "minimum"):
        raise ValueError(f"unknown rtype {rtype!r}")
    pout: list = []
    mult: list = []
    groups: list = []
    used = np.zeros(p.size, bool)
    for i in range(p.size):
        if used[i]:
            continue
        close = np.abs(p - p[i]) < tol
        close &= ~used
        idx = np.nonzero(close)[0]
        used[idx] = True
        g = p[idx]
        groups.append(g)
        mult.append(idx.size)
        if rtype in ("max", "maximum"):
            pout.append(g[np.argmax(np.abs(g))])
        elif rtype in ("min", "minimum"):
            pout.append(g[np.argmin(np.abs(g))])
        else:
            pout.append(np.mean(g))
    return np.asarray(pout), np.asarray(mult, int)


def _rational_derivatives(num, den, point, count):
    """[f(point), f'(point), ..., f^(count-1)(point)] for f = num/den via
    the quotient rule on coefficient arrays (exact, no limits)."""
    out = []
    n, d = np.asarray(num, complex), np.asarray(den, complex)
    for _ in range(count):
        out.append(np.polyval(n, point) / np.polyval(d, point))
        # (n/d)' = (n'd - nd')/d^2
        n, d = (
            np.polysub(
                np.polymul(np.polyder(n), d), np.polymul(n, np.polyder(d))
            ),
            np.polymul(d, d),
        )
    return out


def residue(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of b(s)/a(s) (scipy.signal.residue):
    returns ``(r, p, k)`` with poles repeated per multiplicity and
    residues ordered by ascending power of (s - p)."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    if a.size < 2:
        return np.array([]), np.array([]), b / a[0]
    k, b_rem = (
        np.polydiv(b, a) if b.size >= a.size else (np.array([]), b)
    )
    poles = np.roots(a)
    uniq, mult = unique_roots(poles, tol=tol, rtype=rtype)
    r_all, p_all = [], []
    for gi, (pole, m) in enumerate(zip(uniq, mult)):
        # denominator with this pole factored out entirely
        others = []
        for gj, (q, mq) in enumerate(zip(uniq, mult)):
            if gj != gi:
                others.extend([q] * mq)
        an = a[0] * np.poly(others) if others else np.atleast_1d(a[0])
        # b_rem/an = sum_j r_j (s-p)^(j-1) + O((s-p)^m): Taylor at the pole
        ders = _rational_derivatives(b_rem, an, pole, m)
        fact = 1.0
        taylor = []
        for j, dv in enumerate(ders):
            if j:
                fact *= j
            taylor.append(dv / fact)
        # scipy orders residues for (s-p)^1 ... (s-p)^m as the
        # HIGHEST-order Taylor coefficient first paired with power 1
        r_all.extend(taylor[::-1])
        p_all.extend([pole] * m)
    return np.asarray(r_all), np.asarray(p_all), np.real_if_close(k)


def residuez(b, a, tol: float = 1e-3, rtype: str = "avg"):
    """Partial-fraction expansion of b(z^-1)/a(z^-1)
    (scipy.signal.residuez): r_i/(1 - p_i z^-1)^j terms + direct k."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    # substitute w = z^-1: b(w)/a(w) with ascending -> np descending is a
    # reversal; expand around the w-poles 1/p
    brev, arev = b[::-1], a[::-1]
    # direct polynomial part in z^-1 (appears when deg_b >= deg_a in w)
    k, brem_rev = (
        np.polydiv(brev, arev) if brev.size >= arev.size else (np.array([]), brev)
    )
    poles = np.roots(a[::-1])  # roots in w; z-poles are 1/w
    uniq_w, mult = unique_roots(poles, tol=tol, rtype=rtype)
    r_all, p_all = [], []
    for gi, (wpole, m) in enumerate(zip(uniq_w, mult)):
        others = []
        for gj, (q, mq) in enumerate(zip(uniq_w, mult)):
            if gj != gi:
                others.extend([q] * mq)
        an = arev[0] * np.poly(others) if others else np.atleast_1d(arev[0])
        # g(w) = brem/an is analytic at w0 = wpole: Taylor c_j there
        ders = _rational_derivatives(brem_rev, an, wpole, m)
        fact = 1.0
        taylor = []
        for j, dv in enumerate(ders):
            if j:
                fact *= j
            taylor.append(dv / fact)
        pz = 1.0 / wpole
        # f = sum_j c_j (w-w0)^(j-m) and (w-w0) = -w0 (1 - pz z^-1), so
        # the r/(1 - pz z^-1)^s term (s = m-j) carries c_j (-w0)^(-s);
        # scipy orders ascending s = 1..m
        for s in range(1, m + 1):
            r_all.append(taylor[m - s] * (-wpole) ** (-s))
            p_all.append(pz)
    return np.asarray(r_all), np.asarray(p_all), np.real_if_close(k[::-1])


def invres(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residue` (scipy.signal.invres)."""
    r = np.atleast_1d(np.asarray(r, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    k = np.atleast_1d(np.asarray(k)) if np.size(k) else np.zeros(0)
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    # rebuild the denominator from the GROUPED poles so repeated-root
    # terms stay consistent with the grouping
    a = np.ones(1, complex)
    for pole, m in zip(uniq, mult):
        a = np.polymul(a, np.poly([pole] * m))
    num = np.zeros(1, complex)
    idx = 0
    for gi, (pole, m) in enumerate(zip(uniq, mult)):
        other = np.ones(1, complex)
        for gj, (q, mq) in enumerate(zip(uniq, mult)):
            if gj != gi:
                other = np.polymul(other, np.poly([q] * mq))
        for j in range(1, m + 1):
            # r_{idx+j-1} * a(s) / (s-pole)^j
            term = np.polymul(other, np.poly([pole] * (m - j)))
            num = np.polyadd(num, r[idx + j - 1] * term)
        idx += m
    if k.size:
        num = np.polyadd(num, np.polymul(k, a))
    return np.real_if_close(num), np.real_if_close(a)


def invresz(r, p, k, tol: float = 1e-3, rtype: str = "avg"):
    """Inverse of :func:`residuez` (scipy.signal.invresz)."""
    r = np.atleast_1d(np.asarray(r, complex))
    p = np.atleast_1d(np.asarray(p, complex))
    k = np.atleast_1d(np.asarray(k)) if np.size(k) else np.zeros(0)
    uniq, mult = unique_roots(p, tol=tol, rtype=rtype)
    # denominator prod (1 - p z^-1)^m: build in w = z^-1 ascending then
    # express descending-in-w, finally reverse to z^-1 ascending
    a_w = np.ones(1, complex)
    for pole, m in zip(uniq, mult):
        a_w = np.polymul(a_w, np.poly([1.0 / pole] * m) * (-pole) ** m)
    num_w = np.zeros(1, complex)
    idx = 0
    for gi, (pole, m) in enumerate(zip(uniq, mult)):
        other_w = np.ones(1, complex)
        for gj, (q, mq) in enumerate(zip(uniq, mult)):
            if gj != gi:
                other_w = np.polymul(
                    other_w, np.poly([1.0 / q] * mq) * (-q) ** mq
                )
        for s in range(1, m + 1):
            self_w = np.poly([1.0 / pole] * (m - s)) * (-pole) ** (m - s)
            num_w = np.polyadd(
                num_w, r[idx + s - 1] * np.polymul(other_w, self_w)
            )
        idx += m
    if k.size:
        num_w = np.polyadd(num_w, np.polymul(k[::-1], a_w))
    b = num_w[::-1]
    a = a_w[::-1]
    # normalize a[0] (the z^0 coefficient) to 1 like scipy
    b = b / a[0]
    a = a / a[0]
    return np.real_if_close(b), np.real_if_close(a)


def freqz_zpk(z, p, k, worN: int = 512):
    """Frequency response straight from zpk (scipy.signal.freqz_zpk) —
    numerically robust for high orders where the polynomial form
    overflows."""
    w = np.linspace(0, np.pi, worN, endpoint=False)
    ejw = np.exp(1j * w)
    h = np.full(worN, complex(k))
    for zz in np.atleast_1d(z):
        h = h * (ejw - zz)
    for pp in np.atleast_1d(p):
        h = h / (ejw - pp)
    return w, h


# --- continuous-time responses (scipy.signal.lsim/impulse/step/bode) -----------


def _as_ss(system):
    if len(system) == 2:
        return tf2ss(*system)
    if len(system) == 3:
        return zpk2ss(*system)
    if len(system) >= 4:
        return tuple(np.atleast_2d(np.asarray(m, np.float64)) for m in system[:4])
    raise ValueError("system must be (b,a), (z,p,k) or (A,B,C,D)")


def _default_response_times(A, n: int) -> np.ndarray:
    """scipy's heuristic: ~7 slowest time constants, n points."""
    vals = np.linalg.eigvals(A) if A.size else np.array([-1.0])
    r = np.min(np.abs(np.real(vals)))
    if r == 0.0:
        r = 1.0
    return np.linspace(0.0, 7.0 / r, n)


def _host(y: torch.Tensor) -> np.ndarray:
    y = y.cpu().numpy()
    return y[:, 0] if y.shape[1] == 1 else y


def lsim(system, U, T, X0=None, interp: bool = True, *, device="cuda"):
    """Continuous LTI simulation over a uniform time grid (scipy.signal.lsim):
    exact per-step discretization (first-order hold on the input when
    ``interp``, as scipy interpolates linearly; zero-order hold otherwise),
    then :func:`dlsim` on ``device``. Returns NumPy ``(T, y, x)``; the state
    recursion runs in float32 (about 1e-4 relative to scipy's float64 over a
    few hundred steps)."""
    T = np.asarray(T, np.float64)
    if T.ndim != 1 or T.size < 2:
        raise ValueError("T must be 1-D with at least 2 points")
    dts = np.diff(T)
    if not np.allclose(dts, dts[0], rtol=1e-6):
        raise ValueError("this lsim requires a uniform time grid")
    A, B, C, D = _as_ss(system)
    if U is None:
        U = np.zeros((T.size, B.shape[1]))
    U = np.atleast_1d(np.asarray(U, np.float64))
    if U.ndim == 1:
        U = U[:, None]
    method = "foh" if interp else "zoh"
    Ad, Bd, Cd, Dd, _ = cont2discrete((A, B, C, D), float(dts[0]), method=method)
    y, x = dlsim((Ad, Bd, Cd, Dd), U, x0=X0, device=device)
    return T, _host(y), x.cpu().numpy()


def impulse(system, X0=None, T=None, N: int | None = None, *, device="cuda"):
    """Continuous impulse response (scipy.signal.impulse): the zero-input response
    from state B (plus X0), sampled by exact propagation x_{k+1} = e^{A dt} x_k.
    Returns NumPy ``(T, y)``."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_response_times(A, 100 if N is None else int(N))
    else:
        T = np.asarray(T, np.float64)
    dts = np.diff(T)
    if dts.size and not np.allclose(dts, dts[0], rtol=1e-6):
        raise ValueError("this impulse requires a uniform time grid")
    x0 = B[:, 0] + (0 if X0 is None else np.asarray(X0, np.float64).ravel())
    Ad = _expm(A * float(dts[0])) if dts.size else np.eye(A.shape[0])
    y, _ = dlsim((Ad, np.zeros_like(B), C, np.zeros_like(D)), np.zeros((T.size, B.shape[1])),
                 x0=x0, device=device)
    return T, _host(y)


def step(system, X0=None, T=None, N: int | None = None, *, device="cuda"):
    """Continuous step response (scipy.signal.step) by exact zero-order-hold
    discretization and :func:`dlsim`. Returns NumPy ``(T, y)``."""
    A, B, C, D = _as_ss(system)
    if T is None:
        T = _default_response_times(A, 100 if N is None else int(N))
    else:
        T = np.asarray(T, np.float64)
    dts = np.diff(T)
    if dts.size and not np.allclose(dts, dts[0], rtol=1e-6):
        raise ValueError("this step requires a uniform time grid")
    Ad, Bd, Cd, Dd, _ = cont2discrete(
        (A, B, C, D), float(dts[0]) if dts.size else 1.0, method="zoh"
    )
    y, _ = dlsim((Ad, Bd, Cd, Dd), np.ones((T.size, B.shape[1])), x0=X0, device=device)
    return T, _host(y)


def freqresp(system, w=None, n: int = 10000):
    """Continuous frequency response H(jw) (scipy.signal.freqresp)."""
    from .iir_design import findfreqs, freqs, freqs_zpk

    if len(system) == 3:
        z, p, k = system
        if w is None:
            w = findfreqs(z, p, n, kind="zp")
        return freqs_zpk(z, p, k, worN=np.asarray(w, np.float64))
    if len(system) == 2:
        b, a = system
    else:
        num, den = ss2tf(*_as_ss(system))
        b, a = num[0], den
    if w is None:
        w = findfreqs(b, a, n)
    return freqs(b, a, worN=np.asarray(w, np.float64))


def bode(system, w=None, n: int = 100):
    """Continuous Bode magnitude (dB) and phase (deg)
    (scipy.signal.bode)."""
    w, h = freqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.maximum(np.abs(h), 1e-300))
    phase = np.unwrap(np.angle(h)) * 180.0 / np.pi
    return w, mag, phase


def dfreqresp(system, w=None, n: int = 64, whole: bool = False):
    """Discrete frequency response (scipy.signal.dfreqresp).

    System tuples follow scipy's dlti convention — dt is ALWAYS the last
    element: ``(b, a, dt)``, ``(z, p, k, dt)``, or ``(A, B, C, D, dt)``.
    """
    sys = tuple(system)
    if len(sys) == 3:
        b, a, dt = sys
    elif len(sys) == 4:
        from .iir_design import zpk2tf

        b, a = zpk2tf(*sys[:3])
        dt = sys[3]
    elif len(sys) == 5:
        num, den = ss2tf(*_as_ss(sys[:4]))
        b, a = num[0], den
        dt = sys[4]
    else:
        raise ValueError(
            "system must be (b, a, dt), (z, p, k, dt) or (A, B, C, D, dt)"
        )
    if w is None:
        w = np.linspace(0, 2 * np.pi if whole else np.pi, n, endpoint=False)
    else:
        w = np.asarray(w, np.float64)
    ejw = np.exp(1j * w)
    h = np.polyval(np.asarray(b, np.float64), ejw) / np.polyval(
        np.asarray(a, np.float64), ejw
    ) * ejw ** (len(np.atleast_1d(a)) - len(np.atleast_1d(b)))
    # scipy convention: dfreqresp keeps rad/SAMPLE; dbode rescales by dt
    return w, h


def dbode(system, w=None, n: int = 100):
    """Discrete Bode plot data (scipy.signal.dbode): frequencies in
    rad/time-unit (rad/sample divided by dt)."""
    dt = system[-1] if len(system) in (3, 4, 5) else 1.0
    w, h = dfreqresp(system, w=w, n=n)
    mag = 20.0 * np.log10(np.maximum(np.abs(h), 1e-300))
    phase = np.unwrap(np.angle(h)) * 180.0 / np.pi
    return w / dt, mag, phase


# --- class API (scipy.signal.lti / dlti and representation classes) ------------
#
# Thin object wrappers over the functions above, so scipy-style code
# (`sys = lti(b, a); sys.bode(); sys.step()`) runs as it is. They hold NumPy
# matrices only; the responses take ``device`` as the functions do.


class _LTIBase:
    """Common behavior for continuous/discrete systems in any
    representation."""

    dt = None  # None = continuous

    # representation conversions ------------------------------------------------
    def to_ss(self):
        A, B, C, D = _as_ss(self._system)
        return (
            StateSpace(A, B, C, D)
            if self.dt is None
            else StateSpace(A, B, C, D, dt=self.dt)
        )

    def to_tf(self):
        num, den = ss2tf(*_as_ss(self._system))
        return (
            TransferFunction(num[0], den)
            if self.dt is None
            else TransferFunction(num[0], den, dt=self.dt)
        )

    def to_zpk(self):
        z, p, k = ss2zpk(*_as_ss(self._system))
        return (
            ZerosPolesGain(z, p, k)
            if self.dt is None
            else ZerosPolesGain(z, p, k, dt=self.dt)
        )

    @property
    def poles(self):
        return self.to_zpk().p

    @property
    def zeros(self):
        return self.to_zpk().z

    def dcgain(self):
        num, den = ss2tf(*_as_ss(self._system))
        if self.dt is None:
            return float(num[0][-1] / den[-1])
        return float(np.sum(num[0]) / np.sum(den))

    # responses ----------------------------------------------------------------
    def _check_continuous(self):
        if self.dt is not None:
            raise ValueError("continuous-time method on a discrete system")

    def impulse(self, X0=None, T=None, N=None, *, device="cuda"):
        if self.dt is None:
            return impulse(self._system, X0=X0, T=T, N=N, device=device)
        n = 100 if N is None else int(N)
        return dimpulse(tuple(self._system) + (self.dt,), n, device=device)

    def step(self, X0=None, T=None, N=None, *, device="cuda"):
        if self.dt is None:
            return step(self._system, X0=X0, T=T, N=N, device=device)
        n = 100 if N is None else int(N)
        return dstep(tuple(self._system) + (self.dt,), n, device=device)

    def output(self, U, T, X0=None, *, device="cuda"):
        if self.dt is None:
            return lsim(self._system, U, T, X0=X0, device=device)
        y, x = dlsim(_as_ss(self._system), U, x0=X0, device=device)
        return T, y.cpu().numpy(), x.cpu().numpy()

    def freqresp(self, w=None, n=10000):
        if self.dt is None:
            return freqresp(self._system, w=w, n=n)
        num, den = ss2tf(*_as_ss(self._system))
        return dfreqresp((num[0], den, self.dt), w=w, n=n)

    def bode(self, w=None, n=100):
        if self.dt is None:
            return bode(self._system, w=w, n=n)
        num, den = ss2tf(*_as_ss(self._system))
        return dbode((num[0], den, self.dt), w=w, n=n)

    def __repr__(self):
        dt = "continuous" if self.dt is None else f"dt={self.dt}"
        return f"{type(self).__name__}({dt})"


class StateSpace(_LTIBase):
    """State-space system (scipy.signal.StateSpace)."""

    def __init__(self, A, B, C, D, *, dt=None):
        self.A, self.B, self.C, self.D = abcd_normalize(A, B, C, D)
        self.dt = dt
        self._system = (self.A, self.B, self.C, self.D)


class TransferFunction(_LTIBase):
    """Transfer-function system (scipy.signal.TransferFunction)."""

    def __init__(self, num, den, *, dt=None):
        self.num = np.atleast_1d(np.asarray(num, np.float64))
        self.den = np.atleast_1d(np.asarray(den, np.float64))
        self.dt = dt
        self._system = (self.num, self.den)


class ZerosPolesGain(_LTIBase):
    """Zeros-poles-gain system (scipy.signal.ZerosPolesGain)."""

    def __init__(self, z, p, k, *, dt=None):
        self.z = np.atleast_1d(np.asarray(z))
        self.p = np.atleast_1d(np.asarray(p))
        self.k = float(k)
        self.dt = dt
        self._system = (self.z, self.p, self.k)


def lti(*system):
    """Continuous-system factory (scipy.signal.lti): dispatches on arity
    — (num, den), (z, p, k), or (A, B, C, D)."""
    if len(system) == 2:
        return TransferFunction(*system)
    if len(system) == 3:
        return ZerosPolesGain(*system)
    if len(system) == 4:
        return StateSpace(*system)
    raise ValueError("lti takes 2 (tf), 3 (zpk) or 4 (ss) arguments")


def dlti(*system, dt=True):
    """Discrete-system factory (scipy.signal.dlti)."""
    dt = 1.0 if dt is True else float(dt)
    if len(system) == 2:
        return TransferFunction(*system, dt=dt)
    if len(system) == 3:
        return ZerosPolesGain(*system, dt=dt)
    if len(system) == 4:
        return StateSpace(*system, dt=dt)
    raise ValueError("dlti takes 2 (tf), 3 (zpk) or 4 (ss) arguments")


# --- pole placement (scipy.signal.place_poles) ---------------------------------


def _ackermann(A, b, poles):
    n = A.shape[0]
    ctrb = np.hstack(
        [np.linalg.matrix_power(A, i) @ b for i in range(n)]
    )
    phi = np.poly(poles)  # descending
    phiA = np.zeros_like(A)
    for c in phi:
        phiA = phiA @ A + c * np.eye(n)
    e_last = np.zeros(n)
    e_last[-1] = 1.0
    return e_last @ np.linalg.solve(ctrb, phiA)


class _PlaceResult:
    def __init__(self, gain, computed, requested):
        self.gain_matrix = gain
        self.computed_poles = computed
        self.requested_poles = requested
        self.rtol = float(
            np.max(
                np.abs(np.sort_complex(computed) - np.sort_complex(requested))
            )
            / max(1.0, np.max(np.abs(requested)))
        )
        self.nb_iter = 1

    def __repr__(self):
        return f"PlaceResult(rtol={self.rtol:.2e})"


def place_poles(A, B, poles, *, maxiter: int = 30, seed: int = 0):
    """Full-state-feedback pole placement: K with
    ``eig(A - B K) = poles`` (scipy.signal.place_poles' contract).

    SISO uses Ackermann's formula; multi-input reduces to SISO through a
    random input combination ``B v`` (valid w.p. 1 for controllable
    pairs), retrying until the closed-loop eigenvalues verify. The
    result's ``gain_matrix`` generally differs from scipy's (the K for a
    MIMO placement is not unique); ``computed_poles`` is the contract.
    """
    A = np.atleast_2d(np.asarray(A, np.float64))
    B = np.atleast_2d(np.asarray(B, np.float64))
    poles = np.asarray(poles, complex)
    n, m = A.shape[0], B.shape[1]
    if poles.size != n:
        raise ValueError(f"need exactly {n} poles, got {poles.size}")
    # conjugate-closed requirement for a real K
    if not np.allclose(np.sort_complex(poles), np.sort_complex(poles.conj())):
        raise ValueError("poles must be conjugate-symmetric")
    rng = np.random.default_rng(seed)
    last_err = None
    for it in range(maxiter):
        v = (
            np.ones((m, 1))
            if (m == 1 or it == 0)
            else rng.standard_normal((m, 1))
        )
        b = B @ v
        try:
            k_row = _ackermann(A, b, poles)
        except np.linalg.LinAlgError as exc:
            last_err = exc
            continue
        K = v @ k_row[None, :]
        computed = np.linalg.eigvals(A - B @ K)
        if np.allclose(
            np.sort_complex(computed), np.sort_complex(poles),
            rtol=1e-4, atol=1e-6 * max(1.0, np.max(np.abs(poles))),
        ):
            return _PlaceResult(np.real(K), computed, poles)
        last_err = ValueError("placement did not verify")
    raise ValueError(
        f"pole placement failed after {maxiter} attempts: {last_err} "
        "(is (A, B) controllable?)"
    )


__all__ = [
    "tf2ss",
    "ss2tf",
    "zpk2ss",
    "ss2zpk",
    "abcd_normalize",
    "cont2discrete",
    "dlsim",
    "dlsim_scan",
    "dlsim_geometry",
    "dlsim_kernel_attrs",
    "dimpulse",
    "dstep",
    "unique_roots",
    "residue",
    "residuez",
    "invres",
    "invresz",
    "freqz_zpk",
    "lsim",
    "impulse",
    "step",
    "freqresp",
    "bode",
    "dfreqresp",
    "dbode",
    "StateSpace",
    "TransferFunction",
    "ZerosPolesGain",
    "lti",
    "dlti",
    "place_poles",
]
