"""Numerics rules shared by every averager path.

The golden model accumulates window sums in int64 and divides with C-style
truncation toward zero (see golden/reference.py). The kernels keep the
reference package's int32 modular argument instead of int64:

    window_sum[i] = (cumsum[i] - cumsum[i - k*C]) mod 2^32

equals the true window sum whenever the true sum fits in int32, i.e. for
``k * 32768 <= 2^31 - 1  <=>  k <= 65535``. Prefix overflow cancels in the
difference. The CUDA kernels do this arithmetic in uint32, where wraparound
is defined, and reinterpret the final difference as int32.
"""

from __future__ import annotations

import numpy as np
import torch

# Largest window for which int32 modular window sums of int16 samples are
# exact: k * 32768 <= 2^31 - 1  =>  k <= 65535.
MAX_EXACT_WINDOW = 65535


def trunc_div(num, den: int):
    """C-style integer division, truncating toward zero.

    NumPy's and PyTorch's ``//`` floor; C++ ``/`` truncates. The two differ
    for negative window sums. Takes a NumPy array or an integer tensor;
    ``den`` must be positive.
    """
    if isinstance(num, np.ndarray):
        return np.where(num >= 0, num // den, -((-num) // den))
    return torch.div(num, den, rounding_mode="trunc")


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced mod 2^32 into int32's range, as int32.

    PyTorch's int64 -> int32 cast is C++'s integral conversion, which keeps
    the low 32 bits (defined so since C++20, and what every compiler did
    before); tests/test_torch_cumsum.py holds it to NumPy's modular result.
    """
    return v.to(torch.int32)


def float_reciprocal_quantize(wsum: torch.Tensor, window: int, out_dtype=torch.int16) -> torch.Tensor:
    """The reference GPU variants' quantization: ``sum * (1.0 / window)`` in
    float32, then a truncating cast.

    They multiply by a precomputed reciprocal instead of dividing, which lands
    one LSB away from integer division for a few (sum, k) pairs. For A/B
    parity studies only: every averager of the port divides exactly
    (:func:`trunc_div`).
    """
    inv = np.float32(1.0) / np.float32(window)
    q = torch.trunc(wsum.to(torch.float32) * float(inv)).to(torch.float64)
    info = torch.iinfo(out_dtype)  # out of range saturates, as the reference's cast does
    return torch.clamp(q, info.min, info.max).to(out_dtype)


def exact_window_bound(sample_bits: int = 16) -> int:
    """Largest window for which int32 modular window sums are exact."""
    max_abs = 1 << (sample_bits - 1)  # 32768 for int16 (|-32768| dominates)
    return (2**31 - 1) // max_abs


def snr_db(reference, test) -> float:
    """Signal-to-noise ratio of ``test`` against ``reference``, in dB (float64)."""
    ref = np.asarray(reference, dtype=np.float64)
    err = np.asarray(test, dtype=np.float64) - ref
    p_sig = float(np.sum(ref * ref))
    p_err = float(np.sum(err * err))
    if p_err == 0.0:
        return float("inf")
    if p_sig == 0.0:
        return float("-inf")
    return 10.0 * np.log10(p_sig / p_err)


__all__ = [
    "MAX_EXACT_WINDOW",
    "trunc_div",
    "wrap_int32",
    "float_reciprocal_quantize",
    "exact_window_bound",
    "snr_db",
]
