"""The averager variant zoo: the reference's nine binaries as one registry.

Counterpart of ``digital_signal_processsing_tpu/models/averager_zoo.py``,
with the same keys and methods. Maps every reference executable (SURVEY.md
§0 census) to the port's realization on Hopper. Used by the sweep driver;
:func:`run_variant` is the single entry point.

| reference binary (basics/)            | zoo key       | Hopper realization |
|---------------------------------------|---------------|--------------------|
| profilable_moving_averager.cpp        | golden_cpu    | NumPy oracle |
| profilable_parallel_averager.cu       | xla_direct    | plain PyTorch shifted adds (no kernel of ours) |
| profilable_sm_averager.cu             | direct        | csrc/direct.cu: tile + halo in shared memory, k adds an output |
| profilable_sm_vload2.cu               | direct        | same kernel; wider loads are a later step |
| profilable_sm_vload4.cu               | direct        | same kernel |
| hillis_steele_averager.cu             | scan_hillis   | csrc/scan.cu: stride-doubling across the lanes by shuffles, 16-byte loads |
| hillis_steele_vloaded_averager.cu     | scan_hillis   | same kernel |
| blelloch_scan_averager.cu             | scan          | csrc/scan.cu: up-sweep and down-sweep in registers and across the lanes |
| blelloch_scan_vloaded_averager.cu     | scan          | same kernel |

The reference's vectorized-load rungs share a kernel with their scalar
rung here, as in the reference package: the scan kernel loads 16 bytes a
thread (PERF.md), the direct kernel 2. The port's CPU realization of each
kernel is its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class VariantInfo:
    key: str
    method: str  # ops.moving_average method name
    reference_files: tuple[str, ...]
    work: str  # asymptotic work per element
    regime: str  # where it wins


AVERAGER_ZOO: dict[str, VariantInfo] = {
    v.key: v
    for v in [
        VariantInfo(
            "golden_cpu",
            "golden",
            ("basics/profilable_moving_averager.cpp",),
            "O(1) sliding",
            "host baseline / semantic oracle",
        ),
        VariantInfo(
            "xla_direct",
            "xla_direct",
            ("basics/profilable_parallel_averager.cu",),
            "O(k)",
            "tiny windows, zero kernel-engineering",
        ),
        VariantInfo(
            "direct",
            "direct",
            (
                "basics/profilable_sm_averager.cu",
                "basics/profilable_sm_vload2.cu",
                "basics/profilable_sm_vload4.cu",
            ),
            "O(k)",
            "small windows (memory-latency regime, README.md:10-12)",
        ),
        VariantInfo(
            "scan_hillis",
            "scan_hillis",
            (
                "basics/hillis_steele_averager.cu",
                "basics/hillis_steele_vloaded_averager.cu",
            ),
            "O(log n) passes, O(n log n) work",
            "ladder rung: demonstrates work-inefficiency cost",
        ),
        VariantInfo(
            "scan",
            "scan",
            (
                "basics/blelloch_scan_averager.cu",
                "basics/blelloch_scan_vloaded_averager.cu",
            ),
            "O(log) passes, O(n) work",
            "large windows (compute regime); the flagship",
        ),
        VariantInfo(
            "xla_scan",
            "xla_scan",
            (),
            "compiler-chosen scan",
            "correctness anchor / any channel count",
        ),
    ]
}


def run_variant(key: str, x, window: int, channels: int = 1, **kw):
    from ..ops import moving_average

    if key not in AVERAGER_ZOO:
        raise KeyError(f"unknown variant {key!r}; options {sorted(AVERAGER_ZOO)}")
    return moving_average(x, window, channels, method=AVERAGER_ZOO[key].method, **kw)


__all__ = ["AVERAGER_ZOO", "VariantInfo", "run_variant"]
