"""CSV logger with the reference's 14-column schema (gpu_utils.h:196-199).

Counterpart of ``digital_signal_processsing_tpu/harness/csvlog.py``, with
the same columns, so tooling written against either package's CSVs reads
both:

    Algorithm,MemoryMode,N_Samples,Grade,BlockSize,H2D_ms,Compute_ms,D2H_ms,
    Total_ms,Init_ms,ColdStart_Total_ms,Bandwidth_GBs,Throughput_MSs,
    ColdStart_MSs

Append mode with a header on create (gpu_utils.h:188), so an interrupted
sweep keeps its earlier rows.
"""

from __future__ import annotations

from pathlib import Path

from .profile import ProfileResult

DEFAULT_CSV = "benchmark_results.csv"

CSV_COLUMNS = (
    "Algorithm,MemoryMode,N_Samples,Grade,BlockSize,H2D_ms,Compute_ms,D2H_ms,"
    "Total_ms,Init_ms,ColdStart_Total_ms,Bandwidth_GBs,Throughput_MSs,"
    "ColdStart_MSs"
)


class CsvLogger:
    """Append-mode CSV logger (CsvLogger analog, gpu_utils.h:162-232)."""

    def __init__(self, path: str | Path = DEFAULT_CSV):
        self.path = Path(path)
        if not self.path.exists() or self.path.stat().st_size == 0:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self.path.write_text(CSV_COLUMNS + "\n")

    def log(
        self,
        algorithm: str,
        memory_mode: str,
        num_samples: int,
        grade: int,
        block_size: int,
        result: ProfileResult,
        bytes_per_sample: int,
    ) -> None:
        r = result.averaged()
        row = (
            f"{algorithm},{memory_mode},{num_samples},{grade},{block_size},"
            f"{r.h2d_ms:.4f},{r.compute_ms:.4f},{r.d2h_ms:.4f},"
            f"{r.total_ms:.4f},{r.initialization_ms:.4f},{r.cold_total_ms:.4f},"
            f"{r.bandwidth_gbs(num_samples, bytes_per_sample):.4f},"
            f"{r.throughput_msps(num_samples):.4f},"
            f"{r.cold_throughput_msps(num_samples):.4f}"
        )
        with self.path.open("a") as f:
            f.write(row + "\n")


__all__ = ["CsvLogger", "CSV_COLUMNS", "DEFAULT_CSV"]
