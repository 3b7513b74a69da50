"""The port's phase harness and CSV logger: the reference's schema, card-only timing."""

import numpy as np
import pytest

from digital_signal_processsing_tpu.harness.csvlog import CSV_COLUMNS as JAX_CSV_COLUMNS
from digital_signal_processsing_tpu_torch.__main__ import main
from digital_signal_processsing_tpu_torch.harness import CSV_COLUMNS, CsvLogger, ProfileResult
from digital_signal_processsing_tpu_torch.harness import time_phases
from digital_signal_processsing_tpu_torch.io import write_wav


def test_csv_schema_matches_the_reference(tmp_path):
    assert CSV_COLUMNS == JAX_CSV_COLUMNS
    assert len(CSV_COLUMNS.split(",")) == 14
    res = ProfileResult(initialization_ms=5.0)
    res.accumulate(1.0, 2.0, 3.0)
    res.accumulate(1.0, 4.0, 3.0)
    log = CsvLogger(tmp_path / "bench.csv")
    log.log("windowed", "staged", 1000, 16, 0, res, 2)
    CsvLogger(tmp_path / "bench.csv").log("windowed", "resident", 1000, 16, 0, res, 2)
    lines = (tmp_path / "bench.csv").read_text().splitlines()
    assert lines[0] == CSV_COLUMNS and len(lines) == 3
    row = lines[1].split(",")
    assert len(row) == 14
    assert row[:5] == ["windowed", "staged", "1000", "16", "0"]
    assert float(row[6]) == pytest.approx(3.0)  # compute averaged over 2 rounds
    assert float(row[8]) == pytest.approx(7.0)  # total = h2d + compute + d2h


def test_time_phases_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA"):
        time_phases(lambda x: x, np.zeros(8, np.int16), device="cpu")


def test_cli_bench_on_cpu_refuses(tmp_path):
    write_wav(tmp_path / "in.wav", np.zeros(64, np.int16), 8000, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([str(tmp_path / "in.wav"), "4", "--bench", "--device", "cpu"])
