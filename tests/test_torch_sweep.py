"""The port's variant zoo, sweep driver and CLI switches against the JAX package's.

The sweep times a card, so here ``time_phases`` is replaced by a test
double in both packages: the grid logic (skip rules, variants, tile axis,
CSV rows) runs without one, and the port's double also calls each timed
function on a CPU tensor and holds it to the golden model.
"""

import numpy as np
import pytest
import torch

import digital_signal_processsing_tpu.harness.profile as jax_profile
from digital_signal_processsing_tpu.__main__ import main as jax_cli
from digital_signal_processsing_tpu.harness import sweep as jax_sweep
from digital_signal_processsing_tpu.models.averager_zoo import AVERAGER_ZOO as JAX_ZOO
from digital_signal_processsing_tpu_torch.__main__ import main as port_cli
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.harness import CSV_COLUMNS, ProfileResult
from digital_signal_processsing_tpu_torch.harness import sweep
from digital_signal_processsing_tpu_torch.io import read_wav, write_wav
from digital_signal_processsing_tpu_torch.models import AVERAGER_ZOO, run_variant
from digital_signal_processsing_tpu_torch.ops import moving_average
from tests.conftest import make_interleaved


def fixed_result() -> ProfileResult:
    res = ProfileResult(initialization_ms=5.0)
    res.accumulate(1.0, 2.0, 3.0)
    return res


def test_zoo_matches_the_reference():
    assert AVERAGER_ZOO.keys() == JAX_ZOO.keys()
    for key, info in AVERAGER_ZOO.items():
        ref = JAX_ZOO[key]
        assert (info.key, info.method, info.reference_files, info.work, info.regime) == (
            ref.key, ref.method, ref.reference_files, ref.work, ref.regime
        )


@pytest.mark.parametrize("key", sorted(JAX_ZOO))
def test_run_variant_equals_moving_average(rng, key):
    x = torch.from_numpy(make_interleaved(rng, 2000, 2))
    got = run_variant(key, x, 33, 2)
    assert torch.equal(got, moving_average(x, 33, 2, method=AVERAGER_ZOO[key].method))
    np.testing.assert_array_equal(got.numpy(), moving_average_golden(x.numpy(), 33, 2))


def test_run_variant_rejects_unknown_keys(rng):
    with pytest.raises(KeyError, match="unknown variant"):
        run_variant("warp", torch.zeros(4, dtype=torch.int16), 2)


def test_sweep_grid_matches_the_reference(monkeypatch, tmp_path):
    checked = []

    def port_time_phases(fn, host_input, *, device, warmup, rounds, resident=False, chain=1):
        assert device == "cpu" and warmup == 1 and rounds == 2 and chain == 1
        channels, window = 2, fn.keywords["window"]
        got = fn(torch.from_numpy(host_input)).numpy()
        np.testing.assert_array_equal(got, moving_average_golden(host_input, window, channels))
        checked.append(resident)
        return fixed_result()

    def jax_time_phases(fn, host_input, **kw):
        return fixed_result()

    monkeypatch.setattr(sweep, "time_phases", port_time_phases)
    monkeypatch.setattr(jax_profile, "time_phases", jax_time_phases)
    grid = dict(sizes=[1000, 5000], grades=[1, 16, 128, 600, 3000], variants=list(sweep.VARIANTS),
                tile_rows_list=[None, 16], warmup=1, rounds=2, verbose=False)
    assert sweep.run_suite(out_csv=str(tmp_path / "port.csv"), device="cpu", **grid) == 0
    assert jax_sweep.run_suite(out_csv=str(tmp_path / "jax.csv"), **grid) == 0

    port_rows = (tmp_path / "port.csv").read_text().splitlines()
    jax_rows = (tmp_path / "jax.csv").read_text().splitlines()
    assert port_rows[0] == jax_rows[0] == CSV_COLUMNS

    def keys(rows):
        # Algorithm, MemoryMode, N_Samples, Grade, BlockSize
        return [tuple(r.split(",")[:5]) for r in rows[1:]]

    assert keys(port_rows) == keys(jax_rows)
    assert all(len(r.split(",")) == 14 for r in port_rows)
    assert sweep.VARIANTS == jax_sweep.VARIANTS
    assert (sweep.DEFAULT_GRADES, sweep.DEFAULT_SIZES, sweep.DEFAULT_TILE_ROWS) == (
        jax_sweep.DEFAULT_GRADES, jax_sweep.DEFAULT_SIZES, jax_sweep.DEFAULT_TILE_ROWS
    )
    # staged and resident rows for every timed configuration; skip rules held
    assert checked.count(False) == checked.count(True) > 0
    grades = {(a, int(k)) for a, _, _, k, _ in keys(port_rows)}
    assert ("direct", 128) not in grades and ("xla_direct", 600) not in grades
    assert not [k for k in keys(port_rows) if k[2] == "1000" and int(k[3]) >= 500]


def test_sweep_counts_failures(monkeypatch, tmp_path, capsys):
    def call_once(fn, host_input, **kw):
        fn(torch.from_numpy(host_input))
        return fixed_result()

    monkeypatch.setattr(sweep, "time_phases", call_once)
    # an explicit tile smaller than the halo: the scan wrapper refuses it
    failures = sweep.run_suite(
        [5000], [600], ["scan", "windowed"], [4], str(tmp_path / "f.csv"), verbose=False,
        device="cpu",
    )
    assert failures == 1
    assert "FAIL scan" in capsys.readouterr().err


def test_sweep_needs_a_card(tmp_path):
    with pytest.raises(SystemExit):
        sweep.main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "x.csv")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep.main(["--smoke", "--out", str(tmp_path / "x.csv")])


@pytest.mark.parametrize("block_size", ["15", "100"])
def test_cli_block_size_must_be_a_multiple_of_16(tmp_path, block_size):
    write_wav(tmp_path / "in.wav", np.zeros(64, np.int16), 8000, 2)
    args = [str(tmp_path / "in.wav"), "4", block_size, "--method", "scan", "--device", "cpu"]
    assert port_cli(args) == 1
    assert jax_cli(args[:-2]) == 1  # the JAX CLI takes no --device


@pytest.mark.parametrize("extra", [[], ["64"]])
def test_cli_scan_byte_identical_to_golden(rng, tmp_path, extra):
    x = rng.integers(-32768, 32768, size=20000, dtype=np.int16)
    write_wav(tmp_path / "in.wav", x, 8000, 2)
    write_wav(tmp_path / "golden.wav", moving_average_golden(x, 16, 2), 8000, 2)
    out = tmp_path / "port.wav"
    assert port_cli([str(tmp_path / "in.wav"), "16", *extra, "--method", "scan",
                     "--out", str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == (tmp_path / "golden.wav").read_bytes()
    assert jax_cli([str(tmp_path / "in.wav"), "16", *extra, "--method", "scan",
                    "--out", str(tmp_path / "jax.wav")]) == 0
    assert out.read_bytes() == (tmp_path / "jax.wav").read_bytes()
    assert read_wav(out)[0].num_channels == 2
