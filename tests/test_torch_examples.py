"""The port's twelve examples (``digital_signal_processsing_tpu_torch/examples``)
run in-process on the CPU with ``--device cpu``: each exits 0 and prints no
``MISS``, as ``tests/test_examples.py`` requires of the reference's scripts.
Their default device is the card, which raises here; an anchor that misses
prints ``MISS`` and makes the exit code non-zero.
"""

import importlib
import tempfile

import numpy as np
import pytest
import torch

from digital_signal_processsing_tpu_torch.examples import NAMES
from digital_signal_processsing_tpu_torch.examples import qam_link as qam_example


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # where audio_timestretch writes
    module = importlib.import_module(f"digital_signal_processsing_tpu_torch.examples.{name}")
    rc = module.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "MISS" not in out
    assert out.strip()


def test_every_reference_example_has_a_counterpart():
    from pathlib import Path

    ref = sorted(p.stem for p in (Path(__file__).parents[1] / "examples").glob("*.py"))
    assert sorted(NAMES) == ref


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qam_example.main([])


def test_a_missed_anchor_exits_non_zero(capsys, monkeypatch):
    real = qam_example.modem.receive

    def flipped(*args, **kw):
        bits, diag = real(*args, **kw)
        return 1 - bits, diag

    monkeypatch.setattr(qam_example.modem, "receive", flipped)
    assert qam_example.main(["--device", "cpu"]) == 1
    assert "MISS" in capsys.readouterr().out


def test_audio_timestretch_reads_a_given_file(capsys, tmp_path, monkeypatch):
    from digital_signal_processsing_tpu_torch.examples import audio_timestretch
    from digital_signal_processsing_tpu_torch.io import read_wav, write_wav

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    t = np.arange(8192)
    write_wav(tmp_path / "in.wav", (8000 * np.sin(0.05 * t)).astype(np.int16), 8000, 1)
    assert audio_timestretch.main([str(tmp_path / "in.wav"), "--device", "cpu"]) == 0
    assert f"in: {tmp_path / 'in.wav'} (8192 samples @ 8000 Hz)" in capsys.readouterr().out
    for name in ("slow2x", "fast2x", "fifth_up"):
        info, y = read_wav(tmp_path / f"vocoder_{name}.wav")
        assert info.sample_rate == 8000 and y.size > 0
