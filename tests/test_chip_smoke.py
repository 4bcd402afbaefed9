"""chip_smoke.py: its refusals, and its phases rehearsed on the CPU.

On the card the script runs the main path at full size; here every phase
runs at a tiny size (the equalizer kernel in the Pallas interpreter) so a
wrong path, argument or check shows before any card time is spent.
"""

import json
import os
import shutil
import subprocess
import sys

import jax

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except json.JSONDecodeError:
        return False


def test_exits_nonzero_without_gpu():
    proc = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert "needs a CUDA GPU" in proc.stderr
    assert not _has_result(proc.stdout)


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


def test_main_path_rehearsal_tiny():
    """Stages 1-5 with every check, at TINY sizes on the CPU."""
    chip_smoke.run_main_path(chip_smoke.TINY, seed=0, interpret=True)


def test_four_device_rehearsal_tiny():
    """The --four path on four of the suite's virtual CPU devices."""
    assert len(jax.devices()) >= 4
    chip_smoke.run_four(chip_smoke.TINY, seed=0)


def test_check_raises_on_failure():
    """A failed check is kept and fails the run at raise_if_failed."""
    import pytest

    chip_smoke.check(True, "passes")
    chip_smoke.raise_if_failed()
    chip_smoke.check(False, "boom")
    chip_smoke.check(True, "later check still runs")
    with pytest.raises(chip_smoke.CheckFailed, match="1 check.*boom"):
        chip_smoke.raise_if_failed()
    chip_smoke.raise_if_failed()  # the failure is reported once


def test_sizes_match_the_main_path():
    """FULL is the workload the docs promise: 11 channels, 2^20 samples
    (2^16 symbols at 16 SpS), 5 x 50 km at hz 0.5 km, 64 served
    codewords at batch 8."""
    s = chip_smoke.FULL
    assert (s.n_channels, s.n_samples, s.n_spans, s.hz) == (11, 2**20, 5,
                                                            0.5)
    assert s.n_samples // chip_smoke.SPS == 2**16
    assert s.serve_batch * (s.serve_symbols * 2 * 4 // 64800) == 64
