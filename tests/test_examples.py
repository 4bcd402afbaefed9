"""CI smoke tests: every example script must run end-to-end on CPU.

The reference's examples live only in notebooks with no CI (SURVEY.md §4 —
its own weakness); here each `examples/*.py` is executed as a subprocess
with ``--cpu`` (the CPU, whatever accelerator the machine has) and
``OPTICOMMPY_FAST=1`` (the CI size knob the heavy examples honor), so
any API drift that breaks an example breaks pytest.
"""

import os
import subprocess
import sys

import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
EXAMPLES = sorted(f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py"))


@pytest.mark.slow
@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs(name):
    env = dict(os.environ)
    env.update(MPLBACKEND="Agg", OPTICOMMPY_FAST="1")
    # examples select the CPU platform themselves via --cpu
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, name), "--cpu"],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=EXAMPLES_DIR)
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode}):\n"
        f"--- stdout ---\n{proc.stdout[-3000:]}\n"
        f"--- stderr ---\n{proc.stderr[-3000:]}")
