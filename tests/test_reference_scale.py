"""Reference-scale BER/GMI regression pins (VERDICT r1 item 3).

Runs the 11-channel WDM polmux chain and the DBP chain at the reference
notebook scale (`/root/reference/examples/test_WDM_transmission.ipynb` /
`test_NLC_withDBP_WDM_transmission.ipynb` workload shapes) and asserts the
committed physics numbers. Pinned from a full-scale run of this repo
(2026-08-20, CPU mesh):

- wdm_11ch_transmission (11ch 16-QAM polmux, 500 km, 32768 sym/pol):
    BER   ~ [1.61e-4, 1.87e-4]
    SNR   ~ [18.45, 18.25] dB
    GMI   ~ [3.997, 3.997] bits  (NGMI ~ 0.9993)
- nlc_dbp_transmission: DBP recovers >= 8 dB SNR over EDC at 2 dBm
  (22.31 -> 32.94 dB) and holds BER 0 through 6 dBm.

A physics drift beyond the tolerances below fails this test.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

EXAMPLES_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def _run(name, timeout=900):
    env = dict(os.environ)
    env.update(MPLBACKEND="Agg")
    env.pop("OPTICOMMPY_FAST", None)  # full notebook scale
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES_DIR, name), "--cpu"],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=EXAMPLES_DIR)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    return proc.stdout


def _floats(line):
    return [float(v) for v in re.findall(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?",
                                         line)]


@pytest.mark.slow
def test_wdm_11ch_full_scale_ber_gmi():
    out = _run("wdm_11ch_transmission.py")
    ber = snr = gmi = None
    for line in out.splitlines():
        if "BER" in line:
            ber = _floats(line)
        elif "SNR" in line:
            snr = _floats(line)[:2]
        elif "GMI" in line:
            vals = _floats(line)
            gmi, ngmi = vals[:2], vals[2:4]
    assert ber is not None and snr is not None and gmi is not None, out
    # pinned 2026-08-20: BER [1.61e-4, 1.87e-4], SNR [18.45, 18.25] dB,
    # GMI [3.9974, 3.9970], NGMI ~0.9993. BER band ~2x around the pin
    # (VERDICT r3 item 8: the old [0.3e-4, 5e-4] band let a 2.5x BER
    # regression pass); at 32768 sym/pol x 4 bit, 1.6e-4 is ~21 bit
    # errors, so a 2x band is ~5 sigma of binomial counting noise.
    for b in ber:
        assert 0.8e-4 < b < 3.6e-4, (ber, out)
    assert np.allclose(snr, [18.45, 18.25], atol=0.4), snr
    assert np.allclose(gmi, [3.9974, 3.9970], atol=0.01), gmi
    assert all(v > 0.998 for v in ngmi), ngmi


@pytest.mark.slow
def test_dbp_full_scale_snr_gain():
    out = _run("nlc_dbp_transmission.py")
    rows = []
    for line in out.splitlines():
        vals = _floats(line)
        if len(vals) == 5 and -3 <= vals[0] <= 7:
            rows.append(vals)
    assert len(rows) >= 4, out
    table = {p: (s_edc, s_dbp, b_edc, b_dbp)
             for p, s_edc, s_dbp, b_edc, b_dbp in rows}
    # pinned 2026-08-20: at 2 dBm EDC 22.31 dB / DBP 32.94 dB
    s_edc, s_dbp, _, b_dbp = table[2.0]
    assert abs(s_edc - 22.31) < 0.5, table
    assert s_dbp - s_edc >= 8.0, table
    assert b_dbp == 0.0, table
    # DBP-chain GMI pin (VERDICT r3 item 8): 16-QAM error-free through
    # 6 dBm => saturated GMI (pinned full-scale 2026-08-21: 4.0000 bits
    # at every power)
    gmis = {}
    for line in out.splitlines():
        if line.startswith("GMI_DBP"):
            v = _floats(line)
            gmis[v[0]] = v[1]
    assert gmis, out
    assert gmis[2.0] >= 3.99, gmis
    assert all(g >= 3.95 for g in gmis.values()), gmis
    # DBP keeps the link error-free through 6 dBm
    for p, (_, _, _, bd) in table.items():
        if p <= 6.0:
            assert bd < 1e-4, table
