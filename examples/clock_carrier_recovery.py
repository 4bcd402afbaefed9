"""Clock and carrier recovery: Gardner NCO retiming + BPS/DD-PLL phase tracking.

Counterpart of the reference's ``test_clockRecovery.ipynb`` and
``test_carrierPhaseRecovery.ipynb``: a QPSK/16-QAM signal is impaired with a
200 ppm sampling-clock offset, laser phase noise, and a residual carrier
frequency offset; the DSP chain then runs Gardner clock recovery
(clockRecovery.py:85), 4th-power FOE (carrierRecovery.py:331), and carrier
phase recovery (bps/ddpll via the cpr dispatcher, carrierRecovery.py:37).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true")
args = parser.parse_args()
if args.cpu:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from opticommpy_tpu.comm import modulate_gray  # noqa: E402
from opticommpy_tpu.dsp import CPRConfig, cpr  # noqa: E402
from opticommpy_tpu.dsp.clock_recovery import (  # noqa: E402
    ClockRecoveryConfig,
    calc_clock_drift,
    gardner_clock_recovery,
)
from opticommpy_tpu.ops import (  # noqa: E402
    clock_sampling_interp,
    fir_filter,
    phase_noise,
    pnorm,
    pulse_shape,
    upsample,
)

rs, sps = 32e9, 2
n_sym = 16000
rng = np.random.default_rng(3)

# --- clock recovery --------------------------------------------------------
symb = pnorm(modulate_gray(jnp.asarray(rng.integers(0, 2, 2 * n_sym)), 4, "qam"))
pulse = jnp.asarray(pulse_shape("rrc", sps, 513, 0.2))  # ODD taps: no half-sample shift (CLAUDE.md gotcha)
sig = fir_filter(pulse, upsample(symb, sps))
ppm_true = 200e-6
sig_off = clock_sampling_interp(sig, 1.0, 1.0 / (1 + ppm_true))

rec, timing = gardner_clock_recovery(
    sig_off, ClockRecoveryConfig(kp=2e-3, ki=1e-5, isNyquist=False),
    return_timing=True,
)
ppm_est = calc_clock_drift(np.asarray(timing))
est = float(np.ravel(ppm_est)[0])
print(f"clock recovery: applied {1e6*ppm_true:.0f} ppm sampling offset, "
      f"NCO tracked {abs(est):.0f} ppm (sign = NCO correction direction)")

# --- feedforward clock recovery (no recurrence) ----------------------------
from opticommpy_tpu.dsp.clock_recovery import (  # noqa: E402
    FFWClockRecoveryConfig,
    ffw_clock_recovery,
)

rec_f, (ppm_f, _) = jax.jit(
    lambda s: ffw_clock_recovery(
        s, FFWClockRecoveryConfig(rollOff=0.2), return_est=True))(sig_off)
err = np.mean(np.abs(np.asarray(rec_f)[64:-64]
                     - np.asarray(sig)[64:rec_f.shape[0] - 64]) ** 2)
err /= np.mean(np.abs(np.asarray(sig)) ** 2)
print(f"feedforward clock recovery: estimated {float(ppm_f):+.1f} ppm "
      f"(block spectral-line estimator, parallel resampler; residual "
      f"{10*np.log10(err):.1f} dB vs the clean waveform — dominated by the "
      f"impairment model's own linear interpolation, not the estimator)")

# --- carrier recovery ------------------------------------------------------
n2 = 20000
symb16 = pnorm(modulate_gray(jnp.asarray(rng.integers(0, 2, 4 * n2)), 16, "qam"))
lw, ts = 100e3, 1 / rs
pn = phase_noise(jax.random.PRNGKey(9), lw, n2, ts)
foff = 50e6
rx = symb16 * jnp.exp(1j * (pn + 2 * np.pi * foff * jnp.arange(n2) * ts))

for alg in ("bps", "ddpll"):
    out = cpr(rx, CPRConfig(alg=alg, M=16, B=64, N=35, Ts=ts, runFOE=True),
              symb_tx=symb16)
    out = np.asarray(out)
    ref = np.asarray(pnorm(symb16))
    # fold the 4-fold phase ambiguity per block before scoring
    amb = np.round(np.angle(np.mean(out[100:] / ref[100:])) / (np.pi / 2))
    evm = np.mean(np.abs(out[100:] * np.exp(-1j * amb * np.pi / 2) - ref[100:]) ** 2)
    print(f"cpr[{alg}]: residual EVM {evm:.4f} "
          f"(linewidth {lw/1e3:.0f} kHz, FO {foff/1e6:.0f} MHz)")
