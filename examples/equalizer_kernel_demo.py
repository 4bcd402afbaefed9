"""Equalizer kernel demo: adaptive 2x2 equalization + carrier recovery.

- ``mimo_eq_pallas`` — the per-symbol 2x2 adaptive equalizer recurrence
  (lms / nlms / cma / rde update rules) as one Pallas kernel launch, the
  taps held in registers for the whole stage. On a GPU it runs compiled;
  on the CPU (``--cpu``, or no GPU) it runs in the Pallas interpreter, as
  the platform table :mod:`opticommpy_tpu.backend` says.
- ``bps`` and ``ddpll`` — blind phase search and the decision-directed PLL,
  plain XLA.

Counterpart of the reference's mimoAdaptEqualizer/cpr examples
(optic/examples, equalization.py:125, carrierRecovery.py:37).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="run on the CPU (equalizer kernel interpreted)")
args = parser.parse_args()
if args.cpu:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from opticommpy_tpu.comm.modulation import gray_mapping  # noqa: E402
from opticommpy_tpu.backend import implementation  # noqa: E402
from opticommpy_tpu.dsp import bps, ddpll, mimo_eq_pallas  # noqa: E402
from opticommpy_tpu.ops import fir_filter, pnorm, pulse_shape, upsample  # noqa: E402

interp = implementation() != "kernel"

# --- 16-QAM pol-mux signal with polarization mixing ------------------------
n_sym, sps = 12000, 2
key = jax.random.PRNGKey(0)
const = gray_mapping(16, "qam")
const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
symb = jnp.asarray(const)[jax.random.randint(key, (n_sym, 2), 0, 16)]
pulse = jnp.asarray(pulse_shape("rrc", sps, 256, 0.1))
sig = pnorm(fir_filter(pulse, upsample(symb, sps)))
theta = 0.3
J = jnp.array([[np.cos(theta), np.sin(theta)], [-np.sin(theta), np.cos(theta)]],
              dtype=jnp.complex64)
mixed = pnorm(sig @ J.T)

# --- adaptive equalization: blind CMA, then data-aided LMS -----------------
for alg, ref, mu in [("cma", None, 8e-3), ("lms", symb, 2e-3)]:
    y, H = mimo_eq_pallas(mixed, ref, const, alg=alg, n_taps=15, sps=sps,
                          mu=mu, n_train=8000, interpret=interp)
    y = np.asarray(y)
    if ref is None:
        radii = np.unique(np.round(np.abs(const), 6))
        err = np.mean(np.min(np.abs(np.abs(y[-3000:, :, None]) - radii), -1) ** 2)
        print(f"{alg:4s}: tail radius MSE {err:.4f}")
    else:
        err = np.mean(np.abs(y[-3000:] - np.asarray(symb[-3000:])) ** 2)
        print(f"{alg:4s}: tail MSE {err:.4f}")

# --- carrier recovery on a phase-noisy symbol stream -----------------------
lw, ts = 100e3, 1 / 32e9
pn = jnp.cumsum(
    jax.random.normal(jax.random.PRNGKey(1), (n_sym, 2))
    * np.sqrt(2 * np.pi * lw * ts),
    axis=0,
)
noisy = symb * jnp.exp(1j * pn)

phi_bps = bps(noisy, 16, jnp.asarray(const), 32)
rot = np.asarray(noisy * jnp.exp(1j * jnp.asarray(phi_bps)))
# BPS phase is mod pi/2: fold the residual per symbol before scoring
amb = np.round(np.angle(rot / np.asarray(symb)) / (np.pi / 2)) * (np.pi / 2)
evm_bps = np.mean(np.abs(rot * np.exp(-1j * amb) - np.asarray(symb)) ** 2)
print(f"bps : residual EVM {evm_bps:.4f}")

phi_pll = ddpll(noisy, ts, 0.05, 1 / (2 * np.pi * 10e6),
                1 / (2 * np.pi * 10e6), jnp.asarray(const))
rot = np.asarray(noisy * jnp.exp(1j * jnp.asarray(phi_pll)))
amb = np.round(np.angle(rot / np.asarray(symb)) / (np.pi / 2)) * (np.pi / 2)
evm_pll = np.mean(np.abs(rot * np.exp(-1j * amb) - np.asarray(symb)) ** 2)
print(f"pll : residual EVM {evm_pll:.4f}")
