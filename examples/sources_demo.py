"""Bit and symbol sources: random/PRBS bits, uniform vs. Maxwell-Boltzmann
shaped symbols, and the Zadoff-Chu CAZAC sequence.

JAX analog of the reference example ``test_sources.ipynb``
(sources.py:23,75,137,215). Saves ``sources_demo.png``.

Usage: python examples/sources_demo.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from opticommpy_tpu.comm.sources import (
    bit_source,
    cazac_sequence,
    symbol_pmf,
    symbol_source,
)

N_BITS = 200_000

# --- random vs PRBS bit sources ---------------------------------------------
bits_rand = np.asarray(bit_source(123, n_bits=N_BITS, mode="random"))
bits_prbs = np.asarray(bit_source(0, n_bits=N_BITS, mode="prbs", order=23))

print(f"random bits : mean {bits_rand.mean():.4f} (expect ~0.5)")
print(f"PRBS-23 bits: mean {bits_prbs.mean():.4f} (expect ~0.5)")

# PRBS determinism & periodicity: order-7 sequence repeats with period 2^7-1
p7 = np.asarray(bit_source(0, n_bits=4 * 127, mode="prbs", order=7))
assert np.array_equal(p7[:127], p7[127:254]), "PRBS-7 must have period 127"
print("PRBS-7 period check: 127 samples (LFSR maximal length) OK")

fig, axes = plt.subplots(2, 2, figsize=(11, 8))

# autocorrelation of the PRBS (+-1 mapped) — impulse-like
x = 2.0 * bits_prbs[:50_000] - 1
ac = np.correlate(x, x, mode="same") / x.size
mid = ac.size // 2
axes[0, 0].plot(np.arange(-200, 201), ac[mid - 200:mid + 201])
axes[0, 0].set_title("PRBS-23 autocorrelation (impulse-like)")
axes[0, 0].set_xlabel("lag [bits]")

# --- shaped vs uniform symbol sources ---------------------------------------
M = 256
symb_uni = np.asarray(symbol_source(7, n_symbols=40_000, M=M, const_type="qam"))
symb_mb = np.asarray(symbol_source(7, n_symbols=40_000, M=M, const_type="qam",
                                   dist="maxwell-boltzmann",
                                   shaping_factor=0.08))
px = symbol_pmf(M, "qam", "maxwell-boltzmann", shaping_factor=0.08)
entropy = -np.sum(px * np.log2(px))
print(f"Maxwell-Boltzmann {M}QAM source entropy: {entropy:.2f} bits "
      f"(uniform = {np.log2(M):.0f})")
assert entropy < np.log2(M)

for ax, symb, name in [(axes[0, 1], symb_uni, "uniform"),
                       (axes[1, 0], symb_mb, "Maxwell-Boltzmann")]:
    ax.hexbin(symb.real, symb.imag, gridsize=60, cmap="turbo")
    ax.set_title(f"{M}QAM, {name} (unit mean energy)")
    ax.set_aspect("equal")

# --- Zadoff-Chu CAZAC sequence ----------------------------------------------
N = 10_000
z = np.asarray(cazac_sequence(N, M=1))
assert np.allclose(np.abs(z), 1.0, atol=1e-5), "CAZAC is constant amplitude"
ac = np.abs(np.correlate(z, z, mode="full")) / N
lags = np.arange(-N + 1, N)
axes[1, 1].plot(lags, ac)
axes[1, 1].set_title("Zadoff-Chu |autocorrelation| (zero off-peak)")
axes[1, 1].set_xlabel("lag [samples]")
print(f"CAZAC off-peak autocorrelation max: "
      f"{np.max(ac[np.abs(lags) > 0]):.2e} (peak = 1)")

fig.tight_layout()
fig.savefig(os.path.join(os.path.dirname(__file__), "sources_demo.png"),
            dpi=110)
print("saved sources_demo.png")
