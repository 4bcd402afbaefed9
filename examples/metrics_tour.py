"""Performance-metrics tour: Monte-Carlo BER/GMI/MI/EVM vs. theory, plus the
GN-model OSNR estimators.

JAX analog of the reference example ``test_metrics.ipynb``
(metrics.py:111,329,429,572,640,917,942). All Monte-Carlo sweeps run as one
jitted, vmapped program per format family — the SNR axis is a batch axis on
the accelerator instead of a Python loop. Saves ``metrics_tour.png``.

Usage: python examples/metrics_tour.py [--cpu]
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
import jax
import jax.numpy as jnp

from opticommpy_tpu.comm.metrics import (
    calc_evm,
    calc_lin_osnr,
    fast_ber_calc,
    gn_model_osnr,
    monte_carlo_gmi,
    monte_carlo_mi,
    theory_ber,
)
from opticommpy_tpu.comm.modulation import gray_mapping, modulate_gray
from opticommpy_tpu.comm.sources import bit_source
from opticommpy_tpu.ops import pnorm

N_SYMBOLS = 60_000
EBN0_DB = np.arange(0, 27, 1.0)


def awgn_sweep(M, const_type, snr_db_axis, seed):
    """Transmit one random symbol sequence; add noise at every SNR at once."""
    k = int(np.log2(M))
    bits = bit_source(seed, n_bits=N_SYMBOLS * k)
    tx = pnorm(modulate_gray(bits, M, const_type))

    @jax.jit
    def add_noise(snrs_db):
        key = jax.random.PRNGKey(seed + 1)
        noise = jax.random.normal(key, (snrs_db.size, tx.size, 2))
        noise = noise[..., 0] + 1j * noise[..., 1]
        sigma = jnp.sqrt(0.5 * 10 ** (-snrs_db / 10))
        return tx[None, :] + sigma[:, None] * noise

    return tx, add_noise(jnp.asarray(snr_db_axis))


# --- BER vs Eb/N0 for three format families --------------------------------
fig, axes = plt.subplots(2, 2, figsize=(12, 9))

families = [("qam", [4, 16, 64]), ("psk", [4, 8, 16]), ("pam", [2, 4, 8])]
for (const_type, orders), ax in zip(families, axes.flat[:3]):
    for M in orders:
        k = int(np.log2(M))
        snr_db = EBN0_DB + 10 * np.log10(k)
        tx, rx = awgn_sweep(M, const_type, snr_db, seed=M)
        ber = np.array([fast_ber_calc(r, tx, M, const_type)[0][0] for r in rx])
        ber[ber == 0] = np.nan
        th = theory_ber(M, EBN0_DB, const_type)
        (line,) = ax.semilogy(EBN0_DB, th, "-", lw=1.5,
                              label=f"{M}-{const_type.upper()} theory")
        ax.semilogy(EBN0_DB, ber, "o", ms=3, color=line.get_color(),
                    label=f"{M}-{const_type.upper()} MC")
        print(f"{const_type:4s} M={M:3d}: max |MC-theory| rel err (BER>1e-4): "
              f"{np.nanmax(np.abs(ber - th) / th * (th > 1e-4)):.2f}")
    ax.set_xlabel("Eb/N0 [dB]"), ax.set_ylabel("BER")
    ax.set_ylim(1e-5, 0.5), ax.grid(True, which="both", alpha=0.3)
    ax.legend(fontsize=7)

# --- GMI / MI vs SNR for QAM ------------------------------------------------
ax = axes.flat[3]
snr_axis = np.arange(0, 30, 1.0)
for M in [4, 16, 64]:
    tx, rx = awgn_sweep(M, "qam", snr_axis, seed=1000 + M)
    gmi = np.array([monte_carlo_gmi(r, tx, M, "qam")[0][0] for r in rx])
    mi = np.array([monte_carlo_mi(r, tx, M, "qam")[0] for r in rx])
    (line,) = ax.plot(snr_axis, gmi, "-", label=f"{M}QAM GMI")
    ax.plot(snr_axis, mi, "--", color=line.get_color(), label=f"{M}QAM MI")
    assert gmi[-1] > 0.99 * np.log2(M), "GMI must saturate at log2(M)"
ax.plot(snr_axis, np.log2(1 + 10 ** (snr_axis / 10)), "k:", label="Shannon")
ax.set_xlabel("SNR [dB]"), ax.set_ylabel("bits/symbol")
ax.grid(True, alpha=0.3), ax.legend(fontsize=7)

fig.tight_layout()
fig.savefig(os.path.join(os.path.dirname(__file__), "metrics_tour.png"),
            dpi=110)
print("saved metrics_tour.png")

# --- EVM sanity: EVM(dB) ~ -SNR(dB) for data-aided QAM ----------------------
tx, rx = awgn_sweep(16, "qam", np.array([20.0]), seed=7)
evm = float(calc_evm(rx[0], 16, "qam", symb_tx=tx)[0])
print(f"EVM @ 20 dB SNR: {10 * np.log10(evm):.2f} dB (expected ~ -20 dB)")

# --- GN-model OSNR prediction (metrics.py:917) ------------------------------
ptx = np.arange(-10, 4.5, 0.5)
osnr, p_nli, p_ase = gn_model_osnr(32e9, 80, 37.5e9, ptx, ltotal=800, l_span=50)
osnr_db = 10 * np.log10(osnr)
best = ptx[np.argmax(osnr_db)]
print(f"GN model, 80ch Nyquist-WDM, 800 km: optimum launch power "
      f"{best:.1f} dBm, peak OSNR {np.max(osnr_db):.2f} dB")

# --- multi-span linear OSNR evolution (metrics.py:942) ----------------------
osnr_per_span = calc_lin_osnr(14, 0.0, 0.2, 50, 40.0, nf_db=4.5)
print(f"linear OSNR after 14x50 km spans (NF 4.5 dB): "
      f"{osnr_per_span[-1]:.2f} dB")
