"""Modulation formats: Gray-mapped constellations through an AWGN channel,
with density / decision-colored / decision-boundary constellation plots.

JAX analog of the reference example ``test_modulation.ipynb``
(modulation.py:334,369; plot.py:38,217,288). Saves
``modulation_formats.png``.

Usage: python examples/modulation_formats.py [--cpu]
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

from opticommpy_tpu.comm.metrics import fast_ber_calc, theory_ber
from opticommpy_tpu.comm.modulation import (
    demodulate_gray,
    gray_mapping,
    modulate_gray,
)
from opticommpy_tpu.comm.sources import bit_source
from opticommpy_tpu.models.channels import AWGNConfig, awgn
from opticommpy_tpu.ops import pnorm
from opticommpy_tpu.plot import pconst, plot_colored_const, plot_decision_boundaries
from opticommpy_tpu.utils.units import db2lin

M = 64
CONST_TYPE = "apsk"  # 'qam', 'psk', 'apsk', 'pam' or 'ook'
SNR_DB = 25.0
N_BITS = int(np.log2(M)) * 50_000

# --- modulate -> AWGN -> demodulate -----------------------------------------
bits = bit_source(42, n_bits=N_BITS)
symb_tx = pnorm(modulate_gray(bits, M, CONST_TYPE))
symb_rx = awgn(symb_tx, jax.random.PRNGKey(7), AWGNConfig(snr=SNR_DB))

bits_rx = demodulate_gray(pnorm(symb_rx), M, CONST_TYPE)
ber_hard = float(np.mean(np.asarray(bits) != np.asarray(bits_rx)))
ber, ser, snr_est = fast_ber_calc(symb_rx, symb_tx, M, CONST_TYPE)
ebn0_db = SNR_DB - 10 * np.log10(np.log2(M))
print(f"{M}-{CONST_TYPE.upper()} @ SNR {SNR_DB} dB:")
print(f"  estimated SNR   : {float(snr_est[0]):.2f} dB")
print(f"  BER (hard)      : {ber_hard:.2e}")
print(f"  BER (fastBER)   : {float(ber[0]):.2e}   SER: {float(ser[0]):.2e}")
if CONST_TYPE in ("qam", "psk", "pam"):
    print(f"  BER (theory)    : {theory_ber(M, ebn0_db, CONST_TYPE):.2e}")
assert float(snr_est[0]) > SNR_DB - 1.0, "SNR estimate must track the channel"

# --- constellation figures ---------------------------------------------------
const = np.asarray(pnorm(gray_mapping(M, CONST_TYPE)))
noise_var = 1.0 / db2lin(SNR_DB)

fig, axes = plt.subplots(1, 3, figsize=(15, 4.6))
pconst(symb_rx, ax=axes[0], density=True,
       r=1.5 * np.max(np.abs(const)))
axes[0].set_title(f"{M}-{CONST_TYPE.upper()} received (density)")

plot_colored_const(symb_rx, M, CONST_TYPE, noise_var=noise_var, rule="MAP",
                   ax=axes[1])
axes[1].set_title("colored by MAP decision")

plot_decision_boundaries(M, CONST_TYPE, noise_var=noise_var, rule="MAP",
                         ax=axes[2])
axes[2].plot(np.asarray(symb_rx[:2000]).real, np.asarray(symb_rx[:2000]).imag,
             "k.", ms=1.5)
axes[2].set_title("MAP decision boundaries")

fig.tight_layout()
fig.savefig(os.path.join(os.path.dirname(__file__),
                         "modulation_formats.png"), dpi=110)
print("saved modulation_formats.png")
