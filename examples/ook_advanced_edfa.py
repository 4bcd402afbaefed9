"""10G OOK receiver pre-amplified by the physical (Giles) EDFA model.

JAX analog of the reference example
``OOK_transmission_with_advanced_EDFA_model.ipynb``: OOK/NRZ transmitter ->
VOA sweep -> stateful EDFA (Giles rate/propagation equations with AGC pump
control, amplification.py:420) -> pin photodiode -> BER vs received power.
The modulation/detection runs jitted; the EDFA BVP solver is host-side by
design (SURVEY.md §7). Saves ``ook_advanced_edfa.png``.

Usage: python examples/ook_advanced_edfa.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from opticommpy_tpu.comm import bit_source, modulate_gray
from opticommpy_tpu.comm.metrics import bert
from opticommpy_tpu.models import MZMConfig, PhotodiodeConfig, mzm, photodiode
from opticommpy_tpu.models.amplification import EDFASMConfig, edfa_sm
from opticommpy_tpu.models.devices import voa
from opticommpy_tpu.ops import fir_filter, pulse_shape, upsample
from opticommpy_tpu.utils import dbm2w

SPS = 8
RS = 10e9
FS = RS * SPS
FC = 193.1e12
N_BITS = 8192
P_LASER_DBM = 0.0

# --- transmitter: OOK / NRZ / MZM (reference notebook, cells 3-5) ----------
key = jax.random.PRNGKey(7)
bits = bit_source(key, N_BITS)
symb = modulate_gray(bits, 2, "ook").real.astype(jnp.float32)
pulse = pulse_shape("nrz", SPS)
u = fir_filter(jnp.asarray(pulse), upsample(symb, SPS))
ai = jnp.sqrt(dbm2w(P_LASER_DBM)) * jnp.ones_like(u) + 0j
tx = mzm(ai, 0.5 * (2 * u - 1), MZMConfig(Vpi=2.0, Vb=-1.0, ER=60))

edfa_cfg = EDFASMConfig(type="AGC", value=20.0, lngth=10.0,
                        forPumpW=(60e-3,), bckPumpW=(0.0,),
                        noiseBand=50e9, tolCtrl=1.0)
pd_cfg = PhotodiodeConfig(Fs=FS, B=10e9)

rx_powers_dbm = np.arange(-40, -24, 3.0)
ber = []
for i, p_rx in enumerate(rx_powers_dbm):
    p_tx = 10 * np.log10(float(jnp.mean(jnp.abs(tx) ** 2)) / 1e-3)
    attenuated = voa(tx, p_tx - p_rx)
    sig2 = np.stack([np.asarray(attenuated),
                     np.zeros_like(np.asarray(attenuated))], axis=1)
    amplified, ppf, _, _ = edfa_sm(sig2, FS, FC, edfa_cfg,
                                   rng=np.random.default_rng(i))
    i_rx = photodiode(jnp.asarray(amplified[:, 0]), pd_cfg,
                      key=jax.random.fold_in(key, i))
    # fir_filter is delay-compensated: symbols sit at phase 0
    i_sym = i_rx[0::SPS][8:-8]
    b, q = bert(i_sym, bits[8:-8][: i_sym.shape[0]])
    gain_db = 10 * np.log10(np.mean(np.abs(amplified[:, 0]) ** 2)
                            / np.mean(np.abs(np.asarray(attenuated)) ** 2))
    ber.append(float(np.asarray(b)))
    print(f"Prx {p_rx:6.1f} dBm | EDFA gain {gain_db:5.2f} dB "
          f"(pump {1e3*float(np.ravel(ppf)[0]):.1f} mW) | "
          f"BER {ber[-1]:.2e} | Q {float(np.asarray(q)):.2f} dB")

fig, ax = plt.subplots(figsize=(6, 4))
ber_arr = np.maximum(np.array(ber), 1e-6)
ax.semilogy(rx_powers_dbm, ber_arr, "-o")
ax.set_xlabel("received power before EDFA preamp [dBm]")
ax.set_ylabel("BER")
ax.grid(True, which="both", alpha=0.4)
ax.set_title("10G OOK with Giles-model EDFA preamp (AGC)")
fig.tight_layout()
fig.savefig(os.path.join(os.path.dirname(__file__), "ook_advanced_edfa.png"),
            dpi=110)
print("saved ook_advanced_edfa.png")
