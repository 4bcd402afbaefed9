"""Data-sequence synchronization: align a delayed, repeated received signal
with the transmitted reference waveform/symbols.

JAX analog of the reference example ``test_sequence_synchronizer.ipynb``
(synchronization.py:30). Saves ``sequence_synchronizer.png``.

Usage: python examples/sequence_synchronizer.py [--cpu]
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

from opticommpy_tpu.dsp import SyncConfig, sync_data_sequences
from opticommpy_tpu.models.tx import PAMTxConfig, pam_transmitter
from opticommpy_tpu.ops import finddelay, pnorm

# --- generate a 2-pol PAM test signal --------------------------------------
cfg_tx = PAMTxConfig(M=8, SpS=2, nBits=12000, pulseType="nrz", nPolModes=2)
sig, symb = pam_transmitter(123, cfg_tx)
sig = np.asarray(sig)
symb = np.asarray(symb)

# direct-detected envelope (the reference squares and removes DC)
env = np.abs(sig) ** 2
env = np.asarray(pnorm(env - np.mean(env, axis=0)))

# --- emulate a free-running receiver: repeat, delay per mode, crop ---------
rep = np.tile(env, (23, 1))
delays = [179, 53]  # samples
for k, d in enumerate(delays):
    rep[:, k] = np.roll(rep[:, k], d)
rep = rep[:-332]

# --- synchronize against the known symbol sequence -------------------------
cfg = SyncConfig(SpS=cfg_tx.SpS, reference="symbols", syncMode="amp",
                 pulseType="nrz", M=cfg_tx.M, constType="pam")
ref_wave, ref_symb = sync_data_sequences(rep, symb, cfg)
ref_wave = np.asarray(ref_wave)

# after sync the reference waveform should align with the received signal
for k, d in enumerate(delays):
    resid = int(finddelay(rep[:, k], ref_wave[:, k]))
    print(f"mode {k}: inserted delay {d} samples -> residual after sync: "
          f"{resid} samples")

fig, axes = plt.subplots(2, 1, figsize=(10, 5), sharex=True)
n_show = 50 * cfg.SpS
for k in range(2):
    axes[k].plot(pnorm(rep[:n_show, k]), "-", label="received (delayed)")
    axes[k].plot(pnorm(ref_wave[:n_show, k]), "--",
                 label="synchronized reference")
    axes[k].set_title(f"polarization {k}")
    axes[k].legend(fontsize=8)
fig.tight_layout()
fig.savefig(os.path.join(os.path.dirname(__file__),
                         "sequence_synchronizer.png"), dpi=110)
print("saved sequence_synchronizer.png")
