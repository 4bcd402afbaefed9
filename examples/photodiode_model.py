"""Pin photodiode model: noise regimes and receiver sensitivity.

JAX analog of the reference ``test_photodiode_model.ipynb``: a 10G OOK
signal is detected by the pin photodiode model (``models.devices.photodiode``,
reference devices.py:289) under four noise configurations — ideal, thermal
noise only, shot noise only, and both — and the resulting Q-factor is swept
against received optical power. The crossover from the thermal-limited to the
shot-limited regime appears as the shot-only curve overtaking thermal-only at
high power.

Usage: python examples/photodiode_model.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import dataclasses

import jax
import jax.numpy as jnp
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from opticommpy_tpu.comm import bit_source, modulate_gray
from opticommpy_tpu.comm.metrics import bert
from opticommpy_tpu.models import MZMConfig, PhotodiodeConfig, mzm, photodiode
from opticommpy_tpu.ops import fir_filter, pulse_shape, upsample
from opticommpy_tpu.utils import dbm2w

SPS, RS = 16, 10e9
FS = RS * SPS
N_BITS = 60_000

CONFIGS = {
    "ideal": PhotodiodeConfig(ideal=True),
    "thermal only": PhotodiodeConfig(B=RS, Fs=FS, shotNoise=False),
    "shot only": PhotodiodeConfig(B=RS, Fs=FS, thermalNoise=False),
    "shot + thermal": PhotodiodeConfig(B=RS, Fs=FS),
}


def main():
    key = jax.random.PRNGKey(0)
    k_bits, k_pd = jax.random.split(key)
    bits = bit_source(k_bits, N_BITS, "random")
    symb = modulate_gray(bits, 2, "pam")
    sig = fir_filter(jnp.asarray(pulse_shape("nrz", SPS)), upsample(symb, SPS))
    sig = sig / jnp.max(jnp.abs(sig))
    mzm_cfg = MZMConfig(Vpi=2.0, Vb=-1.0)

    powers_dbm = np.arange(-30.0, -5.0, 2.0)
    plt.figure()
    for name, pd_cfg in CONFIGS.items():
        qs = []
        for i, p in enumerate(powers_dbm):
            e_in = jnp.sqrt(dbm2w(p)) * jnp.ones_like(sig)
            e_tx = mzm(e_in, sig, mzm_cfg)
            i_rx = photodiode(e_tx, pd_cfg, jax.random.fold_in(k_pd, i))
            _, q = bert(i_rx[0::SPS], bits)
            qs.append(float(q))
        plt.plot(powers_dbm, 20 * np.log10(np.maximum(qs, 1e-2)), "-o",
                 label=name)
        print(f"{name:>15}: Q @ {powers_dbm[0]:.0f} dBm = {qs[0]:.2f}, "
              f"@ {powers_dbm[-1]:.0f} dBm = {qs[-1]:.2f}")
    plt.grid()
    plt.xlabel("received power [dBm]")
    plt.ylabel("20 log10(Q) [dB]")
    plt.legend()
    plt.title("pin photodiode noise regimes (10G OOK)")
    plt.savefig("photodiode_regimes.png", dpi=120, bbox_inches="tight")
    print("saved photodiode_regimes.png")


if __name__ == "__main__":
    main()
