"""Getting started: the reference's first notebook, written against compat.

This is the migration showcase: the code below is (almost) line-for-line the
reference ``examples/getting_started.ipynb`` — 10 Gb/s NRZ OOK over 100 km
with direct detection — but every ``optic.*`` import is served by
``opticommpy_tpu.compat``, which runs the whole flow through JAX/XLA on
CPU or GPU. The only semantic difference is reproducible randomness: compat
functions take explicit ``seed`` arguments instead of global numpy state.

Usage: python examples/getting_started.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
from scipy.special import erfc

# the reference imports, one-for-one (optic.* -> opticommpy_tpu.compat)
from opticommpy_tpu.compat import (
    anorm,
    bert,
    bitSource,
    dBm2W,
    firFilter,
    linearFiberChannel,
    modulateGray,
    mzm,
    parameters,
    photodiode,
    pulseShape,
    upsample,
)

# simulation parameters (reference getting_started.ipynb values)
SpS = 16  # samples per symbol
M = 2  # modulation order (OOK)
Rs = 10e9  # symbol rate
Fs = SpS * Rs
Pi_dBm = 3  # laser power into the MZM
Pi = dBm2W(Pi_dBm)

# bit source
paramBits = parameters()
paramBits.nBits = 100_000
paramBits.mode = "random"
paramBits.seed = 123

# pulse shaping
paramPulse = parameters()
paramPulse.pulseType = "nrz"
paramPulse.SpS = SpS

# MZM
paramMZM = parameters()
paramMZM.Vpi = 2
paramMZM.Vb = -paramMZM.Vpi / 2

# fiber channel
paramCh = parameters()
paramCh.L = 100  # km
paramCh.alpha = 0.2  # dB/km
paramCh.D = 16  # ps/nm/km
paramCh.Fc = 193.1e12
paramCh.Fs = Fs

# photodiode
paramPD = parameters()
paramPD.ideal = False
paramPD.B = 10e9
paramPD.Fs = Fs
paramPD.seed = 42

print("\nStarting simulation...", end="")

bitsTx = bitSource(paramBits)
symbTx = modulateGray(bitsTx, M, "pam")
symbolsUp = upsample(symbTx, SpS)
pulse = pulseShape(paramPulse)
sigTx = firFilter(pulse, symbolsUp)
sigTx = anorm(sigTx)  # normalize to 1 Vpp

# optical modulation
Ai = np.sqrt(Pi)
sigTxo = mzm(Ai, np.asarray(sigTx), paramMZM)

# fiber + detection
sigCh = linearFiberChannel(sigTxo, paramCh)
I_Rx = photodiode(np.asarray(sigCh), paramPD)
I_Rx = np.asarray(I_Rx)[0::SpS]
print(" done.")

BER, Q = bert(I_Rx)
BER, Q = float(BER), float(Q)
print("\nTransmission performance metrics:")
print(f"Q-factor = {Q:.2f} ")
print(f"BER = {BER:.2e}")
Pb = 0.5 * erfc(Q / np.sqrt(2))
print(f"Pb = {Pb:.2e}\n")

# BER vs received power across distances (the notebook's closing sweep)
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

distances = [100, 120, 140]
powerValues = np.arange(-28, -13, 2.0)
paramPD.B = Rs
markers = ["o", ">", "x"]
plt.figure()
for indL, L in enumerate(distances):
    bers = []
    paramCh.L = float(L)
    for indP, P_dbm in enumerate(powerValues):
        Pi = dBm2W(P_dbm + L * paramCh.alpha + 3)  # power at the MZM input
        sigTxo = mzm(np.sqrt(Pi), np.asarray(sigTx), paramMZM)
        sigCh = linearFiberChannel(sigTxo, paramCh)
        paramPD.seed = 1000 * indL + indP
        I = np.asarray(photodiode(np.asarray(sigCh), paramPD))
        I = I / np.std(I)
        ber, _ = bert(I[0::SpS], bitsTx)
        bers.append(max(float(ber), 1e-6))
    plt.plot(powerValues, np.log10(bers), "--", marker=markers[indL],
             label=f"{L} km")
plt.grid()
plt.xlabel("Prx [dBm]")
plt.ylabel("log10(BER)")
plt.legend()
plt.title("OOK IM-DD: BER vs received power")
plt.savefig("getting_started_ber.png", dpi=120, bbox_inches="tight")
print("saved getting_started_ber.png")
