"""Tour of the DSP core primitives: resampling, clock interpolation with
jitter, quantization, fractional delay, and overlap-save convolution.

JAX analog of the reference example ``test_dsp_core_functions.ipynb``.
Saves ``dsp_core_functions.png``.

Usage: python examples/dsp_core_functions.py [--cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from opticommpy_tpu.ops import (
    clock_sampling_interp,
    delay_signal,
    finddelay,
    fir_filter,
    overlap_save,
    quantizer,
    resample,
)

fig, axes = plt.subplots(2, 2, figsize=(11, 6))

# --- 1. resampling (reference core.py:494) --------------------------------
fs_in, fs_out, fc = 800.0, 3200.0, 100.0
t = np.arange(512) / fs_in
sig = np.sin(2 * np.pi * fc * t)
sig_res = np.asarray(resample(sig, int(fs_in), int(fs_out), n_taps=401))
t_res = np.arange(sig_res.shape[0]) / fs_out
ax = axes[0, 0]
ax.plot(t, sig, "o", ms=3, label=f"input @ {fs_in:.0f} Hz")
ax.plot(t_res, sig_res, "-", lw=0.8, label=f"resampled @ {fs_out:.0f} Hz")
ax.set_xlim(0, 5 / fc)
ax.set_title("resample (4x)")
ax.legend(fontsize=7)

# round-trip check: resample up then down restores the signal
back = np.asarray(resample(sig_res, int(fs_out), int(fs_in), n_taps=401))
n_chk = min(len(back), len(sig))
err = np.max(np.abs(back[50:n_chk - 50] - sig[50:n_chk - 50]))
print(f"resample up/down round-trip max error: {err:.2e}")

# --- 2. clock interpolation with sampling-clock drift + jitter ------------
fs = 3200.0
n = 20000
t2 = np.arange(n) / fs
sig2 = np.sin(2 * np.pi * fc * t2).reshape(-1, 1)
ppm = 400e-6
out = np.asarray(
    clock_sampling_interp(sig2, fs, fs * (1 + ppm), jitter_rms=1e-6,
                          key=jax.random.PRNGKey(0))
)
# the drifted clock accumulates a phase shift visible late in the record
ax = axes[0, 1]
seg = slice(n - 200, n - 100)
ax.plot(t2[seg], sig2[seg, 0], "-", label="ideal clock")
ax.plot(t2[seg], out[seg, 0], "--", label=f"{ppm*1e6:.0f} ppm drift + jitter")
ax.set_title("clock_sampling_interp")
ax.legend(fontsize=7)
# comparing the same sample indices late in the record exposes the
# accumulated clock offset (~k*ppm samples at index k)
k0 = 16000
lag = abs(int(finddelay(sig2[k0:n, 0], out[k0:n, 0])))
print(f"clock drift at sample {k0}..{n}: {lag} samples "
      f"(expected ~{(k0 + n) / 2 * ppm:.1f})")

# --- 3. uniform quantizer (reference core.py:317) --------------------------
x = np.linspace(-1, 1, 1000)
for bits in (2, 3):
    xq = np.asarray(quantizer(x, n_bits=bits))
    axes[1, 0].plot(x, xq, label=f"{bits}-bit")
    assert len(np.unique(xq)) <= 2**bits
axes[1, 0].plot(x, x, "k:", lw=0.5)
axes[1, 0].set_title("quantizer transfer")
axes[1, 0].legend(fontsize=7)

# --- 4. fractional delay + finddelay + overlap-save equivalence -----------
rng = np.random.default_rng(1)
h = np.exp(-0.3 * np.arange(31)) * rng.normal(size=31)
x4 = rng.normal(size=8192).astype(np.float32)
y_fir = np.asarray(fir_filter(h, x4))
y_os = np.asarray(overlap_save(x4, h, nfft=512))
print(f"overlap-save vs direct FFT FIR max error: "
      f"{np.max(np.abs(y_fir - y_os)):.2e}")

d_true = 37
x_delj = np.asarray(delay_signal(x4, d_true))
d_est = int(finddelay(x_delj, x4))
print(f"delaySignal({d_true}) recovered by finddelay: {d_est}")
axes[1, 1].plot(x4[:80], label="x")
axes[1, 1].plot(x_delj[:80], label=f"delayed {d_true}")
axes[1, 1].set_title("integer delay via FFT phase ramp")
axes[1, 1].legend(fontsize=7)

fig.tight_layout()
fig.savefig(os.path.join(os.path.dirname(__file__), "dsp_core_functions.png"),
            dpi=110)
print("saved dsp_core_functions.png")
