"""Device-vs-CPU speedups for the three kernels the reference benchmarks on GPU.

Counterpart of the reference's ``benchmarck_GPU_processing.ipynb``, which
reports manakovSSF / firFilter / bps CuPy-vs-Numba speedups (~17-25x on a
GTX 1060 / Colab T4 for >1e6-sample signals, BASELINE.md). Here the same
three workloads run jitted on JAX's default device and are compared against a
vectorized NumPy transcription of the reference algorithm measured on this
host's CPU. Prints one JSON line per (kernel, size).

Run: ``python examples/benchmark_gpu_processing.py`` (the CPU baselines
always run on the host with NumPy; ``--cpu`` runs the jitted side on the
CPU too).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--cpu" in sys.argv:
    # CI/smoke mode: the jitted side also runs on the host CPU
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np

import jax
import jax.numpy as jnp

RS = 32e9
SPS = 4


def _best_of(f, reps=3):
    jax.block_until_ready(f())  # warm-up / compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f())
        ts.append(time.perf_counter() - t0)
    return min(ts)


# --- manakovSSF -------------------------------------------------------------

def bench_manakov(n_samples, n_steps=50):
    from opticommpy_tpu.models import SSFMConfig
    from opticommpy_tpu.models.channels import manakov_ssf

    hz = 0.5
    cfg = SSFMConfig(Ltotal=n_steps * hz, Lspan=n_steps * hz, hz=hz,
                     alpha=0.2, D=16.0, gamma=1.3, Fs=RS * SPS, amp="ideal",
                     nlprMethod=False, trapIters=1, fusedLinear=True)
    dev = jax.jit(lambda e: manakov_ssf(e, cfg))

    rng = np.random.default_rng(0)
    x = jnp.asarray((0.01 * (rng.normal(size=(n_samples, 2))
                             + 1j * rng.normal(size=(n_samples, 2))))
                    .astype(np.complex64))
    t_dev = _best_of(lambda: dev(x))

    # NumPy transcription of the reference loop (channels.py:252)
    alpha = 0.2 / (10 * np.log10(np.e))
    lam = 299792458.0 / 1e3 / 193.1e12
    beta2 = -(16.0 * lam**2) / (2 * np.pi * 299792458.0 / 1e3)
    w = 2 * np.pi * RS * SPS * np.fft.fftfreq(n_samples)
    lin = np.exp((-(alpha / 2) + 1j * (beta2 / 2) * w**2) * (hz / 2)).astype(
        np.complex64)
    xf = 0.01 * (rng.normal(size=(2, n_samples))
                 + 1j * rng.normal(size=(2, n_samples))).astype(np.complex64)
    n_cpu_steps = max(2, n_steps // 10)

    def cpu():
        e = xf.copy()
        for _ in range(n_cpu_steps):
            e = np.fft.ifft(np.fft.fft(e, axis=-1) * lin, axis=-1)
            p = np.sum(np.abs(e) ** 2, axis=0)
            e = e * np.exp(1j * (8 / 9) * 1.3 * p * hz)
            e = np.fft.ifft(np.fft.fft(e, axis=-1) * lin, axis=-1)
        return e

    t_cpu = _best_of(cpu) * (n_steps / n_cpu_steps)
    return n_samples / t_dev, t_cpu / t_dev


# --- firFilter --------------------------------------------------------------

def bench_fir(n_samples, n_taps=1024):
    from opticommpy_tpu.ops.filtering import fir_filter

    rng = np.random.default_rng(1)
    h = rng.normal(size=n_taps).astype(np.float32)

    dev = jax.jit(lambda x: fir_filter(jnp.asarray(h), x))
    x = jnp.asarray((rng.normal(size=(n_samples, 2))
                     + 1j * rng.normal(size=(n_samples, 2))).astype(np.complex64))
    t_dev = _best_of(lambda: dev(x))

    from scipy.signal import fftconvolve

    xc = (rng.normal(size=(n_samples, 2))
          + 1j * rng.normal(size=(n_samples, 2))).astype(np.complex64)

    def cpu():
        return fftconvolve(xc, h[:, None], mode="same", axes=0)

    t_cpu = _best_of(cpu)
    return n_samples / t_dev, t_cpu / t_dev


# --- bps --------------------------------------------------------------------

def bench_bps(n_symbols, n_win=32, b_phases=64):
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.dsp.carrier_recovery import bps

    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    rng = np.random.default_rng(2)

    dev = jax.jit(lambda x: bps(x, n_win, jnp.asarray(const), b_phases))
    x = jnp.asarray((rng.normal(size=(n_symbols, 2))
                     + 1j * rng.normal(size=(n_symbols, 2))).astype(np.complex64))
    t_dev = _best_of(lambda: dev(x))

    # NumPy transcription of the vectorized GPU reference
    # (carrierRecoveryGPU.py:54-66): B x M distance tensor + window sum
    xc = (rng.normal(size=(n_symbols, 2))
          + 1j * rng.normal(size=(n_symbols, 2))).astype(np.complex64)
    phis = np.float32(np.pi / 2) * np.arange(b_phases) / b_phases - np.pi / 4
    rot = np.exp(1j * phis).astype(np.complex64)

    def cpu():
        out = []
        for m in range(xc.shape[1]):
            z = xc[:, m, None] * rot[None, :]  # (N, B)
            d = np.min(np.abs(z[:, :, None] - const[None, None, :]) ** 2,
                       axis=2)  # (N, B)
            k = np.ones(2 * n_win + 1, dtype=np.float32)
            s = np.apply_along_axis(
                lambda c: np.convolve(c, k, mode="same"), 0, d)
            out.append(phis[np.argmin(s, axis=1)])
        return np.stack(out, 1)

    t_cpu = _best_of(cpu, reps=1)
    return n_symbols / t_dev, t_cpu / t_dev


def main():
    fast = os.environ.get("OPTICOMMPY_FAST") == "1"
    man_sizes = (2**14,) if fast else (2**16, 2**18, 2**20)
    fir_sizes = (2**16,) if fast else (2**18, 2**20, 2**22)
    bps_sizes = (2**12,) if fast else (2**14, 2**16)
    for n in man_sizes:
        sps, speedup = bench_manakov(n, n_steps=5 if fast else 50)
        print(json.dumps({"kernel": "manakovSSF", "n_samples": n,
                          "device_samples_per_s": sps,
                          "speedup_vs_cpu": speedup}))
    for n in fir_sizes:
        sps, speedup = bench_fir(n)
        print(json.dumps({"kernel": "firFilter", "n_samples": n,
                          "device_samples_per_s": sps,
                          "speedup_vs_cpu": speedup}))
    for n in bps_sizes:
        sps, speedup = bench_bps(n)
        print(json.dumps({"kernel": "bps", "n_symbols": n,
                          "device_sym_per_s": sps,
                          "speedup_vs_cpu": speedup}))


if __name__ == "__main__":
    main()
