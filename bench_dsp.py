"""Auxiliary benchmark: coherent DSP chain throughput (Msym/s) on one device.

Measures the receiver chain of the flagship workload (BASELINE.json config 3)
at 2 samples/symbol, 16-QAM polmux:

- end-to-end Msym/s for the adaptive chain (single-stage dd-lms on the
  scan, and the multi-stage schedule on the backend the platform table
  picks: the equalizer kernel on a GPU, the scan on the CPU),
- the converged (frozen-tap) chain — the production/serving path — staged,
  fused, with Gardner or feedforward clock recovery, single and batch 8.

Prints one JSON line per configuration. Not invoked by the driver (bench.py
is the headline); run manually: ``python bench_dsp.py``.
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

N_SYM = 2**17  # symbols per polarization
SPS = 2
RS = 32e9


def build_chain():
    """The chains to time, by name, plus their inputs ``sig`` (N, 2)
    complex64 and ``h0`` (2, 2, taps) complex64 central-spike taps. The
    ``*batch*`` chains take (B, ...) stacks of both."""
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.dsp.carrier_recovery import bps
    from opticommpy_tpu.dsp.clock_recovery import (ClockRecoveryConfig,
                                                   FFWClockRecoveryConfig,
                                                   ffw_clock_recovery,
                                                   gardner_clock_recovery)
    from opticommpy_tpu.dsp.equalization import (EDCConfig,
                                                 MIMOEqualizerConfig, edc,
                                                 mimo_adapt_equalizer,
                                                 mimo_adapt_equalizer_batch,
                                                 mimo_apply, mimo_apply_fused)
    from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape
    from opticommpy_tpu.ops.signal import pnorm

    fs = RS * SPS
    n = N_SYM * SPS
    n_taps = 15
    pulse = jnp.asarray(pulse_shape("rrc", SPS, 512, 0.1).astype(np.float32))
    const = gray_mapping(16, "qam")
    const = jnp.asarray(
        (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64))
    edc_cfg = EDCConfig(L=400, D=16, Fs=fs, Rs=RS)

    def front(sig):
        return pnorm(edc(fir_filter(pulse, sig), edc_cfg))

    def cpr(y):
        """BPS over the columns of (nSym, cols); power of the result."""
        out = y * jnp.exp(1j * bps(y, 32, const, 64))
        return jnp.mean((out * jnp.conj(out)).real)

    def cpr_batch(y):
        """One BPS call with the batch folded into the mode axis."""
        b, n_sym_, m = y.shape
        return cpr(jnp.moveaxis(y, 0, 1).reshape(n_sym_, b * m))

    def adaptive(sig, h0):
        # single-stage dd-lms on the reference-shaped scan
        cfg = MIMOEqualizerConfig(nTaps=n_taps, SpS=SPS, mu=(2e-3,),
                                  alg=("dd-lms",), M=16, backend="scan")
        return cpr(mimo_adapt_equalizer(front(sig), cfg))

    multistage = MIMOEqualizerConfig(
        nTaps=n_taps, SpS=SPS, mu=(5e-3, 1e-3), alg=("da-rde", "dd-lms"),
        L=(N_SYM // 8, N_SYM - N_SYM // 8), M=16, numIter=2)

    def adaptive_multistage(sig, h0):
        x = front(sig)
        d = x[::SPS][:N_SYM]  # placeholder reference (timing workload)
        return cpr(mimo_adapt_equalizer(x, multistage, symb_ref=d))

    def adaptive_batch_multistage(sig_b, h_b):
        x = jax.vmap(front)(sig_b)
        d = x[:, ::SPS][:, :N_SYM]  # placeholder reference
        return cpr_batch(mimo_adapt_equalizer_batch(x, multistage,
                                                    symb_ref=d))

    def frozen(sig, H):
        return cpr(mimo_apply(H, front(sig), SPS))

    def fused(sig, H):
        # MF + EDC + pnorm + MIMO apply collapsed into ONE decimating
        # frequency-domain MIMO filter (all stages LTI + one scalar)
        return cpr(mimo_apply_fused(H, sig, SPS, pre=pulse,
                                    edc_config=edc_cfg))

    def fused_batch(sig_b, h_b):
        return cpr_batch(jax.vmap(lambda s, h: mimo_apply_fused(
            h, s, SPS, pre=pulse, edc_config=edc_cfg))(sig_b, h_b))

    def cr_gardner(sig, H):
        """Frozen-tap serving chain WITH the Gardner clock-recovery stage
        (runCR analogue): the PI/NCO loop is a sequential while_loop."""
        x = gardner_clock_recovery(
            front(sig), ClockRecoveryConfig(kp=2e-3, ki=1e-5, isNyquist=True),
            static_out=True)
        return cpr(mimo_apply(H, pnorm(x), SPS))

    cr_cfg = FFWClockRecoveryConfig(rollOff=0.01)

    def cr_ffw_one(sig, H):
        x = ffw_clock_recovery(front(sig), cr_cfg)
        return mimo_apply(H, pnorm(x), SPS)

    def cr_ffw(sig, H):
        """Frozen-tap serving chain with the FEEDFORWARD clock-recovery
        stage (crMethod='ffw'): per-block spectral-line timing estimate +
        block-parallel cubic resampler — dense XLA ops, no recurrence."""
        return cpr(cr_ffw_one(sig, H))

    def cr_ffw_batch(sig_b, h_b):
        # each signal gets its own clock estimate (independent ADCs)
        return cpr_batch(jax.vmap(cr_ffw_one)(sig_b, h_b))

    rng = np.random.default_rng(0)
    sig = (0.2 * (rng.normal(size=(n, 2)) + 1j * rng.normal(size=(n, 2))))
    h0 = np.zeros((2, 2, n_taps), np.complex64)
    h0[0, 0, n_taps // 2] = h0[1, 1, n_taps // 2] = 1.0
    return {
        "adaptive": adaptive, "adaptive_multistage": adaptive_multistage,
        "adaptive_batch_multistage": adaptive_batch_multistage,
        "frozen": frozen, "fused": fused, "fused_batch": fused_batch,
        "cr_gardner": cr_gardner, "cr_ffw": cr_ffw,
        "cr_ffw_batch": cr_ffw_batch,
        "sig": jnp.asarray(sig.astype(np.complex64)), "h0": jnp.asarray(h0),
    }


def time_fn(fn, *args, reps=3):
    """Best seconds of ``reps`` runs of ``jit(fn)``, compile excluded."""
    f = jax.jit(fn)
    jax.block_until_ready(f(*args))  # compile
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def bench_volterra(n_sym=16384, sps=2):
    """3rd-order Volterra equalizer (XLA scan), Msym/s."""
    from opticommpy_tpu.dsp.equalization import VolterraConfig, volterra

    rng = np.random.default_rng(4)
    sym = (2 * rng.integers(0, 4, size=n_sym) - 3).astype(np.float32)
    sig = np.repeat(sym, sps) + 0.1 * rng.normal(size=n_sym * sps)
    sig = (sig + 0.05 * sig**2).astype(np.float32)  # mild NL distortion
    cfg = VolterraConfig(n1Taps=13, n2Taps=7, n3Taps=5, SpS=sps, mu=1e-3,
                         nTrain=4000, order=3, M=4, constType="pam")

    def run(s, r):
        y, hs, mse = volterra(s, r, cfg)
        return jnp.mean(jnp.abs(y)) + jnp.mean(mse)

    t = time_fn(run, jnp.asarray(sig), jnp.asarray(sym))
    print(json.dumps({
        "metric": "Volterra equalizer (order 3, 13/7/5 taps, PAM4)",
        "scan_Msym_per_s": n_sym / t / 1e6,
        "n_symbols": n_sym,
    }))


def bench_ofdm(batch=8, n_frames=273):
    """Batched OFDM receive (CP strip + FFT + pilot channel EQ), Msym/s.

    B 16QAM-OFDM streams (Nfft=256, CP=32, pilots every 16 -> 240 data
    carriers/frame, ~2^16 data symbols each) over 40 km CD + AWGN,
    demodulated + BER-checked in ONE program. The receive path is pure
    FFT/elementwise/interp work — XLA-native, no kernel needed; this row
    records what it sustains at serving shape.
    """
    from opticommpy_tpu.comm import bit_source, modulate_gray
    from opticommpy_tpu.comm.metrics import fast_ber_calc
    from opticommpy_tpu.comm.ofdm import (OFDMConfig, demodulate_ofdm,
                                          modulate_ofdm)
    from opticommpy_tpu.models import (AWGNConfig, LinearFiberConfig, awgn,
                                       linear_fiber_channel)
    from opticommpy_tpu.ops import pnorm

    nfft, cp = 256, 32
    pilots = tuple(range(0, nfft, 16))
    cfg = OFDMConfig(Nfft=nfft, G=cp, SpS=1, pilotCarriers=pilots)
    ni = nfft - len(pilots)
    n_sym = ni * n_frames
    fs = 10e9

    @jax.jit
    def synth(key):
        def one(k):
            kb, kn = jax.random.split(k)
            bits = bit_source(kb, n_sym * 4)
            symb = pnorm(modulate_gray(bits, 16, "qam"))
            sig = modulate_ofdm(symb, cfg)
            rx = linear_fiber_channel(
                sig, LinearFiberConfig(L=40, alpha=0.0, D=17, Fs=fs))
            return awgn(rx, kn, AWGNConfig(snr=25.0)), symb

        return jax.vmap(one)(jax.random.split(key, batch))

    rx_b, tx_b = synth(jax.random.PRNGKey(6))

    def serve(rx, tx):
        rec = jax.vmap(lambda s: demodulate_ofdm(s, cfg))(rx)
        bers = jax.vmap(
            lambda y, t: fast_ber_calc(y, t, 16, "qam")[0][0])(rec, tx)
        return jnp.max(bers)

    max_ber = float(jax.jit(serve)(rx_b, tx_b))
    t = time_fn(serve, rx_b, tx_b)
    print(json.dumps({
        "metric": f"OFDM batched receive (Nfft={nfft}, CP={cp}, 16QAM, "
                  f"pilot EQ, 40 km CD)",
        f"batch{batch}_Msym_per_s": batch * n_sym / t / 1e6,
        "max_ber": max_ber,
        "n_data_symbols": n_sym,
    }))


def main():
    from opticommpy_tpu.backend import implementation

    c = build_chain()
    sig, h0 = c["sig"], c["h0"]
    batch = 8
    sig_b = jnp.broadcast_to(sig, (batch,) + sig.shape)
    h_b = jnp.broadcast_to(h0, (batch,) + h0.shape)
    single = {k: time_fn(c[k], sig, h0) for k in (
        "adaptive", "adaptive_multistage", "frozen", "fused", "cr_gardner",
        "cr_ffw")}
    batched = {k: time_fn(c[k], sig_b, h_b) for k in (
        "adaptive_batch_multistage", "fused_batch", "cr_ffw_batch")}
    row = {"metric": "coherent DSP chain (MF+EDC+2x2 MIMO+BPS), 16QAM polmux",
           "device": jax.devices()[0].device_kind,
           "multistage_equalizer": implementation(),
           "n_symbols": N_SYM}
    row.update({f"{k}_Msym_per_s": N_SYM / t / 1e6 for k, t in single.items()})
    row.update({f"{k}{batch}_Msym_per_s": batch * N_SYM / t / 1e6
                for k, t in batched.items()})
    print(json.dumps(row))
    bench_volterra()
    bench_ofdm()


if __name__ == "__main__":
    main()
