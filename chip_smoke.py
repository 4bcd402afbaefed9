"""Run the coherent WDM link end to end on one CUDA GPU and check every stage.

    python chip_smoke.py          # the five main-path stages on one GPU
    python chip_smoke.py --four   # the four-GPU data-parallel paths only

The main path is the one the README quick start and ``bench.py`` describe:

1. transmit   ``models.tx.simple_wdm_tx`` — 11 x DP-16QAM, 32 GBd on a
   37.5 GHz grid, 16 samples/symbol, 2^20 samples, generated on the device;
2. propagate  ``models.channels.manakov_ssf`` — 5 x 50 km, hz 0.5 km (500
   split steps), ideal amplification;
3. receive    ``models.devices.pdm_coherent_receiver`` tuned to the centre
   channel;
4. train      ``pipelines.coherent_dsp_chain`` on 2^16 symbols at 2 SpS (MF,
   EDC, da-rde -> dd-lms adaptive MIMO, FOE, BPS), then BER/SNR/GMI;
5. serve      ``pipelines.coherent_coded_serve`` at batch 8 (fused front
   end, BPS, LLRs, DVB-S2 64800 R4/5 NMSA decode with early exit, 64
   codewords).

Each stage prints its compile time, its steady time (median of three runs
ending in ``block_until_ready``) and ``compiled.memory_analysis()``, and is
checked against a plain reference (NumPy or the XLA path on the CPU) at the
tolerance and precision it prints. One A/B line per kernel decision times
the hand-written kernel against XLA's plain version in this process, and a
profiler trace of stages 4 and 5 gives device busy time, idle share and the
time of the BPS and LDPC check passes. The ``gpu``-marked tests run last.

A failed check prints ``FAILED:`` and the run goes on, so that one run
shows every failure; the script then exits non-zero. It also exits non-zero
when JAX finds no GPU; only then is the last line of standard output
missing. On success the last
line is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Sizes:
    """Problem sizes. ``FULL`` is the main path; tests rehearse ``TINY``."""

    n_samples: int = 2**20  # stage 1-3 field length (16 SpS)
    n_channels: int = 11
    n_spans: int = 5
    hz: float = 0.5  # [km]
    ref_steps: int = 100  # split steps compared with the NumPy SSFM
    n_train: int = 10000  # stage-4 data-aided training symbols
    serve_batch: int = 8
    serve_symbols: int = 2**16  # per signal and mode, at 2 SpS
    ldpc_iters: int = 20
    cpu_ref_codewords: int = 8  # decoded again on the CPU
    mimo_batch: int = 8
    four_decode_batch: int = 512
    reps: int = 3


FULL = Sizes()
TINY = Sizes(n_samples=2**16, n_channels=3, n_spans=1, hz=5.0, ref_steps=10,
             n_train=1500, serve_batch=2, serve_symbols=2**13,
             ldpc_iters=8, cpu_ref_codewords=2, mimo_batch=2,
             four_decode_batch=8, reps=1)

RS, SPS, GRID, P_CH = 32e9, 16, 37.5e9, -2.0
L_SPAN, ALPHA, D, GAMMA = 50.0, 0.2, 16.0, 1.3
M = 16
# AWGN std per quadrature per sample of the stage-5 waveforms (16QAM levels
# +-1, +-3): about 1.5 dB above where R4/5 NMSA starts to fail frames, so
# every codeword converges and takes several iterations (3-4 measured)
SERVE_NOISE = 0.3


class CheckFailed(AssertionError):
    pass


_FAILED = []


def check(cond, msg):
    """Record a failed check and go on, so that one run reports every
    failure; :func:`raise_if_failed` then fails the run."""
    if cond:
        print(f"  ok: {msg}", flush=True)
    else:
        _FAILED.append(msg)
        print(f"  FAILED: {msg}", flush=True)


def raise_if_failed():
    """Raise :class:`CheckFailed` if any check failed (and forget them)."""
    failed, _FAILED[:] = list(_FAILED), []
    if failed:
        raise CheckFailed(f"{len(failed)} check(s) failed: "
                          + "; ".join(failed))


def card_line():
    """The card's name and power limit, read by nvidia-smi (not JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def compile_timed(name, fn, *args, reps=3):
    """jit + compile ``fn``, print compile time, memory and steady time.

    Returns (output of the first run, compiled executable, median seconds).
    """
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    t_first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    mb = 1 / 2**20
    mem_s = ("n/a" if mem is None else
             f"args {mem.argument_size_in_bytes * mb:.1f} MiB, "
             f"out {mem.output_size_in_bytes * mb:.1f} MiB, "
             f"temp {mem.temp_size_in_bytes * mb:.1f} MiB, "
             f"code {mem.generated_code_size_in_bytes * mb:.2f} MiB")
    print(f"[{name}] compile {t_compile:.3f} s | first run {t_first:.4f} s | "
          f"steady median {med:.6f} s of {[round(t, 6) for t in times]} | "
          f"memory: {mem_s}", flush=True)
    return out, compiled, med


def rel_l2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# plain NumPy references
# ---------------------------------------------------------------------------


def ssfm_numpy(e, fs, n_steps, hz):
    """float64 Manakov split-step (symmetric, fixed step, one span, ideal
    gain at its end): the formulation of the reference's manakovSSF
    (channels.py:252) with the nonlinear phase (8/9) gamma (|Ex|^2+|Ey|^2)
    taken at the step midpoint."""
    c_kms = 299792458.0 / 1e3
    lam = c_kms / 193.1e12
    alpha = ALPHA / (10 * np.log10(np.e))
    beta2 = -(D * lam**2) / (2 * np.pi * c_kms)
    w = 2 * np.pi * fs * np.fft.fftfreq(e.shape[0])
    lin = (-(alpha / 2) + 1j * (beta2 / 2) * w**2)[:, None]
    half, full = np.exp(lin * hz / 2), np.exp(lin * hz)
    ef = np.fft.fft(np.asarray(e, np.complex128), axis=0) * half
    for k in range(n_steps):
        et = np.fft.ifft(ef, axis=0)
        pch = np.sum(np.abs(et) ** 2, axis=1, keepdims=True)
        et = et * np.exp(1j * (8 / 9) * GAMMA * pch * hz)
        ef = np.fft.fft(et, axis=0) * (full if k < n_steps - 1 else half)
    return np.fft.ifft(ef, axis=0) * np.exp(alpha / 2 * n_steps * hz)


def pdm_receiver_numpy(e_s, e_lo):
    """Ideal PDM coherent front end: LO split at 45 degrees, 2x4 90-degree
    hybrids (reference devices.py:462) and balanced photodiodes."""
    T = np.array([[0.5, 0.5j, 0.5j, -0.5], [0.5j, -0.5, 0.5, 0.5j],
                  [0.5j, 0.5, -0.5j, -0.5], [-0.5, 0.5j, -0.5, 0.5j]])
    e_s = np.asarray(e_s, np.complex128)
    lo = np.asarray(e_lo, np.complex128)
    # PBS at 45 degrees: x gets cos, y gets -sin (devices.pbs rotation)
    los = (lo * np.cos(np.pi / 4), -lo * np.sin(np.pi / 4))
    out = []
    for pol, lo in zip((e_s[:, 0], e_s[:, 1]), los):
        eo = T[:, 0, None] * pol[None] + T[:, 3, None] * lo[None]
        i = np.abs(eo[1]) ** 2 - np.abs(eo[0]) ** 2
        q = np.abs(eo[2]) ** 2 - np.abs(eo[3]) ** 2
        out.append(i + 1j * q)
    return np.stack(out, axis=1)


def decisions(y, const):
    y = np.asarray(y)
    return np.argmin(np.abs(y[..., None] - const) ** 2, axis=-1)


def decision_margin(y, const):
    """Distance from each symbol to its decision boundary: half the gap
    between its second-nearest and nearest constellation distances."""
    d = np.sort(np.abs(np.asarray(y)[..., None] - const), axis=-1)
    return (d[..., 1] - d[..., 0]) / 2


# ---------------------------------------------------------------------------
# the five stages
# ---------------------------------------------------------------------------


def stage_tx(sz, key):
    import jax.numpy as jnp

    from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx
    from opticommpy_tpu.utils.units import dbm2w

    print("== stage 1: transmit (simple_wdm_tx) ==", flush=True)
    txc = WDMTxConfig(M=M, Rs=RS, SpS=SPS, nChannels=sz.n_channels,
                      nPolModes=2, wdmGridSpacing=GRID,
                      powerPerChannel=(P_CH,),
                      nBits=sz.n_samples // SPS * 4, nFilterTaps=1024,
                      pulseRollOff=0.01)
    (field, symb), _, _ = compile_timed(
        "tx", lambda k: simple_wdm_tx(k, txc)[:2], key, reps=sz.reps)
    f = np.asarray(field)
    check(f.shape == (sz.n_samples, 2) and np.isfinite(f).all(),
          f"field {f.shape} complex64, finite")
    p = float(np.sum(np.mean(np.abs(f) ** 2, axis=0)))
    p_want = sz.n_channels * float(dbm2w(P_CH))
    check(abs(p / p_want - 1) < 0.05,
          f"launch power {p * 1e3:.4f} mW vs {sz.n_channels} x {P_CH} dBm "
          f"= {p_want * 1e3:.4f} mW (within 5 %: finite record, random "
          "symbols)")
    return txc, field, jnp.asarray(symb)


def stage_propagate(sz, field):
    import jax

    from opticommpy_tpu.models import SSFMConfig
    from opticommpy_tpu.models.channels import manakov_ssf

    print("== stage 2: propagate (manakov_ssf, XLA FFT = cuFFT) ==",
          flush=True)
    fs = RS * SPS

    def cfg(n_spans):
        return SSFMConfig(Ltotal=n_spans * L_SPAN, Lspan=L_SPAN, hz=sz.hz,
                          alpha=ALPHA, D=D, gamma=GAMMA, Fs=fs, amp="ideal",
                          nlprMethod=False, trapIters=1, fusedLinear=True)

    n_steps = int(round(L_SPAN / sz.hz))
    out, _, t = compile_timed(
        "ssfm", lambda e: manakov_ssf(e, cfg(sz.n_spans)), field,
        reps=sz.reps)
    o = np.asarray(out)
    print(f"  {sz.n_spans} spans x {n_steps} steps: {sz.n_samples / t:.6g} "
          "samples/s", flush=True)
    check(np.isfinite(o).all(), "propagated field finite")
    p_in = np.mean(np.abs(np.asarray(field)) ** 2)
    check(abs(np.mean(np.abs(o) ** 2) / p_in - 1) < 1e-3,
          "ideal amplification conserves power within 1e-3")
    # one span of the same field against float64 NumPy
    hz_ref = L_SPAN / sz.ref_steps
    one = SSFMConfig(Ltotal=L_SPAN, Lspan=L_SPAN, hz=hz_ref, alpha=ALPHA, D=D,
                     gamma=GAMMA, Fs=fs, amp="ideal", nlprMethod=False,
                     trapIters=1, fusedLinear=True)
    y1 = np.asarray(jax.jit(lambda e: manakov_ssf(e, one))(field))
    t0 = time.perf_counter()
    y_np = ssfm_numpy(np.asarray(field), fs, sz.ref_steps, hz_ref)
    err = rel_l2(y1, y_np)
    check(err <= 1e-4,
          f"1 span ({sz.ref_steps} steps) vs float64 NumPy: rel L2 {err:.3e} "
          "<= 1e-4 (complex64 FFTs, no matmul; float32 rounding over "
          f"{sz.ref_steps} steps sits near 1e-5) [NumPy "
          f"{time.perf_counter() - t0:.1f} s]")
    return out


def stage_receive(sz, txc, field, key):
    import jax

    from opticommpy_tpu.models.config import LaserConfig, PDMFrontendConfig
    from opticommpy_tpu.models.devices import (basic_laser_model,
                                               pdm_coherent_receiver)
    from opticommpy_tpu.models.tx import wdm_freq_grid

    print("== stage 3: receive (pdm_coherent_receiver, centre channel) ==",
          flush=True)
    fs = RS * SPS
    center = sz.n_channels // 2
    f_lo = float(wdm_freq_grid(sz.n_channels, GRID)[center]) + 40e6
    lo_cfg = LaserConfig(P=10.0, lw=100e3, Ns=sz.n_samples, Fs=fs,
                         freqShift=f_lo, RIN_var=0.0)
    k_lo = jax.random.fold_in(key, 1)
    lo = jax.jit(lambda k: basic_laser_model(lo_cfg, k))(k_lo)
    rx, _, _ = compile_timed(
        "rx", lambda e, l_: pdm_coherent_receiver(
            e, l_, PDMFrontendConfig(Fs=fs)), field, lo, reps=sz.reps)
    err = rel_l2(rx, pdm_receiver_numpy(field, lo))
    check(err <= 1e-5,
          f"front end vs float64 NumPy hybrid/balanced PD: rel L2 {err:.2e} "
          "<= 1e-5 (hybrid and PBS matmuls at precision HIGHEST; TF32 would "
          "put ~1e-3 here)")
    return rx, center


def stage_train(sz, rx, symb, center, interpret=False):
    import jax
    import jax.numpy as jnp

    from opticommpy_tpu.comm.metrics import fast_ber_calc, monte_carlo_gmi
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.dsp.equalization import (EDCConfig,
                                                 MIMOEqualizerConfig, edc,
                                                 mimo_adapt_equalizer)
    from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape
    from opticommpy_tpu.ops.signal import symbol_sync
    from opticommpy_tpu.pipelines import (CoherentDSPConfig,
                                          coherent_dsp_chain,
                                          coherent_dsp_chain_batch)

    print("== stage 4: train (coherent_dsp_chain, 2 SpS) ==", flush=True)
    link = sz.n_spans * L_SPAN
    n_sym = sz.n_samples // SPS

    @jax.jit
    def sync(r, s):
        pulse = jnp.asarray(pulse_shape("rrc", SPS, 1024, 0.01))
        pre = decimate(fir_filter(pulse, r), SPS, 2)
        pre = edc(pre, EDCConfig(L=link, D=D, Fs=2 * RS, Rs=RS))
        return pnorm(symbol_sync(pre, s, 2))

    d_ref = sync(rx, symb[:, :, center])

    def cfg(backend):
        return CoherentDSPConfig(
            Rs=RS, SpS_in=SPS, SpS_dsp=2, nFilterTaps=1024, rollOff=0.01,
            L=link, D=D, nTaps=15, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
            nTrain=sz.n_train, M=M, eqBackend=backend, interpret=interpret)

    def chain(backend):
        return lambda r, d: coherent_dsp_chain(r, d, cfg(backend))[0]

    kernel = "pallas"
    y_k, c_k, t_k = compile_timed("train kernel (eq=pallas)", chain(kernel),
                                  rx, d_ref, reps=sz.reps)
    y_s, c_s, t_s = compile_timed("train scan (eq=scan)", chain("scan"),
                                  rx, d_ref, reps=sz.reps)
    print(f"A/B mimo equalizer, stage 4 single ({n_sym} symbols, 2x2, 15 "
          f"taps, da-rde x2 -> dd-lms): kernel {t_k:.6f} s vs scan "
          f"{t_s:.6f} s end to end ({t_s / t_k:.2f}x)", flush=True)

    # the equalizer alone on the chain's own input: kernel vs scan, beside
    # the scan against itself on an input moved by one float32 rounding
    @jax.jit
    def eq_input(r):
        pulse = jnp.asarray(pulse_shape("rrc", SPS, 1024, 0.01))
        x = decimate(fir_filter(pulse, r), SPS, 2)
        return pnorm(edc(x, EDCConfig(L=link, D=D, Fs=2 * RS, Rs=RS)))

    def eq(backend):
        c = MIMOEqualizerConfig(
            nTaps=15, SpS=2, mu=(5e-3, 2e-3), alg=("da-rde", "dd-lms"),
            L=(sz.n_train, n_sym - sz.n_train), M=M, numIter=2,
            backend=backend, interpret=interpret)
        return jax.jit(lambda x, d: mimo_adapt_equalizer(x, c, symb_ref=d))

    x_eq = eq_input(rx)
    x_ulp = x_eq * np.float32(1 + 2**-23)
    e_k = np.asarray(eq(kernel)(x_eq, d_ref))
    e_s = np.asarray(eq("scan")(x_eq, d_ref))
    e_u = np.asarray(eq("scan")(x_ulp, d_ref))
    for name, a, b in (("kernel vs scan", e_k, e_s),
                       ("scan vs scan, input moved 1 ulp", e_u, e_s)):
        da = np.abs(a - b)
        print(f"  equalizer output, {name}: max |dy| da-rde stage "
              f"{da[:sz.n_train].max():.3e}, dd-lms stage "
              f"{da[sz.n_train:].max():.3e} (median "
              f"{np.median(da[sz.n_train:]):.3e})", flush=True)
    y_u = np.asarray(jax.jit(chain("scan"))(rx * np.float32(1 + 2**-23),
                                            d_ref))

    const = np.asarray(gray_mapping(M, "qam"))
    const = const / np.sqrt(np.mean(np.abs(const) ** 2))
    disc = slice(sz.n_train + 1000, -100)

    def metrics(y):
        y = jnp.asarray(y)[disc]
        dd = jnp.asarray(d_ref)[disc]
        ber, _, snr = fast_ber_calc(y, dd, M, "qam")
        gmi, _ = monte_carlo_gmi(y, dd, M, "qam")
        return np.asarray(ber), np.asarray(snr), np.asarray(gmi)

    yk, ys = np.asarray(y_k)[disc], np.asarray(y_s)[disc]
    differ = decisions(yk, const) != decisions(ys, const)
    agree = 1.0 - float(np.mean(differ))
    print(f"  kernel vs scan: decisions differ on {int(differ.sum())} of "
          f"{differ.size} symbols at indices {np.argwhere(differ)[:12, 0]}; "
          f"margin there kernel {decision_margin(yk, const)[differ][:12]} "
          f"scan {decision_margin(ys, const)[differ][:12]}; max |dy| "
          f"{np.abs(yk - ys).max():.3e}, median {np.median(np.abs(yk - ys)):.3e}",
          flush=True)
    yu = np.asarray(y_u)[disc]
    n_u = int(np.sum(decisions(yu, const) != decisions(ys, const)))
    _, snr_u, _ = metrics(y_u)
    print(f"  scan vs scan on rx moved 1 ulp: decisions differ on {n_u} of "
          f"{ys.size} symbols; SNR {snr_u} dB", flush=True)
    check(agree >= 0.9999,
          f"kernel vs scan hard decisions equal on {agree * 100:.4f} % >= "
          "99.99 % of symbols (both float32; order of sums differs)")
    ber, snr, gmi = metrics(y_k)
    _, snr_s, _ = metrics(y_s)
    check(np.all(np.abs(snr - snr_s) <= 0.05),
          f"kernel vs scan SNR {snr} vs {snr_s} dB, within 0.05 dB (float32 "
          "recurrence on both; rounding order only)")
    print(f"  stage-4 BER {ber}, SNR {snr} dB, GMI {gmi} bit/symbol",
          flush=True)
    check(np.all(ber < 1e-2), "BER < 1e-2 on both polarizations")

    # the same seed on the CPU, XLA path (the plain reference)
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        y_c = jax.jit(chain("scan"))(jax.device_put(rx, cpu),
                                     jax.device_put(d_ref, cpu))
    ber_c, snr_c, gmi_c = metrics(np.asarray(y_c))
    yc = np.asarray(y_c)[disc]
    for label, y_ in (("scan", ys), ("kernel", yk)):
        n_diff = int(np.sum(decisions(y_, const) != decisions(yc, const)))
        print(f"  {label} on the device vs scan on the CPU: decisions differ "
              f"on {n_diff} of {yc.size} symbols", flush=True)
    check(np.all(np.abs(snr - snr_c) <= 0.1),
          f"SNR device vs CPU {snr} vs {snr_c} dB, within 0.1 dB (float32 "
          "both; FFT and reduction order differ)")
    check(np.all(np.abs(gmi - gmi_c) <= 0.01),
          f"GMI device vs CPU {gmi} vs {gmi_c} bit/symbol, within 0.01 "
          "(LLR matmuls at HIGHEST)")

    # batch: the same chain for mimo_batch copies of the signal
    rb = jnp.broadcast_to(rx, (sz.mimo_batch,) + rx.shape)
    db = jnp.broadcast_to(d_ref, (sz.mimo_batch,) + d_ref.shape)

    def batch(backend):
        return lambda r, d_: coherent_dsp_chain_batch(r, d_, cfg(backend))[0]

    yb_k, _, tb_k = compile_timed("train batch kernel", batch(kernel), rb, db,
                                  reps=sz.reps)
    yb_s, _, tb_s = compile_timed("train batch scan", batch("scan"), rb, db,
                                  reps=sz.reps)
    print(f"A/B mimo equalizer, stage 4 batch {sz.mimo_batch}: kernel "
          f"{tb_k:.6f} s vs scan {tb_s:.6f} s end to end "
          f"({tb_s / tb_k:.2f}x)", flush=True)
    agree_b = float(np.mean(decisions(np.asarray(yb_k)[:, disc], const)
                            == decisions(np.asarray(yb_s)[:, disc], const)))
    check(agree_b >= 0.9999,
          f"batch kernel vs scan decisions equal on {agree_b * 100:.4f} %")
    return y_k, d_ref, c_k, (rx, d_ref)


def _serve_signals(sz, key):
    """DVB-S2 encoded 16QAM at 2 SpS, RRC shaped, with AWGN: the bits, the
    codewords and the waveforms of ``serve_batch`` polmux signals."""
    import jax
    import jax.numpy as jnp

    from opticommpy_tpu.comm.fec import encode_ldpc, standard_ldpc
    from opticommpy_tpu.comm.modulation import modulate_gray
    from opticommpy_tpu.ops import fir_filter, pulse_shape, upsample

    n, k = 64800, 51840
    graph, edges = standard_ldpc("DVBS2", n, "4/5")
    B, n_sym = sz.serve_batch, sz.serve_symbols
    bits_sig = n_sym * 2 * 4
    ncw = bits_sig // n
    k1, k2, k3 = jax.random.split(key, 3)
    info = jax.random.bernoulli(k1, 0.5, (k, B * ncw)).astype(jnp.int8)
    cw = encode_ldpc(info, edges=edges)  # (n, B*ncw)
    fill = jax.random.bernoulli(k2, 0.5, (B, bits_sig - ncw * n))

    @jax.jit
    def waveforms(cw, fill, k_noise):
        stream = jnp.concatenate(
            [cw.T.reshape(B, ncw * n), fill.astype(cw.dtype)], axis=1)
        syms = jax.vmap(lambda b: modulate_gray(b, M, "qam"))(stream)
        grid = jnp.moveaxis(syms.reshape(B, 2, n_sym), 1, 2)  # mode-major
        pulse = jnp.asarray(pulse_shape("rrc", 2, 257, 0.01))
        wav = jax.vmap(lambda g: fir_filter(pulse, upsample(g, 2)))(grid)
        noise = SERVE_NOISE * (jax.random.normal(k_noise, wav.shape)
                         + 1j * jax.random.normal(
                             jax.random.fold_in(k_noise, 1), wav.shape))
        return (wav + noise).astype(jnp.complex64), grid

    wav, grid = waveforms(cw, fill, k3)
    return graph, np.asarray(cw), wav, grid, ncw


def stage_serve(sz, key):
    import jax
    import jax.numpy as jnp

    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.fec import LDPCConfig
    from opticommpy_tpu.comm.metrics import calc_llr
    from opticommpy_tpu.comm.modulation import bit_map, gray_mapping
    from opticommpy_tpu.pipelines import (CoherentDSPConfig,
                                          coherent_coded_serve)

    print("== stage 5: serve (coherent_coded_serve, batch "
          f"{sz.serve_batch}, DVB-S2 64800 R4/5) ==", flush=True)
    graph, cw, wav, grid, ncw = _serve_signals(sz, key)
    B, n_sym = sz.serve_batch, sz.serve_symbols
    H = np.zeros((B, 2, 2, 15), np.complex64)
    H[:, 0, 0, 7] = H[:, 1, 1, 7] = 1
    H = jnp.asarray(H)
    g = np.asarray(grid)
    pilots = jnp.asarray(g[:, :64] / np.sqrt(np.mean(np.abs(g) ** 2)))
    cfg = CoherentDSPConfig(nFilterTaps=257, L=0.5, M=M)
    fcfg = LDPCConfig(maxIter=sz.ldpc_iters, alg="NMSA", msgDtype="bf16",
                      earlyExit=True)
    noise_var = 0.05

    def serve(w, h, p):
        return coherent_coded_serve(w, h, cfg, noise_var, fec_graph=graph,
                                    fec_config=fcfg, pilot_grid=p)

    (bits, fail, syms), c_serve, t = compile_timed("serve", serve, wav, H,
                                                   pilots, reps=sz.reps)
    n_cw = B * ncw
    print(f"  {n_cw} codewords in {t:.6f} s: "
          f"{n_cw * 64800 / t / 1e6:.4g} coded Mbit/s, "
          f"{B * n_sym / t / 1e6:.4g} Msym/s per mode", flush=True)
    check(int(np.asarray(fail).sum()) == 0,
          f"all {n_cw} codewords decode (no frame failures)")
    check(np.array_equal(np.asarray(bits), cw),
          "decoded bits equal the transmitted codewords")

    # iteration counts: the same LLRs through the decoder on this device
    # and on the CPU (fixed-iteration scan there; iteration counts freeze
    # at convergence, so they equal the early-exit counts)
    const = jnp.asarray(gray_mapping(M, "qam")
                        / np.sqrt(np.mean(np.abs(gray_mapping(M, "qam"))
                                          ** 2)), jnp.complex64)
    bmap = bit_map(M, "qam")
    px = jnp.full(M, 1.0 / M)

    @jax.jit
    def llrs(s):
        ys = jnp.moveaxis(s, 2, 1).reshape(B, 2 * n_sym)
        ll = jax.vmap(lambda y: calc_llr(y, noise_var, const, bmap, px))(ys)
        return jnp.clip(ll[:, :ncw * 64800].reshape(n_cw, 64800).T,
                        -fcfg.clipLLR, fcfg.clipLLR)

    ll = llrs(syms)
    dec_dev = fec_qc.make_qc_decoder(64800, "4/5", sz.ldpc_iters, "NMSA",
                                     "bf16", early_exit=True)
    (out_d, it_d, fail_d), c_dec, t_dec = compile_timed(
        "decode alone", dec_dev, ll, reps=sz.reps)
    check(np.array_equal(np.asarray(out_d) < 0, np.asarray(bits) > 0),
          "decoder on the serve's LLRs reproduces the serve's bits")
    nc = min(sz.cpu_ref_codewords, n_cw)
    cpu = jax.devices("cpu")[0]
    dec_cpu = fec_qc.make_qc_decoder(64800, "4/5", sz.ldpc_iters, "NMSA",
                                     "bf16")
    with jax.default_device(cpu):
        out_c, it_c, fail_c = dec_cpu(jax.device_put(ll[:, :nc], cpu))
    it_dev = np.asarray(it_d)[:nc]
    check(np.array_equal(it_dev, np.asarray(it_c)),
          f"iteration counts {it_dev.tolist()} equal the CPU XLA decoder's "
          "on the same LLRs (bf16 messages, f32 sums)")
    check(np.array_equal(np.asarray(out_d)[:, :nc] < 0,
                         np.asarray(out_c) < 0),
          f"decisions equal the CPU decoder's on {nc} codewords")
    print(f"  iterations to converge: min {int(np.min(it_d))}, max "
          f"{int(np.max(it_d))} of {sz.ldpc_iters}", flush=True)
    return (wav, H, pilots), c_serve, c_dec, ll


def kernel_decisions(sz, y_train, c_train, serve_args, c_serve, ll,
                     trace_dir):
    """Times of the XLA paths that replaced removed kernels, and a trace
    of stages 4 and 5."""
    import jax
    import jax.numpy as jnp

    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.dsp import bps
    from opticommpy_tpu.utils.profiling import device_time_by_scope

    print("== kernel decisions: XLA paths that replaced hand kernels ==",
          flush=True)
    const = jnp.asarray(gray_mapping(M, "qam")
                        / np.sqrt(np.mean(np.abs(gray_mapping(M, "qam"))
                                          ** 2)), jnp.complex64)
    y = jnp.asarray(y_train)
    _, _, t_bps = compile_timed("bps xla (stage-4 shape)",
                                lambda s: bps(s, 37, const, 64), y,
                                reps=sz.reps)
    n_sym = y.shape[0]
    # bytes the BPS must move at least: read the symbols, write phases
    print(f"  bps {n_sym} x {y.shape[1]} x 64 phases: {t_bps * 1e6:.1f} us "
          f"({n_sym * y.shape[1] / t_bps / 1e6:.4g} Msym/s)", flush=True)
    y8 = jnp.tile(y, (1, 2 * sz.serve_batch // 2))
    _, _, t_bps8 = compile_timed("bps xla (stage-5 shape)",
                                 lambda s: bps(s, 37, const, 64), y8,
                                 reps=sz.reps)
    dec = fec_qc.make_qc_decoder(64800, "4/5", sz.ldpc_iters, "NMSA",
                                 "bf16")
    _, c_fixed, t_fixed = compile_timed("ldpc xla fixed iterations", dec, ll,
                                        reps=sz.reps)
    n_cw = ll.shape[1]
    print(f"  DVB-S2 decode {n_cw} codewords x {sz.ldpc_iters} iterations: "
          f"{t_fixed:.6f} s, {n_cw * 64800 / t_fixed / 1e6:.4g} coded "
          "Mbit/s (fixed iterations)", flush=True)

    rx_d = c_train[1]
    jax.block_until_ready(c_train[0](*rx_d))
    jax.block_until_ready(c_serve(*serve_args))
    jax.profiler.start_trace(trace_dir)
    try:
        jax.block_until_ready(c_train[0](*rx_d))
        jax.block_until_ready(c_serve(*serve_args))
    finally:
        jax.profiler.stop_trace()
    # first match wins: kernels by name, then jitted functions and the
    # pipelines' named scopes (ops inside a nested jit keep only its name)
    scopes = {"mimo_kernel": "mimo_eq_stage", "ldpc_check": "ldpc_check",
              "ldpc_other": "jit(decode)", "bps": "/bps/", "llr": "/llr/",
              "equalizer_other": "/equalizer/", "foe": "/foe/",
              "front_end": "/front_end/"}
    r = device_time_by_scope(
        trace_dir, [c_train[0].as_text(), c_serve.as_text()], scopes)
    print(f"  trace stages 4+5: device busy {r['busy_s']:.6f} s of a "
          f"{r['window_s']:.6f} s window, idle share {r['idle_share']:.4f}",
          flush=True)
    for label, t in r["by_scope"].items():
        print(f"    {label:<12} {t * 1e3:10.4f} ms", flush=True)
    for op, t, label in r["top"]:
        print(f"    top: {op:<48} {t * 1e3:10.4f} ms  [{label}]", flush=True)
    check(r["busy_s"] > 0, "trace recorded device work")
    return r


def run_gpu_tests():
    import pytest

    print("== gpu-marked tests ==", flush=True)
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    check(rc == 0, f"pytest -m gpu exit code {rc}")


def run_main_path(sz=FULL, seed=0, interpret=False, trace_dir=None):
    """Stages 1-5 and the kernel decisions; raises on any failed check."""
    import jax

    key = jax.random.PRNGKey(seed)
    txc, field, symb = stage_tx(sz, key)
    out = stage_propagate(sz, field)
    rx, center = stage_receive(sz, txc, out, key)
    y_train, d_ref, c_train, train_args = stage_train(sz, rx, symb, center,
                                                      interpret=interpret)
    serve_args, c_serve, _, ll = stage_serve(sz, jax.random.fold_in(key, 5))
    if not interpret:
        kernel_decisions(sz, y_train, (c_train, train_args), serve_args,
                         c_serve, ll,
                         trace_dir or os.path.join(REPO, "traces"))
    raise_if_failed()


def run_four(sz=FULL, seed=0):
    """Data-parallel SSFM and sharded DVB-S2 decode on four devices, each
    compared with the same work on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from opticommpy_tpu.comm import fec_qc
    from opticommpy_tpu.comm.fec import encode_ldpc, standard_ldpc
    from opticommpy_tpu.models import SSFMConfig
    from opticommpy_tpu.models.channels import manakov_ssf
    from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx
    from opticommpy_tpu.parallel import manakov_ssf_dp, shard_batch

    devices = jax.devices()
    check(len(devices) >= 4, f"{len(devices)} devices >= 4")
    mesh = Mesh(np.array(devices[:4]), ("data",))
    print("== four devices: data-parallel SSFM (manakov_ssf_dp) ==",
          flush=True)
    fs = RS * SPS
    fields = []
    for i, p in enumerate((-4.0, -2.0, 0.0, 2.0)):
        txc = WDMTxConfig(M=M, Rs=RS, SpS=SPS, nChannels=11, nPolModes=2,
                          wdmGridSpacing=GRID, powerPerChannel=(p,),
                          nBits=sz.n_samples // SPS * 4, nFilterTaps=1024,
                          pulseRollOff=0.01)
        fields.append(jax.jit(lambda k, c=txc: simple_wdm_tx(k, c)[0])(
            jax.random.PRNGKey(seed + i)))
    # (N, 8): four polmux fields, placed on the mesh before the timing
    e4 = jax.device_put(jnp.concatenate(fields, axis=1), shard_batch(mesh))
    cfg = SSFMConfig(Ltotal=sz.n_spans * L_SPAN, Lspan=L_SPAN, hz=sz.hz,
                     alpha=ALPHA, D=D, gamma=GAMMA, Fs=fs, amp="ideal",
                     nlprMethod=False, trapIters=1, fusedLinear=True)
    key = jax.random.PRNGKey(seed)
    out4 = jax.block_until_ready(manakov_ssf_dp(e4, cfg, key, mesh))
    times = []
    for _ in range(sz.reps):
        t0 = time.perf_counter()
        out4 = jax.block_until_ready(manakov_ssf_dp(e4, cfg, key, mesh))
        times.append(time.perf_counter() - t0)
    t4 = float(np.median(times))
    one = jax.jit(lambda e: manakov_ssf(e, cfg, key))  # on device 0
    refs = [jax.block_until_ready(one(f)) for f in fields]
    times = []
    for _ in range(sz.reps):
        t0 = time.perf_counter()
        for f in fields:
            jax.block_until_ready(one(f))
        times.append(time.perf_counter() - t0)
    t1 = float(np.median(times))
    err = max(rel_l2(np.asarray(out4)[:, 2 * i:2 * i + 2], np.asarray(r))
              for i, r in enumerate(refs))
    steps = int(round(sz.n_spans * L_SPAN / sz.hz))
    print(f"  4 fields x {sz.n_samples} samples, {steps} steps: 4 devices "
          f"{t4:.6f} s vs 1 device {t1:.6f} s ({t1 / t4:.2f}x)", flush=True)
    check(err <= 1e-6,
          f"sharded vs one device: max rel L2 {err:.2e} <= 1e-6 (same "
          "per-field program on every device)")

    n, k, B = 64800, 51840, sz.four_decode_batch
    print(f"== four devices: sharded DVB-S2 decode (B={B}) ==", flush=True)
    _, edges = standard_ldpc("DVBS2", n, "4/5")
    kb = jax.random.PRNGKey(seed + 7)
    info = jax.random.bernoulli(kb, 0.5, (k, B)).astype(jnp.int8)
    cw = encode_ldpc(info, edges=edges)
    sigma = np.sqrt(0.5 * 10 ** (-3.2 / 10))
    y = (1.0 - 2.0 * cw) + sigma * jax.random.normal(
        jax.random.fold_in(kb, 1), cw.shape)
    llr = (2 * y / sigma**2).astype(jnp.float32)
    dec = fec_qc.make_qc_decoder(n, "4/5", 20, "NMSA", "bf16",
                                 early_exit=True)
    sharded = jax.jit(jax.shard_map(
        dec, mesh=mesh, in_specs=P(None, "data"),
        out_specs=(P(None, "data"), P("data"), P("data"))))
    o4, i4, f4 = jax.block_until_ready(sharded(llr))
    o1, i1, f1 = jax.block_until_ready(dec(jax.device_put(llr, devices[0])))

    def timed(fn, x):
        ts = []
        for _ in range(sz.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x))
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    t4 = timed(sharded, llr)
    t1 = timed(dec, jax.device_put(llr, devices[0]))
    print(f"  {B} codewords: 4 devices {t4:.6f} s vs 1 device {t1:.6f} s "
          f"({B * n / t4 / 1e6:.4g} vs {B * n / t1 / 1e6:.4g} coded "
          "Mbit/s)", flush=True)
    check(np.array_equal(np.asarray(o4) < 0, np.asarray(o1) < 0),
          "sharded decisions bit-identical to one device")
    check(np.array_equal(np.asarray(i4), np.asarray(i1))
          and np.array_equal(np.asarray(f4), np.asarray(f1)),
          "sharded iteration counts and failure flags identical")
    raise_if_failed()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU data-parallel paths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-dir", default=os.path.join(REPO, "traces"),
                    help="where the profiler trace of stages 4-5 goes")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import opticommpy_tpu  # noqa: F401  (fails outside a checkout)
    from opticommpy_tpu.utils.compile_cache import enable_persistent_cache

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a CUDA GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    print(f"jax {jax.__version__}; devices {jax.devices()}; compile cache "
          f"{enable_persistent_cache(min_compile_secs=1.0)}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        run_four(FULL, args.seed)
    else:
        run_main_path(FULL, args.seed, trace_dir=args.trace_dir)
        run_gpu_tests()
        raise_if_failed()
    print(f"chip_smoke: all checks passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
