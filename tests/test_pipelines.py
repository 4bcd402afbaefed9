"""Tests for the one-jit coherent DSP pipeline."""

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.metrics import fast_ber_calc
from opticommpy_tpu.models import (
    LaserConfig,
    PDMFrontendConfig,
    SSFMConfig,
    basic_laser_model,
    manakov_ssf,
    pdm_coherent_receiver,
)
from opticommpy_tpu.models.tx import WDMTxConfig, simple_wdm_tx
from opticommpy_tpu.ops import decimate, fir_filter, pnorm, pulse_shape, symbol_sync
from opticommpy_tpu.dsp import EDCConfig, edc
from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_chain


def test_coherent_pipeline_one_jit():
    key = jax.random.PRNGKey(33)
    k_tx, k_ch, k_lo, k_rx = jax.random.split(key, 4)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**15, nChannels=1,
                         nPolModes=2, nFilterTaps=512, pulseRollOff=0.01,
                         powerPerChannel=(0.0,), laserLinewidth=50e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=100, Lspan=50, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", nlprMethod=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    lo = basic_laser_model(LaserConfig(P=10.0, lw=50e3, Ns=sig_ch.shape[0],
                                       Fs=fs, freqShift=50e6, RIN_var=0.0), k_lo)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs),
                                   key=k_rx)

    # synchronize the reference once, outside the pipeline
    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 512, 0.01))
    pre = decimate(fir_filter(pulse, sig_rx), cfg_tx.SpS, 2)
    pre = edc(pre, EDCConfig(L=100, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, 0], 2))

    cfg = CoherentDSPConfig(SpS_in=cfg_tx.SpS, nFilterTaps=512, L=100,
                            nTrain=4000, blockUpdate=1)
    chain = jax.jit(lambda s, d: coherent_dsp_chain(s, d, cfg))
    y, phases = chain(sig_rx, d_ref)
    disc = 5000
    ber, _, snr = fast_ber_calc(y[disc:-100], d_ref[disc:-100], 16, "qam")
    assert float(jnp.max(ber)) < 5e-3, np.asarray(ber)

    # blockUpdate variant of the same one-jit chain also converges
    cfg_b = CoherentDSPConfig(SpS_in=cfg_tx.SpS, nFilterTaps=512, L=100,
                              nTrain=4000, blockUpdate=16, mu=(5e-3, 1e-3))
    y_b, _ = jax.jit(lambda s, d: coherent_dsp_chain(s, d, cfg_b))(sig_rx, d_ref)
    ber_b, _, _ = fast_ber_calc(y_b[disc:-100], d_ref[disc:-100], 16, "qam")
    assert float(jnp.max(ber_b)) < 1e-2, np.asarray(ber_b)


def test_coherent_pipeline_pallas_backend():
    """The same one-jit chain with the equalizer stages on the Pallas
    kernel (in the interpreter on the CPU)."""
    key = jax.random.PRNGKey(34)
    k_tx, k_ch, k_lo, k_rx = jax.random.split(key, 4)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**15, nChannels=1,
                         nPolModes=2, nFilterTaps=512, pulseRollOff=0.01,
                         powerPerChannel=(0.0,), laserLinewidth=50e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=100, Lspan=50, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", nlprMethod=True)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    lo = basic_laser_model(LaserConfig(P=10.0, lw=50e3, Ns=sig_ch.shape[0],
                                       Fs=fs, freqShift=50e6, RIN_var=0.0), k_lo)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs),
                                   key=k_rx)
    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 512, 0.01))
    pre = decimate(fir_filter(pulse, sig_rx), cfg_tx.SpS, 2)
    pre = edc(pre, EDCConfig(L=100, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, 0], 2))

    cfg = CoherentDSPConfig(SpS_in=cfg_tx.SpS, nFilterTaps=512, L=100,
                            nTrain=6000, mu=(2e-3, 1e-3), eqBackend="pallas",
                            interpret=True)
    y, _ = jax.jit(lambda s, d: coherent_dsp_chain(s, d, cfg))(sig_rx, d_ref)
    disc = 7000
    ber, _, _ = fast_ber_calc(y[disc:-100], d_ref[disc:-100], 16, "qam")
    assert float(jnp.max(ber)) < 1e-2, np.asarray(ber)


_CR_SCENARIO = {}


def _cr_offset_scenario():
    """Shared 200-ppm clock-offset link for the CR chain tests.

    Receiver ADC runs 200 ppm fast with sampling jitter; at 50 ppm the
    fractionally-spaced DD-LMS tracks the drift by itself (measured BER
    0.0047 vs 0.0041 with CR) — 200 ppm slips ~6.5 samples across the
    record and breaks the plain chain (BER 0.42)."""
    if _CR_SCENARIO:
        return _CR_SCENARIO["v"]
    from opticommpy_tpu.ops.signal import clock_sampling_interp

    key = jax.random.PRNGKey(35)
    k_tx, k_ch, k_lo, k_rx, k_j = jax.random.split(key, 5)
    cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**15, nChannels=1,
                         nPolModes=2, nFilterTaps=512, pulseRollOff=0.01,
                         powerPerChannel=(0.0,), laserLinewidth=50e3)
    fs = cfg_tx.Fs
    sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
    cfg_ch = SSFMConfig(Ltotal=50, Lspan=50, alpha=0.2, D=16, gamma=1.3,
                        Fs=fs, amp="edfa", nlprMethod=False, hz=1.0)
    sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
    lo = basic_laser_model(LaserConfig(P=10.0, lw=50e3, Ns=sig_ch.shape[0],
                                       Fs=fs, freqShift=50e6, RIN_var=0.0),
                           k_lo)
    sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs),
                                   key=k_rx)

    # reference sync from the CLEAN signal (50 ppm drifts < 1 sample over
    # this record, so the alignment carries over to the offset signal)
    pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 512, 0.01))
    pre = decimate(fir_filter(pulse, sig_rx), cfg_tx.SpS, 2)
    pre = edc(pre, EDCConfig(L=50, D=16, Fs=2 * 32e9, Rs=32e9))
    d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, 0], 2))

    # receiver ADC runs 200 ppm fast, with sampling jitter
    sig_off = clock_sampling_interp(sig_rx, fs, fs * (1 + 200e-6),
                                    jitter_rms=1e-3 / fs, key=k_j)

    n_sym_cr = (sig_off.shape[0] // (8 // 2)
                * 999) // 1000 // 2 * 2  # conservative post-CR budget
    d_cr = d_ref[:min(8000, n_sym_cr)]
    _CR_SCENARIO["v"] = (sig_off, d_cr)
    _CR_SCENARIO["rx"] = (sig_rx, fs)
    return _CR_SCENARIO["v"]


def test_coherent_pipeline_with_clock_recovery():
    """One-jit chain with the Gardner stage: a +200 ppm receiver-clock
    offset (plus sampling jitter) that breaks the plain chain is absorbed
    by runCR=True (VERDICT r4 item 3; reference clockRecovery.py:85 +
    test_clockRecovery.ipynb compose clock recovery the same way).
    CR-chain BER 0.0033 (CPU mesh, this exact seed)."""
    sig_off, d_cr = _cr_offset_scenario()
    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=4000,
                            runCR=True, crNyquist=True,
                            crKp=2e-3, crKi=1e-5)
    chain = jax.jit(lambda s, d: coherent_dsp_chain(s, d, cfg))
    y, _ = chain(sig_off, d_cr)
    disc = 5000
    ber, _, _ = fast_ber_calc(y[disc:-100], d_cr[disc:-100], 16, "qam")
    assert float(jnp.max(ber)) < 1e-2, np.asarray(ber)

    # control: without clock recovery the same offset signal is
    # unequalizable (the drifting sampling phase defeats the static taps)
    cfg_off = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=4000)
    y_n, _ = jax.jit(lambda s, d: coherent_dsp_chain(s, d, cfg_off))(
        sig_off, d_cr)
    ber_n, _, _ = fast_ber_calc(y_n[disc:-100], d_cr[disc:-100], 16, "qam")
    assert float(jnp.max(ber_n)) > 10 * float(jnp.max(ber))


def test_coherent_pipeline_with_ffw_clock_recovery():
    """The same 200-ppm offset link through crMethod='ffw' — the
    feedforward block-parallel recovery (spectral-line estimate +
    parallel resampler, no recurrence) recovers the link like the
    Gardner loop does, at dense-XLA cost instead of a per-sample NCO."""
    sig_off, d_cr = _cr_offset_scenario()
    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=4000,
                            runCR=True, crMethod="ffw")
    chain = jax.jit(lambda s, d: coherent_dsp_chain(s, d, cfg))
    y, _ = chain(sig_off, d_cr)
    disc = 5000
    ber, _, _ = fast_ber_calc(y[disc:-100], d_cr[disc:-100], 16, "qam")
    assert float(jnp.max(ber)) < 1e-2, np.asarray(ber)


def test_coherent_batch_chain_with_ffw_clock_recovery():
    """coherent_dsp_chain_batch(runCR=True, crMethod='ffw'): two signals
    with DIFFERENT receiver clock offsets (+200 / -150 ppm) through one
    batched program — each signal gets its own feedforward clock
    estimate, and both recover. Gardner in the batch chain raises (no
    batched NCO kernel)."""
    import pytest

    from opticommpy_tpu.ops.signal import clock_sampling_interp
    from opticommpy_tpu.pipelines import coherent_dsp_chain_batch

    sig_off, d_cr = _cr_offset_scenario()
    sig_rx, fs = _CR_SCENARIO["rx"]
    k_j2 = jax.random.PRNGKey(77)
    sig_off2 = clock_sampling_interp(sig_rx, fs, fs * (1 - 150e-6),
                                     jitter_rms=1e-3 / fs, key=k_j2)
    n = min(sig_off.shape[0], sig_off2.shape[0])
    sig_b = jnp.stack([sig_off[:n], sig_off2[:n]])
    d_b = jnp.stack([d_cr, d_cr])

    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50,
                            nTrain=4000, runCR=True, crMethod="ffw")
    y, _ = jax.jit(
        lambda s, d: coherent_dsp_chain_batch(s, d, cfg))(sig_b, d_b)
    disc = 5000
    for b in range(2):
        ber, _, _ = fast_ber_calc(y[b, disc:-100], d_b[b, disc:-100],
                                  16, "qam")
        assert float(jnp.max(ber)) < 1e-2, (b, np.asarray(ber))

    with pytest.raises(NotImplementedError):
        coherent_dsp_chain_batch(
            sig_b, d_b,
            CoherentDSPConfig(runCR=True, crMethod="gardner"))


def test_coherent_pipeline_4x4_modes():
    """N=4 mode-multiplexed chain (VERDICT r4 item 9): a 4x4 complex mixing
    channel through the SAME one-jit coherent_dsp_chain, on the scan AND
    Pallas equalizer backends — no composed chain had run at >2 modes.
    Reference N x N claim: equalization.py:125."""
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.ops import fir_filter, pulse_shape, upsample

    rng = np.random.default_rng(77)
    n_sym, sps, modes = 2**14, 2, 4
    const = gray_mapping(16, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(
        np.complex64)
    sym = const[rng.integers(0, 16, size=(n_sym, modes))]
    pulse = jnp.asarray(pulse_shape("rrc", sps, 257, 0.1))
    wav = fir_filter(pulse, upsample(jnp.asarray(sym), sps))
    mix = (np.eye(modes) + 0.12 * (rng.normal(size=(modes, modes))
                                   + 1j * rng.normal(size=(modes, modes)))
           ).astype(np.complex64)
    sig = jnp.asarray(np.asarray(wav) @ mix.T
                      + 0.015 * (rng.normal(size=wav.shape)
                                 + 1j * rng.normal(size=wav.shape)))
    ref = jnp.asarray(sym)

    for backend in ("scan", "pallas"):
        cfg = CoherentDSPConfig(
            SpS_in=sps, SpS_dsp=sps, nFilterTaps=257, rollOff=0.1, L=0.5,
            nTaps=15, mu=(5e-3, 1e-3), nTrain=6000, runFOE=False,
            eqBackend=backend, interpret=True)
        y, _ = jax.jit(lambda s, d: coherent_dsp_chain(s, d, cfg))(sig, ref)
        assert y.shape[1] == modes
        disc = 8000
        ber, _, _ = fast_ber_calc(y[disc:-100], ref[disc:-100], 16, "qam")
        assert float(jnp.max(ber)) < 1e-2, (backend, np.asarray(ber))


def test_coherent_dsp_serve_matches_staged_components():
    """Serving path == staged mimo_apply+bps composition per signal."""
    import numpy as np
    from opticommpy_tpu.comm.modulation import gray_mapping
    from opticommpy_tpu.dsp.carrier_recovery import bps
    from opticommpy_tpu.dsp.equalization import EDCConfig, edc, mimo_apply
    from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape
    from opticommpy_tpu.ops.signal import pnorm
    from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_serve

    rng = np.random.default_rng(3)
    cfg = CoherentDSPConfig(nFilterTaps=128, L=50, cpr_window=33,
                            cpr_phases=32)
    n = 2**12
    b = 3
    sig_b = (0.3 * (rng.normal(size=(b, n, 2)) + 1j * rng.normal(size=(b, n, 2)))
             ).astype(np.complex64)
    H_b = (0.1 * (rng.normal(size=(b, 2, 2, 15))
                  + 1j * rng.normal(size=(b, 2, 2, 15)))).astype(np.complex64)
    H_b[:, 0, 0, 7] += 1
    H_b[:, 1, 1, 7] += 1

    out, phases = coherent_dsp_serve(jnp.asarray(sig_b), jnp.asarray(H_b), cfg)
    assert out.shape[0] == b and out.shape[2] == 2

    # staged reference for signal 0
    fs = cfg.Rs * cfg.SpS_dsp
    pulse = pulse_shape(cfg.pulseType, cfg.SpS_dsp, cfg.nFilterTaps,
                        cfg.rollOff).astype(np.float32)
    x = fir_filter(jnp.asarray(pulse), jnp.asarray(sig_b[0]))
    x = edc(x, EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs, Rs=cfg.Rs))
    y0 = mimo_apply(jnp.asarray(H_b[0]), pnorm(x), cfg.SpS_dsp)
    const = gray_mapping(cfg.M, "qam")
    const = (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    ph0 = bps(y0, cfg.cpr_window // 2, jnp.asarray(const), cfg.cpr_phases)
    ph0 = jnp.unwrap(4 * ph0, axis=0) / 4
    ref0 = np.asarray(y0 * jnp.exp(1j * ph0))

    got0 = np.asarray(out[0])
    lo, hi = 32, ref0.shape[0] - (cfg.nFilterTaps + 200) // cfg.SpS_dsp
    err = (np.linalg.norm(got0[lo:hi] - ref0[lo:hi])
           / np.linalg.norm(ref0[lo:hi]))
    assert err < 5e-2, err  # Parseval scale + BPS backend quantization


def test_coherent_dsp_serve_single_signal():
    import numpy as np
    from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_serve

    rng = np.random.default_rng(4)
    cfg = CoherentDSPConfig(nFilterTaps=64, L=20, cpr_window=17,
                            cpr_phases=16)
    sig = (0.3 * (rng.normal(size=(2**11, 2)) + 1j * rng.normal(size=(2**11, 2)))
           ).astype(np.complex64)
    H = np.zeros((2, 2, 15), dtype=np.complex64)
    H[0, 0, 7] = 1
    H[1, 1, 7] = 1
    out, phases = coherent_dsp_serve(jnp.asarray(sig), jnp.asarray(H), cfg)
    assert out.ndim == 2 and out.shape[1] == 2
    assert np.isfinite(np.asarray(out)).all()


def test_coherent_dsp_serve_sharded_batch():
    """Serving scales over the mesh data axis: shard_map == single-device."""
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from opticommpy_tpu.pipelines import CoherentDSPConfig, coherent_dsp_serve

    rng = np.random.default_rng(5)
    cfg = CoherentDSPConfig(nFilterTaps=64, L=20, cpr_window=17,
                            cpr_phases=16)
    b = 4
    sig_b = (0.3 * (rng.normal(size=(b, 2**11, 2))
                    + 1j * rng.normal(size=(b, 2**11, 2)))).astype(np.complex64)
    H_b = np.zeros((b, 2, 2, 15), dtype=np.complex64)
    H_b[:, 0, 0, 7] = 1
    H_b[:, 1, 1, 7] = 1

    ref, _ = coherent_dsp_serve(jnp.asarray(sig_b), jnp.asarray(H_b), cfg)

    mesh = Mesh(np.array(jax.devices()[:b]), ("data",))
    fn = jax.shard_map(
        lambda s, h: coherent_dsp_serve(s, h, cfg)[0],
        mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P("data"),
    )
    out = fn(jnp.asarray(sig_b), jnp.asarray(H_b))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def test_coherent_dsp_chain_batch_converges():
    """Batched adaptive chain: two real links decode with low BER."""
    from opticommpy_tpu.pipelines import coherent_dsp_chain_batch

    sigs, refs = [], []
    for seed in (41, 42):
        key = jax.random.PRNGKey(seed)
        k_tx, k_ch, k_lo, k_rx = jax.random.split(key, 4)
        cfg_tx = WDMTxConfig(M=16, Rs=32e9, SpS=8, nBits=2**15, nChannels=1,
                             nPolModes=2, nFilterTaps=512, pulseRollOff=0.01,
                             powerPerChannel=(0.0,), laserLinewidth=50e3)
        fs = cfg_tx.Fs
        sig_tx, symb_tx, _ = simple_wdm_tx(k_tx, cfg_tx)
        cfg_ch = SSFMConfig(Ltotal=50, Lspan=50, alpha=0.2, D=16, gamma=1.3,
                            Fs=fs, amp="edfa", nlprMethod=False, hz=1.0)
        sig_ch = manakov_ssf(sig_tx, cfg_ch, k_ch)
        lo = basic_laser_model(LaserConfig(P=10.0, lw=50e3,
                                           Ns=sig_ch.shape[0], Fs=fs,
                                           freqShift=50e6, RIN_var=0.0), k_lo)
        sig_rx = pdm_coherent_receiver(sig_ch, lo, PDMFrontendConfig(Fs=fs),
                                       key=k_rx)
        pulse = jnp.asarray(pulse_shape("rrc", cfg_tx.SpS, 512, 0.01))
        pre = decimate(fir_filter(pulse, sig_rx), cfg_tx.SpS, 2)
        pre = edc(pre, EDCConfig(L=50, D=16, Fs=2 * 32e9, Rs=32e9))
        d_ref = pnorm(symbol_sync(pre, symb_tx[:, :, 0], 2))
        sigs.append(sig_rx)
        refs.append(d_ref)

    sig_b = jnp.stack(sigs)
    ref_b = jnp.stack(refs)
    cfg = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=3000,
                            mu=(2e-3,))
    y_b, _ = coherent_dsp_chain_batch(sig_b, ref_b, cfg)
    # eqBackend='pallas': the same multi-stage schedule with every kernel
    # stage's recurrences in one launch recovers the same links
    cfg_ms = CoherentDSPConfig(SpS_in=8, nFilterTaps=512, L=50, nTrain=3000,
                               mu=(5e-3, 2e-3), eqBackend="pallas",
                               interpret=True)
    y_ms, _ = coherent_dsp_chain_batch(sig_b, ref_b, cfg_ms)
    disc = 4000
    for i in range(2):
        ber, _, _ = fast_ber_calc(y_b[i, disc:-100], ref_b[i][disc:-100],
                                  16, "qam")
        assert float(jnp.max(ber)) < 1e-2, (i, np.asarray(ber))
        ber_ms, _, _ = fast_ber_calc(y_ms[i, disc:-100], ref_b[i][disc:-100],
                                     16, "qam")
        assert float(jnp.max(ber_ms)) < 1e-2, (i, np.asarray(ber_ms))


def test_coherent_coded_serve_end_to_end():
    """Complete coded receiver in one jit: serving DSP chain -> bit
    LLRs -> LDPC BP. Loopback RRC 16QAM with AWGN; all codewords clear of
    the FIR edge transients decode error-free (802.11n 648b R1/2)."""
    from opticommpy_tpu.comm.codes import ldpc_parity_matrix
    from opticommpy_tpu.comm.fec import (
        LDPCConfig,
        encode_ldpc,
        ldpc_graph,
        triang_p1p2,
    )
    from opticommpy_tpu.comm.modulation import modulate_gray
    from opticommpy_tpu.ops.signal import upsample
    from opticommpy_tpu.pipelines import coherent_coded_serve

    H = ldpc_parity_matrix(mode="IEEE_802.11nD2", n=648, R="1/2")
    rng = np.random.default_rng(9)
    n_sym, modes, bps = 1024, 2, 4
    nbits = n_sym * modes * bps  # 8192 -> 12 codewords + tail
    ncw = nbits // 648
    msg = rng.integers(0, 2, size=(324, ncw))
    # triangular encoding when possible, generator fallback otherwise
    P1, P2, Hm = triang_p1p2(H)
    if P1 is not None:
        cw = np.asarray(encode_ldpc(jnp.asarray(msg), H=Hm, P1=P1, P2=P2,
                                    config=LDPCConfig(mode="triang")))
    else:
        from opticommpy_tpu.comm.fec import par2gen

        G, _, Hm = par2gen(H)
        cw = np.asarray(encode_ldpc(jnp.asarray(msg), H=Hm,
                                    config=LDPCConfig(mode="G"), G=G))
    graph = ldpc_graph(Hm)
    stream = np.concatenate(
        [cw.T.reshape(-1), rng.integers(0, 2, size=nbits - 648 * ncw)])
    syms = np.asarray(modulate_gray(jnp.asarray(stream), 16, "qam"))
    grid = syms.reshape(modes, n_sym).T  # mode-major framing of the serve
    # RRC shaping at SpS_dsp (odd taps: no half-sample shift; CLAUDE.md)
    sps, taps = 2, 257
    pulse = jnp.asarray(pulse_shape("rrc", sps, taps, 0.01))
    wav = fir_filter(pulse, upsample(jnp.asarray(grid), sps))
    wav = wav + 0.02 * (rng.normal(size=wav.shape)
                        + 1j * rng.normal(size=wav.shape))
    Hb = np.zeros((1, 2, 2, 15), np.complex64)
    Hb[:, 0, 0, 7] = Hb[:, 1, 1, 7] = 1
    cfg = CoherentDSPConfig(nFilterTaps=taps, L=0.5, cpr_window=33,
                            cpr_phases=32, M=16)
    fcfg = LDPCConfig(maxIter=30, alg="NMSA")
    # pilots resolve the blind-CPR k*pi/2 ambiguity per (signal, mode)
    pilots = jnp.asarray(
        (grid[:64] / np.sqrt(np.mean(np.abs(grid) ** 2)))[None])
    run = jax.jit(lambda s, h, p: coherent_coded_serve(
        s, h, cfg, 0.05, fec_graph=graph, fec_config=fcfg, pilot_grid=p))
    bits, fail, out = run(jnp.asarray(wav.astype(np.complex64))[None],
                          jnp.asarray(Hb), pilots)
    assert bits.shape == (648, ncw)
    # codewords overlapping the tx/MF edge transients may fail; everything
    # clear of them must decode exactly
    clean = [1, 2, 3, 4, 8, 9, 10]
    fail = np.asarray(fail)
    assert fail[clean].sum() == 0, fail
    assert np.array_equal(np.asarray(bits)[:, clean], cw[:, clean])
    assert fail.sum() <= 5, fail
