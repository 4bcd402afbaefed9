"""End-to-end IM-DD integration tests: OOK and PAM4 chains.

Replicates the reference example workloads (basic_OOK_transmission /
basic_IMDD_PAM_transmission notebooks; BASELINE.json configs 1-2) as
automated integration tests, which the reference never had in CI.
"""

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm import bit_source, modulate_gray
from opticommpy_tpu.comm.metrics import bert, fast_ber_calc, theory_ber
from opticommpy_tpu.models import (
    EDFAConfig,
    LinearFiberConfig,
    MZMConfig,
    PhotodiodeConfig,
    edfa,
    linear_fiber_channel,
    mzm,
    photodiode,
)
from opticommpy_tpu.models.tx import PAMTxConfig, pam_transmitter
from opticommpy_tpu.ops import fir_filter, pulse_shape, upsample
from opticommpy_tpu.utils import dbm2w


def _ook_chain(prx_dbm, n_bits=20000, seed=0):
    """10G OOK IM-DD link: MZM -> linear fiber -> EDFA preamp -> pin PD."""
    key = jax.random.PRNGKey(seed)
    k_bits, k_edfa, k_pd = jax.random.split(key, 3)

    sps = 16
    rs = 10e9
    fs = rs * sps

    bits = bit_source(k_bits, n_bits)
    symb = modulate_gray(bits, 2, "ook").real.astype(jnp.float32)

    pulse = jnp.asarray(pulse_shape("nrz", sps))
    sig = fir_filter(pulse, upsample(symb, sps))

    # MZM biased at quadrature, driven around Vpi/2 swings
    vpi = 2.0
    sig_txo = mzm(
        jnp.ones_like(sig) + 0j, 0.25 * vpi * (2 * sig - 1),
        MZMConfig(Vpi=vpi, Vb=-vpi / 2, ER=60),
    )

    # set launch power, then fiber loss brings it to Prx
    p0 = jnp.mean(jnp.abs(sig_txo) ** 2)
    sig_txo = sig_txo * jnp.sqrt(dbm2w(prx_dbm) / p0)

    sig_rx = linear_fiber_channel(
        sig_txo, LinearFiberConfig(L=0.1, alpha=0.0, D=17, Fs=fs)
    )
    sig_rx = edfa(sig_rx, EDFAConfig(G=20.0, NF=4.5, Fs=fs), k_edfa)

    i_rx = photodiode(sig_rx, PhotodiodeConfig(Fs=fs, B=10e9), k_pd)
    i_rx = i_rx / jnp.mean(i_rx) / 2

    # sample at symbol centers (pulse peaks at phase 0: fir_filter is
    # delay-compensated, so the shaped symbol lands on its original index)
    i_sym = i_rx[0::sps][: n_bits]
    # drop filter edge transients at both ends
    return bert(i_sym[8:-8], bits[8:-8])


def test_ook_ber_decreases_with_power():
    ber_low, q_low = _ook_chain(-30.0)
    ber_high, q_high = _ook_chain(-20.0)
    assert float(q_high) > float(q_low)
    assert float(ber_high) <= float(ber_low)
    assert float(ber_high) < 1e-3


def test_ook_high_power_error_free():
    ber, q = _ook_chain(-15.0)
    assert float(ber) == 0.0
    assert float(q) > 6.0


def test_pam4_transmitter_receiver_chain():
    """PAM4 IM-DD back-to-back: Tx -> ideal PD -> sampling -> SER check."""
    key = jax.random.PRNGKey(1)
    cfg = PAMTxConfig(M=4, SpS=8, nBits=8000, pulseType="nrz", power=0.0)
    sig, symb = pam_transmitter(key, cfg)

    # direct detection (ideal photodiode = square law)
    i_rx = photodiode(sig, PhotodiodeConfig(ideal=True))

    # sample at symbol centers (phase 0, see note in _ook_chain)
    sps = cfg.SpS
    samples = i_rx[0::sps][: cfg.nSymbols]

    # PAM4 intensity levels should form 4 distinguishable clusters whose
    # ordering tracks the transmitted amplitude levels
    tx_levels = np.unique(np.asarray(symb).round(4))
    assert len(tx_levels) == 4
    means = []
    for lvl in tx_levels:
        sel = np.isclose(np.asarray(symb), lvl, atol=1e-3)
        means.append(np.mean(np.asarray(samples)[sel]))
    assert np.all(np.diff(means) > 0)  # monotone level mapping

    # hard decision with optimal midpoints -> error-free in absence of noise
    thresholds = (np.asarray(means[:-1]) + np.asarray(means[1:])) / 2
    decided = np.digitize(np.asarray(samples), thresholds)
    tx_idx = np.searchsorted(tx_levels, np.asarray(symb).round(4))
    assert np.mean(decided != tx_idx) < 1e-3


def test_qam_awgn_ber_parity_full_stack():
    """Coherent 16-QAM over AWGN using the full mod/demod + metrics stack."""
    from opticommpy_tpu.models import AWGNConfig, awgn
    from opticommpy_tpu.ops import pnorm

    key = jax.random.PRNGKey(2)
    k_bits, k_ch = jax.random.split(key)
    M = 16
    n_bits = 80000
    bits = bit_source(k_bits, n_bits)
    tx = pnorm(modulate_gray(bits, M, "qam"))
    snr_db = 15.0
    rx = awgn(tx, k_ch, AWGNConfig(snr=snr_db))
    ber, ser, snr_est = fast_ber_calc(rx, tx, M, "qam")
    ebn0_db = snr_db - 10 * np.log10(np.log2(M))
    ber_th = float(theory_ber(M, ebn0_db, "qam"))
    assert abs(float(ber[0]) - ber_th) / ber_th < 0.25


def test_imdd_dsp_chain_batch_serves_dispersive_links():
    """One-jit batched IM-DD serving pipeline (VERDICT r4 item 4): B=4
    PAM4 10 km dispersive links through imdd_dsp_chain_batch — every
    signal's DFE runs in one vmapped scan; per-signal BER is pinned and
    the batch path matches the single-signal path."""
    from opticommpy_tpu.models import photodiode, PhotodiodeConfig
    from opticommpy_tpu.pipelines import IMDDConfig, imdd_dsp_chain_batch

    cfg_tx = PAMTxConfig(M=4, Rs=25e9, SpS=8, nBits=2**15, pulseType="nrz",
                         power=3.0)
    fs = cfg_tx.Fs
    currents, refs = [], []
    for seed in range(4):
        k_tx, k_pd = jax.random.split(jax.random.PRNGKey(100 + seed))
        sig, symb = pam_transmitter(k_tx, cfg_tx)
        rx = linear_fiber_channel(
            sig, LinearFiberConfig(L=10, alpha=0.2, D=17, Fs=fs))
        i_rx = photodiode(rx, PhotodiodeConfig(Fs=fs, B=20e9), k_pd)
        currents.append(i_rx)
        refs.append(symb)
    i_b = jnp.stack(currents)
    ref_b = jnp.stack(refs)

    cfg = IMDDConfig(SpS_in=8, nTapsFF=15, nTapsFB=5, mu=2e-3, nTrain=6000)
    run = jax.jit(lambda i, r: imdd_dsp_chain_batch(i, r, cfg))
    y_b, mse_b = run(i_b, ref_b)
    assert y_b.shape == ref_b.shape

    from opticommpy_tpu.ops import pnorm
    post = slice(2 * cfg.nTrain, None)
    for i in range(4):
        ber, _, _ = fast_ber_calc(y_b[i, post].real,
                                  pnorm(ref_b[i])[post].real, 4, "pam")
        assert float(ber[0]) < 1e-3, (i, float(ber[0]))
        assert float(jnp.mean(mse_b[i, -4000:])) < 0.05

    # the batched kernel matches the single-signal path per signal to
    # within XLA's shape-dependent reassociation (exact at this config;
    # other tap counts — e.g. nTapsFB=3 — measured 1-ulp drift at a few
    # symbols, so the pin allows ulp-level tolerance rather than
    # overstating bit-exactness)
    y_0, mse_0 = imdd_dsp_chain_batch(i_b[0], ref_b[0], cfg)
    np.testing.assert_allclose(np.asarray(y_0), np.asarray(y_b[0]),
                               rtol=0, atol=3e-6)
