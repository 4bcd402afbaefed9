"""End-to-end jittable pipelines: whole receiver chains as single programs.

The reference composes its chains step by step in notebooks; here each
flagship flow traces into one ``jax.jit`` program, so a device pays one
dispatch per call instead of one per operation:

- :func:`coherent_dsp_chain` — matched filter -> decimation -> EDC -> MIMO
  equalization (adaptive training schedule) -> FOE -> BPS carrier recovery.
- :func:`coherent_dsp_chain_batch` — the same training chain for a batch of
  signals.
- :func:`coherent_dsp_serve` / :func:`coherent_coded_serve` — the
  converged-receiver serving path, optionally through LLRs and LDPC decode.
- :func:`imdd_dsp_chain_batch` — the IM-DD PAM receiver at batch.
"""

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.modulation import gray_mapping
from opticommpy_tpu.dsp.carrier_recovery import bps, fourth_power_foe
from opticommpy_tpu.dsp.equalization import (
    EDCConfig,
    MIMOEqualizerConfig,
    edc,
    mimo_adapt_equalizer,
)
from opticommpy_tpu.ops.filtering import fir_filter, pulse_shape
from opticommpy_tpu.ops.signal import decimate, pnorm

__all__ = ["CoherentDSPConfig", "coherent_dsp_chain",
           "coherent_dsp_chain_batch", "coherent_dsp_serve",
           "coherent_coded_serve", "IMDDConfig", "imdd_dsp_chain_batch"]


@dataclass(frozen=True)
class CoherentDSPConfig:
    """One-jit coherent receiver chain configuration."""

    Rs: float = 32e9
    SpS_in: int = 16  # samples/symbol at the receiver input
    SpS_dsp: int = 2  # samples/symbol for equalization
    # matched filter
    pulseType: str = "rrc"
    nFilterTaps: int = 1024
    rollOff: float = 0.01
    # CD compensation
    L: float = 400.0  # [km]
    D: float = 16.0
    Fc: float = 193.1e12
    # equalizer
    nTaps: int = 15
    mu: tuple = (5e-3, 2e-3)
    alg: tuple = ("da-rde", "dd-lms")
    nTrain: int = 10000
    M: int = 16
    blockUpdate: int = 1
    # adaptive-equalizer backend (MIMOEqualizerConfig.backend): 'auto'
    # takes the Pallas kernel on a GPU and the lax.scan on the CPU;
    # 'pallas' and 'scan' force one. Same training schedule either way.
    eqBackend: str = "auto"
    # run the equalizer kernel in the Pallas interpreter (CPU tests only)
    interpret: bool = False
    # carrier recovery (XLA broadcast BPS, dsp.carrier_recovery.bps)
    cpr_window: int = 75
    cpr_phases: int = 64
    runFOE: bool = True
    # clock recovery (Gardner PI/NCO, reference clockRecovery.py:85): when
    # True a retiming stage runs between EDC and the equalizer, absorbing a
    # sampling-clock frequency offset up to ``crMaxPPM`` ppm; the output
    # keeps the STATIC length (1 - crMaxPPM/1e6) * n_samples (fully valid
    # for true offsets below crMaxPPM; see gardner_clock_recovery). The
    # fractionally-spaced equalizer then absorbs the residual sampling
    # PHASE, so no further interpolation stage is needed.
    runCR: bool = False
    # 'gardner' runs the reference's PI/NCO feedback loop (a sequential
    # while_loop recurrence). 'ffw' runs the feedforward block-parallel recovery
    # (dsp.clock_recovery.ffw_clock_recovery): per-block band-edge
    # spectral-line timing estimates + parallel cubic resampling — no
    # recurrence, so the stage costs a few dense passes instead of a
    # per-sample loop (the serving path for clock offsets).
    crMethod: str = "gardner"
    crKp: float = 2e-3
    crKi: float = 1e-5
    crMaxPPM: float = 500.0
    crNyquist: bool = False
    crBlockLen: int = 4096  # ffw estimation block (samples)
    crFit: str = "linear"  # ffw drift model: 'linear' | 'pwl'


def _norm_const(M):
    """Unit-power square-QAM constellation (complex64, device array)."""
    const = gray_mapping(M, "qam")
    return jnp.asarray(
        (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64))


def _bps_columns(y_cols, cfg):
    """BPS over (nSym, cols) columns, unwrapped; returns (y_rot, phases)."""
    with jax.named_scope("bps"):  # profiler attribution
        phases = bps(y_cols, cfg.cpr_window // 2, _norm_const(cfg.M),
                     cfg.cpr_phases)
        phases = jnp.unwrap(4 * phases, axis=0) / 4
        return y_cols * jnp.exp(1j * phases), phases


def _stage_lengths(cfg: CoherentDSPConfig, n_sym: int):
    """Per-stage symbol counts for the chain's training schedule.

    ``CoherentDSPConfig`` exposes a single ``nTrain`` split, so the chain
    supports 1-stage (all symbols) and 2-stage (nTrain, rest) ``alg``
    tuples; longer schedules need an explicit
    :class:`~opticommpy_tpu.dsp.equalization.MIMOEqualizerConfig` via
    ``mimo_adapt_equalizer`` directly.
    """
    n_stages = len(cfg.alg)
    if n_stages == 1:
        return (n_sym,)
    if n_stages == 2:
        return (cfg.nTrain, n_sym - cfg.nTrain)
    raise ValueError(
        f"CoherentDSPConfig.alg has {n_stages} stages; the chain's "
        "nTrain split only defines schedules for 1 or 2 stages — build a "
        "MIMOEqualizerConfig with an explicit L tuple and call "
        "mimo_adapt_equalizer directly for longer schedules")


def coherent_dsp_chain(sig, symb_ref, config: CoherentDSPConfig = CoherentDSPConfig()):
    """Full coherent DSP chain as one traceable function.

    Parameters
    ----------
    sig : (N, modes) complex received signal at ``SpS_in`` samples/symbol.
    symb_ref : (nSym, modes) transmitted symbols, already synchronized
        (use ops.symbol_sync beforehand, or training-free algorithms).

    Returns
    -------
    (y, phases): equalized + carrier-recovered symbols and the CPR phases.
    """
    cfg = config
    fs_in = cfg.Rs * cfg.SpS_in
    fs_dsp = cfg.Rs * cfg.SpS_dsp

    pulse = pulse_shape(cfg.pulseType, cfg.SpS_in, cfg.nFilterTaps, cfg.rollOff)
    with jax.named_scope("front_end"):
        x = fir_filter(jnp.asarray(pulse.astype(np.float32)), sig)
        x = decimate(x, cfg.SpS_in, cfg.SpS_dsp)
        x = edc(x, EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs_dsp,
                             Rs=cfg.Rs))
        x = pnorm(x)

    n_sym = symb_ref.shape[0]
    if cfg.runCR:
        # Gardner retiming between EDC and the equalizer (the reference
        # chains clock recovery the same way: CD-compensated 2-SpS signal
        # in, retimed 2-SpS signal out — clockRecovery.py:85, exercised in
        # examples/test_clockRecovery.ipynb). static_out keeps the chain
        # one-jit; the T/2-spaced equalizer absorbs the residual phase.
        if cfg.crMethod == "ffw":
            from opticommpy_tpu.dsp.clock_recovery import (
                FFWClockRecoveryConfig, ffw_clock_recovery)

            x = ffw_clock_recovery(
                x, FFWClockRecoveryConfig(blockLen=cfg.crBlockLen,
                                          maxPPM=cfg.crMaxPPM,
                                          rollOff=cfg.rollOff,
                                          fit=cfg.crFit,
                                          sps=cfg.SpS_dsp))
        else:
            from opticommpy_tpu.dsp.clock_recovery import (
                ClockRecoveryConfig, gardner_clock_recovery)

            cr_cfg = ClockRecoveryConfig(kp=cfg.crKp, ki=cfg.crKi,
                                         isNyquist=cfg.crNyquist,
                                         maxPPM=cfg.crMaxPPM)
            x = gardner_clock_recovery(x, cr_cfg, static_out=True)
        x = pnorm(x)
        n_sym_cr = x.shape[0] // cfg.SpS_dsp
        if n_sym > n_sym_cr:
            raise ValueError(
                f"symb_ref has {n_sym} symbols but clock recovery retains "
                f"only {n_sym_cr} ((1 - crMaxPPM/1e6) * n_samples / SpS_dsp)"
                " — trim the reference")
    eq_cfg = MIMOEqualizerConfig(
        nTaps=cfg.nTaps, SpS=cfg.SpS_dsp, mu=cfg.mu, alg=cfg.alg,
        L=_stage_lengths(cfg, n_sym), M=cfg.M, numIter=2,
        blockUpdate=cfg.blockUpdate, backend=cfg.eqBackend,
        interpret=cfg.interpret)
    with jax.named_scope("equalizer"):
        y = mimo_adapt_equalizer(x, eq_cfg, symb_ref=pnorm(symb_ref))
    if cfg.runFOE:
        with jax.named_scope("foe"):
            y, _ = fourth_power_foe(y, cfg.Rs, 4)
            y = pnorm(y)
    y, phases = _bps_columns(y, cfg)
    return pnorm(y), phases


def coherent_dsp_serve(sig_batch, H_batch,
                       config: CoherentDSPConfig = CoherentDSPConfig(),
                       scale=None):
    """Converged-receiver serving path for a batch of signals, one program.

    The steady-state receiver (after :func:`coherent_dsp_chain` has
    converged its taps) is LTI up to carrier phase: matched filter + CD
    compensation + power normalization + frozen MIMO taps collapse into one
    decimating frequency-domain filter per signal
    (:func:`~opticommpy_tpu.dsp.equalization.mimo_apply_fused`), and BPS
    runs once over the whole batch folded into the mode axis.

    Parameters
    ----------
    sig_batch : (B, N, modes) received signals at ``SpS_dsp`` samples/symbol
        (a single (N, modes) signal is also accepted).
    H_batch : (B, modes, modes, nTaps) converged tap tensors from
        ``mimo_adapt_equalizer(..., returnH=...)`` / the training chain.
    scale : optional (B,) training-time pnorm scalars (else Parseval).

    Returns
    -------
    (B, nSym, modes) equalized, carrier-recovered symbols.
    """
    from opticommpy_tpu.dsp.equalization import mimo_apply_fused

    cfg = config
    sig_batch = jnp.asarray(sig_batch)
    squeeze = sig_batch.ndim == 2
    if squeeze:
        sig_batch = sig_batch[None]
        H_batch = jnp.asarray(H_batch)[None]
    fs_dsp = cfg.Rs * cfg.SpS_dsp
    pulse = pulse_shape(cfg.pulseType, cfg.SpS_dsp, cfg.nFilterTaps,
                        cfg.rollOff).astype(np.float32)
    edc_cfg = EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs_dsp, Rs=cfg.Rs)

    def front(sig, Hm, s):
        return mimo_apply_fused(Hm, sig, cfg.SpS_dsp, pre=pulse,
                                edc_config=edc_cfg, scale=s)

    with jax.named_scope("front_end"):
        if scale is None:
            y = jax.vmap(lambda s, h: front(s, h, None))(sig_batch, H_batch)
        else:
            y = jax.vmap(front)(sig_batch, H_batch, jnp.asarray(scale))
    b, n_sym, m = y.shape
    y_cols = jnp.moveaxis(y, 0, 1).reshape(n_sym, b * m)
    out, phases = _bps_columns(y_cols, cfg)
    out = jnp.moveaxis(out.reshape(n_sym, b, m), 1, 0)
    return (out[0], phases[:, :m]) if squeeze else (out, phases)


def coherent_dsp_chain_batch(sig_batch, symb_ref_batch,
                             config: CoherentDSPConfig = CoherentDSPConfig()):
    """Adaptive coherent chain for a BATCH of signals, one program.

    The multi-channel training counterpart of :func:`coherent_dsp_serve`:
    the LTI front end (matched filter, decimation, CD compensation,
    normalization, optional feedforward clock recovery) is vmapped per
    signal; the full multi-stage training schedule (``config.alg``/``config.mu``, numIter=2)
    then runs per signal through
    :func:`~opticommpy_tpu.dsp.equalization.mimo_adapt_equalizer_batch`
    (on the kernel backend: every stage's B recurrences in one launch,
    bit-exact per signal vs the single-signal path), then the optional
    4th-power FOE per signal, and carrier recovery is one BPS call with the
    batch folded into the mode axis.

    Parameters
    ----------
    sig_batch : (B, N, modes) received signals at ``SpS_in`` samples/symbol.
    symb_ref_batch : (B, nSym, modes) synchronized reference symbols.

    Returns
    -------
    (y (B, nSym, modes), phases (nSym, B*modes)).
    """
    from opticommpy_tpu.dsp.equalization import mimo_adapt_equalizer_batch

    cfg = config
    fs_dsp = cfg.Rs * cfg.SpS_dsp
    sig_batch = jnp.asarray(sig_batch)
    symb_ref_batch = jnp.asarray(symb_ref_batch)
    pulse = pulse_shape(cfg.pulseType, cfg.SpS_in, cfg.nFilterTaps,
                        cfg.rollOff).astype(np.float32)
    edc_cfg = EDCConfig(L=cfg.L, D=cfg.D, Fc=cfg.Fc, Fs=fs_dsp, Rs=cfg.Rs)

    if cfg.runCR and cfg.crMethod != "ffw":
        raise NotImplementedError(
            "coherent_dsp_chain_batch supports clock recovery only with "
            "crMethod='ffw' (the feedforward stage vmaps per signal; the "
            "Gardner NCO recurrence has no batched kernel — run "
            "coherent_dsp_chain per signal for that)")
    if cfg.runCR:
        from opticommpy_tpu.dsp.clock_recovery import (
            FFWClockRecoveryConfig, ffw_clock_recovery)

        cr_cfg = FFWClockRecoveryConfig(blockLen=cfg.crBlockLen,
                                        maxPPM=cfg.crMaxPPM,
                                        rollOff=cfg.rollOff, fit=cfg.crFit,
                                        sps=cfg.SpS_dsp)

    def front(sig):
        x = fir_filter(jnp.asarray(pulse), sig)
        x = decimate(x, cfg.SpS_in, cfg.SpS_dsp)
        x = edc(x, edc_cfg)
        x = pnorm(x)
        if cfg.runCR:
            # per-signal feedforward retiming (each signal has its own
            # ADC clock); static output length, as in coherent_dsp_chain
            x = pnorm(ffw_clock_recovery(x, cr_cfg))
        return x

    def foe(y):
        return pnorm(fourth_power_foe(y, cfg.Rs, 4)[0])

    x = jax.vmap(front)(sig_batch)  # (B, n_dsp, modes)
    if cfg.runCR and symb_ref_batch.shape[1] > x.shape[1] // cfg.SpS_dsp:
        raise ValueError(
            f"symb_ref_batch has {symb_ref_batch.shape[1]} symbols but "
            f"clock recovery retains only {x.shape[1] // cfg.SpS_dsp} "
            "((1 - crMaxPPM/1e6) * n_samples / SpS_dsp) — trim the "
            "reference")
    ref = jax.vmap(pnorm)(symb_ref_batch)
    eq_cfg = MIMOEqualizerConfig(
        nTaps=cfg.nTaps, SpS=cfg.SpS_dsp, mu=cfg.mu, alg=cfg.alg,
        L=_stage_lengths(cfg, ref.shape[1]), M=cfg.M, numIter=2,
        blockUpdate=cfg.blockUpdate, backend=cfg.eqBackend,
        interpret=cfg.interpret)
    y = mimo_adapt_equalizer_batch(x, eq_cfg, symb_ref=ref)
    if cfg.runFOE:
        y = jax.vmap(foe)(y)
    b, n_sym, m = y.shape
    out, phases = _bps_columns(jnp.moveaxis(y, 0, 1).reshape(n_sym, b * m),
                               cfg)
    return jnp.moveaxis(out.reshape(n_sym, b, m), 1, 0), phases


@dataclass(frozen=True)
class IMDDConfig:
    """One-jit IM-DD (direct-detection PAM) receiver chain configuration.

    The reference treats IM-DD as a first-class workload
    (/root/reference/optic/models/tx.py:231, equalization.py:1176,
    test_equalizers_for_IMDD_transmission.ipynb); this is its serving
    counterpart — a batch of photodiode-current streams through DC
    removal, symbol-rate sampling, normalization and a vmapped
    decision-feedback (or feedforward) equalizer in one program.
    """

    SpS_in: int = 8  # photodiode-current oversampling
    M: int = 4
    eq: str = "dfe"  # 'dfe' | 'ffe'
    nTapsFF: int = 15
    nTapsFB: int = 5
    mu: float = 2e-3
    nTrain: int = 8000
    trainingMode: str = "fulltime"


def imdd_dsp_chain_batch(i_rx_batch, symb_ref_batch,
                         config: IMDDConfig = IMDDConfig()):
    """IM-DD PAM receiver for a BATCH of signals, one traceable program.

    Parameters
    ----------
    i_rx_batch : (B, N) real photodiode currents at ``SpS_in``
        samples/symbol (a single (N,) stream is also accepted).
    symb_ref_batch : (B, nSym) reference PAM symbols (any scale).

    Returns
    -------
    (y (B, nSym) equalized symbols, mse (B, nSym) per-symbol MSE).

    The B signals' equalizer recurrences run as one vmapped scan
    (:func:`~opticommpy_tpu.dsp.equalization.dfe` /
    :func:`~opticommpy_tpu.dsp.equalization.ffe`) — the IM-DD counterpart
    of :func:`coherent_dsp_serve`.
    """
    from opticommpy_tpu.dsp.equalization import DFEConfig, FFEConfig, dfe, ffe

    cfg = config
    x = jnp.asarray(i_rx_batch)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
        symb_ref_batch = jnp.asarray(symb_ref_batch)[None]
    # DC removal + symbol-rate sampling (photodiode currents are
    # unipolar; the equalizer slicer expects zero-mean PAM)
    x = x - jnp.mean(x, axis=1, keepdims=True)
    n_sym = jnp.asarray(symb_ref_batch).shape[1]
    samples = x[:, ::cfg.SpS_in][:, :n_sym]
    if cfg.eq == "dfe":
        eq_cfg = DFEConfig(nTapsFF=cfg.nTapsFF, nTapsFB=cfg.nTapsFB,
                           mu=cfg.mu, nTrain=cfg.nTrain, M=cfg.M,
                           constType="pam", trainingMode=cfg.trainingMode)
        y, _, _, mse = jax.vmap(lambda s, r: dfe(s, r, eq_cfg))(
            samples, jnp.asarray(symb_ref_batch))
    else:
        eq_cfg = FFEConfig(nTaps=cfg.nTapsFF, mu=cfg.mu, nTrain=cfg.nTrain,
                           M=cfg.M, constType="pam",
                           trainingMode=cfg.trainingMode)
        y, _, mse = jax.vmap(lambda s, r: ffe(s, r, eq_cfg))(
            samples, jnp.asarray(symb_ref_batch))
    if squeeze:
        return y[0], mse[0]
    return y, mse


def coherent_coded_serve(sig_batch, H_batch,
                         config: CoherentDSPConfig = CoherentDSPConfig(),
                         noise_var=0.05, fec_graph=None, fec_config=None,
                         scale=None, pilot_grid=None):
    """Complete coded coherent receiver, composable as ONE program.

    :func:`coherent_dsp_serve` (fused LTI front end + BPS) -> bit LLRs as
    matrix contractions (:func:`~opticommpy_tpu.comm.metrics.calc_llr`) ->
    LDPC belief propagation (the quasi-cyclic roll-based decoder for
    DVB-S2 graphs). The reference composes these stages eagerly across
    notebook cells (test_WDM_transmission + test_fec.ipynb); here the whole
    receive path traces into a single XLA program: one dispatch instead of
    dozens.

    Framing: per signal, the recovered (nSym, modes) symbol grid is read
    mode-major (all of mode 0's symbols, then mode 1's, ...), each symbol
    contributing log2(M) interleaved bits in :func:`calc_llr` order; the
    bit-LLR stream is chopped into consecutive length-n codewords and any
    tail bits beyond the last whole codeword are discarded.

    Parameters
    ----------
    sig_batch : (B, N, modes) received signals at ``SpS_dsp``.
    H_batch : (B, modes, modes, nTaps) converged equalizer taps.
    noise_var : per-symbol noise variance for the LLR model (scalar).
    fec_graph : decoding graph from :func:`~opticommpy_tpu.comm.fec.
        standard_ldpc` / ``ldpc_graph`` (default: DVB-S2 64800b R4/5).
    fec_config : :class:`~opticommpy_tpu.comm.fec.LDPCConfig`
        (default: 20-iteration bf16 NMSA).
    pilot_grid : optional (B, P, modes) known leading tx symbols (any
        scale). Blind BPS carries a k*pi/2 phase ambiguity per column
        (square-QAM symmetry; same in the reference's bps,
        carrierRecovery.py:171); correlating the first P recovered
        symbols against the pilots resolves k per (signal, mode) before
        demapping. Without pilots the caller must resolve the ambiguity
        upstream (e.g. differential coding).

    Returns
    -------
    (decoded_bits (n, n_codewords), frame_fail (n_codewords,),
     symbols (B, nSym, modes)) — codeword c of signal b is column
    ``b * (n_codewords // B) + c``.
    """
    from opticommpy_tpu.comm.fec import LDPCConfig, decode_ldpc, standard_ldpc
    from opticommpy_tpu.comm.metrics import calc_llr
    from opticommpy_tpu.comm.modulation import bit_map

    if fec_graph is None:
        fec_graph, _ = standard_ldpc("DVBS2", 64800, "4/5")
    if fec_config is None:
        # earlyExit by default: the reference's decodeLDPC serving loop
        # breaks on parity success (fec.py:494-497,735) — identical
        # decisions, wall time tracks the slowest codeword of the batch.
        fec_config = LDPCConfig(maxIter=20, alg="NMSA", msgDtype="bf16",
                                earlyExit=True)
    out, _ = coherent_dsp_serve(sig_batch, H_batch, config, scale)
    out3 = out if out.ndim == 3 else out[None]
    B, n_sym, modes = out3.shape
    if pilot_grid is not None:
        pg = jnp.asarray(pilot_grid)
        pg = pg if pg.ndim == 3 else pg[None]
        P = pg.shape[1]
        c = jnp.sum(out3[:, :P] * jnp.conj(pg), axis=1)  # (B, modes)
        k = jnp.round(jnp.angle(c) / (jnp.pi / 2)) % 4
        out3 = out3 * jnp.exp(-1j * (jnp.pi / 2) * k)[:, None, :]
    const = _norm_const(config.M)
    bmap = bit_map(config.M, "qam")
    px = jnp.full(config.M, 1.0 / config.M)
    ys = jnp.moveaxis(out3, 2, 1).reshape(B, modes * n_sym)  # mode-major
    with jax.named_scope("llr"):
        llr = jax.vmap(
            lambda y: calc_llr(y, noise_var, const, bmap, px))(ys)  # (B, bits)
    n_code = fec_graph["n"]
    ncw = llr.shape[1] // n_code
    if ncw == 0:
        raise ValueError(
            f"{llr.shape[1]} bits/signal < one length-{n_code} codeword")
    llr_cols = llr[:, :ncw * n_code].reshape(B * ncw, n_code).T
    with jax.named_scope("ldpc"):
        bits, _, fail = decode_ldpc(llr_cols, graph=fec_graph,
                                    config=fec_config)
    return bits, fail, (out3[0] if out.ndim == 2 else out3)
