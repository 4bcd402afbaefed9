"""Static and adaptive equalization: EDC, NxN MIMO adaptive EQ, DBP, DFE/FFE/Volterra.

Counterpart of reference ``optic/dsp/equalization.py``:

- :func:`edc` ~ equalization.py:36 — frequency-domain CD compensation over the
  batched overlap-save primitive (all modes in one call; the time axis can be
  sharded across chips, see opticommpy_tpu.parallel).
- :func:`mimo_adapt_equalizer` ~ equalization.py:125 with the Numba hot loop
  coreAdaptEq (equalization.py:354) re-expressed as a ``lax.scan`` over
  symbols carrying the tap tensor H — the update rule is selected at trace
  time, so each training stage compiles to one fused scan kernel. All seven
  update rules (nlms/cma/dd-lms/rde/da-rde/rls/dd-rls) + 'static' and the
  widely-linear mode are implemented.
- :func:`manakov_dbp` ~ equalization.py:976 — digital backpropagation reusing
  the Manakov span kernel from opticommpy_tpu.models.channels with inverted
  signs (one code path for channel and compensator).
- :func:`dfe` / :func:`ffe` / :func:`volterra` ~ equalization.py:1176,1545,1868
  — SISO decision-feedback scans.
"""

import dataclasses
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.modulation import gray_mapping
from opticommpy_tpu.comm.sources import symbol_pmf
from opticommpy_tpu.models.channels import _manakov_span, _to_columns, fiber_coefficients
from opticommpy_tpu.models.config import SSFMConfig
from opticommpy_tpu.ops.filtering import overlap_save
from opticommpy_tpu.ops.signal import anorm, pnorm

__all__ = [
    "edc",
    "EDCConfig",
    "mimo_adapt_equalizer",
    "mimo_adapt_equalizer_batch",
    "mimo_apply",
    "mimo_apply_fused",
    "MIMOEqualizerConfig",
    "manakov_dbp",
    "dfe",
    "ffe",
    "volterra",
    "DFEConfig",
    "FFEConfig",
    "VolterraConfig",
]


# ---------------------------------------------------------------------------
# EDC
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EDCConfig:
    """Chromatic-dispersion compensation parameters (equalization.py:36)."""

    L: float = 50.0  # [km]
    D: float = 16.0  # [ps/nm/km]
    Fc: float = 193.1e12
    Fs: float = None
    Rs: float = 32e9
    NfilterCoeffs: int = None
    Nfft: int = None


def edc(sig, config: EDCConfig):
    """Electronic chromatic dispersion compensation (reference equalization.py:36).

    Builds the inverse CD frequency response ``H = exp(-j*b2/2*w^2*L)`` on an
    auto-sized tap grid (Savory's rule, equalization.py:97) and applies it
    with overlap-save block convolution — one batched call across modes.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    sig = jnp.asarray(sig)
    _, beta2 = fiber_coefficients(0.0, config.D, config.Fc)
    n_coeffs = config.NfilterCoeffs
    if n_coeffs is None:
        n_coeffs = int(
            2
            * np.ceil(
                6.67 * np.abs(beta2) * config.L * config.Rs**2 * (config.Fs / config.Rs)
            )
        )
    nfft = config.Nfft
    if nfft is None:
        # the reference uses next-pow2(K) (equalization.py:103), which makes
        # the overlap-save valid-block length K-1 times smaller than the FFT
        # — pathological for long CD filters. 8x the filter length keeps
        # ~7/8 of every FFT productive; the 16384 floor keeps per-block
        # overhead small next to the FFT work. Capped at one single-signal
        # block.
        nfft = min(
            max(8 * 2 ** int(np.ceil(np.log2(n_coeffs))), 16384),
            2 ** int(np.ceil(np.log2(sig.shape[0] + n_coeffs))),
        )
    w = 2 * np.pi * config.Fs * np.fft.fftfreq(n_coeffs)
    H = jnp.asarray(np.exp(-1j * (beta2 / 2) * (w**2) * config.L).astype(np.complex64))
    if config.Nfft is None and sig.shape[0] + n_coeffs <= 2**22:
        # one transposed FFT with time on the minor axis (no block
        # gathers, no FFT along a non-minor axis with a 2-wide minor dim).
        # Falls back to overlap-save for very long signals (memory) or an
        # explicit Nfft.
        squeeze = sig.ndim == 1
        x = sig[:, None] if squeeze else sig
        n = x.shape[0]
        d_delay = n_coeffs // 2
        big = 1 << int(np.ceil(np.log2(n + n_coeffs)))
        ht = jnp.fft.fftshift(jnp.fft.ifft(H))
        Hf = jnp.fft.fft(ht, n=big)
        y = jnp.fft.ifft(
            jnp.fft.fft(x.astype(jnp.complex64).T, n=big, axis=-1) * Hf,
            axis=-1,
        )
        out = y[:, d_delay : d_delay + n].T
        return out[:, 0] if squeeze else out
    return overlap_save(sig, H, nfft=nfft, freq_domain_filter=True)


# ---------------------------------------------------------------------------
# N x N MIMO adaptive equalizer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MIMOEqualizerConfig:
    """MIMO adaptive equalizer parameters (equalization.py:125 defaults).

    ``alg``/``mu``/``L`` are per-training-stage tuples; stage i runs algorithm
    alg[i] with step mu[i] for L[i] output symbols.
    """

    numIter: int = 1
    nTaps: int = 15
    mu: tuple = (1e-3,)
    lambdaRLS: float = 0.99
    SpS: int = 2
    L: tuple = None  # per-stage lengths; None = single stage over everything
    storeCoeff: bool = False
    runWL: bool = False
    alg: tuple = ("nlms",)
    constType: str = "qam"
    M: int = 4
    shapingFactor: float = 0.0
    # blockUpdate > 1 enables block-parallel training: taps are held fixed
    # within each K-symbol block, the K filter outputs and error gradients
    # are computed as one batched contraction, and the accumulated update
    # is applied once per block — a K-fold shorter scan (mini-batch /
    # delayed-gradient LMS; reduce mu accordingly). K=1 reproduces the
    # reference's per-symbol recursion. Not supported for 'rls'/'dd-rls'.
    blockUpdate: int = 1
    # 'pallas' runs each training stage's per-symbol recurrence as one
    # Pallas kernel launch (kernels/mimo_pallas.py, Triton route) instead
    # of a lax.scan, with the same per-symbol semantics, for alg in
    # {'nlms','dd-lms','cma','rde','da-rde'} with blockUpdate == 1,
    # runWL == False and storeCoeff == False; other stages run the scan
    # (H chains through either way). 'scan' is the reference-shaped
    # lax.scan path. 'auto' takes the kernel on a GPU and the scan on the
    # CPU (opticommpy_tpu.backend).
    backend: str = "auto"
    # run the kernel in the Pallas interpreter (CPU tests only)
    interpret: bool = False


def _decide(z, const):
    """Hard decision: closest constellation point (per mode)."""
    return const[jnp.argmin(jnp.abs(z[:, None] - const[None, :]) ** 2, axis=1)]


def _make_update(alg, const, r_cma, r_rde, mu, lam, run_wl):
    """Build the per-symbol tap update for one training stage.

    All rules share the gradient form ``H[out, in, :] += mu * e[out] *
    conj(win[:, in])`` (an outer product over (modes_out, modes_in, taps))
    with rule-specific error terms, matching equalization.py:519-973.
    """

    def grad_update(H, H_, err_vec, win):
        # err_vec: (modes,), win: (taps, modes)
        upd = err_vec[:, None, None] * jnp.conj(win.T)[None, :, :]  # (o, i, t)
        H = H + mu * upd
        if run_wl:
            H_ = H_ + mu * err_vec[:, None, None] * win.T[None, :, :]
        return H, H_

    if alg == "nlms":

        def update(carry, out_eq, ref, win):
            H, H_, Sd = carry
            err = ref - out_eq
            norm2 = jnp.sum(jnp.abs(win) ** 2, axis=0)  # per input mode
            win_n = win / norm2[None, :]
            H, H_ = grad_update(H, H_, err, win_n)
            return (H, H_, Sd), jnp.abs(err) ** 2

    elif alg == "cma":

        def update(carry, out_eq, ref, win):
            H, H_, Sd = carry
            err = (r_cma - jnp.abs(out_eq) ** 2).astype(H.dtype)
            H, H_ = grad_update(H, H_, err * out_eq, win)
            return (H, H_, Sd), jnp.abs(err) ** 2

    elif alg == "dd-lms":

        def update(carry, out_eq, ref, win):
            H, H_, Sd = carry
            err = _decide(out_eq, const) - out_eq
            H, H_ = grad_update(H, H_, err, win)
            return (H, H_, Sd), jnp.abs(err) ** 2

    elif alg == "rde":

        def update(carry, out_eq, ref, win):
            H, H_, Sd = carry
            r_dec = r_rde[jnp.argmin(jnp.abs(r_rde[None, :] - jnp.abs(out_eq)[:, None]), axis=1)]
            err = (r_dec**2 - jnp.abs(out_eq) ** 2).astype(H.dtype)
            H, H_ = grad_update(H, H_, err * out_eq, win)
            return (H, H_, Sd), jnp.abs(err) ** 2

    elif alg == "da-rde":

        def update(carry, out_eq, ref, win):
            H, H_, Sd = carry
            err = (jnp.abs(ref) ** 2 - jnp.abs(out_eq) ** 2).astype(H.dtype)
            H, H_ = grad_update(H, H_, err * out_eq, win)
            return (H, H_, Sd), jnp.abs(err) ** 2

    elif alg in ("rls", "dd-rls"):

        def update(carry, out_eq, ref, win):
            H, H_, Sd = carry
            if alg == "rls":
                err = ref - out_eq
            else:
                err = _decide(out_eq, const) - out_eq
            # per input mode: Kalman-gain style inverse-correlation update
            # (reference rlsUp, equalization.py:575: A = Sd@conj(x),
            # B = x^T@Sd, Sd' = (Sd - A@B/(lam + x^T@Sd@conj(x)))/lam,
            # update direction Y = Sd'@conj(x))
            def upd_mode(Sd_n, x):
                xc = jnp.conj(x)[:, None]  # conj(x) column
                A = Sd_n @ xc
                B = x[None, :] @ Sd_n
                C = (x[None, :] @ A)[0, 0]
                Sd_new = (Sd_n - (A @ B) / (lam + C)) / lam
                y = Sd_new @ xc
                return Sd_new, y[:, 0]

            Sd_new, Y = jax.vmap(upd_mode)(Sd, win.T)  # over input modes
            # H[out, in, :] += err[out] * Y[in, :]
            H = H + err[:, None, None] * Y[None, :, :]
            return (H, H_, Sd_new), jnp.abs(err) ** 2

    elif alg == "static":

        def update(carry, out_eq, ref, win):
            H, H_, Sd = carry
            err = ref - out_eq
            return (H, H_, Sd), jnp.abs(err) ** 2

    else:
        raise ValueError(
            "Equalization algorithm not specified (or incorrectly specified)."
        )

    return update


@partial(
    jax.jit,
    static_argnames=("alg", "sps", "n_taps", "length", "run_wl", "store_coeff"),
)
def _adapt_eq_stage(
    sig_pad, symb_ref, H, H_, Sd, const, r_cma, r_rde, mu, lam,
    alg, sps, n_taps, length, run_wl, store_coeff,
):
    """One training stage: lax.scan over ``length`` output symbols.

    sig_pad: (Lpad + N*SpS + Lpad, modes) padded input slice for this stage.
    H: (modes, modes, taps) tap tensor (H[out, in, :]).
    """
    update = _make_update(alg, const, r_cma, r_rde, mu, lam, run_wl)

    def step(carry, ind):
        H, H_, Sd = carry
        win = jax.lax.dynamic_slice_in_dim(sig_pad, ind * sps, n_taps, axis=0)
        # out_eq[o] = sum_i H[o, i, :] . win[:, i]
        out_eq = jnp.einsum("oit,ti->o", H, win)
        if run_wl:
            out_eq = out_eq + jnp.einsum("oit,ti->o", H_, jnp.conj(win))
        ref = symb_ref[ind]
        (H, H_, Sd), err_sq = update((H, H_, Sd), out_eq, ref, win)
        out = (out_eq, err_sq, H) if store_coeff else (out_eq, err_sq)
        return (H, H_, Sd), out

    (H, H_, Sd), outs = jax.lax.scan(step, (H, H_, Sd), jnp.arange(length))
    if store_coeff:
        sig_out, err_sq, h_iter = outs
    else:
        sig_out, err_sq = outs
        h_iter = H[None]
    return sig_out, H, H_, Sd, err_sq, h_iter


@partial(
    jax.jit,
    static_argnames=("alg", "sps", "n_taps", "length", "run_wl", "k_block"),
)
def _adapt_eq_stage_blocked(
    sig_pad, symb_ref, H, H_, const, r_cma, r_rde, mu,
    alg, sps, n_taps, length, run_wl, k_block,
):
    """Block-parallel training stage: taps frozen within K-symbol blocks.

    Each scan step filters K symbols with the current taps (one batched
    einsum), computes the per-symbol errors of the selected algorithm, and
    applies the accumulated gradient once — mini-batch LMS. K-fold fewer
    scan iterations with matrix-shaped work per iteration.
    """
    n_blocks = length // k_block
    # build all windows once: (length, taps, modes) — strided slices, not
    # a gather (kernels/_util.sliding_windows: identical array)
    from opticommpy_tpu.kernels._util import sliding_windows

    wins_all = sliding_windows(sig_pad, length, sps, n_taps)

    def step(carry, b):
        H, H_ = carry
        wins = jax.lax.dynamic_slice_in_dim(
            wins_all, b * k_block, k_block, axis=0
        )  # (K, taps, modes)
        refs = jax.lax.dynamic_slice_in_dim(symb_ref, b * k_block, k_block, 0)
        out = jnp.einsum("oit,kti->ko", H, wins)
        if run_wl:
            out = out + jnp.einsum("oit,kti->ko", H_, jnp.conj(wins))

        if alg == "nlms":
            err = refs - out
            norm2 = jnp.sum(jnp.abs(wins) ** 2, axis=1, keepdims=True)
            wins_g = wins / norm2
            eff = err
        elif alg == "cma":
            eff = (r_cma - jnp.abs(out) ** 2).astype(H.dtype) * out
            err = r_cma - jnp.abs(out) ** 2
            wins_g = wins
        elif alg == "dd-lms":
            dec = const[jnp.argmin(
                jnp.abs(out[..., None] - const[None, None, :]) ** 2, axis=-1)]
            err = dec - out
            eff = err
            wins_g = wins
        elif alg == "rde":
            r_dec = r_rde[jnp.argmin(
                jnp.abs(r_rde[None, None, :] - jnp.abs(out)[..., None]), axis=-1)]
            err = (r_dec**2 - jnp.abs(out) ** 2).astype(H.dtype)
            eff = err * out
            wins_g = wins
        elif alg == "da-rde":
            err = (jnp.abs(refs) ** 2 - jnp.abs(out) ** 2).astype(H.dtype)
            eff = err * out
            wins_g = wins
        elif alg == "static":
            err = refs - out
            eff = jnp.zeros_like(out)
            wins_g = wins
        else:
            raise ValueError(
                f"blockUpdate > 1 is not supported for algorithm '{alg}'"
            )

        grad = jnp.einsum("ko,kti->oit", eff, jnp.conj(wins_g))
        H = H + mu * grad
        if run_wl:
            H_ = H_ + mu * jnp.einsum("ko,kti->oit", eff, wins_g)
        return (H, H_), (out, jnp.abs(err) ** 2)

    (H, H_), (outs, errs) = jax.lax.scan(step, (H, H_), jnp.arange(n_blocks))
    sig_out = outs.reshape(n_blocks * k_block, -1)
    err_sq = errs.reshape(n_blocks * k_block, -1)
    return sig_out, H, H_, err_sq


# training-stage alg -> kernel rule ('dd-lms' is the kernel's 'lms' with
# n_train=0, i.e. decision-directed from the first symbol)
_KERNEL_STAGE_ALG = {"nlms": "nlms", "dd-lms": "lms", "cma": "cma",
                     "rde": "rde", "da-rde": "da-rde"}


def _use_kernel(config, alg):
    """Whether a training stage runs on the Pallas kernel.

    ``backend='auto'`` takes the kernel where the platform table
    (:mod:`opticommpy_tpu.backend`) says compiled kernels run; stages the
    kernel does not implement (rls/dd-rls/static, runWL, storeCoeff,
    blockUpdate > 1) run as the scan whatever the backend.
    """
    if config.backend not in ("auto", "scan", "pallas"):
        raise ValueError(f"unknown MIMO equalizer backend {config.backend!r}")
    backend = config.backend
    if backend == "auto":
        from opticommpy_tpu.backend import implementation

        backend = "pallas" if implementation() == "kernel" else "scan"
    return (backend == "pallas" and alg in _KERNEL_STAGE_ALG
            and not config.runWL and not config.storeCoeff
            and config.blockUpdate == 1)


def _kernel_stage_err_sq(alg, y, ref, const_np):
    """Elementwise err_sq recomputed from the kernel outputs — the same
    formulas as the scan rules (:func:`_make_update`); broadcast-safe for
    single (length, modes) and batched (B, length, modes) outputs."""
    const = jnp.asarray(const_np)
    bcast = (1,) * y.ndim
    if alg == "nlms":
        return jnp.abs(ref - y) ** 2
    if alg == "dd-lms":
        dec = const[jnp.argmin(
            jnp.abs(y[..., None] - const.reshape(bcast + (-1,))) ** 2,
            axis=-1)]
        return jnp.abs(dec - y) ** 2
    if alg == "cma":
        r_cma = np.mean(np.abs(const_np) ** 4) / np.mean(np.abs(const_np) ** 2)
        return (np.float32(r_cma) - jnp.abs(y) ** 2) ** 2
    if alg == "rde":
        radii = jnp.asarray(np.unique(np.round(np.abs(const_np), 6)),
                            jnp.float32)
        r = jnp.abs(y)
        r_dec = radii[jnp.argmin(
            jnp.abs(r[..., None] - radii.reshape(bcast + (-1,))), axis=-1)]
        return (r_dec ** 2 - r ** 2) ** 2
    return (jnp.abs(ref) ** 2 - jnp.abs(y) ** 2) ** 2  # da-rde


def _adapt_eq_stage_kernel(sig_pad_b, symb_ref_b, H_b, const_np, mu, alg,
                           sps, n_taps, n_start, length, interpret):
    """One training stage for B signals on the Pallas kernel.

    Per-symbol semantics identical to :func:`_adapt_eq_stage` for the
    supported rules (pinned in tests/test_mimo_pallas.py). The kernel reads
    symbol windows from the SAME globally padded signal at the scan
    stages' alignment, so H chains between mixed scan/kernel stages.
    Returns (y (B, length, modes), H (B, o, i, t), err_sq (B, length,
    modes)).
    """
    from opticommpy_tpu.kernels.mimo_pallas import mimo_eq_stage

    n_train = length if alg == "nlms" else 0
    y, H_new = mimo_eq_stage(sig_pad_b, symb_ref_b, H_b, const_np, mu,
                             _KERNEL_STAGE_ALG[alg], sps, n_taps, n_start,
                             length, n_train, interpret)
    ref = symb_ref_b[:, n_start:n_start + length]
    return y, H_new, _kernel_stage_err_sq(alg, y, ref, const_np)


def mimo_adapt_equalizer_batch(sig, config: MIMOEqualizerConfig = None,
                               symb_ref=None, H=None, return_results=False):
    """B signals' FULL multi-stage training schedules in one program.

    Batched counterpart of :func:`mimo_adapt_equalizer` for the WDM
    serving/training shape (reference semantics per signal: the reference
    trains each channel's ``mimoAdaptEqualizer`` in a Python loop,
    equalization.py:125): ``sig`` is ``(B, N, modes)``, ``symb_ref``
    ``(B, nSym, modes)``; every signal runs the same per-stage schedule
    independently. On the kernel backend each supported stage runs all B
    recurrences in ONE kernel launch (one program per signal and output
    mode); other stages run as a vmapped scan, with taps/state chaining
    through either way. ``storeCoeff`` is rejected (no per-symbol
    coefficient-history return in the batch API).

    Per-signal outputs are bit-exact vs :func:`mimo_adapt_equalizer`.

    Returns the equalized symbols ``(B, nSym_out, modes)``, or
    ``(sigOut, H (B,o,i,t), errSq (B, modes, nSym_out))`` when
    ``return_results`` is True.
    """
    if config is None:
        config = MIMOEqualizerConfig()
    if config.storeCoeff:
        raise ValueError(
            "storeCoeff is not supported by mimo_adapt_equalizer_batch "
            "(there is no per-symbol h_iter return in the batch API); use "
            "mimo_adapt_equalizer per signal to record coefficient history")
    sig = jnp.asarray(sig)
    if sig.ndim != 3:
        raise ValueError("mimo_adapt_equalizer_batch expects (B, N, modes)")
    if symb_ref is None:
        symb_ref = sig
    symb_ref = jnp.asarray(symb_ref)

    n_batch, _, n_modes = sig.shape
    n_taps = config.nTaps
    sps = config.SpS
    l_pad = n_taps // 2
    sig_pad = jnp.pad(sig.astype(jnp.complex64),
                      ((0, 0), (l_pad, l_pad + sps + n_taps), (0, 0)))

    const_np = gray_mapping(config.M, config.constType)
    px = symbol_pmf(config.M, config.constType,
                    "maxwell-boltzmann" if config.shapingFactor else "uniform",
                    config.shapingFactor)
    const_np = (const_np / np.sqrt(np.sum(np.abs(const_np) ** 2 * px))
                ).astype(np.complex64)
    const = jnp.asarray(const_np)

    total_symbols = int(np.fix((sig.shape[1] + 2 * l_pad - n_taps) / sps + 1))
    stage_lengths = config.L if config.L is not None else (total_symbols,)
    if any(l <= 0 for l in stage_lengths) or sum(stage_lengths) > total_symbols:
        raise ValueError(
            f"invalid stage lengths {tuple(stage_lengths)}: must be positive "
            f"and sum to at most {total_symbols} output symbols"
        )
    algs = config.alg
    mus = config.mu
    if len(mus) == 1 and len(algs) > 1:
        mus = mus * len(algs)

    if H is None:
        H = jnp.zeros((n_batch, n_modes, n_modes, n_taps),
                      dtype=jnp.complex64)
        H = H.at[:, jnp.arange(n_modes), jnp.arange(n_modes),
                 n_taps // 2].set(1.0)
    H_ = jnp.zeros_like(H)
    Sd = jnp.tile(jnp.eye(n_taps, dtype=jnp.complex64),
                  (n_batch, n_modes, 1, 1))

    r_cma = jnp.asarray(np.float32(
        np.mean(np.abs(const_np) ** 4) / np.mean(np.abs(const_np) ** 2)))
    r_rde = jnp.asarray(np.unique(np.abs(const_np)).astype(np.float32))

    outs, errs = [], []
    n_start = 0
    for stage, alg in enumerate(algs):
        length = int(stage_lengths[stage])
        n_iter = config.numIter if stage == 0 else 1
        k_block = config.blockUpdate
        use_kernel = _use_kernel(config, alg)
        stage_slice = sig_pad[
            :, n_start * sps : (n_start + length - 1) * sps + n_taps]
        ref_slice = symb_ref[:, n_start : n_start + length]
        use_blocked = (
            k_block > 1
            and alg not in ("rls", "dd-rls")
            and not config.storeCoeff
            and length >= k_block
        )
        for _ in range(n_iter):
            if use_kernel:
                sig_out, H, err_sq = _adapt_eq_stage_kernel(
                    sig_pad, symb_ref, H, const_np, float(mus[stage]),
                    alg, sps, n_taps, n_start, length, config.interpret)
            elif use_blocked:
                n_main = (length // k_block) * k_block

                def run_blk(ss, rs, h, h_):
                    return _adapt_eq_stage_blocked(
                        ss, rs, h, h_, const, r_cma, r_rde,
                        float(mus[stage]), alg, sps, n_taps, n_main,
                        config.runWL, k_block)

                sig_out, H, H_, err_sq = jax.vmap(run_blk)(
                    stage_slice, ref_slice, H, H_)
                if n_main < length:
                    rem = length - n_main

                    def run_rem(ss, rs, h, h_, sd):
                        return _adapt_eq_stage(
                            ss, rs, h, h_, sd, const, r_cma, r_rde,
                            float(mus[stage]), float(config.lambdaRLS),
                            alg, sps, n_taps, rem, config.runWL, False)

                    so2, H, H_, Sd, es2, _ = jax.vmap(run_rem)(
                        stage_slice[:, n_main * sps:], ref_slice[:, n_main:],
                        H, H_, Sd)
                    sig_out = jnp.concatenate([sig_out, so2], axis=1)
                    err_sq = jnp.concatenate([err_sq, es2], axis=1)
            else:

                def run_scan(ss, rs, h, h_, sd):
                    return _adapt_eq_stage(
                        ss, rs, h, h_, sd, const, r_cma, r_rde,
                        float(mus[stage]), float(config.lambdaRLS), alg,
                        sps, n_taps, length, config.runWL, False)

                sig_out, H, H_, Sd, err_sq, _ = jax.vmap(run_scan)(
                    stage_slice, ref_slice, H, H_, Sd)
        outs.append(sig_out)
        errs.append(err_sq)
        n_start += length

    sig_out = jnp.concatenate(outs, axis=1)
    err_sq = jnp.concatenate(errs, axis=1).transpose(0, 2, 1)
    if return_results:
        return sig_out, H, err_sq
    return sig_out


def mimo_adapt_equalizer(sig, config: MIMOEqualizerConfig = None, symb_ref=None,
                         H=None, H_=None, return_results=False):
    """N x N MIMO adaptive equalizer with multi-stage training.

    Parity with reference mimoAdaptEqualizer (equalization.py:125): central
    spike initialization, zero padding of nTaps//2 at both ends, per-stage
    algorithm list, pre-convergence iterations of the first stage, optional
    widely-linear mode and coefficient storage.

    Returns the equalized symbols, or (sigOut, H, H_, errSq, Hiter) when
    ``return_results`` is True.

    Throughput notes: the per-symbol scan is latency-bound; the kernel
    backend (``backend='pallas'``, the GPU default) runs each stage's exact
    per-symbol recurrence in one launch, ``blockUpdate`` trades it for
    mini-batch updates, and :func:`mimo_apply` serves converged taps.
    """
    if config is None:
        config = MIMOEqualizerConfig()
    sig = jnp.asarray(sig)
    squeeze = sig.ndim == 1
    if squeeze:
        sig = sig[:, None]
    if symb_ref is None:
        symb_ref = sig
    symb_ref = jnp.asarray(symb_ref)
    if symb_ref.ndim == 1:
        symb_ref = symb_ref[:, None]

    n_modes = sig.shape[1]
    n_taps = config.nTaps
    sps = config.SpS
    l_pad = n_taps // 2
    # extra trailing zeros guarantee every stage slice holds full windows
    sig_pad = jnp.pad(sig.astype(jnp.complex64), ((l_pad, l_pad + sps + n_taps), (0, 0)))

    # normalized reference constellation under the shaping pmf (all host-side
    # numpy: these must stay concrete even when this function is traced
    # inside an outer jit)
    const_np = gray_mapping(config.M, config.constType)
    px = symbol_pmf(config.M, config.constType,
                    "maxwell-boltzmann" if config.shapingFactor else "uniform",
                    config.shapingFactor)
    const_np = (const_np / np.sqrt(np.sum(np.abs(const_np) ** 2 * px))).astype(
        np.complex64
    )
    const = jnp.asarray(const_np)

    total_symbols = int(np.fix((sig.shape[0] + 2 * l_pad - n_taps) / sps + 1))
    stage_lengths = config.L if config.L is not None else (total_symbols,)
    if any(l <= 0 for l in stage_lengths) or sum(stage_lengths) > total_symbols:
        raise ValueError(
            f"invalid stage lengths {tuple(stage_lengths)}: must be positive "
            f"and sum to at most {total_symbols} output symbols"
        )
    algs = config.alg
    mus = config.mu
    if len(mus) == 1 and len(algs) > 1:
        mus = mus * len(algs)

    # tap tensors: H[out, in, taps], central-spike init
    if H is None:
        H = jnp.zeros((n_modes, n_modes, n_taps), dtype=jnp.complex64)
        H = H.at[jnp.arange(n_modes), jnp.arange(n_modes), n_taps // 2].set(1.0)
    if H_ is None:
        H_ = jnp.zeros((n_modes, n_modes, n_taps), dtype=jnp.complex64)
    Sd = jnp.tile(jnp.eye(n_taps, dtype=jnp.complex64), (n_modes, 1, 1))

    r_cma = jnp.asarray(
        np.float32(np.mean(np.abs(const_np) ** 4) / np.mean(np.abs(const_np) ** 2))
    )
    r_rde = jnp.asarray(np.unique(np.abs(const_np)).astype(np.float32))

    outs, errs, h_iters = [], [], []
    n_start = 0
    for stage, alg in enumerate(algs):
        length = int(stage_lengths[stage])
        stage_slice = sig_pad[
            n_start * sps : (n_start + length - 1) * sps + n_taps
        ]
        ref_slice = symb_ref[n_start : n_start + length]
        n_iter = config.numIter if stage == 0 else 1
        k_block = config.blockUpdate
        use_kernel = _use_kernel(config, alg)
        use_blocked = (
            k_block > 1
            and alg not in ("rls", "dd-rls")
            and not config.storeCoeff
            and length >= k_block
        )
        for _ in range(n_iter):
            if use_kernel:
                y_b, H_b, e_b = _adapt_eq_stage_kernel(
                    sig_pad[None], symb_ref[None], H[None], const_np,
                    float(mus[stage]), alg, sps, n_taps, n_start, length,
                    config.interpret)
                sig_out, H, err_sq = y_b[0], H_b[0], e_b[0]
                h_iter = H[None]
            elif use_blocked:
                n_main = (length // k_block) * k_block
                sig_out, H, H_, err_sq = _adapt_eq_stage_blocked(
                    stage_slice, ref_slice, H, H_, const, r_cma, r_rde,
                    float(mus[stage]), alg, sps, n_taps, n_main,
                    config.runWL, k_block,
                )
                h_iter = H[None]
                if n_main < length:  # per-symbol remainder
                    rem = length - n_main
                    rem_slice = stage_slice[n_main * sps :]
                    so2, H, H_, Sd, es2, _ = _adapt_eq_stage(
                        rem_slice, ref_slice[n_main:], H, H_, Sd, const,
                        r_cma, r_rde, float(mus[stage]),
                        float(config.lambdaRLS), alg, sps, n_taps, rem,
                        config.runWL, False,
                    )
                    sig_out = jnp.concatenate([sig_out, so2], axis=0)
                    err_sq = jnp.concatenate([err_sq, es2], axis=0)
            else:
                sig_out, H, H_, Sd, err_sq, h_iter = _adapt_eq_stage(
                    stage_slice, ref_slice, H, H_, Sd, const, r_cma, r_rde,
                    float(mus[stage]), float(config.lambdaRLS),
                    alg, sps, n_taps, length, config.runWL, config.storeCoeff,
                )
        outs.append(sig_out)
        errs.append(err_sq)
        h_iters.append(h_iter)
        n_start += length

    sig_out = jnp.concatenate(outs, axis=0)
    err_sq = jnp.concatenate(errs, axis=0).T
    h_iter = jnp.concatenate(h_iters, axis=0) if config.storeCoeff else h_iters[-1]
    if squeeze:
        sig_out = sig_out[:, 0]
    if return_results:
        return sig_out, H, H_, err_sq, h_iter
    return sig_out


@partial(jax.jit, static_argnames=("sps",))
def mimo_apply(H, sig, sps=2):
    """Apply a trained (frozen) MIMO tap tensor as a batched convolution.

    The throughput companion to :func:`mimo_adapt_equalizer` (SURVEY.md §7's
    tap-freeze-and-filter strategy): after the adaptive stages converge, the
    remaining signal is filtered with frozen taps — an embarrassingly
    parallel correlation bank, instead of a per-symbol scan. Numerically identical to running the
    equalizer with ``alg='static'``.

    Parameters
    ----------
    H : (modes_out, modes_in, nTaps) tap tensor from the adaptive equalizer.
    sig : (N, modes_in) input signal at ``sps`` samples/symbol.

    Returns
    -------
    (nSym, modes_out) equalized symbols.
    """
    sig = jnp.asarray(sig).astype(jnp.complex64)
    if sig.ndim == 1:
        sig = sig[:, None]
    n_taps = H.shape[-1]
    l_pad = n_taps // 2
    sig_pad = jnp.pad(sig, ((l_pad, l_pad + sps + n_taps), (0, 0)))
    n_sym = int(np.fix((sig.shape[0] + 2 * l_pad - n_taps) / sps + 1))
    # y_o[s] = sum_{i,t} H[o,i,t] * xp[s*sps + t]: a bank of correlations,
    # evaluated in the frequency domain (no (nSym, taps, modes) window
    # materialization). HIGHEST keeps the mode-mixing contraction in f32:
    # a default-precision f32 matmul may run in a reduced-precision mode
    # (bf16 or TF32, depending on the device).
    n = sig_pad.shape[0]
    nfft = 1 << int(np.ceil(np.log2(n)))
    # time on the minor axis throughout (see edc)
    X = jnp.fft.fft(sig_pad.T, n=nfft, axis=-1)  # (modes_in, nfft)
    Hf = jnp.fft.fft(H[..., ::-1], n=nfft, axis=-1)  # (o, i, nfft)
    Yf = jnp.einsum("if,oif->of", X, Hf,
                    precision=jax.lax.Precision.HIGHEST)
    if nfft % sps == 0:
        # fold the symbol-rate decimation into the inverse transform: shift
        # the wanted sampling phase (offset n_taps-1) to index 0, alias the
        # spectrum down by sps, and run an nfft/sps-point inverse FFT
        # (~2x less inverse-FFT + post-processing work at sps=2)
        k = jnp.arange(nfft)[None, :]
        Yf = Yf * jnp.exp(2j * jnp.pi * k * ((n_taps - 1) / nfft))
        m = nfft // sps
        yd = jnp.fft.ifft(
            Yf.reshape(H.shape[0], sps, m).sum(axis=1) / sps, axis=-1
        )
        return yd[:, :n_sym].T
    y_full = jnp.fft.ifft(Yf, axis=-1)  # correlation at y_full[t + n_taps - 1]
    return y_full[:, n_taps - 1 :][:, ::sps][:, :n_sym].T


def mimo_apply_fused(H, sig, sps=2, pre=None, edc_config=None, scale=None):
    """Converged receiver front end in ONE pass: pre-filter + EDC + MIMO.

    The serving path's matched filter, chromatic-dispersion compensation,
    power normalization, and frozen MIMO taps are a cascade of LTI stages
    plus one scalar — so the whole front end collapses into a single
    decimating MIMO frequency-domain filter. This computes

    ``mimo_apply(H, pnorm(edc(fir_filter(pre, sig), edc_config)), sps)``

    with one forward FFT per input mode and one folded inverse FFT per
    output mode, instead of three separate filtering passes plus a
    normalization pass over the signal (the staged composition the reference
    runs, equalization.py:36,125 after core.py:87).

    Parameters
    ----------
    H : (modes_out, modes_in, nTaps) frozen tap tensor.
    sig : (N, modes_in) signal at ``sps`` samples/symbol (pre matched
        filter / CD compensation).
    pre : optional (K,) pre-filter taps (e.g. the matched RRC), applied
        'same'/delay-compensated like :func:`~opticommpy_tpu.ops.fir_filter`.
    edc_config : optional EDCConfig for CD compensation (same filter design
        as :func:`edc`).
    scale : power-normalization divisor. ``None`` derives it from the
        combined spectrum by Parseval — that includes the convolution tails
        outside the staged pnorm's window, an O(K/N) relative difference;
        pass the training-time scalar for exact parity with the staged path.

    Returns
    -------
    (nSym, modes_out) equalized symbols.
    """
    sig = jnp.asarray(sig).astype(jnp.complex64)
    if sig.ndim == 1:
        sig = sig[:, None]
    n = sig.shape[0]
    n_taps = H.shape[-1]
    l_pad = n_taps // 2
    n_pad = n + 2 * l_pad + sps + n_taps  # = mimo_apply's padded length
    n_sym = int(np.fix((n + 2 * l_pad - n_taps) / sps + 1))

    # combined pre-filter response assembly. Taps are usually concrete
    # (host-designed filters) — then the whole response P is precomputed in
    # NumPy and enters the program as a constant, instead of full-nfft tap
    # FFTs re-traced (and re-run per vmap lane) on device.
    k_extra = 0
    pre_parts = []
    if pre is not None:
        k_pre = pre.shape[0]
        pre_parts.append((pre, (k_pre - 1) // 2))
        k_extra += k_pre - 1
    if edc_config is not None:
        if edc_config.Fs is None:
            raise ValueError("Simulation sampling frequency (Fs) not provided.")
        _, beta2 = fiber_coefficients(0.0, edc_config.D, edc_config.Fc)
        n_coeffs = edc_config.NfilterCoeffs
        if n_coeffs is None:
            n_coeffs = int(2 * np.ceil(
                6.67 * np.abs(beta2) * edc_config.L * edc_config.Rs**2
                * (edc_config.Fs / edc_config.Rs)))
        w = 2 * np.pi * edc_config.Fs * np.fft.fftfreq(n_coeffs)
        Hcd = np.exp(-1j * (beta2 / 2) * (w**2) * edc_config.L)
        ht = np.fft.fftshift(np.fft.ifft(Hcd)).astype(np.complex64)
        pre_parts.append((ht, n_coeffs // 2))
        k_extra += n_coeffs - 1

    nfft = 1 << int(np.ceil(np.log2(n_pad + k_extra)))
    k = jnp.arange(nfft)
    all_host = all(not isinstance(t, jax.Array) for t, _ in pre_parts)
    if all_host:
        kh = np.arange(nfft)
        # front zero-padding of the MIMO stage = pure delay by l_pad
        Pn = np.exp(-2j * np.pi * kh * (l_pad / nfft))
        for taps, delay in pre_parts:
            # 'same' delay-compensated filter: response advanced by center
            Pn = Pn * np.fft.fft(np.asarray(taps), n=nfft) * np.exp(
                2j * np.pi * kh * (delay / nfft))
        P = jnp.asarray(Pn.astype(np.complex64))
    else:
        P = jnp.exp(-2j * jnp.pi * k * (l_pad / nfft)).astype(jnp.complex64)
        for taps, delay in pre_parts:
            P = P * jnp.fft.fft(jnp.asarray(taps).astype(jnp.complex64),
                                n=nfft) * jnp.exp(
                2j * jnp.pi * k * (delay / nfft))

    X = jnp.fft.fft(sig.T, n=nfft, axis=-1) * P[None, :]  # (modes_in, nfft)
    if scale is None:
        # Parseval: pnorm's mean power over the filtered signal (tails incl.)
        scale = jnp.sqrt(
            jnp.sum((X * jnp.conj(X)).real)
            / np.float32(float(nfft) * n * sig.shape[1]))
    X = X / scale

    Hf = jnp.fft.fft(H[..., ::-1].astype(jnp.complex64), n=nfft, axis=-1)
    Yf = jnp.einsum("if,oif->of", X, Hf,
                    precision=jax.lax.Precision.HIGHEST)
    if nfft % sps == 0:
        Yf = Yf * jnp.exp(2j * jnp.pi * k[None, :] * ((n_taps - 1) / nfft))
        m = nfft // sps
        yd = jnp.fft.ifft(
            Yf.reshape(H.shape[0], sps, m).sum(axis=1) / sps, axis=-1)
        return yd[:, :n_sym].T
    y_full = jnp.fft.ifft(Yf, axis=-1)
    return y_full[:, n_taps - 1 :][:, ::sps][:, :n_sym].T


# ---------------------------------------------------------------------------
# Manakov digital backpropagation
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("config",))
def manakov_dbp(e_in, config: SSFMConfig):
    """Manakov-equation digital backpropagation (reference equalization.py:976).

    Runs the same span kernel as the forward Manakov SSFM with inverted
    linear/nonlinear signs: per span, first undo the amplifier gain
    (multiply by exp(-alpha/2*Lspan)), then back-propagate with
    ``+alpha/2 - j*beta2/2*w^2`` and negative gamma.
    """
    if config.Fs is None:
        raise ValueError("Simulation sampling frequency (Fs) not provided.")
    e_in = jnp.asarray(e_in, dtype=jnp.complex64)
    n = e_in.shape[0]
    e = jnp.stack([e_in[:, 0::2].T, e_in[:, 1::2].T])

    alpha, beta2 = fiber_coefficients(config.alpha, config.D, config.Fc)
    n_spans = int(np.floor(config.Ltotal / config.Lspan))
    w = 2 * jnp.pi * config.Fs * jnp.fft.fftfreq(n)
    lin_arg = ((alpha / 2) - 1j * (beta2 / 2) * w**2).astype(jnp.complex64)

    def span(e, _):
        if config.amp in ("edfa", "ideal"):
            e = e * jnp.exp(-alpha / 2 * config.Lspan)
        e = _manakov_span(e, lin_arg, config.Lspan, config, nl_sign=-1.0)
        return e, None

    e, _ = jax.lax.scan(span, e, jnp.arange(n_spans))
    return _to_columns(e, n)


# ---------------------------------------------------------------------------
# SISO decision-feedback equalizers (DFE / FFE / Volterra)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DFEConfig:
    """Decision-feedback equalizer parameters (equalization.py:1176)."""

    nTapsFF: int = 5
    nTapsFB: int = 5
    SpS: int = 1
    mu: float = 1e-4
    nTrain: int = 1000
    M: int = 4
    constType: str = "pam"
    trainingMode: str = "data-aided"  # or 'fulltime'
    preconvIters: int = 1


@dataclass(frozen=True)
class FFEConfig:
    """Feedforward equalizer parameters (equalization.py:1545)."""

    nTaps: int = 5
    mu: float = 1e-4
    SpS: int = 1
    nTrain: int = 1000
    M: int = 4
    constType: str = "pam"
    trainingMode: str = "data-aided"
    preconvIters: int = 1


@dataclass(frozen=True)
class VolterraConfig:
    """Volterra equalizer parameters (equalization.py:1868)."""

    n1Taps: int = 5
    n2Taps: int = 3
    n3Taps: int = 2
    SpS: int = 1
    mu: float = 1e-3
    nTrain: int = 1000
    order: int = 2
    M: int = 4
    constType: str = "pam"
    trainingMode: str = "data-aided"
    preconvIters: int = 1


def _norm_const(M, const_type):
    const = gray_mapping(M, const_type)
    return jnp.asarray(
        (const / np.sqrt(np.mean(np.abs(const) ** 2))).astype(np.complex64)
    )


def _windows(sig_pad, n_out, sps, n_taps):
    """(n_out, n_taps) matrix of input windows (strided slices + stack)."""
    from opticommpy_tpu.kernels._util import sliding_windows

    return sliding_windows(sig_pad, n_out, sps, n_taps)


@partial(jax.jit, static_argnames=("cfg", "is_complex"))
def _ffe_core(wins, symb_ref, f0, cfg: FFEConfig, is_complex):
    const = _norm_const(cfg.M, cfg.constType)
    n_train = cfg.nTrain
    fulltime = cfg.trainingMode == "fulltime"

    def run(f):
        def step(f, inp):
            k, win, ref = inp
            y = jnp.sum(f * win)
            dec = const[jnp.argmin(jnp.abs(y - const))]
            out_ref = jnp.where(k < n_train, ref, dec)
            e = out_ref - y
            do_update = fulltime | (k < n_train)
            g = e * (jnp.conj(win) if is_complex else win)
            f = jnp.where(do_update, f + cfg.mu * g, f)
            return f, (y, jnp.abs(e) ** 2)

        ks = jnp.arange(wins.shape[0])
        f, (y, mse) = jax.lax.scan(step, f, (ks, wins, symb_ref))
        return f, y, mse

    f = f0
    for _ in range(cfg.preconvIters):
        f, y, mse = run(f)
    return y, f, mse


def ffe(sig, symb_ref, config: FFEConfig = FFEConfig()):
    """Decision-directed feedforward LMS equalizer (equalization.py:1545).

    Returns (sigOut, f, mse). The per-symbol recurrence is a ``lax.scan``;
    the input windows are gathered as one (N, taps) matrix up front.
    """
    sig = pnorm(jnp.asarray(sig)).astype(jnp.complex64)
    symb_ref = pnorm(jnp.asarray(symb_ref).reshape(-1)).astype(jnp.complex64)
    n_taps = config.nTaps
    sig_pad = jnp.pad(sig.reshape(-1), (n_taps // 2, n_taps // 2))
    n_out = int((sig_pad.shape[0] - n_taps + n_taps % 2) // config.SpS)
    wins = _windows(sig_pad, n_out, config.SpS, n_taps)
    ref = jnp.zeros(n_out, dtype=jnp.complex64).at[: symb_ref.shape[0]].set(
        symb_ref[:n_out]
    )
    f0 = jnp.zeros(n_taps, dtype=jnp.complex64).at[n_taps // 2].set(1.0)
    is_complex = config.constType != "pam"
    y, f, mse = _ffe_core(wins, ref, f0, config, is_complex)
    if config.constType == "pam":
        y = y.real
    return y, f, mse.real


@partial(jax.jit, static_argnames=("cfg", "is_complex"))
def _dfe_core(wins, symb_ref, f0, b0, cfg: DFEConfig, is_complex):
    const = _norm_const(cfg.M, cfg.constType)
    n_train = cfg.nTrain
    fulltime = cfg.trainingMode == "fulltime"

    def run(fb):
        def step(carry, inp):
            f, b, dbuf = carry
            k, win, ref = inp
            y = jnp.sum(f * win) + jnp.sum(b * dbuf)
            dec = const[jnp.argmin(jnp.abs(y - const))]
            out_ref = jnp.where(k < n_train, ref, dec)
            e = out_ref - y
            do_update = fulltime | (k < n_train)
            gf = e * (jnp.conj(win) if is_complex else win)
            gb = e * (jnp.conj(dbuf) if is_complex else dbuf)
            f = jnp.where(do_update, f + cfg.mu * gf, f)
            b = jnp.where(do_update, b + cfg.mu * gb, b)
            dbuf = jnp.roll(dbuf, 1).at[0].set(out_ref)
            return (f, b, dbuf), (y, jnp.abs(e) ** 2)

        f, b = fb
        dbuf = jnp.zeros(cfg.nTapsFB, dtype=jnp.complex64)
        ks = jnp.arange(wins.shape[0])
        (f, b, _), (y, mse) = jax.lax.scan(step, (f, b, dbuf), (ks, wins, symb_ref))
        return (f, b), y, mse

    fb = (f0, b0)
    for _ in range(cfg.preconvIters):
        fb, y, mse = run(fb)
    return y, fb[0], fb[1], mse


def dfe(sig, symb_ref, config: DFEConfig = DFEConfig()):
    """Decision-feedback LMS equalizer (equalization.py:1176).

    Returns (sigOut, f, b, mse).
    """
    sig = pnorm(jnp.asarray(sig)).astype(jnp.complex64)
    symb_ref = pnorm(jnp.asarray(symb_ref).reshape(-1)).astype(jnp.complex64)
    n_ff = config.nTapsFF
    sig_pad = jnp.pad(sig.reshape(-1), (n_ff // 2, n_ff // 2))
    n_out = int((sig_pad.shape[0] - n_ff + n_ff % 2) // config.SpS)
    wins = _windows(sig_pad, n_out, config.SpS, n_ff)
    ref = jnp.zeros(n_out, dtype=jnp.complex64).at[: symb_ref.shape[0]].set(
        symb_ref[:n_out]
    )
    f0 = jnp.zeros(n_ff, dtype=jnp.complex64).at[n_ff // 2].set(1.0)
    b0 = jnp.zeros(config.nTapsFB, dtype=jnp.complex64)
    is_complex = config.constType != "pam"
    y, f, b, mse = _dfe_core(wins, ref, f0, b0, config, is_complex)
    if config.constType == "pam":
        y = y.real
    return y, f, b, mse.real


@partial(jax.jit, static_argnames=("cfg",))
def _volterra_core(wins, symb_ref, h1_0, h2_0, h3_0, cfg: VolterraConfig):
    # real-valued equalizer: cast the constellation like the reference does
    # (volterra, equalization.py:1906: constSymb.astype(prec=float32))
    const = jnp.real(_norm_const(cfg.M, cfg.constType)).astype(jnp.float32)
    n_train = cfg.nTrain
    fulltime = cfg.trainingMode == "fulltime"
    t2 = (cfg.n1Taps - cfg.n2Taps) // 2
    t3 = (cfg.n1Taps - cfg.n3Taps) // 2

    def run(hs):
        def step(carry, inp):
            h1, h2, h3 = carry
            k, win, ref = inp
            x2 = jax.lax.dynamic_slice_in_dim(win, t2, cfg.n2Taps)
            outer2 = x2[:, None] * x2[None, :]
            y = jnp.sum(h1 * win) + jnp.sum(h2 * outer2)
            if cfg.order == 3:
                x3 = jax.lax.dynamic_slice_in_dim(win, t3, cfg.n3Taps)
                outer3 = x3[:, None, None] * x3[None, :, None] * x3[None, None, :]
                y = y + jnp.sum(h3 * outer3)
            dec = const[jnp.argmin(jnp.abs(y - const))]
            out_ref = jnp.where(k < n_train, ref, dec)
            e = out_ref - y
            do_update = fulltime | (k < n_train)
            h1 = jnp.where(do_update, h1 + cfg.mu * e * win, h1)
            h2 = jnp.where(do_update, h2 + cfg.mu / 2 * e * outer2, h2)
            if cfg.order == 3:
                h3 = jnp.where(do_update, h3 + cfg.mu / 7 * e * outer3, h3)
            return (h1, h2, h3), (y, jnp.abs(e) ** 2)

        ks = jnp.arange(wins.shape[0])
        hs, (y, mse) = jax.lax.scan(step, hs, (ks, wins, symb_ref))
        return hs, y, mse

    hs = (h1_0, h2_0, h3_0)
    for _ in range(cfg.preconvIters):
        hs, y, mse = run(hs)
    return y, hs[0], hs[1], hs[2], mse


def volterra(sig, symb_ref, config: VolterraConfig = VolterraConfig()):
    """Decision-directed Volterra equalizer to 3rd order (equalization.py:1868).

    Returns (sigOut, [h1, h2, h3], mse). The nonlinear kernel contractions are
    per-step outer products inside the scan (small, VPU-friendly).
    """
    if config.n1Taps < config.n2Taps or config.n1Taps < config.n3Taps:
        raise ValueError("n1Taps must be >= n2Taps and n3Taps.")
    sig = anorm(pnorm(jnp.asarray(sig).reshape(-1))).real.astype(jnp.float32)
    symb_ref = pnorm(jnp.asarray(symb_ref).reshape(-1)).real.astype(jnp.float32)
    n_taps = max(config.n1Taps, config.n2Taps, config.n3Taps)
    sig_pad = jnp.pad(sig, (n_taps // 2, n_taps // 2))
    n_out = int((sig_pad.shape[0] - n_taps + n_taps % 2) // config.SpS)
    wins = _windows(sig_pad, n_out, config.SpS, n_taps)
    ref = jnp.zeros(n_out, dtype=jnp.float32).at[: symb_ref.shape[0]].set(
        symb_ref[:n_out]
    )
    h1 = jnp.zeros(config.n1Taps, dtype=jnp.float32).at[config.n1Taps // 2].set(1.0)
    h2 = jnp.zeros((config.n2Taps, config.n2Taps), dtype=jnp.float32)
    h3 = jnp.zeros((config.n3Taps,) * 3, dtype=jnp.float32)
    y, h1, h2, h3, mse = _volterra_core(wins, ref, h1, h2, h3, config)
    return pnorm(y), [h1, h2, h3], mse
