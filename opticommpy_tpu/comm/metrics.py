"""Performance metrics: BER/SER/SNR, LLRs, MI/GMI/NGMI, EVM, theory curves.

Counterpart of reference ``optic/comm/metrics.py``. All Monte-Carlo
paths are vectorized JAX (one code path, batched over modes); the per-symbol
Numba prange loops of the reference become broadcast distance tensors and
matmuls against the bit map (matrix contractions):

- :func:`calc_llr`  ~ metrics.py:198  (prob @ bitMap matmuls)
- :func:`calc_mi`   ~ metrics.py:496  (vectorized reduction)
- :func:`monte_carlo_gmi` / :func:`monte_carlo_mi` ~ metrics.py:329,429
- :func:`theory_mi` keeps SciPy 2-D quadrature on host (offline analysis,
  matching the reference's dblquad at metrics.py:824).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import erf

import scipy.constants as sconst
from scipy.integrate import dblquad

from opticommpy_tpu.comm.modulation import (
    bit_map,
    demodulate_gray,
    gray_mapping,
    min_euclid,
)
from opticommpy_tpu.ops.signal import pnorm
from opticommpy_tpu.utils.units import db2lin

__all__ = [
    "bert",
    "fast_ber_calc",
    "calc_llr",
    "calc_extr_llr",
    "monte_carlo_gmi",
    "monte_carlo_mi",
    "calc_mi",
    "qfunc",
    "calc_evm",
    "theory_ber",
    "theory_mi",
    "gn_model_nyquist_wdm",
    "ase_nyquist_wdm",
    "gn_model_osnr",
    "calc_lin_osnr",
]


def qfunc(x):
    """Gaussian tail function Q(x) = 0.5*erfc(x/sqrt(2)) (metrics.py:550)."""
    return 0.5 - 0.5 * erf(jnp.asarray(x) / jnp.sqrt(2.0))


def bert(i_rx, bits_tx):
    """OOK BER and Q-factor from received intensities (metrics.py:37).

    Computes the per-level statistics, the optimal threshold
    ``Id = (s1*I0 + s0*I1)/(s1+s0)``, the Q-factor, and the BER under the
    optimal decision rule. ``bits_tx`` is required (the reference's implicit
    numpy-global-seed fallback is not reproducible under jit — generate bits
    explicitly with :func:`opticommpy_tpu.comm.sources.bit_source`).
    """
    i_rx = jnp.asarray(i_rx).reshape(-1)
    bits_tx = jnp.asarray(bits_tx).reshape(-1)
    is1 = bits_tx == 1
    n1 = jnp.sum(is1)
    n0 = bits_tx.shape[0] - n1
    i1 = jnp.sum(jnp.where(is1, i_rx, 0.0)) / n1
    i0 = jnp.sum(jnp.where(is1, 0.0, i_rx)) / n0
    var1 = jnp.sum(jnp.where(is1, (i_rx - i1) ** 2, 0.0)) / n1
    var0 = jnp.sum(jnp.where(is1, 0.0, (i_rx - i0) ** 2)) / n0
    std1, std0 = jnp.sqrt(var1), jnp.sqrt(var0)
    i_d = (std1 * i0 + std0 * i1) / (std1 + std0)
    q = (i1 - i0) / (std1 + std0)
    bits_rx = (i_rx > i_d).astype(jnp.int32)
    ber = jnp.mean(jnp.abs(bits_rx - bits_tx).astype(jnp.float32))
    return ber, q


def _as_columns(x):
    x = jnp.asarray(x)
    if x.ndim == 1:
        return x[:, None]
    return x.T if x.shape[1] > x.shape[0] else x


def _phase_align(rx, tx, const_type):
    """Correct a possible constant phase ambiguity: rx *= mean(tx/rx)."""
    if const_type in ("qam", "psk"):
        rot = jnp.mean(tx / rx, axis=0, keepdims=True)
        rx = rot * rx
    return rx


def _pnorm_cols(x):
    return x / jnp.sqrt(jnp.mean((x * jnp.conj(x)).real, axis=0, keepdims=True))


def fast_ber_calc(rx, tx, M, const_type, px=None):
    """Monte-Carlo BER/SER/SNR per mode (metrics.py:111).

    Returns (BER, SER, SNR_dB) arrays of length nModes. The phase-ambiguity
    correction, power normalization, hard demodulation, and bit/symbol error
    counting are all batched across modes.
    """
    if const_type == "ook":
        M = 2
    if px is None:
        px = np.ones(M) / M
    const = gray_mapping(M, const_type)
    es = np.sum(np.abs(const) ** 2 * np.asarray(px).reshape(-1))
    b = int(np.log2(M))

    rx = _as_columns(rx)
    tx = _as_columns(tx)
    rx = _phase_align(rx, tx, const_type)
    rx = _pnorm_cols(rx)
    tx = _pnorm_cols(tx)

    err_pow = jnp.mean(jnp.abs(rx - tx) ** 2, axis=0)
    sig_pow_ = jnp.mean(jnp.abs(tx) ** 2, axis=0)
    snr = 10 * jnp.log10(sig_pow_ / err_pow)

    bmap = jnp.asarray(bit_map(M, const_type))
    const_j = jnp.asarray(const)
    ind_rx = min_euclid(jnp.sqrt(es) * rx, const_j)  # (N, modes)
    ind_tx = min_euclid(jnp.sqrt(es) * tx, const_j)
    bits_rx = bmap[ind_rx]  # (N, modes, b)
    bits_tx = bmap[ind_tx]
    err = bits_rx != bits_tx
    ber = jnp.mean(err, axis=(0, 2))
    ser = jnp.mean(jnp.any(err, axis=2), axis=0)
    return ber, ser, snr


@jax.jit
def calc_llr(rx_symb, noise_var, const_symb, bitmap, px):
    """Bit LLRs under a circular AWGN model (metrics.py:198).

    ``p(b_k=v) = sum_{m: bitMap[m,k]=v} exp(-|r - s_m|^2/sigma^2) * px[m]``
    computed as two matmuls of the (N, M) likelihood matrix against the bit
    map — a matrix contraction instead of the reference's per-symbol loop.
    Returns interleaved LLRs of length N*log2(M).
    """
    rx_symb = jnp.asarray(rx_symb).reshape(-1)
    const_symb = jnp.asarray(const_symb).reshape(-1)
    bitmap = jnp.asarray(bitmap).astype(jnp.float32)  # (M, b)
    px = jnp.asarray(px).reshape(-1)
    d2 = jnp.abs(rx_symb[:, None] - const_symb[None, :]) ** 2
    # log-sum-exp per bit value for numerical stability
    logw = -d2 / noise_var + jnp.log(px)[None, :]  # (N, M)
    mx = jnp.max(logw, axis=1, keepdims=True)
    w = jnp.exp(logw - mx)
    # HIGHEST: a default f32 matmul may run in TF32 on a GPU (~1e-3
    # relative error in every LLR)
    hi = jax.lax.Precision.HIGHEST
    p1 = jnp.matmul(w, bitmap, precision=hi)  # (N, b)
    p0 = jnp.matmul(w, 1.0 - bitmap, precision=hi)
    llr = jnp.log(p0) - jnp.log(p1)
    return llr.reshape(-1)


@jax.jit
def calc_extr_llr(bit_llr, x, x_mu, x_nu, const_symb, bitmap, px=None):
    """Extrinsic bit LLRs under an auxiliary Gaussian model (metrics.py:242).

    Vectorized over symbols: the Gaussian likelihoods, per-symbol priors from
    bit probabilities, and the leave-one-bit-out prior division are all
    batched (N, M, b) tensor ops.
    """
    from opticommpy_tpu.utils.units import llr2bit_prob

    num_floor = 1e-3
    prob_floor = 1e-4
    const_symb = jnp.asarray(const_symb).reshape(-1)
    bitmap_f = jnp.asarray(bitmap).astype(jnp.float32)  # (M, b)
    M, b = bitmap_f.shape
    if px is None:
        px = jnp.ones(M) / M
    x = jnp.asarray(x).reshape(-1)
    x_mu = jnp.asarray(x_mu).reshape(-1)
    var = jnp.maximum(jnp.asarray(x_nu).reshape(-1), num_floor)

    pb1 = jnp.clip(
        llr2bit_prob(jnp.asarray(bit_llr).reshape(-1, b)), prob_floor, 1 - prob_floor
    )  # (N, b)
    pb0 = 1.0 - pb1

    d2 = jnp.abs(x[:, None] - x_mu[:, None] * const_symb[None, :]) ** 2
    psi = (1.0 / (jnp.pi * var[:, None])) * jnp.exp(-d2 / var[:, None]) * px[None, :]

    # probProd[n, m, k] = Pb1[n,k] if bit k of symbol m is 1 else Pb0[n,k]
    prob_prod = (
        pb1[:, None, :] * bitmap_f[None, :, :]
        + pb0[:, None, :] * (1.0 - bitmap_f[None, :, :])
    )  # (N, M, b)
    prior = jnp.prod(prob_prod, axis=2)  # (N, M)
    extr_prior = prior[:, :, None] / prob_prod  # leave-one-out, (N, M, b)
    weighted = psi[:, :, None] * extr_prior
    pe1 = jnp.sum(weighted * bitmap_f[None, :, :], axis=1)  # (N, b)
    pe0 = jnp.sum(weighted * (1.0 - bitmap_f[None, :, :]), axis=1)
    pe1 = jnp.clip(pe1, prob_floor, 1 - prob_floor)
    pe0 = jnp.clip(pe0, prob_floor, 1 - prob_floor)
    return jnp.log(pe0 / pe1).reshape(-1)


def monte_carlo_gmi(rx, tx, M, const_type, px=None):
    """Monte-Carlo generalized mutual information (metrics.py:329).

    Returns (GMI, NGMI) per mode. Uses :func:`calc_llr` (matmul form) and the
    bitwise-MI estimator ``H/b - mean(log2(1 + exp((2b-1)*LLR)))``.
    """
    const = gray_mapping(M, const_type)
    b = int(np.log2(M))
    bmap = bit_map(M, const_type)
    if px is None:
        px = np.ones(M) / M
    px = np.asarray(px).reshape(-1)
    es = np.sum(np.abs(const) ** 2 * px)
    const_n = const / np.sqrt(es)
    H = float(-np.sum(px * np.log2(px)))

    rx = _as_columns(rx)
    tx = _as_columns(tx)
    rx = _phase_align(rx, tx, const_type)
    rx = _pnorm_cols(rx)
    tx = _pnorm_cols(tx)
    n_modes = rx.shape[1]
    noise_var = jnp.var(rx - tx, axis=0)

    gmi = []
    for k in range(n_modes):
        btx = demodulate_gray(jnp.sqrt(es) * tx[:, k], M, const_type)
        llrs = calc_llr(rx[:, k], noise_var[k], const_n, bmap, px)
        llrs = jnp.clip(llrs, -500.0, 500.0)
        sign = 2 * btx.astype(jnp.float32) - 1
        # numerically-stable log2(1 + exp(s*llr)) via logaddexp
        penalty = jnp.logaddexp(0.0, sign * llrs) / jnp.log(2.0)
        mi_bits = H / b - jnp.mean(penalty.reshape(-1, b), axis=0)
        gmi.append(jnp.sum(mi_bits))
    gmi = jnp.stack(gmi)
    return gmi, gmi / H


@jax.jit
def calc_mi(rx, tx, noise_var, const_symb, px):
    """Mutual information for a circular AWGN channel (metrics.py:496)."""
    rx = jnp.asarray(rx).reshape(-1)
    tx = jnp.asarray(tx).reshape(-1)
    const_symb = jnp.asarray(const_symb).reshape(-1)
    px = jnp.asarray(px).reshape(-1)
    h_x = -jnp.sum(px * jnp.log2(px))
    ind = jnp.argmin(jnp.abs(tx[:, None] - const_symb[None, :]) ** 2, axis=1)
    log2_pygx = -(1.0 / noise_var) * jnp.abs(rx - tx) ** 2 * jnp.log2(jnp.e)
    logw = -(1.0 / noise_var) * jnp.abs(rx[:, None] - const_symb[None, :]) ** 2
    mx = jnp.max(logw, axis=1)
    py = jnp.exp(mx) * jnp.sum(jnp.exp(logw - mx[:, None]) * px[None, :], axis=1)
    h_xgy = -jnp.mean(log2_pygx + jnp.log2(px[ind]) - jnp.log2(py))
    return h_x - h_xgy


def monte_carlo_mi(rx, tx, M, const_type, px=None):
    """Monte-Carlo MI estimation per mode (metrics.py:429)."""
    if px is None:
        px = np.ones(M) / M
    px = np.asarray(px).reshape(-1)
    const = gray_mapping(M, const_type)
    const = const / np.sqrt(np.sum(np.abs(const) ** 2 * px))

    rx = _as_columns(rx)
    tx = _as_columns(tx)
    rx = _phase_align(rx, tx, const_type)
    rx = _pnorm_cols(rx)
    tx = _pnorm_cols(tx)
    noise_var = jnp.var(rx - tx, axis=0)
    return jnp.stack(
        [
            calc_mi(rx[:, k], tx[:, k], noise_var[k], const, px)
            for k in range(rx.shape[1])
        ]
    )


def calc_evm(symb, M, const_type, symb_tx=None):
    """Error vector magnitude per mode (metrics.py:572)."""
    symb = pnorm(jnp.asarray(symb))
    symb = _as_columns(symb)
    const = pnorm(jnp.asarray(gray_mapping(M, const_type)))
    if symb_tx is not None:
        symb_tx = pnorm(_as_columns(jnp.asarray(symb_tx)))
        symb = _phase_align(symb, symb_tx, const_type)
        decided = symb_tx
    else:
        ind = min_euclid(symb, const)
        decided = const[ind]
    return jnp.mean(jnp.abs(symb - decided) ** 2, axis=0) / jnp.mean(
        jnp.abs(decided) ** 2, axis=0
    )


def theory_ber(M, ebn0_db, const_type):
    """Approximate AWGN bit error probability for PAM/QAM/PSK (metrics.py:640)."""
    ebn0 = db2lin(ebn0_db)
    k = np.log2(M)
    if const_type == "qam":
        L = np.sqrt(M)
        return (
            2
            * (1 - 1 / L)
            / np.log2(L)
            * qfunc(jnp.sqrt(3 * np.log2(L) / (L**2 - 1) * (2 * ebn0)))
        )
    elif const_type == "psk":
        ps = 2 * qfunc(jnp.sqrt(2 * k * ebn0) * np.sin(np.pi / M))
        return ps / k
    elif const_type == "pam":
        ps = (2 * (M - 1) / M) * qfunc(jnp.sqrt(6 * np.log2(M) / (M**2 - 1) * ebn0))
        return ps / k
    raise ValueError("const_type must be 'qam', 'psk' or 'pam'")


# ---------------------------------------------------------------------------
# Theory MI via 2-D quadrature (host-side SciPy, offline analysis)
# ---------------------------------------------------------------------------


def _cond_entropy(y_i, y_q, const, p_x, ind, sigma):
    """Integrand: H(X|Y=y) contribution of symbol ``ind`` (metrics.py:689)."""
    d2 = (y_i - const.real) ** 2 + (y_q - const.imag) ** 2
    g = 1 / (2 * np.pi * sigma**2) * np.exp(-d2 / (2 * sigma**2))
    p_y = max(np.sum(g * p_x), 1e-50)
    exp_term = g[ind]
    int1 = exp_term * np.log2(max(exp_term, 1e-50))
    int2 = exp_term * np.log2(p_x[ind])
    int3 = exp_term * np.log2(p_y)
    return -(int1 + int2 - int3) * p_x[ind]


def theory_mi(M, const_type, snr_db, px=None, symmetry=True, lim=np.inf, tol=1e-3):
    """DCMC AWGN mutual information via 2-D quadrature (metrics.py:770).

    Exploits rotational symmetry (grouping symbols by |s|) to reduce the
    number of dblquad evaluations, as the reference does.
    """
    const = gray_mapping(M, const_type)
    es = np.sum(np.mean(np.abs(const) ** 2))
    const = np.asarray(const / np.sqrt(es), dtype=np.complex128)
    sigma = np.sqrt(0.5 / float(db2lin(snr_db)))
    if px is None:
        px = np.ones(M) / M
    mi = -np.sum(px * np.log2(px))

    if symmetry:
        groups = {}
        for i, s in enumerate(const):
            key = round(abs(s) / 1e-12)
            groups.setdefault(key, []).append(i)
        items = [(idxs[0], len(idxs)) for idxs in groups.values()]
    else:
        items = [(i, 1) for i in range(M)]

    for rep, count in items:
        val, _ = dblquad(
            _cond_entropy,
            -lim,
            lim,
            -lim,
            lim,
            args=(const, px, rep, sigma),
            epsabs=tol,
        )
        mi -= val * count
    return mi


# ---------------------------------------------------------------------------
# GN-model and OSNR budgeting (host-side NumPy, closed-form)
# ---------------------------------------------------------------------------


def gn_model_nyquist_wdm(rs, n_ch, df, alpha_db, gamma_, l_span, n_spans,
                         ptx_dbm, disp, b_ref, fc):
    """GN-model NLIN variance for Nyquist-WDM (metrics.py:851, Poggiolini 2012).

    Parity note (carried KNOWINGLY from the reference, not ground truth):
    the reference's own code flags its trailing "multiplication by two"
    as questionable ("is this correct?", metrics.py:894-897) yet ships it;
    it also uses inconsistent Nch exponents between the two arcsinh terms
    — ``Nch**(2*Rs/df)`` in var_NLI vs ``(Nch**2)**(2*Rs/df)`` in epsilon
    (Poggiolini 2012 eq. (13)/(23) use Nch**2 inside both log/arcsinh
    forms). Both quirks are reproduced verbatim here so predictions match
    the reference bit-for-bit; fix them upstream-first if ever corrected.
    """
    lam = sconst.c / fc * 1e-3  # km
    c_kms = sconst.c / 1.5 * 1e-3
    alpha = alpha_db / (10 * np.log10(np.exp(1)))
    leff = (1 - np.exp(-2 * alpha * l_span)) / (2 * alpha)
    leffa = 1 / (2 * alpha)
    ptx = 10 ** (ptx_dbm / 10) * 1e-3
    beta2 = -disp * lam**2 / (2 * np.pi * c_kms)

    var_nli = (
        (8 / 27)
        * gamma_**2
        * leff**2
        * (ptx / rs) ** 3
        * np.arcsinh(
            np.pi**2 / 2 * np.abs(beta2) * leffa * n_ch ** (2 * rs / df) * rs**2
        )
        / (np.pi * np.abs(beta2) * leffa)
        * b_ref
    )
    epsilon = (3 / 10) * np.log(
        1
        + 6
        / l_span
        * leffa
        / np.arcsinh(
            (np.pi**2 / 2) * np.abs(beta2) * leffa * (n_ch**2) ** (2 * rs / df) * rs**2
        )
    )
    return 2 * (n_spans ** (1 + epsilon)) * var_nli


def ase_nyquist_wdm(alpha_db, l_span, n_spans, nf_db, b_ref, fc):
    """Accumulated ASE power over n_spans EDFAs (metrics.py:901)."""
    g_db = alpha_db * l_span
    nf_lin = 10 ** (nf_db / 10)
    g_lin = 10 ** (g_db / 10)
    nsp = (g_lin * nf_lin - 1) / (2 * (g_lin - 1))
    n_ase = n_spans * (g_lin - 1) * nsp * sconst.h * fc
    return 2 * n_ase * b_ref


def gn_model_osnr(rs, n_ch, df, ptx_dbm_list, ltotal=800, l_span=50,
                  alpha_db=0.2, disp=16, gamma_=1.3, fc=193.1e12, nf_db=4.5,
                  b_ref=12.5e9):
    """OSNR prediction from the GN model (metrics.py:917)."""
    n_spans = int(ltotal // l_span)
    ptx_dbm_list = np.atleast_1d(ptx_dbm_list)
    p_nli = np.array(
        [
            gn_model_nyquist_wdm(
                rs, n_ch, df, alpha_db, gamma_, l_span, n_spans, p, disp, b_ref, fc
            )
            for p in ptx_dbm_list
        ]
    )
    p_ase = np.full_like(p_nli, ase_nyquist_wdm(alpha_db, l_span, n_spans, nf_db, b_ref, fc))
    osnr = 10 ** (ptx_dbm_list / 10) * 1e-3 / (p_nli + p_ase)
    return osnr, p_nli, p_ase


def calc_lin_osnr(n_spans, p_in, alpha_db, l_span, osnr_in, nf_db=4.5,
                  fc=193.1e12, b_ref=12.5e9):
    """OSNR evolution across a chain of spans + EDFAs (metrics.py:942)."""
    g_db = alpha_db * l_span
    nf_lin = 10 ** (nf_db / 10)
    g_lin = 10 ** (g_db / 10)
    nsp = (g_lin * nf_lin - 1) / (2 * (g_lin - 1))
    n_ase = (g_lin - 1) * nsp * sconst.h * fc
    p_ase_dbm = 10 * np.log10((2 * n_ase * b_ref) / 1e-3)

    pn_in = (p_in - osnr_in) - alpha_db * l_span
    osnr = np.zeros(n_spans + 1)
    osnr[0] = osnr_in
    for span in range(1, n_spans + 1):
        pn_out = 10 * np.log10(10 ** ((pn_in + g_db) / 10) + 10 ** (p_ase_dbm / 10))
        osnr[span] = p_in - pn_out
        pn_in = pn_out - alpha_db * l_span
    return osnr
