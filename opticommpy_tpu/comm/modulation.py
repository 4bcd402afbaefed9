"""Digital modulation: constellations, Gray mapping, (de)mapping, detection.

Counterpart of reference ``optic/comm/modulation.py``. Constellation
*generation* is host-side NumPy (tiny, offline, produces constant arrays);
everything per-symbol (minEuclid, demap, detector, soft estimation, MLSE) is
vectorized JAX:

- :func:`min_euclid` ~ modulation.py:271 — the Numba prange loop becomes one
  broadcast distance tensor + argmin (vmap/shard-able).
- :func:`soft_estimator` ~ modulation.py:522 — the per-symbol M*q probability
  products become two log-domain matmuls against the bit map.
- :func:`mlse` ~ modulation.py:581 — Viterbi as a ``lax.scan`` over time with
  all trellis states updated in parallel per step.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.ops.signal import pnorm
from opticommpy_tpu.utils.units import llr2bit_prob

__all__ = [
    "gray_code",
    "gray_mapping",
    "pam_const",
    "qam_const",
    "psk_const",
    "apsk_const",
    "min_euclid",
    "demap",
    "modulate_gray",
    "demodulate_gray",
    "detector",
    "soft_mapper",
    "soft_estimator",
    "bit_map",
    "mlse",
]


# ---------------------------------------------------------------------------
# Constellation generation (host-side NumPy, offline)
# ---------------------------------------------------------------------------


def gray_code(n):
    """n-bit Gray code as integer array: g(i) = i ^ (i >> 1)."""
    i = np.arange(1 << n)
    return i ^ (i >> 1)


def pam_const(M):
    """M-PAM levels {-(M-1), ..., -1, 1, ..., M-1} (modulation.py:121)."""
    L = M - 1
    return np.arange(-L, L + 1, 2).astype(np.float32)


def qam_const(M):
    """Square M-QAM grid with serpentine row ordering (modulation.py:143)."""
    L = int(np.sqrt(M)) - 1
    pam = np.arange(-L, L + 1, 2)
    grid = np.tile(pam, (L + 1, 1))
    const = grid + 1j * np.flipud(grid.T)
    for row in range(1, L + 1, 2):
        const[row] = const[row][::-1]
    return const.astype(np.complex64)


def psk_const(M):
    """M-PSK points on the unit circle (modulation.py:177)."""
    phases = 2 * np.pi * np.arange(M) / M
    return np.exp(1j * phases).astype(np.complex64)


def apsk_const(M, m1=None, phase_offset=None):
    """M-APSK multi-ring constellation (modulation.py:200).

    ``m1`` bits index the rings; ring radii follow the Gaussian-quantile rule
    of Liu et al. (2011); alternate rings are phase-flipped for Gray-ness.
    """
    if m1 is None:
        m1 = {16: 1, 32: 2, 64: 2, 128: 3, 256: 3, 512: 4, 1024: 4}[M]
    n_rings = 1 << m1
    m2 = int(np.log2(M)) - m1
    per_ring = 1 << m2
    if phase_offset is None:
        phase_offset = np.pi / per_ring
    const = np.zeros(M, dtype=np.complex64)
    for r in range(n_rings):
        radius = np.sqrt(-np.log(1 - ((r + 1) - 0.5) * per_ring / M))
        ring = psk_const(per_ring)
        if (r + 1) % 2 == 1:
            ring = np.flip(ring)
        const[r * per_ring : (r + 1) * per_ring] = radius * ring
    return (const * np.exp(1j * phase_offset)).astype(np.complex64)


def gray_mapping(M, const_type):
    """Constellation ordered by Gray-mapped bit label (modulation.py:64).

    Index ``i`` of the returned array is the symbol whose Gray bit label, read
    as an integer, equals ``i``.
    """
    if const_type == "ook":
        M = 2
    bits_per_symbol = int(np.log2(M))
    code = gray_code(bits_per_symbol)
    if const_type == "ook":
        const = np.arange(2).astype(np.float32)
    elif const_type == "pam":
        const = pam_const(M)
    elif const_type == "qam":
        const = qam_const(M)
    elif const_type == "psk":
        const = psk_const(M)
    elif const_type == "apsk":
        const = apsk_const(M)
    else:
        raise ValueError(f"unknown constellation type: {const_type}")
    const = const.reshape(-1)
    # position symbols so that const_out[gray_label] = const[natural_index]
    order = np.argsort(code)
    return const[order]


def bit_map(M, const_type):
    """(M, log2(M)) bit labels of :func:`gray_mapping` order (MSB first).

    Row ``i`` of the map is just the binary expansion of ``i`` — by
    construction of gray_mapping, index == bit label (this is what the
    reference computes via minEuclid(const, const) + dec2bitarray in
    demodulateGray, modulation.py:399-403).
    """
    b = int(np.log2(M)) if const_type != "ook" else 1
    idx = np.arange(1 << b)
    shifts = np.arange(b - 1, -1, -1)
    return ((idx[:, None] >> shifts[None, :]) & 1).astype(np.int32)


# ---------------------------------------------------------------------------
# Per-symbol operations (JAX, vectorized)
# ---------------------------------------------------------------------------


@jax.jit
def min_euclid(symb, const):
    """Index of the closest constellation point per symbol (modulation.py:271).

    Works on any symbol array shape; the constellation axis is broadcast and
    reduced with one argmin (the reference's Numba prange loop).
    """
    symb = jnp.asarray(symb)
    const = jnp.asarray(const)
    d2 = jnp.abs(symb[..., None] - const) ** 2
    return jnp.argmin(d2, axis=-1)


def demap(ind_symb, bitmap):
    """Symbol indices -> interleaved bit sequence (modulation.py:302)."""
    bits = jnp.asarray(bitmap)[jnp.asarray(ind_symb)]
    return bits.reshape(-1)


def modulate_gray(bits, M, const_type):
    """Bits -> Gray-mapped constellation symbols (modulation.py:334)."""
    if const_type == "ook":
        M = 2
    b = int(np.log2(M))
    const = jnp.asarray(gray_mapping(M, const_type))
    bits = jnp.asarray(bits).reshape(-1, b)
    weights = jnp.asarray(1 << np.arange(b - 1, -1, -1), dtype=jnp.int32)
    idx = jnp.sum(bits.astype(jnp.int32) * weights, axis=1)
    return const[idx]


def demodulate_gray(symb, M, const_type):
    """Hard demodulation: minimum-distance + Gray demapping (modulation.py:369)."""
    if const_type == "ook":
        M = 2
    const = jnp.asarray(gray_mapping(M, const_type))
    bmap = jnp.asarray(bit_map(M, const_type))
    ind = min_euclid(jnp.asarray(symb), const)
    return demap(ind, bmap)


@partial(jax.jit, static_argnames=("rule",))
def detector(r, noise_var, const_symb, px=None, rule="MAP"):
    """MAP/ML symbol detection (modulation.py:411), fully vectorized.

    Returns (decided symbols, decided indices).
    """
    r = jnp.asarray(r)
    const_symb = jnp.asarray(const_symb)
    if px is None or rule == "ML":
        px = jnp.ones(const_symb.shape[0]) / const_symb.shape[0]
    d2 = jnp.abs(r[..., None] - const_symb) ** 2
    if rule == "MAP":
        metric = -d2 / noise_var + jnp.log(px)
        ind = jnp.argmax(metric, axis=-1)
    elif rule == "ML":
        ind = jnp.argmin(d2, axis=-1)
    else:
        raise ValueError("Detection rule should be either MAP or ML")
    return const_symb[ind], ind


@jax.jit
def soft_estimator(llr, bitmap, const_symb):
    """Soft symbol mean/variance from bit LLRs (modulation.py:522).

    The reference's per-symbol M*q probability product loops become two
    matmuls in the log domain: ``logP(sym m) = log(Pb1) @ B^T + log(Pb0) @
    (1-B)^T`` — a matrix contraction over bits, batched over symbols.
    """
    llr = jnp.clip(jnp.asarray(llr), -300.0, 300.0)
    bitmap = jnp.asarray(bitmap).astype(jnp.float32)  # (M, q)
    const_symb = jnp.asarray(const_symb)
    pb1 = jnp.clip(llr2bit_prob(llr), 1e-30, 1.0)  # (N, q)
    pb0 = jnp.clip(1.0 - pb1, 1e-30, 1.0)
    # HIGHEST: a default f32 matmul may run in TF32 on a GPU
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    log_p = mm(jnp.log(pb1), bitmap.T) + mm(jnp.log(pb0), 1.0 - bitmap.T)
    prob = jnp.exp(log_p)  # (N, M)
    abs2 = jnp.abs(const_symb) ** 2
    soft_mean = mm(prob, const_symb)
    soft_var = mm(prob, abs2) - jnp.abs(soft_mean) ** 2
    return soft_mean, soft_var


def soft_mapper(llr, M, const_type):
    """Map interleaved bit LLRs to soft symbol estimates (modulation.py:484)."""
    b = int(np.log2(M))
    const = pnorm(jnp.asarray(gray_mapping(M, const_type)))
    bmap = bit_map(M, const_type)
    return soft_estimator(jnp.asarray(llr).reshape(-1, b), bmap, const)


# ---------------------------------------------------------------------------
# MLSE (Viterbi) — lax.scan over time, all states in parallel
# ---------------------------------------------------------------------------


def mlse(y, h, const_symb):
    """Maximum-likelihood sequence estimation via Viterbi (modulation.py:581).

    Trellis states are the channel memory contents (M**L states, L = taps-1).
    The time recurrence is a ``lax.scan``; within each step every state's
    survivor is found with a vectorized min over its M predecessors:
    state ``ns`` at time n+1 is reached from predecessors
    ``ns//M + j*M**(L-1)`` emitting symbol ``ns % M``.
    """
    y = jnp.asarray(y)
    const_symb = np.asarray(const_symb)
    h = np.asarray(h)
    M = len(const_symb)
    L = len(h) - 1

    if L == 0:
        ind = min_euclid(y / h[0], jnp.asarray(const_symb))
        return jnp.asarray(const_symb)[ind]

    n_states = M**L
    # expected channel output for (state, input symbol): state digits are the
    # base-M representation of past symbols (most recent = least significant)
    s = np.arange(n_states)
    digits = np.stack([(s // (M**i)) % M for i in range(L)], axis=1)  # (S, L)
    y_expected = np.outer(np.ones(n_states), h[0] * const_symb).astype(complex)
    for i in range(1, L + 1):
        y_expected += h[i] * const_symb[digits[:, i - 1]][:, None]
    y_expected = jnp.asarray(y_expected.astype(np.complex64))  # (S, M)

    ns = np.arange(n_states)
    pred = ns[:, None] // M + np.arange(M)[None, :] * (M ** (L - 1))  # (S, M)
    emit = ns % M  # symbol emitted entering state ns
    pred_j = jnp.asarray(pred)
    emit_j = jnp.asarray(emit)

    def step(path_metrics, yn):
        bm = jnp.abs(yn - y_expected) ** 2  # (S, M) branch metrics
        cand = path_metrics[pred_j] + bm[pred_j, emit_j[:, None]]  # (S, M)
        j_best = jnp.argmin(cand, axis=1)
        new_pm = jnp.take_along_axis(cand, j_best[:, None], axis=1)[:, 0]
        pointers = pred_j[jnp.arange(n_states), j_best]
        return new_pm, pointers

    pm0 = jnp.zeros(n_states)
    final_pm, pointers = jax.lax.scan(step, pm0, y)

    # traceback (reverse scan over stored pointers)
    best_state = jnp.argmin(final_pm)

    def back(state, ptrs):
        return ptrs[state], state

    _, states = jax.lax.scan(back, best_state, pointers, reverse=True)
    symbols_idx = emit_j[states]
    return jnp.asarray(const_symb)[symbols_idx]
