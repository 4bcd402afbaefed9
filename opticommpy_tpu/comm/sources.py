"""Bit and symbol sources.

Counterpart of reference ``optic/comm/sources.py``. Random draws
thread explicit ``jax.random`` keys; the PRBS LFSR (a strictly sequential bit
recurrence, sources.py:75) runs as a ``lax.scan`` carrying the shift-register
state as an int32 word.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from opticommpy_tpu.comm.modulation import (
    apsk_const,
    pam_const,
    psk_const,
    qam_const,
)
from opticommpy_tpu.utils.rng import ensure_key

__all__ = ["bit_source", "prbs_generator", "symbol_source", "cazac_sequence"]

# Predefined LFSR taps per PRBS order (x^a + x^b + 1), as in sources.py:104-113
_PRBS_TAPS = {
    7: (6, 5),
    9: (8, 4),
    11: (10, 8),
    13: (12, 11),
    15: (14, 13),
    23: (22, 17),
    31: (30, 27),
}


@partial(jax.jit, static_argnames=("order", "length"))
def _prbs_scan(order, length, seed):
    tap_a, tap_b = _PRBS_TAPS[order]
    max_val = (1 << order) - 1

    def step(lfsr, _):
        bit = (lfsr >> (order - 1)) & 1
        fb = ((lfsr >> tap_a) ^ (lfsr >> tap_b)) & 1
        lfsr = ((lfsr << 1) | fb) & max_val
        return lfsr, bit

    _, bits = jax.lax.scan(step, jnp.uint32(seed), None, length=length)
    return bits.astype(jnp.int32)


def prbs_generator(order=23, length=None, seed=1):
    """Pseudo-random binary sequence from an LFSR of the given order.

    Supported orders: 7, 9, 11, 13, 15, 23, 31 (sources.py:75). The register
    recurrence is a ``lax.scan`` — sequential by construction, but cheap, and
    the resulting bits live on-device for downstream vectorized mapping.
    """
    if seed is None:
        seed = 1
    if seed <= 0:
        raise ValueError("Seed must be a positive integer.")
    if order not in _PRBS_TAPS:
        raise ValueError(
            f"PRBS order {order} is not supported. "
            f"Supported orders: {sorted(_PRBS_TAPS)}."
        )
    period = 2**order - 1
    if length is None or length > period:
        length = period
    return _prbs_scan(order, int(length), int(seed))


def bit_source(key_or_seed, n_bits=1000, mode="random", order=23):
    """Random or PRBS bit sequence of length ``n_bits`` (sources.py:23)."""
    if mode == "random":
        key = ensure_key(key_or_seed)
        return jax.random.randint(key, (n_bits,), 0, 2, dtype=jnp.int32)
    elif mode == "prbs":
        # An all-zero LFSR register is a fixed point, so seed 0 (or any
        # non-positive / non-int key) falls back to register state 1.
        seed = key_or_seed if isinstance(key_or_seed, int) and key_or_seed > 0 else 1
        prbs = prbs_generator(order, min(n_bits, 2**order - 1), seed)
        if prbs.shape[0] < n_bits:
            prbs = jnp.tile(prbs, n_bits // prbs.shape[0] + 1)
        return prbs[:n_bits]
    raise ValueError("mode must be 'random' or 'prbs'")


def constellation(M, const_type):
    """Raw (un-normalized) constellation points for a source."""
    if const_type == "qam":
        return qam_const(M).reshape(-1)
    elif const_type == "pam":
        return pam_const(M)
    elif const_type == "psk":
        return psk_const(M)
    elif const_type == "apsk":
        return apsk_const(M)
    raise ValueError(
        "Invalid constellation type. Supported: 'qam', 'pam', 'psk', 'apsk'."
    )


def symbol_pmf(M, const_type, dist="uniform", shaping_factor=0.0):
    """Symbol probability mass function: uniform or Maxwell-Boltzmann."""
    const = constellation(M, const_type)
    if dist == "uniform":
        return np.ones(M) / M
    elif dist == "maxwell-boltzmann":
        px = np.exp(-shaping_factor * np.abs(const) ** 2)
        return (px / np.sum(px)).reshape(-1)
    raise ValueError("dist must be 'uniform' or 'maxwell-boltzmann'")


def symbol_source(
    key_or_seed,
    n_symbols=1000,
    M=4,
    const_type="qam",
    dist="uniform",
    shaping_factor=0.0,
    px=None,
):
    """Random symbols drawn from a (possibly shaped) constellation.

    The constellation is normalized to unit average energy under ``px``
    (sources.py:137). Draws use ``jax.random.choice`` with the explicit key.
    """
    key = ensure_key(key_or_seed)
    const = constellation(M, const_type)
    if px is None:
        px = symbol_pmf(M, const_type, dist, shaping_factor)
    px = np.asarray(px).reshape(-1)
    const = const / np.sqrt(np.sum(px * np.abs(const) ** 2))
    idx = jax.random.choice(key, M, (n_symbols,), p=jnp.asarray(px))
    return jnp.asarray(const)[idx]


def cazac_sequence(N, M=1):
    """Zadoff-Chu CAZAC sequence of length N with root M (sources.py:215)."""
    if np.gcd(M, N) != 1:
        raise ValueError("The root (M) must be coprime with the sequence length (N).")
    n = jnp.arange(N)
    return jnp.exp(-1j * jnp.pi * M * n * (n + 1) / N).astype(jnp.complex64)
