"""Noise generation with explicit PRNG keys.

Counterparts of reference ``optic/dsp/core.py:739-826``
(gaussianComplexNoise / gaussianNoise / phaseNoise). The reference seeds
numpy's global RNG inside Numba kernels; here every draw threads an explicit
``jax.random`` key so runs are reproducible under jit and shardable across
devices. The phase-noise random walk is a vectorized cumsum, not a loop.
"""

import jax
import jax.numpy as jnp

__all__ = ["gaussian_complex_noise", "gaussian_noise", "phase_noise"]


def gaussian_complex_noise(key, shape, var=1.0):
    """Circular complex Gaussian noise with total variance ``var``."""
    kr, ki = jax.random.split(key)
    std = jnp.sqrt(var / 2)
    return (
        std * jax.random.normal(kr, shape)
        + 1j * std * jax.random.normal(ki, shape)
    ).astype(jnp.complex64)


def gaussian_noise(key, shape, var=1.0):
    """Real Gaussian noise with variance ``var``."""
    return (jnp.sqrt(var) * jax.random.normal(key, shape)).astype(jnp.float32)


def phase_noise(key, lw, n_samples, ts):
    """Random-walk (Wiener) laser phase noise realization.

    Increment variance is ``2*pi*lw*ts`` (reference core.py:791); phi[0] = 0.
    """
    var = 2 * jnp.pi * lw * ts
    incr = jnp.sqrt(var) * jax.random.normal(key, (n_samples - 1,))
    return jnp.concatenate([jnp.zeros((1,)), jnp.cumsum(incr)]).astype(jnp.float32)
