"""Whitening-filter estimation: autocorrelation + Levinson-Durbin.

Counterparts of reference ``optic/dsp/core.py:1142-1254``.
The autocorrelation is one batched correlation instead of a double loop; the
Levinson recursion (inherently sequential in filter order) runs as a
``lax.fori_loop`` carrying the coefficient vector with masked updates, since
the order (nTaps) is small and static.
"""

from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["autocorr", "levinson", "estimate_whitening_filter"]


@partial(jax.jit, static_argnames=("n_taps",))
def autocorr(x, n_taps):
    """Unbiased autocorrelation estimates r[0..n_taps-1] (core.py:1193)."""
    x = jnp.asarray(x)
    n = x.shape[0]

    def r_at(k):
        prod = x[k:] * jnp.conj(jnp.roll(x, k)[k:])
        # equivalent to sum_{n=k}^{N-1} x[n] conj(x[n-k])
        return jnp.sum(prod) / (n - k)

    # small n_taps: unrolled at trace time into n_taps reductions
    return jnp.stack([r_at(k) for k in range(n_taps)])


@partial(jax.jit, static_argnames=("n_taps",))
def levinson(r, n_taps):
    """Levinson-Durbin solve of the Toeplitz system (core.py:1142).

    Returns whitening-filter coefficients ``a`` with a[0] = 1.
    """
    r = jnp.asarray(r)
    a0 = jnp.zeros((n_taps,), dtype=r.dtype).at[0].set(1.0)
    idx = jnp.arange(n_taps)

    def body(i, carry):
        a, e = carry
        # acc = sum_{j=1}^{i-1} a[j] * r[i-j]
        mask = (idx >= 1) & (idx < i)
        r_rev = r[jnp.clip(i - idx, 0, n_taps - 1)]
        acc = jnp.sum(jnp.where(mask, a * r_rev, 0.0))
        k = -(r[i] + acc) / e
        # a_new[j] = a[j] + k * conj(a[i-j]) for 1 <= j < i; a_new[i] = k
        a_flip = jnp.conj(a[jnp.clip(i - idx, 0, n_taps - 1)])
        a_new = jnp.where(mask, a + k * a_flip, a)
        a_new = a_new.at[i].set(k)
        e_new = e * (1 - jnp.abs(k) ** 2)
        return a_new, e_new

    a, _ = jax.lax.fori_loop(1, n_taps, body, (a0, r[0]))
    return a


def estimate_whitening_filter(x, n_taps):
    """Whitening filter via autocorrelation + Levinson (core.py:1230)."""
    return levinson(autocorr(x, n_taps), n_taps)
