"""Electro-optic modulator transfer functions (MZM / PM math).

Counterparts of reference ``optic/dsp/core.py:1075-1139``
(calcMZM / calcPM): pure elementwise complex math that XLA fuses on the VPU.
"""

import jax.numpy as jnp

__all__ = ["calc_pm", "calc_mzm"]


def calc_pm(e_in, v_pi, u):
    """Phase modulator: ``E_o = E_i * exp(j*pi*u/Vpi)`` (core.py:1115)."""
    return e_in * jnp.exp(1j * (u / v_pi) * jnp.pi)


def calc_mzm(e_in, v_pi, u, v_b, er_db):
    """Mach-Zehnder modulator with finite extinction ratio (core.py:1075).

    Modeled as the interference of two phase-modulated arms with an imbalance
    set by the extinction ratio ``er_db`` (dB).
    """
    er_lin = 10 ** (er_db / 10)
    g = 2 * jnp.sqrt(er_lin) / (er_lin + 1)
    return jnp.sqrt(1 + g) * calc_pm(e_in / 2, v_pi, (u + v_b) / 2) + jnp.sqrt(
        1 - g
    ) * calc_pm(e_in / 2, v_pi, -(u + v_b) / 2)
