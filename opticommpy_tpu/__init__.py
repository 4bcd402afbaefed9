"""``opticommpy_tpu``: a JAX fiber-optic communication simulation framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of OptiCommPy
(https://github.com/edsonportosilva/OptiCommPy): digital modulation,
electro-optic transmitters, nonlinear fiber propagation (split-step Fourier),
coherent/direct-detection receivers, full coherent DSP chains, performance
metrics, and FEC — designed for compiled accelerator programs:

- one ``jax.jit`` code path replaces the reference's Numba-CPU/CuPy-GPU split,
- explicit ``jax.random`` key threading replaces global numpy seeding,
- frozen, hashable config dataclasses replace the mutable ``parameters`` bag,
- ``lax.scan``/``lax.while_loop`` replace Python hot loops,
- multi-chip scaling via ``jax.sharding.Mesh`` (see :mod:`opticommpy_tpu.parallel`).

Array convention (matching the reference): signals are ``(nSamples,)`` or
``(nSamples, nModes)`` arrays with time on axis 0 and polarization/WDM modes on
axis 1. Default precision is complex64.
"""

__version__ = "0.1.0"

from opticommpy_tpu import comm, dsp, models, ops, parallel, utils  # noqa: F401
