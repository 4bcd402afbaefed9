"""Auxiliary benchmark: SSFM weak-scaling efficiency (data- and pipeline-parallel).

Propagates k WDM polmux signals per chip through the Manakov solver with the
batch axis sharded over the mesh `data` axis, at 1, 2, ..., n_devices chips,
and reports samples/s/chip and weak-scaling efficiency (the north-star
>=80% target, BASELINE.md).

Run on the machine's devices (``python bench_scaling.py``), or on a virtual
CPU mesh to check the sharding layout without accelerators::

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python bench_scaling.py

(virtual-mesh "efficiency" reflects host-core contention, not the
interconnect). Prints one JSON line per mesh size; not part of
``bench.py``.
"""

import json
import time

import numpy as np

import jax
import jax.numpy as jnp

N_SAMPLES = 2**17
SIGNALS_PER_CHIP = 2


def main():
    from opticommpy_tpu.models import SSFMConfig
    from opticommpy_tpu.models.channels import manakov_ssf
    from opticommpy_tpu.parallel import make_mesh
    from jax.sharding import PartitionSpec as P

    cfg = SSFMConfig(Ltotal=50.0, Lspan=50.0, hz=0.5, alpha=0.2, D=16.0,
                     gamma=1.3, Fs=32e9 * 4, amp="ideal", nlprMethod=False,
                     trapIters=1, fusedLinear=True)

    n_dev_total = len(jax.devices())
    sizes = [d for d in [1, 2, 4, 8] if d <= n_dev_total]
    base_rate = None
    rng = np.random.default_rng(0)

    for n_dev in sizes:
        mesh = make_mesh(n_data=n_dev, n_time=1)
        k = SIGNALS_PER_CHIP * n_dev
        x = rng.normal(size=(N_SAMPLES, 2 * k, 2)).astype(np.float32) * 0.01

        prop = jax.shard_map(
            lambda e: manakov_ssf(e, cfg),
            mesh=mesh, in_specs=P(None, "data"), out_specs=P(None, "data"),
        )

        def step(x_ri):
            e = x_ri[..., 0] + 1j * x_ri[..., 1]
            out = prop(e)
            return jnp.mean((out * jnp.conj(out)).real)

        with mesh:
            fn = jax.jit(step)
            xj = jnp.asarray(x)
            float(fn(xj))  # compile
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                float(fn(xj))
                ts.append(time.perf_counter() - t0)
        t = min(ts)
        rate_per_chip = N_SAMPLES * k / t / n_dev
        if base_rate is None:
            base_rate = rate_per_chip
        print(json.dumps({
            "metric": "manakovSSF DP weak scaling",
            "devices": n_dev,
            "samples_per_s_per_chip": round(rate_per_chip, 1),
            "efficiency_vs_1chip": round(rate_per_chip / base_rate, 3),
        }))

    pp_scaling()
    sp_scaling()


def pp_scaling():
    """Pipeline-parallel weak scaling: spans + microbatches grow with chips.

    Each chip owns one span group; M = 2*S microbatches keep the bubble at
    1/3 of ideal. Reported rate counts span-samples (samples x spans), the
    quantity that grows with the pipeline depth.
    """
    from jax.sharding import Mesh
    from opticommpy_tpu.models import SSFMConfig
    from opticommpy_tpu.parallel import manakov_ssf_pp

    n_dev_total = len(jax.devices())
    sizes = [d for d in [1, 2, 4, 8] if d <= n_dev_total]
    rng = np.random.default_rng(1)
    base_rate = None
    n = 2**15
    for n_dev in sizes:
        mesh = Mesh(np.array(jax.devices()[:n_dev]), ("stage",))
        m_micro = 2 * n_dev
        k = m_micro
        n_spans = n_dev
        cfg = SSFMConfig(Ltotal=25.0 * n_spans, Lspan=25.0, hz=2.5, alpha=0.2,
                         D=16.0, gamma=1.3, Fs=32e9 * 4, amp="ideal",
                         nlprMethod=False, trapIters=1, fusedLinear=True)
        x = (0.01 * (rng.normal(size=(n, 2 * k))
                     + 1j * rng.normal(size=(n, 2 * k)))).astype(np.complex64)
        key = jax.random.PRNGKey(0)

        def run():
            out = manakov_ssf_pp(x, cfg, key, mesh, n_microbatches=m_micro)
            return float(jnp.mean(jnp.abs(out) ** 2))

        run()  # compile
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        rate = n * k * n_spans / min(ts) / n_dev
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "metric": "manakovSSF PP weak scaling",
            "devices": n_dev,
            "span_samples_per_s_per_chip": round(rate, 1),
            "efficiency_vs_1chip": round(rate / base_rate, 3),
        }))


def sp_scaling():
    """Sequence-parallel weak scaling: ONE signal's time axis grows with chips.

    Each chip owns an equal time chunk of a single polmux signal
    (manakov_ssf_sp); halos are refreshed once per span. The fixed
    per-chip FFT work makes this weak scaling on the sample axis — the
    framework's long-signal story (SURVEY.md §5).
    """
    from jax.sharding import Mesh
    from opticommpy_tpu.models import SSFMConfig
    from opticommpy_tpu.parallel import manakov_ssf_sp

    n_dev_total = len(jax.devices())
    sizes = [d for d in [1, 2, 4, 8] if d <= n_dev_total]
    rng = np.random.default_rng(2)
    base_rate = None
    n_per_chip = 2**16
    cfg = SSFMConfig(Ltotal=50.0, Lspan=50.0, hz=0.5, alpha=0.2, D=16.0,
                     gamma=1.3, Fs=32e9 * 4, amp="ideal", nlprMethod=False,
                     trapIters=1, fusedLinear=True)
    for n_dev in sizes:
        mesh = Mesh(np.array(jax.devices()[:n_dev]).reshape(1, -1),
                    ("data", "time"))
        n = n_per_chip * n_dev
        x = (0.01 * (rng.normal(size=(n, 2))
                     + 1j * rng.normal(size=(n, 2)))).astype(np.complex64)

        def run():
            out = manakov_ssf_sp(x, cfg, mesh=mesh)
            return float(jnp.mean(jnp.abs(out) ** 2))

        run()  # compile
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        rate = n / min(ts) / n_dev
        if base_rate is None:
            base_rate = rate
        print(json.dumps({
            "metric": "manakovSSF SP weak scaling",
            "devices": n_dev,
            "samples_per_s_per_chip": round(rate, 1),
            "efficiency_vs_1chip": round(rate / base_rate, 3),
        }))


if __name__ == "__main__":
    main()
