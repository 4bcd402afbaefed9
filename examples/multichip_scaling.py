"""Multi-chip scaling demo: dp / sp / pp Manakov SSFM on a device mesh.

The reference is a single-process library (SURVEY.md §2.3); this framework
scales its hottest workload — Manakov split-step propagation — across a
device mesh three independent ways:

- **dp** (``manakov_ssf_dp``): WDM channels / launch powers / Monte-Carlo
  seeds sharded over chips; zero collectives in the propagation loop.
- **sp** (``manakov_ssf_sp``): ONE signal's time axis sharded; each chip
  integrates its halo-padded time chunk locally and refreshes halos from its
  neighbors once per span group (the long-signal story).
- **pp** (``manakov_ssf_pp``): fiber spans staged across chips; microbatches
  of signals flow stage→stage, GPipe-style.

Runs on the machine's devices, or anywhere on a virtual 8-device CPU mesh::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/multichip_scaling.py --cpu

All three paths agree with the single-device ``manakov_ssf`` (dp exactly, sp
to ~-78 dB with the default halo, pp exactly for deterministic amps).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true", help="run on the host CPU mesh")
args = parser.parse_args()
if args.cpu:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )

import jax  # noqa: E402

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from opticommpy_tpu.models import SSFMConfig  # noqa: E402
from opticommpy_tpu.models.channels import manakov_ssf  # noqa: E402
from opticommpy_tpu.parallel import (  # noqa: E402
    make_mesh,
    manakov_ssf_dp,
    manakov_ssf_pp,
    manakov_ssf_sp,
)


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bandlimited(rng, n, k, band=0.35, scale=0.01):
    x = rng.normal(size=(n, 2 * k)) + 1j * rng.normal(size=(n, 2 * k))
    X = np.fft.fft(x, axis=0)
    X[np.abs(np.fft.fftfreq(n)) > band] = 0
    return jnp.asarray((scale * np.fft.ifft(X, axis=0)).astype(np.complex64))


def main():
    devices = jax.devices()
    n_dev = len(devices)
    print(f"devices: {n_dev} x {devices[0].platform}")
    if n_dev < 2:
        print("need >=2 devices for the sharded paths; see --cpu in the "
              "module docstring")
        return

    fs = 32e9 * 4
    cfg = SSFMConfig(Ltotal=100.0, Lspan=50.0, hz=1.0, alpha=0.2, D=16.0,
                     gamma=1.3, Fs=fs, amp="ideal", nlprMethod=False,
                     trapIters=1)
    rng = np.random.default_rng(0)
    key = jax.random.PRNGKey(0)

    # ----- dp: batch of signals sharded over chips ------------------------
    sig = bandlimited(rng, 2**13, n_dev)  # one polmux signal per chip
    ref = manakov_ssf(sig, cfg, key)
    mesh_dp = make_mesh(n_data=n_dev, n_time=1)
    out_dp = manakov_ssf_dp(sig, cfg, key, mesh_dp)
    print(f"dp  ({n_dev} chips, {sig.shape[1] // 2} signals): "
          f"rel err vs single-device {rel_err(out_dp, ref):.2e}")

    # ----- sp: one signal's time axis sharded over chips ------------------
    sig1 = bandlimited(rng, 2**13, 1)
    ref1 = manakov_ssf(sig1, cfg, key)
    mesh_sp = Mesh(np.array(devices).reshape(1, -1), ("data", "time"))
    out_sp = manakov_ssf_sp(sig1, cfg, mesh=mesh_sp)
    print(f"sp  ({n_dev} chips, 1 signal, time-sharded): "
          f"rel err {rel_err(out_sp, ref1):.2e}")

    # ----- pp: spans staged across chips ----------------------------------
    n_spans = 2 * n_dev
    cfg_pp = SSFMConfig(Ltotal=25.0 * n_spans, Lspan=25.0, hz=2.5, alpha=0.2,
                        D=16.0, gamma=1.3, Fs=fs, amp="ideal",
                        nlprMethod=False, trapIters=1)
    sig_pp = bandlimited(rng, 2**12, 2 * n_dev)
    ref_pp = manakov_ssf(sig_pp, cfg_pp, key)
    mesh_pp = Mesh(np.array(devices), ("stage",))
    out_pp = manakov_ssf_pp(sig_pp, cfg_pp, key, mesh_pp,
                            n_microbatches=n_dev)
    print(f"pp  ({n_dev} stages, {n_spans} spans, {n_dev} microbatches): "
          f"rel err {rel_err(out_pp, ref_pp):.2e}")


if __name__ == "__main__":
    main()
