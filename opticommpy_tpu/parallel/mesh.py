"""Device-mesh helpers for multi-chip scaling.

The reference has no distributed layer (SURVEY.md §2.3) — its scaling story is
Numba threads + one GPU. Here scaling is expressed the JAX way: a
``jax.sharding.Mesh`` with two logical axes,

- ``"data"``: batch parallelism over WDM channels / launch powers /
  Monte-Carlo seeds (the reference's mode-batching, channels.py:364-373 and
  modelsGPU.py:775, promoted to a sharded axis),
- ``"time"``: sequence parallelism over the signal's time axis for
  overlap-save filtering, with K-1-sample halos exchanged between devices
  (the reference's blockwise FFT decomposition, core.py:973, promoted to a
  sharded axis).

Multi-host execution uses the same code path after
``jax.distributed.initialize`` — XLA routes collectives within a host (NVLink
on a GPU host) and across hosts. Every device reaches every other at the same
rate on such a host, so mesh axes follow the algorithm alone.
"""

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "data_sharding", "P", "NamedSharding"]


def make_mesh(n_data=None, n_time=1, devices=None):
    """Create a (data, time) mesh over the available devices.

    Parameters
    ----------
    n_data : int, optional
        Size of the batch-parallel axis. Defaults to ``len(devices) // n_time``.
    n_time : int
        Size of the time-parallel (sequence) axis.
    devices : list of jax devices, optional
    """
    if devices is None:
        devices = jax.devices()
    if n_data is None:
        n_data = len(devices) // n_time
    n_used = n_data * n_time
    dev_array = np.asarray(devices[:n_used]).reshape(n_data, n_time)
    return Mesh(dev_array, axis_names=("data", "time"))


def data_sharding(mesh, *spec):
    """NamedSharding shortcut: ``data_sharding(mesh, 'data', None)``."""
    return NamedSharding(mesh, P(*spec))
