"""Multi-host initialization helpers.

The reference has no multi-node story (SURVEY.md §2.3). Here multi-host runs
use the standard JAX distributed runtime: after :func:`init_distributed`,
``jax.devices()`` spans the whole slice/pod, the same `make_mesh` +
`shard_map` code paths scale across hosts, and XLA routes intra-slice
collectives within a host and across hosts automatically.
"""

import jax

__all__ = ["init_distributed", "is_multihost", "local_device_count"]


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize the JAX distributed runtime (no-op for single-process runs).

    Pass the coordinator address (``host:port``), the process count and
    this process's id explicitly (see jax.distributed.initialize); nothing
    in a plain GPU host tells JAX of a cluster.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # already initialized, or single-process environment
        pass
    return jax.process_index(), jax.process_count()


def is_multihost():
    return jax.process_count() > 1


def local_device_count():
    return jax.local_device_count()
