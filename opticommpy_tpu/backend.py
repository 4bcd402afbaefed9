"""One table from JAX platform to the implementation that runs there.

Every choice between a hand-written kernel and its plain XLA form goes
through :func:`implementation`, so that adding a platform is one row here.

- ``"gpu"`` -> ``"kernel"``: the compiled Pallas kernels (Triton route) and
  XLA's compiled device loops.
- ``"cpu"`` -> ``"xla"``: the plain XLA paths. A Pallas kernel runs on the
  CPU only in the Pallas interpreter, and only when a caller asks for it
  (``interpret=True``), as the tests do.

Any other platform raises: nothing here was written or measured for it.
"""

import jax

__all__ = ["IMPLEMENTATIONS", "implementation"]

IMPLEMENTATIONS = {"gpu": "kernel", "cpu": "xla"}


def implementation(platform=None):
    """``"kernel"`` or ``"xla"`` for ``platform`` (default: JAX's backend)."""
    platform = jax.default_backend() if platform is None else platform
    try:
        return IMPLEMENTATIONS[platform]
    except KeyError:
        raise NotImplementedError(
            f"no implementation is registered for platform {platform!r}; "
            f"supported platforms: {sorted(IMPLEMENTATIONS)}") from None
