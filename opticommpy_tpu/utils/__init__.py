"""General utilities: unit conversions, bit manipulation, config helpers.

Counterpart of the reference ``optic/utils.py``.
"""

from opticommpy_tpu.utils.bits import (
    bitarray2dec,
    dec2bitarray,
)
from opticommpy_tpu.utils.units import (
    ber2qfactor,
    db2lin,
    dbm2w,
    lin2db,
    llr2bit_prob,
    w2dbm,
)
from opticommpy_tpu.utils.rng import ensure_key
from opticommpy_tpu.utils.compile_cache import enable_persistent_cache  # noqa: F401

__all__ = [
    "bitarray2dec",
    "dec2bitarray",
    "ber2qfactor",
    "db2lin",
    "dbm2w",
    "lin2db",
    "llr2bit_prob",
    "w2dbm",
    "ensure_key",
]
