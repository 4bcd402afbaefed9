"""Communication-layer algorithms: modulation, sources, metrics, OFDM, FEC.

Counterpart of the reference ``optic/comm`` package.
"""

from opticommpy_tpu.comm import codes, fec, metrics, modulation, ofdm, sources  # noqa: F401
from opticommpy_tpu.comm.modulation import (  # noqa: F401
    bit_map,
    demap,
    demodulate_gray,
    detector,
    gray_code,
    gray_mapping,
    min_euclid,
    mlse,
    modulate_gray,
    soft_estimator,
    soft_mapper,
)
from opticommpy_tpu.comm.sources import (  # noqa: F401
    bit_source,
    cazac_sequence,
    prbs_generator,
    symbol_source,
)
