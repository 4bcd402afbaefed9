"""Import smoke test: every module imports cleanly (reference tests/test_imports.py)."""

import importlib

import pytest

MODULES = [
    "opticommpy_tpu",
    "opticommpy_tpu.utils",
    "opticommpy_tpu.utils.units",
    "opticommpy_tpu.utils.bits",
    "opticommpy_tpu.utils.rng",
    "opticommpy_tpu.utils.profiling",
    "opticommpy_tpu.utils.checkpoint",
    "opticommpy_tpu.ops",
    "opticommpy_tpu.ops.filtering",
    "opticommpy_tpu.ops.signal",
    "opticommpy_tpu.ops.noise",
    "opticommpy_tpu.ops.modulator",
    "opticommpy_tpu.ops.whitening",
    "opticommpy_tpu.comm",
    "opticommpy_tpu.comm.modulation",
    "opticommpy_tpu.comm.sources",
    "opticommpy_tpu.comm.metrics",
    "opticommpy_tpu.comm.ofdm",
    "opticommpy_tpu.comm.fec",
    "opticommpy_tpu.models",
    "opticommpy_tpu.models.config",
    "opticommpy_tpu.models.devices",
    "opticommpy_tpu.models.channels",
    "opticommpy_tpu.models.tx",
    "opticommpy_tpu.models.amplification",
    "opticommpy_tpu.models.perturbation",
    "opticommpy_tpu.dsp",
    "opticommpy_tpu.dsp.equalization",
    "opticommpy_tpu.dsp.carrier_recovery",
    "opticommpy_tpu.dsp.clock_recovery",
    "opticommpy_tpu.dsp.synchronization",
    "opticommpy_tpu.parallel",
    "opticommpy_tpu.parallel.mesh",
    "opticommpy_tpu.parallel.sharded",
    "opticommpy_tpu.parallel.distributed",
    "opticommpy_tpu.backend",
    "opticommpy_tpu.kernels",
    "opticommpy_tpu.kernels._util",
    "opticommpy_tpu.kernels.mimo_pallas",
    "opticommpy_tpu.comm.fec_qc",
    "opticommpy_tpu.comm.fec_lift",
    "opticommpy_tpu.comm.codes",
    "opticommpy_tpu.utils.compile_cache",
    "opticommpy_tpu.native",
    "opticommpy_tpu.pipelines",
    "opticommpy_tpu.plot",
    "opticommpy_tpu.compat",
    "chip_smoke",
]


@pytest.mark.parametrize("name", MODULES)
def test_import(name):
    importlib.import_module(name)
