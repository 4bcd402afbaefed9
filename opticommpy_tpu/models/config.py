"""Frozen config dataclasses for the physical models.

Replacement for the reference's mutable ``parameters`` attribute
bag (``optic/utils.py:29``) + per-function ``getattr`` defaulting blocks
(e.g. ``channels.py:304-322``): each model takes a frozen, hashable dataclass
with the same field names and defaults as the reference, passed to jitted
functions as a static argument. Field names keep the reference spelling so a
reference user can port configs 1:1.
"""

import dataclasses
from dataclasses import dataclass


def replace(cfg, **kw):
    """Functional update of a frozen config (reference ``param.copy()`` idiom)."""
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class MZMConfig:
    """Mach-Zehnder modulator (reference devices.py:94 defaults)."""

    Vpi: float = 2.0
    Vb: float = -1.0
    ER: float = 60.0  # extinction ratio [dB]


@dataclass(frozen=True)
class IQMConfig:
    """IQ modulator (reference devices.py:147 defaults)."""

    Vpi: float = 2.0
    VbI: float = -2.0
    VbQ: float = -2.0
    Vphi: float = 1.0
    ERI: float = 60.0
    ERQ: float = 60.0


@dataclass(frozen=True)
class PhotodiodeConfig:
    """Pin photodiode (reference devices.py:289 defaults)."""

    R: float = 1.0  # responsivity [A/W]
    Tc: float = 25.0  # temperature [C]
    Id: float = 5e-9  # dark current [A]
    RL: float = 50.0  # load impedance [ohm]
    B: float = 30e9  # bandwidth [Hz]
    IpdSat: float = 5e-3
    N: int = 255  # freq-response FIR taps (odd)
    fType: str = "rect"
    ideal: bool = False
    shotNoise: bool = True
    thermalNoise: bool = True
    currentSaturation: bool = False
    bandwidthLimitation: bool = True
    Fs: float = None  # required unless ideal


@dataclass(frozen=True)
class EDFAConfig:
    """Lumped EDFA: flat gain + ASE (reference devices.py:671 defaults)."""

    G: float = 20.0  # gain [dB]
    NF: float = 4.5  # noise figure [dB]
    Fc: float = 193.1e12
    Fs: float = None


@dataclass(frozen=True)
class LaserConfig:
    """CW laser with phase noise + RIN (reference devices.py:729 defaults)."""

    P: float = 10.0  # power [dBm]
    lw: float = 1e3  # linewidth [Hz]
    RIN_var: float = 1e-20
    Ns: int = 1000
    Fs: float = None
    freqShift: float = 0.0


@dataclass(frozen=True)
class ADCConfig:
    """ADC model (reference devices.py:793 defaults)."""

    inFs: float = 1.0
    outFs: float = 1.0
    jitter: float = 0.0
    nBits: int = 8
    ENOB: float = 8
    Vmax: float = 1.0
    Vmin: float = -1.0
    AAF: bool = True
    N: int = 201


@dataclass(frozen=True)
class DACConfig:
    """DAC model (reference devices.py:912 defaults)."""

    inFs: float = 1.0
    outFs: float = 1.0
    nBits: int = 8
    ENOB: float = 8
    jitter: float = 0.0
    Vpp: float = 2.0
    AIF: bool = True
    N: int = 201


@dataclass(frozen=True)
class CoherentFrontendConfig:
    """Single-pol coherent front-end impairments (reference devices.py:503)."""

    Fs: float = None
    phaseImb: float = 0.0  # [rad]
    ampImb: float = 0.0  # [dB]
    timeSkew: float = 0.0  # [s]


@dataclass(frozen=True)
class PDMFrontendConfig:
    """Pol-mux coherent front-end impairments (reference devices.py:574)."""

    Fs: float = None
    polRotation: float = 0.0
    pdl: float = 0.0  # [dB]; >0 loss on X, <0 on Y
    polDelay: float = 0.0  # [s]
    phaseImbX: float = 0.0
    ampImbX: float = 0.0
    timeSkewX: float = 0.0
    phaseImbY: float = 0.0
    ampImbY: float = 0.0
    timeSkewY: float = 0.0


@dataclass(frozen=True)
class LinearFiberConfig:
    """Linear fiber channel (reference channels.py:30 defaults)."""

    L: float = 50.0  # [km]
    alpha: float = 0.2  # [dB/km]
    D: float = 17.0  # [ps/nm/km]
    Fc: float = 193.1e12
    Fs: float = None


@dataclass(frozen=True)
class SSFMConfig:
    """Split-step Fourier channel (reference channels.py:112/252 defaults).

    ``hz`` is the fixed step size; when ``nlprMethod`` is True the Manakov
    solver instead adapts the step to ``maxNlinPhaseRot`` radians of nonlinear
    phase rotation per step (channels.py:392-397).
    """

    Ltotal: float = 400.0  # [km]
    Lspan: float = 80.0  # [km]
    hz: float = 0.5  # [km]
    alpha: float = 0.2  # [dB/km]
    D: float = 16.0  # [ps/nm/km]
    gamma: float = 1.3  # [1/W/km]
    Fc: float = 193.1e12
    Fs: float = None
    amp: str = "edfa"  # 'edfa' | 'ideal' | 'none'
    NF: float = 4.5
    maxIter: int = 10
    tol: float = 1e-5
    nlprMethod: bool = True
    maxNlinPhaseRot: float = 2e-2
    # trapIters > 0 fixes the trapezoidal-correction count (no convergence
    # check): with nlprMethod=False this gives a fully static-control-flow
    # solver (scan only — the fastest-compiling and fastest-running path).
    # trapIters = 0 iterates to `tol` like the reference (while_loop).
    trapIters: int = 0
    # fusedLinear merges adjacent linear half-steps across the span
    # (L(h/2) [N L(h)]^{n-1} N L(h/2)): 2 FFTs per step instead of 4, with
    # the nonlinear rotation anchored on the half-dispersed field (the same
    # O(h^2)-accurate symmetric scheme; the reference's scalar ssfm,
    # channels.py:219-229, uses this anchor too). Requires nlprMethod=False
    # and trapIters=1.
    fusedLinear: bool = False
    # solver precision: 'c64' (default) or 'c128' (requires
    # jax_enable_x64; used for precision studies on CPU, matching the
    # reference's `prec` parameter, channels.py:312).
    prec: str = "c64"


@dataclass(frozen=True)
class AWGNConfig:
    """AWGN channel (reference channels.py:522 defaults)."""

    snr: float = 20.0
    Fs: float = 1.0
    B: float = 1.0
    complexNoise: bool = True
