"""linrad_tpu — a JAX software-defined-radio DSP framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of Linrad
(SM5BSZ's weak-signal SDR receiver, reference at /root/reference): the
overlapped first-FFT wideband spectrum, selective limiter and weak/strong
split, smart/stupid noise blankers, second FFT, frequency-domain mixing
and decimation to baseband, the third FFT with user filter, AGC and
SSB/CW/AM/FM/coherent demodulation, and the weak-signal layer (AFC, spur
cancellation, coherent CW/Morse decoding, dual polarization) — expressed
as a single jitted block-pipeline over streaming IQ blocks, sharded over
a device mesh.
"""

from .geometry import Geometry, derive_geometry, interleave_ratio
from .params import Demod, InputMode, RxMode, RxParams, preset

__version__ = "0.1.0"

__all__ = [
    "Geometry",
    "derive_geometry",
    "interleave_ratio",
    "RxParams",
    "RxMode",
    "InputMode",
    "Demod",
    "preset",
    "__version__",
]
