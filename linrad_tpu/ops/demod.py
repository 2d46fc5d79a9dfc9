"""Baseband detectors: BFO/SSB, AM, FM, coherent.

JAX forms of the reference's detector set (mix2.c:1774-1900
coherent modes 0-2, AM envelope mix2.c:1804-1834, FM fm.c:93
``detect_fm``).  Every per-sample recurrence is expressed as an
associative scan (see utils/scanops.py) so the detectors run data-parallel
instead of as a sample loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass
from ..utils.scanops import one_pole


@pytree_dataclass
class BFOState:
    """Phase accumulator for the product detector, wrapped per block."""

    phase: jax.Array  # () float32 in [0, 2*pi)

    @classmethod
    def create(cls) -> "BFOState":
        return cls(phase=jnp.zeros((), jnp.float32))


def bfo_ssb(state: BFOState, baseb: jax.Array, bfo_hz: float,
            fs: float) -> tuple[BFOState, jax.Array]:
    """Plain BFO product detector (coherent mode 0, mix2.c:1774-1803):
    audio = Re{z * exp(i*2*pi*bfo*t)}.  baseb: (S, C) complex64."""
    s = baseb.shape[0]
    dphi = jnp.float32(2.0 * jnp.pi * bfo_hz / fs)
    ph = state.phase + dphi * jnp.arange(s, dtype=jnp.float32)
    lo = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    audio = jnp.real(baseb * lo[:, None])
    new_phase = jnp.mod(state.phase + dphi * s, 2.0 * jnp.pi)
    return BFOState(phase=new_phase), audio


@pytree_dataclass
class AMState:
    dc: jax.Array  # (C,) float32 — tracked carrier DC level

    @classmethod
    def create(cls, channels: int) -> "AMState":
        return cls(dc=jnp.zeros((channels,), jnp.float32))


def am_detect(state: AMState, baseb: jax.Array, fs: float,
              dc_tc_s: float = 0.05) -> tuple[AMState, jax.Array]:
    """Envelope detector: out = sqrt(total power) - DC, DC from a
    release-rate one-pole (mix2.c:1804-1834)."""
    env = jnp.abs(baseb)
    a = jnp.exp(-1.0 / (fs * dc_tc_s)).astype(jnp.float32)
    dc, dc_last = one_pole(env, a, state.dc, axis=0)
    return AMState(dc=dc_last), env - dc


@pytree_dataclass
class FMState:
    last: jax.Array    # (C,) complex64 — previous baseband sample
    deemph: jax.Array  # (C,) float32 — de-emphasis filter carry

    @classmethod
    def create(cls, channels: int) -> "FMState":
        from .cplx import cfull
        return cls(last=cfull((channels,), 1.0),
                   deemph=jnp.zeros((channels,), jnp.float32))


def fm_detect(state: FMState, baseb: jax.Array, fs: float,
              deviation_hz: float = 5000.0) -> tuple[FMState, jax.Array]:
    """Angle-difference discriminator (detect_fm, fm.c:93): the phase
    step between consecutive samples, scaled to +-1 at the rated
    deviation."""
    prev = jnp.concatenate([state.last[None, :], baseb[:-1]], axis=0)
    prod = baseb * jnp.conj(prev)
    audio = jnp.arctan2(jnp.imag(prod), jnp.real(prod))
    audio = audio * jnp.float32(fs / (2.0 * jnp.pi * deviation_hz))
    # positive static index: x[-1] lowers to a complex dynamic_slice
    # (kept out of the step by test_no_complex_gather.py)
    return FMState(last=baseb[baseb.shape[0] - 1],
                   deemph=state.deemph), audio


def fm_deemphasis(audio: jax.Array, fs: float, tau_us: float,
                  y0: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Standard FM de-emphasis one-pole (the pilot/de-emphasis handling
    of the reference FM path, fm.c): tau 50 us (EU) / 75 us (US).
    Returns (audio, carry)."""
    a = jnp.exp(-1.0 / (fs * tau_us * 1e-6)).astype(jnp.float32)
    return one_pole(audio, a, y0, axis=0)


def wfm_stereo_decode(composite: jax.Array, fs: float,
                      audio_cut_hz: float = 15_000.0,
                      pilot_hz: float = 19_000.0
                      ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Broadcast-WFM stereo decode of an FM-demodulated composite
    (the fm.c wideband-stereo pilot path, fm.c:373-420): correlate the
    19 kHz pilot against a complex exponential to recover its phase,
    coherently demodulate the 38 kHz DSB L-R subcarrier with the doubled
    pilot phase, low-pass both channels, and matrix to L/R.

    Vectorized over the whole block (FFT filtering instead of the
    reference's FIR ring walks).  composite: (n,) float at fs (must
    exceed ~2*53 kHz).  Returns (left, right, pilot_power_ratio)."""
    x = composite.astype(jnp.float32)
    n = x.shape[0]
    t = jnp.arange(n, dtype=jnp.float32) / jnp.float32(fs)
    # pilot phase from the whole-block correlation (fm.c:381-393)
    ref = jnp.exp(-2j * jnp.pi * jnp.float32(pilot_hz) * t)
    pil = jnp.sum(x * ref) * (2.0 / n)
    pilot_pwr = jnp.abs(pil) ** 2 / jnp.maximum(jnp.mean(x * x), 1e-20)
    ph = jnp.angle(pil)
    # 38 kHz coherent subcarrier at doubled pilot phase.  The standard
    # ties the subcarrier's positive-slope zero crossings to the
    # pilot's: pilot = sin(theta) = cos(omega*t + ph) with
    # theta = omega*t + ph + pi/2, subcarrier = sin(2*theta)
    # = -sin(2*(omega*t + ph))
    sub = -jnp.sin(2 * (2 * jnp.pi * jnp.float32(pilot_hz) * t + ph))
    lmr_raw = 2.0 * x * sub
    # FFT brick-wall low-pass with raised-cosine edge at audio_cut_hz
    freqs = jnp.abs(jnp.fft.fftfreq(n, 1.0 / fs)).astype(jnp.float32)
    edge = 0.1 * audio_cut_hz
    gain = jnp.clip((audio_cut_hz + edge - freqs) / edge, 0.0, 1.0)
    gain = jnp.sin(0.5 * jnp.pi * gain) ** 2

    def lp(sig):
        return jnp.real(jnp.fft.ifft(jnp.fft.fft(sig) * gain))

    lpr = lp(x)          # L+R (the mono signal, already ≤15 kHz + trash)
    lmr = lp(lmr_raw)    # L-R
    return 0.5 * (lpr + lmr), 0.5 * (lpr - lmr), pilot_pwr


def wfm_stereo_encode(left: np.ndarray, right: np.ndarray, fs: float,
                      pilot_level: float = 0.1,
                      pilot_hz: float = 19_000.0) -> np.ndarray:
    """Test-vector generator: the standard stereo multiplex
    (L+R)/2 + pilot·sin(theta) + (L-R)/2·sin(2·theta) — the subcarrier
    crosses zero upward together with the pilot (FCC/ITU phasing)."""
    t = np.arange(len(left)) / fs
    return ((left + right) / 2
            + pilot_level * np.sin(2 * np.pi * pilot_hz * t)
            + ((left - right) / 2) * np.sin(4 * np.pi * pilot_hz * t)
            ).astype(np.float32)


@pytree_dataclass
class CoherentState:
    """Carrier-phase tracking for coherent modes 1/2 (mix2.c:1841-1900)."""

    phase: jax.Array  # (C,) complex64 — smoothed carrier phasor

    @classmethod
    def create(cls, channels: int) -> "CoherentState":
        from .cplx import cfull
        return cls(phase=cfull((channels,), 1.0))


def coherent_detect(state: CoherentState, baseb: jax.Array,
                    carrier: jax.Array, fs: float,
                    tc_s: float = 0.05
                    ) -> tuple[CoherentState, jax.Array, jax.Array]:
    """Carrier-locked I/Q demod (coherent mode 2, mix2.c:1841-1900).

    The narrow carrier branch supplies the carrier estimate; its phase is
    smoothed with a one-pole on the unit phasor, then the wide branch is
    rotated by the conjugate phase.  Returns (state, audio_i, audio_q):
    audio_i carries the coherent (in-phase) signal, audio_q the
    quadrature noise — their power ratio is the coherence metric the
    reference displays.
    """
    a = jnp.exp(-1.0 / (fs * tc_s)).astype(jnp.float32)
    sm_r, last_r = one_pole(jnp.real(carrier), a, jnp.real(state.phase))
    sm_i, last_i = one_pole(jnp.imag(carrier), a, jnp.imag(state.phase))
    sm = jax.lax.complex(sm_r, sm_i)
    mag = jnp.abs(sm)
    unit = sm / jnp.maximum(mag, 1e-20)
    z = baseb * jnp.conj(unit)
    return (CoherentState(phase=jax.lax.complex(last_r, last_i)),
            jnp.real(z), jnp.imag(z))
