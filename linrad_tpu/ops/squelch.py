"""Squelch and audio expander.

Squelch: JAX ``update_squelch`` (reference fft3.c:87-145) — the
in-passband fft3 spectral statistics decide signal vs noise: the noise
level comes from the smallest 20% of the in-band slow spectrum; the gate
opens when in-band power exceeds ``ratio`` times that floor, with a
smoothed gate level so opening/closing is click-free.

Expander: the mix2 audio expander — downward expansion below the AGC
reference level suppresses band noise between CW elements.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class SquelchState:
    gate: jax.Array  # () float32 smoothed open fraction 0..1

    @classmethod
    def create(cls) -> "SquelchState":
        return cls(gate=jnp.zeros((), jnp.float32))


def squelch_step(geo: Geometry, state: SquelchState,
                 fft3_spec: jax.Array, filt: jax.Array,
                 ratio: float, tc_ms: float, audio: jax.Array
                 ) -> tuple[SquelchState, jax.Array, jax.Array]:
    """Gate the audio from in-passband fft3 statistics.

    fft3_spec: (n3, fft3_size, C); filt: (mix2_size,) the baseband
    filter (its support defines "in passband", fft3.c:97-128).
    Returns (state, gated_audio, open_fraction)."""
    m2 = filt.shape[0]
    n3 = geo.fft3_size
    rel = jnp.where(jnp.arange(m2) < m2 // 2, jnp.arange(m2),
                    jnp.arange(m2) - m2)
    bins = jnp.mod(rel, n3)
    from .cplx import cgather
    sel = cgather(fft3_spec, (slice(None), bins, slice(None)))
    p = jnp.mean(jnp.sum(jnp.real(sel) ** 2 + jnp.imag(sel) ** 2,
                         axis=-1), axis=0)             # (m2,)
    inband = filt > 0.5 * jnp.max(filt)
    n_in = jnp.maximum(jnp.sum(inband), 1)
    # noise floor: mean of the smallest in-band bins (fft3.c:130-145 uses
    # the smallest 20%); k is sized well below any realistic passband so
    # only genuinely-quiet bins contribute
    big = jnp.where(inband, p, jnp.inf)
    k = max(2, m2 // 16)
    smallest = -jax.lax.top_k(-big, k)[0]
    finite = jnp.isfinite(smallest)
    noise = (jnp.sum(jnp.where(finite, smallest, 0.0))
             / jnp.maximum(jnp.sum(finite), 1))
    signal = jnp.sum(jnp.where(inband, p, 0.0)) / n_in
    open_now = (signal > ratio * jnp.maximum(noise, 1e-30)).astype(
        jnp.float32)
    # smooth the gate at the audio block rate
    steps_per_block = audio.shape[0]
    fs_bb = geo.baseband_sampling_speed
    a = jnp.exp(-steps_per_block / (fs_bb * tc_ms * 1e-3)).astype(
        jnp.float32)
    gate = a * state.gate + (1 - a) * open_now
    return SquelchState(gate=gate), audio * gate, gate


def expander(audio: jax.Array, exponent: float,
             ref_level: float = 1.0) -> jax.Array:
    """Downward expansion: out = x * (|x|/ref)^(e-1) for |x| < ref
    (the mix2 expander's noise suppression between elements)."""
    if exponent <= 1.0:
        return audio
    mag = jnp.abs(audio) / ref_level
    gain = jnp.where(mag < 1.0,
                     jnp.power(jnp.maximum(mag, 1e-9), exponent - 1.0),
                     1.0)
    return audio * gain
