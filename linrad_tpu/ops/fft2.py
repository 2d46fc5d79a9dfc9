"""Second FFT — high-resolution spectrum after blanking.

JAX ``make_fft2`` (reference fft2.c:52-1848).  The reference
re-sums weak+strong per point with the sin^N window fused
(fft2.c:100-116) and runs an incremental state machine
(FFT2_B/C/... globdef.h:330-338) so a CPU thread does bounded work per
call; here the chunking serves no purpose (SURVEY.md §7) — the step is
one batched windowed FFT over all frames of the step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass
from .cplx import czeros
from .framing import frame_stream
from .windows import make_window


@pytree_dataclass(frozen=True)
class FFT2Tables:
    window: jax.Array  # (fft2_size,) float32

    @classmethod
    def create(cls, geo: Geometry) -> "FFT2Tables":
        win = make_window(geo.fft2_size, geo.fft2_sinpow).astype(np.float32)
        return cls(window=jnp.asarray(win))


@pytree_dataclass
class FFT2State:
    tail: jax.Array       # (fft2_interleave, C) complex64
    sumsq_avg: jax.Array  # (fft2_size, C) float32 slow power average

    @classmethod
    def create(cls, geo: Geometry) -> "FFT2State":
        return cls(
            tail=czeros((geo.fft2_interleave_points, geo.channels)),
            sumsq_avg=jnp.full((geo.fft2_size, geo.channels), 1e-20,
                               jnp.float32),
        )


def fft2_transform(geo: Geometry, tables: FFT2Tables, tail: jax.Array,
                   weak: jax.Array, strong: jax.Array
                   ) -> tuple[jax.Array, jax.Array]:
    """Re-sum weak+strong (fft2.c:100-116) and transform.

    weak/strong: (S, C) complex64 timf2 streams (post-blanker weak).
    Returns (new_tail, spectra (n2, fft2_size, C))."""
    timf2 = weak + strong
    frames, new_tail = frame_stream(tail, timf2, geo.fft2_size,
                                    geo.fft2_new_points)
    spec = jnp.fft.fft(frames * tables.window[None, :, None], axis=1)
    return new_tail, spec


def fft2_power_update(geo: Geometry, state: FFT2State, new_tail,
                      spec: jax.Array, avg2num: int = 8
                      ) -> tuple[FFT2State, jax.Array]:
    """Power spectrum + slow average from (possibly spur-subtracted)
    fft2 spectra — the reference computes its summed power AFTER
    eliminate_spurs (fft2.c:648-670)."""
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    step_power = jnp.mean(power, axis=0)
    alpha = min(1.0, geo.fft2_frames_per_step / max(avg2num, 1))
    sumsq = state.sumsq_avg * (1.0 - alpha) + step_power * alpha
    return FFT2State(tail=new_tail, sumsq_avg=sumsq), step_power


def fft2_step(geo: Geometry, tables: FFT2Tables, state: FFT2State,
              weak: jax.Array, strong: jax.Array, avg2num: int = 8
              ) -> tuple[FFT2State, jax.Array, jax.Array]:
    """fft2_transform + fft2_power_update in one call (no spur stage).

    Returns (state, spectra (n2, fft2_size, C), step_power)."""
    new_tail, spec = fft2_transform(geo, tables, state.tail, weak,
                                    strong)
    new_state, step_power = fft2_power_update(geo, state, new_tail,
                                              spec, avg2num)
    return new_state, spec, step_power
