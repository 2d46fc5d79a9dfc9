"""Third FFT — baseband spectrum for filtering and display.

JAX ``do_fft3``/``make_fft3_all`` (reference fft3.c:35/215): the
timf3 baseband stream is framed with a sin^N window at the baseband
overlap and forward transformed; the transforms feed mix2 (filtering +
demod) and the baseband spectrum/waterfall taps.  Squelch statistics
(``update_squelch`` fft3.c:87) are computed from the same transforms in
:mod:`linrad_tpu.ops.mix2`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass
from .framing import frame_stream
from .windows import make_window


@pytree_dataclass(frozen=True)
class FFT3Tables:
    window: jax.Array  # (fft3_size,) float32

    @classmethod
    def create(cls, geo: Geometry) -> "FFT3Tables":
        win = make_window(geo.fft3_size, geo.fft3_sinpow).astype(np.float32)
        return cls(window=jnp.asarray(win))


@pytree_dataclass
class FFT3State:
    tail: jax.Array  # (fft3_interleave, C) complex64

    @classmethod
    def create(cls, geo: Geometry) -> "FFT3State":
        from .cplx import czeros
        return cls(tail=czeros((geo.fft3_interleave_points,
                                geo.channels)))


def fft3_step(geo: Geometry, tables: FFT3Tables, state: FFT3State,
              timf3: jax.Array) -> tuple[FFT3State, jax.Array]:
    """timf3 (S3, C) -> fft3 spectra (n3, fft3_size, C)."""
    frames, new_tail = frame_stream(state.tail, timf3, geo.fft3_size,
                                    geo.fft3_new_points)
    spec = jnp.fft.fft(frames * tables.window[None, :, None], axis=1)
    return FFT3State(tail=new_tail), spec
