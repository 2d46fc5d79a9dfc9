"""Back transform & weak/strong split -> the timf2 time series.

JAX ``make_timf2`` (reference timf2.c:31-208): each fft1 spectrum
is split by liminfo into a weak and a strong spectrum, both are inverse
transformed, and the overlapped inverse transforms are combined into two
continuous time series (``fft1back_one/two`` + ``fft1back_fp_finish``
overlap-add, timf2.c:210-1160).  The weak series carries noise, pulses
and weak signals (the blanker's working set); the strong series carries
the gain-controlled strong signals; fft2 re-sums them (timf2 layout,
SURVEY.md Appendix A).

The per-point weak power series ``timf2_pwr`` (computed in the back
transform finalize step, timf2.c:970-1160) is returned alongside for the
blankers.  The two masked inverse FFTs run as one batched transform with
weak/strong stacked on a leading axis (SURVEY.md §7).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass
from .framing import overlap_add
from .windows import synthesis_weights


@pytree_dataclass
class Timf2State:
    weak_carry: jax.Array    # (fft1_interleave, C) complex64 OLA carry
    strong_carry: jax.Array

    @classmethod
    def create(cls, geo: Geometry) -> "Timf2State":
        # two independent buffers (a shared array breaks donation)
        shape = (geo.fft1_interleave_points, geo.channels)
        from .cplx import czeros
        return cls(weak_carry=czeros(shape),
                   strong_carry=czeros(shape))


def make_timf2_syn(geo: Geometry) -> jax.Array:
    """Synthesis weights for reconstructing the unwindowed time series
    from overlapped fft1 inverse transforms (timf2.c:970-1160)."""
    syn = synthesis_weights(geo.fft1_size, geo.fft1_interleave_points,
                            geo.fft1_sinpow)
    return jnp.asarray(syn, jnp.float32)


def timf2_step(geo: Geometry, syn: jax.Array, state: Timf2State,
               fft1_spec: jax.Array, weak_gain: jax.Array,
               strong_gain: jax.Array
               ) -> tuple[Timf2State, jax.Array, jax.Array, jax.Array]:
    """Split + back transform one step of fft1 spectra.

    fft1_spec: (n, N, C) complex64; weak_gain/strong_gain: (N,) float32
    per-bin gains from :func:`linrad_tpu.ops.sellim.liminfo_gains`.

    Returns (state, weak, strong, weak_pwr):
      weak/strong: (n * fft1_new_points, C) complex64 time series
      weak_pwr:    (n * fft1_new_points,) float32, power summed over
                   channels (the timf2_pwr analog).
    """
    # stack weak/strong on a leading axis -> one batched iFFT
    gains = jnp.stack([weak_gain, strong_gain])            # (2, N)
    masked = fft1_spec[None] * gains[:, None, :, None]     # (2, n, N, C)
    back = jnp.fft.ifft(masked, axis=2)
    frames = back * syn[None, None, :, None]
    weak, wc = overlap_add(frames[0], geo.fft1_new_points,
                           state.weak_carry)
    strong, sc = overlap_add(frames[1], geo.fft1_new_points,
                             state.strong_carry)
    weak_pwr = jnp.sum(jnp.real(weak) ** 2 + jnp.imag(weak) ** 2, axis=-1)
    return (Timf2State(weak_carry=wc, strong_carry=sc), weak, strong,
            weak_pwr)
