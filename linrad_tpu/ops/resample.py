"""Audio-rate conversion — the rx_output resampler.

JAX form of the reference's D/A-rate sync resampler
(``rx_output`` reference rxout.c:266, 4-point interpolation with
precomputed weights rxout.c:1111-1148).  The reference continuously
re-measures true A/D and D/A clock rates and slews ``da_resample_ratio``;
with file input/output there is no clock drift, so the ratio is an exact
rational fs_out/fs_in = p/q (SURVEY.md §7 hard part 6) and every step
produces a static number of output samples.

Interpolation is 4-point cubic (Catmull-Rom), matching the reference's
4-tap t4..t7 weight scheme; the fractional positions repeat with period
p, so the weights are a small static table and the whole resample is one
gather + (S_out, 4) x (4,) weighted sum — fully vectorised.

``taps > 4`` selects a windowed-sinc polyphase kernel instead: the
reference follows its 4-point interpolator with an anti-image IIR
(``enable_resamp_iir5`` baseb_graph.c:1204-1230, the iir3 upsampling
chain rxout.c:1165-1210) because cubic interpolation leaves images only
~20 dB down for tones above ~0.25·fs_in; a 32-tap Blackman-Harris sinc
does the interpolation and the anti-image filtering in the same
gather-einsum (>70 dB rejection), which is the data-parallel shape — one
static (S_out, taps) x (taps,) contraction instead of a sequential IIR.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass


def _catmull_rom(frac: np.ndarray) -> np.ndarray:
    """4-tap interpolation weights for fractional offsets (S,) -> (S, 4)."""
    t = frac
    w0 = -0.5 * t ** 3 + t ** 2 - 0.5 * t
    w1 = 1.5 * t ** 3 - 2.5 * t ** 2 + 1.0
    w2 = -1.5 * t ** 3 + 2.0 * t ** 2 + 0.5 * t
    w3 = 0.5 * t ** 3 - 0.5 * t ** 2
    return np.stack([w0, w1, w2, w3], axis=-1)


@pytree_dataclass
class ResamplerState:
    history: jax.Array  # (taps-1, C) — carried input tail

    @classmethod
    def create(cls, channels: int, dtype=jnp.float32, taps: int = 4
               ) -> "ResamplerState":
        if jnp.issubdtype(dtype, jnp.complexfloating):
            from .cplx import czeros
            return cls(history=czeros((taps - 1, channels), dtype))
        return cls(history=jnp.zeros((taps - 1, channels), dtype))


class Resampler:
    """Rational-ratio streaming resampler with static output shapes."""

    def __init__(self, fs_in: float, fs_out: float, block_in: int,
                 channels: int, dtype=jnp.float32, taps: int = 4,
                 cutoff: float = 0.92):
        # express the ratio as an exact rational p/q
        ratio = fs_out / fs_in
        q = 1
        while (abs(ratio * q - round(ratio * q)) > 1e-9 and q < 1 << 20):
            q += 1
        p = int(round(ratio * q))
        g = math.gcd(p, q)
        p, q = p // g, q // g
        if block_in * p % q != 0:
            raise ValueError(
                f"block of {block_in} input samples maps to a non-integer "
                f"output count at ratio {p}/{q}; pick fs_out so that "
                f"block_in*fs_out/fs_in is an integer")
        self.p, self.q = p, q
        self.block_in = block_in
        self.block_out = block_in * p // q
        self.channels = channels
        self.taps = taps
        # output i nominally sits at input position i*q/p; the stream is
        # delayed so the future taps are always available from the
        # carried history (causal streaming, like the reference's output
        # delay management rxout.c:266-500)
        pos = np.arange(self.block_out) * q / p
        base = np.floor(pos).astype(np.int64)
        frac = pos - base
        self._idx = jnp.asarray(base[:, None] + np.arange(taps)[None, :],
                                jnp.int32)
        if taps == 4:
            w = _catmull_rom(frac)
        else:
            # windowed-sinc: tap j in the buffer is input sample
            # base+j-(taps-1); the output is taken at time pos-D with
            # D = taps//2, so the kernel argument for tap j is
            # (pos-D) - (base+j-(taps-1)) = frac + (taps-1-D) - j
            d = taps // 2
            arg = frac[:, None] + (taps - 1 - d) - np.arange(taps)[None]
            cut = cutoff * min(1.0, p / q)   # anti-image/anti-alias
            k = cut * np.sinc(cut * arg)
            # Blackman-Harris window over the tap span
            u = (arg + d) / (taps - 1)       # 0..1 across the kernel
            u = np.clip(u, 0.0, 1.0)
            win = (0.35875 - 0.48829 * np.cos(2 * np.pi * u)
                   + 0.14128 * np.cos(4 * np.pi * u)
                   - 0.01168 * np.cos(6 * np.pi * u))
            w = k * win
            w /= w.sum(axis=1, keepdims=True)   # exact DC gain
        self._w = jnp.asarray(w, jnp.float32)
        self.dtype = dtype

    def init_state(self) -> ResamplerState:
        return ResamplerState.create(self.channels, self.dtype,
                                     self.taps)

    def __call__(self, state: ResamplerState, x: jax.Array
                 ) -> tuple[ResamplerState, jax.Array]:
        """x: (block_in, C) -> (block_out, C)."""
        buf = jnp.concatenate([state.history, x], axis=0)
        taps = buf[self._idx]                       # (S_out, T, C)
        if jnp.iscomplexobj(x):
            w = self._w.astype(x.dtype)
        else:
            w = self._w
        out = jnp.einsum("stc,st->sc", taps, w,
                         precision=jax.lax.Precision.HIGHEST)
        return (ResamplerState(history=buf[-(self.taps - 1):]),
                out.astype(x.dtype))
