"""First FFT — the wideband analysis stage.

JAX equivalent of ``fft1_b`` (windowed overlapped forward transform
of raw A/D blocks, reference fft1.c:3302-4084) and ``fft1_c`` (calibration
multiply + power-spectrum accumulation, reference fft1.c:4085-4350).

Linrad runs 1-6 worker threads each transforming a different input block
(thrdef.h:88-93, wcw.c:974-1032); here the same block-level data
parallelism is a batch axis: one jitted call transforms all frames of the
step at once.
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
class FFT1Tables:
    """Constant device tables (built once, like get_buffers buf.c:868)."""

    window: jax.Array        # (fft1_size,) float32 (2*fft1_size if real)
    filtercorr: jax.Array    # (fft1_size, channels) complex64 calibration
    iq_corr: jax.Array | None = None  # (fft1_size, C) complex64 foldcorr

    @classmethod
    def create(cls, geo: Geometry,
               filtercorr: np.ndarray | None = None,
               iq_corr: np.ndarray | None = None,
               edge_taper: bool = True) -> "FFT1Tables":
        # real input transforms 2N real samples per frame (the
        # real-to-complex fold, fft_cntrl real2complex fft1var.c:43-65)
        wsize = geo.fft1_size if geo.iq_input else 2 * geo.fft1_size
        win = make_window(wsize, geo.fft1_sinpow).astype(np.float32)
        if filtercorr is None:
            fc = np.ones((geo.fft1_size, geo.channels), np.complex64)
            if edge_taper:
                fc *= edge_taper_response(geo)[:, None]
        else:
            fc = np.asarray(filtercorr, np.complex64)
            if fc.ndim == 1:
                fc = fc[:, None]
        from ..utils.xfer import device_complex
        iq = None
        if iq_corr is not None:
            iq = np.asarray(iq_corr, np.complex64)
            if iq.ndim == 1:
                iq = iq[:, None]
            iq = device_complex(iq)
        return cls(window=jnp.asarray(win),
                   filtercorr=device_complex(fc),
                   iq_corr=iq)


def edge_taper_response(geo: Geometry) -> np.ndarray:
    """Default uncalibrated desired response: sin^2 taper of the 4 bins
    on each side of the band edge, filtering A/D DC-offset artifacts at
    frequency 0 and fft1_size/2 (clear_fft1_filtercorr fft1.c:5196-5222).

    The reference stores spectra DC-centred, tapering its bins 0..3 and
    N-1..N-4 — both sides of the *edge* of the IQ passband.  In our
    DC-at-0 order that edge is bin N/2 (±Nyquist): bins N/2+j and
    N/2-1-j (j=0..3) get sin^2(j*pi/8).

    Real mode tapers the top (Nyquist-side) bins, matching the non-IQ
    branch of the reference (measured: tapering the low bins instead
    moves the timf2 reconstruction AWAY from the reference).
    """
    n = geo.fft1_size
    taper = np.array([np.sin(j * np.pi / 8) ** 2 for j in range(4)],
                     np.float32)
    r = np.ones(n, np.float32)
    if geo.iq_input:
        for j in range(4):
            r[(n // 2 + j) % n] = taper[j]
            r[(n // 2 - 1 - j) % n] = taper[j]
    else:
        for j in range(4):
            r[n - 1 - j] = taper[j]
    return r


@pytree_dataclass
class FFT1State:
    """Carried state: framer tail + slow power-spectrum average."""

    tail: jax.Array          # (interleave, C) complex64
    sumsq_avg: jax.Array     # (fft1_size, C) float32 — averaged |X|^2

    @classmethod
    def create(cls, geo: Geometry) -> "FFT1State":
        if geo.iq_input:
            from .cplx import czeros
            tail = czeros((geo.fft1_interleave_points, geo.channels))
        else:
            tail = jnp.zeros((2 * geo.fft1_interleave_points,
                              geo.channels), jnp.float32)
        return cls(
            tail=tail,
            sumsq_avg=jnp.full((geo.fft1_size, geo.channels), 1e-20,
                               jnp.float32),
        )


def fft1_step(geo: Geometry, tables: FFT1Tables, state: FFT1State,
              block: jax.Array, avg1num: int,
              axis_name: str | None = None
              ) -> tuple[FFT1State, jax.Array, jax.Array]:
    """Transform one step's worth of input.

    block: (samples_per_step, C) complex64 IQ samples.

    Returns (new_state, spectra, step_power):
      spectra: (fft1_frames_per_step, fft1_size, C) complex64 — calibrated
               fft1 transforms (the fft1_float store analog,
               fft1def.h:242-330).
      step_power: (fft1_size, C) float32 — this step's mean power spectrum.

    The slow average ``sumsq_avg`` is Linrad's fft1_sumsq (fft1.c:4085)
    reformulated as an exponential moving average whose weight matches an
    ``avg1num``-transform boxcar.

    With ``axis_name`` (inside shard_map, frames sharded over the mesh)
    the power statistics are pmean-reduced so ``sumsq_avg`` stays
    replicated-consistent; the caller owns the cross-shard framing tail
    exchange (parallel/sharded.py).
    """
    if geo.iq_input:
        frames, new_tail = frame_stream(state.tail, block, geo.fft1_size,
                                        geo.fft1_new_points)
        windowed = frames * tables.window[None, :, None]
        spec = jnp.fft.fft(windowed, axis=1)
    else:
        # real mode: 2N real samples -> N-bin one-sided spectrum
        # (block is (2*samples_per_step, C) float32)
        frames, new_tail = frame_stream(state.tail, block,
                                        2 * geo.fft1_size,
                                        2 * geo.fft1_new_points)
        windowed = frames * tables.window[None, :, None]
        spec = _pack_onesided(jnp.fft.rfft(windowed, axis=1),
                              geo.fft1_size)
    if tables.iq_corr is not None:
        # I/Q image correction X'[k] = X[k] - c[k]*conj(X[-k])
        # (expand_foldcorr application, caliq.c:40-80)
        from .cplx import cgather
        mirror = jnp.conj(cgather(
            spec, (slice(None),
                   (-jnp.arange(geo.fft1_size)) % geo.fft1_size,
                   slice(None))))
        spec = spec - tables.iq_corr[None, :, :] * mirror
    spec = spec * tables.filtercorr[None, :, :]
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    step_power = jnp.mean(power, axis=0)
    if axis_name is not None:
        step_power = jax.lax.pmean(step_power, axis_name)
    alpha = min(1.0, geo.fft1_frames_per_step / max(avg1num, 1))
    sumsq = state.sumsq_avg * (1.0 - alpha) + step_power * alpha
    return FFT1State(tail=new_tail, sumsq_avg=sumsq), spec, step_power


def fft1_real_step(geo: Geometry, window2n: jax.Array, tail: jax.Array,
                   block: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Real-input variant: 2N real samples -> N-bin one-sided spectrum.

    The reference folds real input into a half-size complex transform with
    fused int16->float conversion (``simd1_16_real`` simdasm.s:35-43,
    real2complex descriptors fft1var.c:43-65); here ``jnp.fft.rfft`` does
    the fold and XLA fuses the window multiply.

    tail: (2*interleave, C) float32; block: (2*samples_per_step, C) float32.
    Returns (spectra (n, fft1_size, C) complex64, new_tail).
    """
    frames, new_tail = frame_stream(tail, block, 2 * geo.fft1_size,
                                    2 * geo.fft1_new_points)
    windowed = frames * window2n[None, :, None]
    return _pack_onesided(jnp.fft.rfft(windowed, axis=1),
                          geo.fft1_size), new_tail


def _pack_onesided(full: jax.Array, n: int) -> jax.Array:
    """(…, N+1, C) rfft bins -> (…, N, C) one-sided spectrum with the
    Nyquist component PACKED into bin 0 as DC + i*Nyquist.

    The reference keeps the full information of the 2N real samples in
    its N-bin spectrum by packing both purely-real edge bins into one
    slot (fft1_reherm_dit_one fft1.c-side layout fft1_re.c:100-102:
    out[0].re = Nyquist, out[0].im = DC, with bins 1..N-1 stored as
    i*conj(z)); in OUR convention (z itself) the same packing is
    DC + i*Nyquist.  Without it the wideband timf2 reconstruction loses
    the Nyquist component — the former -32 dB band-edge residual."""
    spec = full[..., :n, :]
    packed = full[..., 0, :] + 1j * jnp.real(full[..., n, :])
    return spec.at[..., 0, :].set(packed).astype(jnp.complex64)
