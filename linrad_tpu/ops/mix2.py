"""Second mixer: baseband filter + inverse transform to demod input.

JAX ``do_mix2``/``fft3_mix2`` (reference mix2.c:41-2070,
mixer_mode 1 frequency-domain path mix2.c:146-216): ``mix2.size`` bins of
each fft3 transform centred at DC are multiplied by the user filter
``bg_filterfunc``, inverse transformed, and overlap-added to the
``baseb_raw`` stream.  The filter includes the inverse-``mix1_fqwin``
compensation of the reference (baseb_graph.c:1517-1520, 3795-3798) so the
end-to-end passband is flat.

The carrier branch (same bins x the ``bg_carrfilter`` narrow filter,
mix2.c:246-262) feeds coherent demodulation in :mod:`demod`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass
from ..params import RxParams
from .framing import overlap_add
from .windows import synthesis_weights


def _filter_response(freq: np.ndarray, geo: Geometry, low_hz: float,
                     high_hz: float, edge_hz: float = 0.0,
                     compensate_fqwin: bool = True, notches: tuple = (),
                     shape: tuple = ()) -> np.ndarray:
    """Baseband filter magnitude response evaluated at ``freq`` Hz
    (shared by the frequency-domain filter and the mixer_mode-2 FIR)."""
    if edge_hz <= 0:
        edge_hz = max(20.0, 0.02 * (high_hz - low_hz))
    h = np.ones(freq.shape[0])
    h *= np.clip((freq - (low_hz - edge_hz)) / edge_hz, 0.0, 1.0)
    h *= np.clip(((high_hz + edge_hz) - freq) / edge_hz, 0.0, 1.0)
    h = np.sin(0.5 * np.pi * h) ** 2  # raised-cosine edge
    if compensate_fqwin:
        # undo the mix1 erfc frequency taper inside the passband
        # (baseb_graph.c:3795-3798); the compensation is bounded (40 dB)
        # and the filter is forced to zero beyond 90% of the mix1
        # selection — the outermost edge is unusable (fqwin -> 0 there,
        # and boosting it amplifies the overlap-add error floor at the
        # frame-rate harmonics).
        from .mix1 import fqwin_weight
        rel_frac = np.abs(freq) / geo.timf3_sampling_speed  # 0..0.5
        fq = fqwin_weight(rel_frac * geo.mix1_size, geo.mix1_size)
        h = h / np.maximum(fq, 1e-2)
        h *= rel_frac < 0.45
    for nf, nw in notches or ():
        # user notch filters (the bg notch controls, baseb_graph.c):
        # raised-cosine rejection of width nw centred at nf
        d = np.abs(freq - nf)
        h *= np.where(d < nw, np.sin(0.5 * np.pi
                                     * np.clip(d / max(nw, 1e-9), 0, 1)
                                     ) ** 2, 1.0)
    if shape:
        pts = sorted((float(f), float(g)) for f, g in shape)
        fz = np.array([f for f, _ in pts])
        gz = np.array([g for _, g in pts])
        gain_db = np.interp(freq, fz, gz)
        h *= 10.0 ** (gain_db / 20.0)
    return h.astype(np.float32)


def bg_filter(geo: Geometry, low_hz: float, high_hz: float,
              edge_hz: float = 0.0, compensate_fqwin: bool = True,
              notches: tuple = (), shape: tuple = ()) -> np.ndarray:
    """Baseband filter in shifted mix2-bin order (the make_bg_filter
    analog, reference baseb_graph.c:1246).

    Passband [low_hz, high_hz] (relative to the tuned frequency, negative
    = below carrier) with raised-cosine edges of width edge_hz, times the
    1/mix1_fqwin passband compensation.

    shape: the user-drawn filter curve (the reference's freehand
    bg_filterfunc drawn with the mouse on the baseband graph) as
    ((freq_hz, gain_db), ...) breakpoints, interpolated linearly in dB
    across the passband and flat beyond the outermost points."""
    m2 = geo.mix2_size
    n3 = geo.fft3_size
    fs3 = geo.timf3_sampling_speed
    rel = np.where(np.arange(m2) < m2 // 2, np.arange(m2),
                   np.arange(m2) - m2)
    freq = rel * fs3 / n3
    return _filter_response(freq, geo, low_hz, high_hz, edge_hz,
                            compensate_fqwin, notches, shape)


def basebraw_fir(geo: Geometry, p: RxParams,
                 threshold: float = 1e-8) -> np.ndarray:
    """Complex FIR taps for the mixer_mode-2 time-domain path.

    The reference (baseb_graph.c:1540-1607) inverse-transforms the
    baseband filter function, applies the fft3 window, symmetrises, and
    truncates where taps fall below 1e-8 of the centre tap.  Here the
    taps stay complex so an asymmetric passband (e.g. SSB) is realised
    exactly instead of through the reference's real-symmetrised
    approximation; linear phase is preserved.

    Returned taps g[k] are applied as a correlation over a window of
    ``len(g)`` timf3 samples centred on each output point.
    """
    n3 = geo.fft3_size
    fs3 = geo.timf3_sampling_speed
    rel = np.where(np.arange(n3) < n3 // 2, np.arange(n3),
                   np.arange(n3) - n3)
    freq = rel * fs3 / n3
    resp = _filter_response(freq, geo, p.filter_low_hz, p.filter_high_hz,
                            notches=p.notches, shape=p.filter_shape)
    # zero outside the decimated band (mix2 selection = baseband Nyquist)
    resp = resp * (np.abs(freq) < 0.5 * geo.baseband_sampling_speed)
    # correlation taps: g[k'] = (1/N) sum_b H[b] e^{-2pi i b k'/N}
    g = np.fft.ifft(resp.astype(np.complex128))
    kprime = np.arange(n3) - n3 // 2          # centred tap index
    taps = g[(-kprime) % n3]
    # fft3 window applied over the full span before truncation
    # (baseb_graph.c:1578-1583); ~1 near the centre where taps live
    taps = taps * np.sin(np.pi * (np.arange(n3) + 0.5) / n3) ** 2
    mag = np.abs(taps)
    keep = np.nonzero(mag > threshold * mag.max())[0]
    half = max(abs(int(keep[0]) - n3 // 2), abs(int(keep[-1]) - n3 // 2))
    half = min(half, n3 // 2 - 1)
    return taps[n3 // 2 - half:n3 // 2 + half + 1].astype(np.complex64)


@pytree_dataclass(frozen=True)
class Mix2Tables:
    filt: jax.Array       # (mix2_size,) float32 main filter
    carr_filt: jax.Array  # (mix2_size,) float32 narrow carrier filter
    syn: jax.Array        # (mix2_size,) float32 OLA synthesis weights
    fir: jax.Array | None = None  # mixer_mode-2 complex taps

    @classmethod
    def create(cls, geo: Geometry, p: RxParams,
               coh_factor: float = 8.0) -> "Mix2Tables":
        filt = bg_filter(geo, p.filter_low_hz, p.filter_high_hz,
                         notches=p.notches, shape=p.filter_shape)
        # carrier filter: bg.coh_factor x narrower, centred on the BFO
        # (mix2.c:246-262)
        width = (p.filter_high_hz - p.filter_low_hz) / (2.0 * coh_factor)
        carr = bg_filter(geo, -width, width)
        m2 = geo.mix2_size
        interleave = m2 - geo.mix2_new_points
        syn = synthesis_weights(m2, interleave, geo.fft3_sinpow)
        from ..utils.xfer import device_complex
        fir = (device_complex(basebraw_fir(geo, p))
               if getattr(p, "mixer_mode", 1) == 2 else None)
        return cls(filt=jnp.asarray(filt), carr_filt=jnp.asarray(carr),
                   syn=jnp.asarray(syn, jnp.float32), fir=fir)


@pytree_dataclass
class Mix2State:
    ola_carry: jax.Array       # (mix2_interleave, C) complex64
    carr_ola_carry: jax.Array  # same for the carrier branch

    @classmethod
    def create(cls, geo: Geometry) -> "Mix2State":
        # two independent buffers (a shared array breaks donation)
        ov = geo.mix2_size - geo.mix2_new_points
        from .cplx import czeros
        return cls(ola_carry=czeros((ov, geo.channels)),
                   carr_ola_carry=czeros((ov, geo.channels),
                                            jnp.complex64))


def _branch(geo: Geometry, spectra, filt, syn, carry):
    m2 = geo.mix2_size
    n3 = geo.fft3_size
    rel = jnp.where(jnp.arange(m2) < m2 // 2, jnp.arange(m2),
                    jnp.arange(m2) - m2)
    bins = jnp.mod(rel, n3)
    from .cplx import cgather
    sel = cgather(spectra, (slice(None), bins, slice(None))) \
        * filt[None, :, None]
    y = jnp.fft.ifft(sel, axis=1) * (m2 / n3)
    frames = y * syn[None, :, None]
    return overlap_add(frames, geo.mix2_new_points, carry)


def mix2_step(geo: Geometry, tables: Mix2Tables, state: Mix2State,
              spectra: jax.Array, with_carrier: bool = False
              ) -> tuple[Mix2State, jax.Array, jax.Array | None]:
    """fft3 spectra (n3, fft3_size, C) -> filtered baseband stream.

    Returns (new_state, baseb, carrier) with baseb shape
    (n3 * mix2_new_points, C) complex64 at baseband_sampling_speed;
    carrier is the narrow carrier-filter branch (or None).
    """
    baseb, carry = _branch(geo, spectra, tables.filt, tables.syn,
                           state.ola_carry)
    carrier = None
    carr_carry = state.carr_ola_carry
    if with_carrier:
        carrier, carr_carry = _branch(geo, spectra, tables.carr_filt,
                                      tables.syn, state.carr_ola_carry)
    return (Mix2State(ola_carry=carry, carr_ola_carry=carr_carry),
            baseb, carrier)


def mix2_carrier_step(geo: Geometry, tables: Mix2Tables, state: Mix2State,
                      spectra: jax.Array
                      ) -> tuple[Mix2State, jax.Array]:
    """Carrier branch only (used with the mixer_mode-2 main path — the
    reference builds carr_tmp from fft3 in both mixer modes,
    mix2.c:246-262)."""
    carrier, carr_carry = _branch(geo, spectra, tables.carr_filt,
                                  tables.syn, state.carr_ola_carry)
    return (Mix2State(ola_carry=state.ola_carry,
                      carr_ola_carry=carr_carry), carrier)


@pytree_dataclass
class Mix2FirState:
    carry: jax.Array  # (fir_len - 1, C) complex64 timf3 history

    @classmethod
    def create(cls, geo: Geometry, fir_len: int) -> "Mix2FirState":
        return cls(carry=jnp.zeros((fir_len - 1, geo.channels),
                                   jnp.complex64))


def mix2_fir_step(geo: Geometry, fir: jax.Array, state: Mix2FirState,
                  timf3: jax.Array) -> tuple[Mix2FirState, jax.Array]:
    """mixer_mode 2: decimating FIR straight on the timf3 stream
    (reference mix2.c:217-245).

    Output m correlates ``len(fir)`` timf3 samples starting at
    ``m * resamp`` against the taps; the stride ``resamp =
    fft3_size / mix2_size`` resamples timf3 to the baseband rate
    exactly as the frequency-domain path does.  The windowed gather +
    matvec form keeps shapes static: one (M, K) @ (K,) contraction
    per step.
    """
    k = fir.shape[0]
    resamp = geo.fft3_size // geo.mix2_size
    xs = jnp.concatenate([state.carry, timf3], axis=0)
    m = timf3.shape[0] // resamp
    idx = np.arange(m)[:, None] * resamp + np.arange(k)[None, :]
    from .cplx import cgather
    baseb = jnp.einsum("mkc,k->mc", cgather(xs, idx), fir,
                       precision=jax.lax.Precision.HIGHEST)
    return (Mix2FirState(carry=xs[xs.shape[0] - (k - 1):]),
            baseb.astype(jnp.complex64))
