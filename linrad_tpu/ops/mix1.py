"""First mixer / decimator — frequency-domain downconversion.

JAX ``do_mix1`` (reference mix1.c:55-647): instead of a time-domain
NCO multiply, a group of ``mix1.size`` bins around the tuned bin is taken
from each fftx transform (fft1 or fft2 stream), weighted by the
frequency-domain window ``mix1_fqwin`` (sin^4 taper built by
make_window(5, mix1.size, 4), reference buf.c:1297 — equivalently
cos^4(pi*rel/M) over bin offset rel), inverse transformed at 1/decimation
size, and overlap-added phase-continuously into the ``timf3`` baseband
stream.

Phase continuity (the reference carries float phase accumulators
mix1_phase/mix1_phase_rot, mix1.c:141-234 and set_mix1_phases
mix1.c:781): here the per-frame rotation is exp(-2*pi*i*c*H/N) per hop of
H samples for centre bin c — tracked as an *integer* phase index
(c*H mod N) so there is zero drift, and tuning (c) is a traced value so
retuning never recompiles.  The AFC-driven variant (do_mix1_afc
mix1.c:648) is the same code with a per-frame array of centre bins.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass
from .cplx import czeros
from .framing import overlap_add
from .windows import synthesis_weights


def fqwin_weight(bin_offset: np.ndarray, mix1_size: int) -> np.ndarray:
    """mix1_fqwin weight at (possibly fractional) bin offset from the
    band centre — the erfc taper of make_window mode 5 (fft0.c:818-829,
    built at buf.c:1297) as applied by do_mix1 (mix1.c:117-134):
    win[M/2 - max(|d|, 1)]."""
    from scipy.special import erfc
    m = mix1_size
    d = np.abs(bin_offset)
    return 0.5 * erfc(3.2 - 13.0 * (m // 2 - np.maximum(d, 1.0)) / m)


@pytree_dataclass(frozen=True)
class Mix1Tables:
    fqwin: jax.Array      # (M,) float32, FFT-shifted order (index = small-FFT bin)
    syn: jax.Array        # (M,) float32 overlap-add synthesis weights

    @classmethod
    def create(cls, geo: Geometry) -> "Mix1Tables":
        m = geo.mix1_size
        rel = np.where(np.arange(m) < m // 2, np.arange(m),
                       np.arange(m) - m)
        # mix1_fqwin: the erfc taper of the reference (see fqwin_weight)
        # — ~1 at the band centre, -110 dB at the band edges.  Verified
        # sample-exact against the compiled reference chain in
        # tests/test_ref_parity.py.
        fqwin = fqwin_weight(rel, m)
        sinpow = geo.fft2_sinpow if geo.second_fft_enable else geo.fft1_sinpow
        syn = synthesis_weights(m, geo.mix1_interleave_points, sinpow)
        return cls(fqwin=jnp.asarray(fqwin, jnp.float32),
                   syn=jnp.asarray(syn, jnp.float32))


@pytree_dataclass
class Mix1State:
    phase_idx: jax.Array   # () int32 — phase accumulator in units of 1/N turn
    ola_carry: jax.Array   # (mix1_interleave, C) complex64
    frac_phase: jax.Array  # () float32 — fractional-tune phase, turns

    @classmethod
    def create(cls, geo: Geometry) -> "Mix1State":
        return cls(
            phase_idx=jnp.zeros((), jnp.int32),
            ola_carry=czeros((geo.mix1_interleave_points,
                              geo.channels)),
            frac_phase=jnp.zeros((), jnp.float32),
        )


def mix1_step(geo: Geometry, tables: Mix1Tables, state: Mix1State,
              spectra: jax.Array, center_bins: jax.Array,
              tune_frac: jax.Array | None = None,
              tune_slope: jax.Array | None = None
              ) -> tuple[Mix1State, jax.Array]:
    """Downconvert one step of fftx spectra to the timf3 baseband stream.

    spectra:     (n, N, C) complex64 fftx transforms at hop H samples
    center_bins: () or (n,) int32 tuned bin(s); a per-frame array is the
                 AFC path (mix1.c:648), a scalar the fixed path (:995).
    tune_frac:   optional () or (n,) float32 fractional bin offset in
                 (-0.5, 0.5] — the reference's per-sample phase ramp
                 ``mix1_phase_rot = frac*2*pi/mix1.size`` (set_mix1_phases
                 mix1.c:781-860) that places ANY dial frequency exactly
                 at DC, not just bin centres.  Traced: retuning never
                 recompiles.  The phase accumulator carries in turns
                 (float32 wrap, same drift class as the reference's
                 float accumulators).
    tune_slope:  optional () or (n,) float32 — frequency CHANGE across
                 each frame, in big-FFT bins per hop.  When tracking a
                 drifting signal with per-frame fracs alone, the mixed
                 output carries a sawtooth FM of one hop's drift; this
                 linearises the per-sample frequency within each frame
                 (our design for the reference's intra-transform chirp,
                 ``phrot_step`` do_mix1 mix1.c:103-106/158-234 — which
                 its own comments call empirically timed, mix1.c:756).
                 Typically ``slope[b] = frac_next[b] - frac[b]`` plus
                 any integer-bin change, so the instantaneous frequency
                 is continuous across frames.  Requires ``tune_frac``.

    Returns (new_state, timf3) with timf3 (n * mix1_new_points, C)
    complex64 at timf3_sampling_speed, amplitude-true (the analysis
    window and 1/N scaling are removed by the synthesis weights).
    """
    if tune_slope is not None and tune_frac is None:
        raise ValueError("tune_slope requires tune_frac (the slope "
                         "linearises the fractional-bin ramp)")
    n, big_n, _c = spectra.shape
    m = geo.mix1_size
    hop = geo.fftx_new_points
    center_bins = jnp.broadcast_to(jnp.asarray(center_bins, jnp.int32), (n,))

    rel = jnp.where(jnp.arange(m) < m // 2, jnp.arange(m),
                    jnp.arange(m) - m)
    bins = jnp.mod(center_bins[:, None] + rel[None, :], big_n)  # (n, M)
    from .cplx import ctake_along_axis
    sel = ctake_along_axis(spectra, bins[:, :, None], axis=1)  # (n,M,C)
    sel = sel * tables.fqwin[None, :, None]

    y = jnp.fft.ifft(sel, axis=1) * (m / big_n)

    # Integer phase bookkeeping: frame b needs exp(-2*pi*i*phi_b/N) with
    # phi advancing by c_b*H (mod N) per frame.  N is a power of two, so
    # uint32 wraparound multiplication/addition is *exact* mod N (N | 2^32)
    # — zero drift at any transform size, unlike the reference's float
    # accumulators (mix1.c:141-234).
    mask = jnp.uint32(big_n - 1)
    incr = (center_bins.astype(jnp.uint32) * jnp.uint32(hop)) & mask
    cum = jnp.cumsum(incr) - incr  # exclusive prefix (wrapping uint32)
    idx = (state.phase_idx.astype(jnp.uint32) + cum) & mask
    theta = (-2.0 * jnp.pi / big_n) * idx.astype(jnp.float32)
    rot = jax.lax.complex(jnp.cos(theta), jnp.sin(theta))
    y = y * rot[:, None, None]
    new_phase = ((state.phase_idx.astype(jnp.uint32) + jnp.sum(incr))
                 & mask).astype(jnp.int32)

    frames = y * tables.syn[None, :, None]
    timf3, carry = overlap_add(frames, geo.mix1_new_points, state.ola_carry)
    new_frac = state.frac_phase
    if tune_frac is not None:
        ramp, new_frac = frac_ramp(geo, state.frac_phase, tune_frac,
                                   tune_slope, n)
        timf3 = timf3 * ramp[:, None]
    return Mix1State(phase_idx=new_phase, ola_carry=carry,
                     frac_phase=new_frac), timf3


def frac_ramp(geo: Geometry, frac_phase: jax.Array, tune_frac: jax.Array,
              tune_slope: jax.Array | None, n: int
              ) -> tuple[jax.Array, jax.Array]:
    """Residual-frequency ramp on the timf3 OUTPUT stream: frac big-FFT
    bins == frac/m turns per timf3 sample (the OLA'd overlapping
    contributions share each output sample's phase, as in the
    reference's per-point multiply, mix1.c:141-234).  With tune_slope
    the frequency is linearised within each frame: frac is the value at
    the frame MIDPOINT, slope the change per hop.

    Returns (complex64 ramp of length n*mix1_new_points, final phase in
    turns)."""
    m = geo.mix1_size
    hop_m = geo.mix1_new_points
    fr = jnp.broadcast_to(jnp.asarray(tune_frac, jnp.float32), (n,))
    per_samp = jnp.repeat(fr / m, hop_m, total_repeat_length=n * hop_m)
    if tune_slope is not None:
        sl = jnp.broadcast_to(jnp.asarray(tune_slope, jnp.float32),
                              (n,))
        pos = (jnp.arange(hop_m, dtype=jnp.float32) + 0.5) / hop_m \
            - 0.5                                     # (-0.5, 0.5)
        per_samp = per_samp + jnp.repeat(
            sl / m, hop_m, total_repeat_length=n * hop_m) \
            * jnp.tile(pos, n)
    cum = frac_phase + jnp.cumsum(per_samp) - per_samp
    theta = (-2.0 * jnp.pi) * jnp.mod(cum, 1.0)
    ramp = jax.lax.complex(jnp.cos(theta), jnp.sin(theta))
    return ramp, jnp.mod(frac_phase + jnp.sum(per_samp), 1.0)
