"""Spur cancellation — coherent subtraction of stable narrow carriers.

JAX re-design of the reference spur canceller
(``eliminate_spurs`` spur.c:36, ``init_spur_elimination`` spursub.c:177,
``spur_removal`` wcw.c:204-248).  The reference models each spur over
SPUR_SIZE=8 consecutive transforms with amplitude/phase/slope/curvature
(globdef.h:173-175) and subtracts the smooth model from fft1/fft2.

Here each spur is a matched-filter estimate against the analysis-window
spectrum template around its bin, with an exponentially-smoothed complex
amplitude and a tracked per-frame phase rotation (the discrete analog of
the reference's phase slope): only components whose phase progresses
coherently build up a prediction, so noise and keyed signals are not
subtracted.  Estimation+subtraction runs on device as a ``lax.scan``
over the frame batch (cheap: max_spurs * (2w+1) bins per frame); the
spur *list* (find/drop/re-centre) is host-side control logic at ~Hz
(the auto-search of spur.c).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass
from ..ops.windows import make_window
from ..ops.cplx import czeros as _czeros, cfull as _cfull

MAX_SPURS = 16      # MAX_NO_OF_SPURS analog (static shape)
TEMPLATE_HALF = 3   # bins each side of the spur centre

# amplitude-smoothing window over frames (spur_speknum analog) and its
# shape: "sg" — quadratic Savitzky-Golay, i.e. a LOCAL LEAST-SQUARES
# fit exactly like the reference's 11-transform LLSQ window
# (spur.c:517-578); unbiased for quadratically-varying envelopes, which
# is what a drifting carrier's template-scaled amplitude looks like.
# "flat"/"hann" kept for experiments (measured 2026-08-21: sg 45.5 dB
# static / 39.9 dB at 2 Hz/s vs flat 45.0/36.7).
SMOOTH_LEN = 11
SMOOTH_KIND = "sg"


def _smooth_kernel(k: int) -> np.ndarray:
    if SMOOTH_KIND == "flat" or k < 3:
        # a quadratic LLSQ needs >= 3 points (the Vandermonde normal
        # matrix is singular below that, e.g. 1-2 fftx frames/step);
        # the flat kernel is the k<3 least-squares fit anyway
        return np.full(k, 1.0 / k)
    if SMOOTH_KIND == "sg":
        x = np.arange(k) - k // 2
        a = np.vander(x, 3, increasing=True)       # [1, x, x^2]
        return (a @ np.linalg.inv(a.T @ a))[:, 0][::-1].copy()
    return np.hanning(k + 2)[1:-1]


TEMPLATE_OS = 64    # fractional-bin oversampling of the template


def window_template(size: int, sinpow: int) -> np.ndarray:
    """Analysis-window spectrum around DC — the shape a pure carrier
    takes in the fftx spectrum (normalised to unit centre)."""
    w = make_window(size, sinpow)
    spec = np.fft.fft(w)
    idx = np.arange(-TEMPLATE_HALF, TEMPLATE_HALF + 1)
    t = spec[idx % size]
    return (t / spec[0]).astype(np.complex64)


def window_template_table(size: int, sinpow: int,
                          os: int = TEMPLATE_OS) -> np.ndarray:
    """Oversampled analysis-window spectrum: the shape a carrier at ANY
    fractional bin offset takes across the surrounding bins — our form
    of the reference's NO_OF_SPUR_SPECTRA=256 fractional template bank
    (init_spur_spectra spursub.c:824, indexed by
    ``NO_OF_SPUR_SPECTRA*(freq-int(freq))`` in eliminate_spurs
    spur.c:177).  A single integer-bin template leaves a ~-10 dB
    mismatch floor for mid-bin spurs; the fractional template removes
    it.

    Returns (2*(TEMPLATE_HALF+1)*os+1,) complex64: the window DTFT
    sampled every 1/os bin over offsets [-(H+1), +(H+1)] from the
    carrier, normalised so the on-bin centre is 1."""
    w = np.zeros(size * os, np.float64)
    w[:size] = make_window(size, sinpow)
    spec = np.fft.fft(w)
    h1 = TEMPLATE_HALF + 1
    idx = np.arange(-h1 * os, h1 * os + 1)
    t = spec[idx % (size * os)]
    return (t / spec[0]).astype(np.complex64)


@pytree_dataclass
class SpurState:
    bins: jax.Array     # (MAX_SPURS,) int32 — centre bin, -1 = inactive
    amp: jax.Array      # (MAX_SPURS, C) complex64 — smoothed amplitude
    rot: jax.Array      # (MAX_SPURS,) complex64 — per-frame phase step
    frac: jax.Array     # (MAX_SPURS,) float32 — fractional bin offset

    @classmethod
    def create(cls, geo: Geometry) -> "SpurState":
        return cls(
            bins=jnp.full((MAX_SPURS,), -1, jnp.int32),
            amp=_czeros((MAX_SPURS, geo.channels)),
            rot=_cfull((MAX_SPURS,), 1.0),
            frac=jnp.zeros((MAX_SPURS,), jnp.float32),
        )


def spur_subtract_step(geo: Geometry, template: jax.Array,
                       state: SpurState, spectra: jax.Array,
                       gamma: float = 0.25, frac_gamma: float = 0.25,
                       refine_iters: int = 3
                       ) -> tuple[SpurState, jax.Array]:
    """Estimate + subtract all active spurs from a step of spectra.

    template: the OVERSAMPLED window-spectrum table
    (:func:`window_template_table`) — each spur's per-bin template is
    looked up at its tracked fractional offset, so mid-bin spurs
    subtract as deeply as on-bin ones (the reference's fractional
    spur_spectra bank, spur.c:177).  The fractional offset itself is
    steered by the tracked per-frame rotation: a frequency offset of
    ``d`` bins advances the frame-to-frame phase by ``2*pi*d*hop/N``
    (the PLL phase-slope of refine_pll_parameters, spur.c:263).

    spectra: (n, N, C) complex64.  Returns (state, cleaned spectra).

    Vectorized per-step model — the refine_pll_parameters analog
    (spur.c:263) without a sequential frame scan: matched-filter
    estimates for ALL frames at once, a measured common per-hop
    rotation, and a CENTERED smoothing of the detrended amplitude (the
    reference's spur_speknum=11-transform least-squares window; a
    causal EMA trails it by ~3 dB of subtraction depth)."""
    n_frames, big_n, c = spectra.shape
    th = TEMPLATE_HALF
    offs = jnp.arange(-th, th + 1)
    active = (state.bins >= 0)                                 # (S,)
    idx = jnp.mod(jnp.where(state.bins < 0, 0, state.bins)[:, None]
                  + offs[None, :], big_n)                      # (S, tlen)
    hop = geo.fftx_new_points
    # phase advance per hop <-> fractional bins; unambiguous while
    # |frac| < big_n/(2*hop)
    bins_per_rad = big_n / (2.0 * np.pi * hop)
    # the tracked rotation carries the TOTAL per-hop advance
    # 2*pi*(b+frac)*hop/N; remove the integer-bin base rotation (for
    # half-overlap this is the odd/even-bin sign the reference flips
    # with (j^(spur_location&1)), spur.c:247) before reading frac
    base_idx = jnp.mod(jnp.where(state.bins < 0, 0, state.bins)
                       * hop, big_n).astype(jnp.float32)
    base_rot = jnp.exp(1j * (2.0 * np.pi / big_n) * base_idx)
    os = TEMPLATE_OS
    centre = (th + 1) * os

    from ..ops.cplx import cadd, cgather

    def templ(frac):
        """fractional templates: frac (..., S) -> (..., S, tlen)."""
        pos = (offs - frac[..., None]) * os + centre
        i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0,
                      template.shape[0] - 2)
        w = pos - i0
        return (cgather(template, i0) * (1.0 - w)
                + cgather(template, i0 + 1) * w)

    def matched(t, sel):
        """t (..., S, tlen), sel (n, S, tlen, C) -> estimates (n, S, C)."""
        tnorm = jnp.maximum(jnp.sum(jnp.abs(t) ** 2, axis=-1), 1e-20)
        if t.ndim == 2:
            t = t[None]
            tnorm = tnorm[None]
        return jnp.sum(sel * jnp.conj(t)[:, :, :, None],
                       axis=2) / tnorm[:, :, None]

    sel = cgather(spectra,
                  (slice(None), idx, slice(None)))  # (n, S, tlen, C)
    # first pass: step-start template, for the rotation/curvature fit
    est = matched(templ(state.frac), sel)         # (n, S, C)

    # measured per-frame advances (power-weighted), relative to the
    # tracked rotation so angles stay small and unwrapped
    advf = jnp.sum(est[1:] * jnp.conj(est[:-1]), axis=2)  # (n-1, S)
    adv = jnp.sum(advf, axis=0)                            # (S,)
    meas = jnp.where(jnp.abs(adv) > 1e-20,
                     adv / jnp.maximum(jnp.abs(adv), 1e-20), 1.0)
    # the step-long measurement averages n_frames advances, so the
    # blend gain scales with the step (one long step ~ convergence)
    g = jnp.float32(min(1.0, gamma * n_frames))
    blend = state.rot + g * (meas - state.rot)
    rot = jnp.where(active, blend / jnp.maximum(jnp.abs(blend), 1e-20),
                    state.rot)

    # second-order term: weighted linear fit of the advance residuals
    # vs frame index — the reference's phase curvature spur_d2pha
    # (refine_pll_parameters spur.c:263): a drifting spur advances its
    # per-hop phase linearly and a constant-rotation model smears it
    dang = jnp.angle(advf * jnp.conj(rot)[None, :])        # (n-1, S)
    wgt = jnp.abs(advf)                                    # (n-1, S)
    f_mid = jnp.arange(n_frames - 1, dtype=jnp.float32)[:, None]
    w0 = jnp.maximum(jnp.sum(wgt, axis=0), 1e-20)
    fbar = jnp.sum(wgt * f_mid, axis=0) / w0
    dbar = jnp.sum(wgt * dang, axis=0) / w0
    varf = jnp.maximum(
        jnp.sum(wgt * (f_mid - fbar[None, :]) ** 2, axis=0), 1e-20)
    curv = jnp.sum(wgt * (f_mid - fbar[None, :])
                   * (dang - dbar[None, :]), axis=0) / varf  # rad/hop^2
    curv = jnp.where(active, curv, 0.0)

    # detrend with the quadratic phase model, smooth (centered),
    # re-trend
    a0 = jnp.angle(rot) + dbar - curv * fbar     # advance at frame 0
    fidx = jnp.arange(n_frames, dtype=jnp.float32)[:, None]
    theta = a0[None, :] * fidx + 0.5 * curv[None, :] * fidx ** 2
    ph = jnp.exp(1j * theta)                             # (n, S)
    # carry the END-of-step advance so the next step (and the frac
    # tracker) see the current frequency, not the step average
    rot = jnp.where(active,
                    jnp.exp(1j * (a0 + curv * (n_frames - 1))), rot)
    # second pass: per-frame fractional templates following the fitted
    # slope — a drifting spur moves ~0.1 bin inside one step and a
    # fixed template leaves a matching-loss floor (the reference
    # re-indexes spur_spectra EVERY transform from its PLL frequency,
    # spur.c:177/296)
    slope_bins = jnp.where(active, curv * bins_per_rad, 0.0)   # (S,)
    frac_f = state.frac[None, :] + slope_bins[None, :] * fidx  # (n, S)
    t = templ(frac_f)                              # (n, S, tlen)
    k = min(SMOOTH_LEN, n_frames)           # spur_speknum window
    if k % 2 == 0:
        k -= 1
    kern = jnp.asarray(_smooth_kernel(k), jnp.float32)
    norm = jnp.convolve(jnp.ones(n_frames), kern, mode="same")

    def smooth(x):                                       # (n,) complex
        return jnp.convolve(x, kern.astype(x.dtype), mode="same") / norm

    smooth_all = jax.vmap(jax.vmap(smooth, in_axes=1, out_axes=1),
                          in_axes=2, out_axes=2)
    # iterated refinement against the post-subtraction residual (the
    # reference re-invokes refine_pll_parameters on the residual,
    # spur.c:371/383): the centered smoothing under-subtracts any part
    # of the carrier whose phase the quadratic model missed, and each
    # re-estimate of the residual through the same matched filter
    # recovers the projection the previous pass left behind —
    # converging to the least-squares fit the reference's iterated LLSQ
    # computes.  Static unroll; each pass is one matched filter + one
    # smoothing + one scatter-add (cheap vs the chain).
    dsm_tot = jnp.zeros_like(est)                        # (n, S, C)
    cleaned = spectra
    for _ in range(max(1, refine_iters)):
        d = matched(t, cgather(cleaned,
                               (slice(None), idx, slice(None)))) \
            * jnp.conj(ph)[:, :, None]                   # (n, S, C)
        dsm = smooth_all(d)
        dsm_tot = dsm_tot + dsm
        pred = dsm * ph[:, :, None]                      # (n, S, C)
        sub = jnp.where(active[None, :, None, None],
                        pred[:, :, None, :] * t[:, :, :, None], 0.0)
        cleaned = cadd(cleaned, (slice(None), idx, slice(None)), -sub)

    # state for the next step / the manager.  NB positive static
    # indices: jnp's x[-1] lowers to a (complex) dynamic_slice, which
    # this backend cannot execute (test_no_complex_gather.py)
    amp = jnp.where(active[:, None],
                    dsm_tot[n_frames - 1] * ph[n_frames - 1][:, None],
                    state.amp)
    frac_target = jnp.angle(rot * jnp.conj(base_rot)) * bins_per_rad
    frac = jnp.where(active,
                     state.frac
                     + jnp.float32(min(1.0, n_frames * frac_gamma))
                     * (frac_target - state.frac),
                     state.frac)
    return SpurState(bins=state.bins, amp=amp, rot=rot, frac=frac), \
        cleaned


@dataclass
class SpurManager:
    """Host-side spur list control (the auto-search of spur.c).

    Finds persistent narrow peaks in the long-term averaged spectrum
    (outside the protected passband), assigns them to state slots and
    re-centres drifted spurs."""

    geo: Geometry
    ston: float = 25.0          # power ratio over median to call a spur
    drop_after: int = 8         # scans of grace before fade checks
    _slots: dict = field(default_factory=dict)   # slot -> bin
    _age: dict = field(default_factory=dict)     # slot -> scans held

    def scan(self, avg_power: np.ndarray, state: SpurState,
             protect_lo: int = -1, protect_hi: int = -1) -> SpurState:
        p = np.asarray(avg_power, np.float64)
        n = len(p)
        med = np.median(p)
        bins = np.asarray(state.bins).copy()
        amp = np.asarray(state.amp).copy()
        rot = np.asarray(state.rot).copy()
        frac = np.asarray(state.frac).copy()
        taken = set(int(b) for b in bins if b >= 0)
        # drop spurs whose TRACKED amplitude faded (avg_power is
        # post-subtraction, as the reference's waterfall is after
        # eliminate_spurs — a well-cancelled spur leaves no power at
        # its bin, so the device-side model amplitude is the evidence
        # of life, like spur_ampl vs spur_minston*spur_noise spur.c:372)
        for s in range(MAX_SPURS):
            b = int(bins[s])
            if b < 0:
                self._age.pop(s, None)
                continue
            self._age[s] = self._age.get(s, 0) + 1
            tracked = float(np.sum(np.abs(amp[s]) ** 2))
            if self._age[s] > self.drop_after and tracked < 3.0 * med:
                bins[s] = -1
                amp[s] = 0
                rot[s] = 1
                frac[s] = 0
                taken.discard(b)
                self._age.pop(s, None)
                continue
            # re-centre a drifted spur: once the tracked fractional
            # offset leaves the centre cell, move the integer bin and
            # keep the model phase-consistent (shift_spur_table
            # spur.c:70-76 + spursub.c:1070)
            shift = int(np.round(frac[s]))
            if shift != 0:
                # rot tracks the PHYSICAL per-hop advance and is
                # unaffected by relabelling the centre bin; frac is
                # measured against the new bin's base rotation
                bins[s] = (b + shift) % n
                frac[s] -= shift
                taken.discard(b)
                taken.add(int(bins[s]))
        # find candidates: local maxima well above the floor, narrow
        cand = np.argsort(p)[::-1][:64]
        for b in cand:
            b = int(b)
            if p[b] < self.ston * med:
                break
            if protect_lo <= b <= protect_hi:
                continue
            if any(abs(b - t) <= 2 * TEMPLATE_HALF or
                   abs(b - t) >= n - 2 * TEMPLATE_HALF for t in taken):
                continue
            free = np.where(bins < 0)[0]
            if len(free) == 0:
                break
            s = int(free[0])
            bins[s] = b
            amp[s] = 0
            rot[s] = 1
            frac[s] = 0
            self._age[s] = 0
            taken.add(b)
        return SpurState(bins=jnp.asarray(bins),
                         amp=jnp.asarray(amp), rot=jnp.asarray(rot),
                         frac=jnp.asarray(frac))
