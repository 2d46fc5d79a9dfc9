"""Noise blankers — the "smart" fit-and-subtract and "stupid" clear
blankers on the weak timf2 channel.

JAX ``first_noise_blanker`` (reference blank1.c:684-1603):

Clever blanker (``subtract_onechan_pulse`` blank1.c:36-232): find the
strongest candidate above threshold, derotate a window around it by the
system phase function, take the power-weighted average phase of the 3
centre points, reject if quadrature power > 0.25 x in-phase power
(blank1.c:121), localise the pulse to sub-sample precision with a
parabolic fit ``t4=(a[-1]-a[+1])/(2*(a[-1]+a[+1]-2*a[0]))`` then
``frac = sign * sqrt(0.5*|t4|)`` (blank1.c:126-137), pick the matching
reference pulse from a bank of fractionally-shifted system responses
(built like init_blanker, buf.c:1771-2104), subtract it, and undo if the
residual power exceeds half the original (blank1.c:188-231).

The reference walks the ring buffer sequentially; here the search is a
global argmax and the sequential dependence (each subtraction changes
the data under later fits — unavoidable, the pulses overlap) is a
bounded ``lax.fori_loop`` of masked steps, per SURVEY.md §7.

Stupid blanker (blank1.c:1013-1083): hard-zero every point above the
threshold, then widen each cleared run by
``(pulsewidth+1)/2 * sqrt(peak/noise)/100`` points before and
``(pulsewidth+1) * sqrt(peak/noise)/100`` after (ratio capped at 10^4),
only when peak/noise > 4.  Vectorised as segmented run maxima plus
prefix/suffix reach scans — no sequential pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .cplx import (cdynamic_slice, cdynamic_update_slice, cgather,
                   cset)
import numpy as np

from ..geometry import Geometry
from ..utils.pytree import pytree_dataclass
from ..utils.segments import segment_max

MAX_REFPULSES = 256  # fractional-shift bank depth (blnkdef.h:13); the
                     # worst-case residual after subtracting a pulse at
                     # the least-favourable inter-entry offset is
                     # measured in tests/test_wideband.py
                     # (test_refpulse_bank_subsample_error): -45.6 dB
                     # at 256 entries (~-34 dB at the old 64)


def make_refpulse_bank(freq_response: np.ndarray, pul_size: int,
                       n_pulses: int = MAX_REFPULSES
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """Build the fractionally-shifted reference pulse bank.

    freq_response: (N,) complex — the system response an impulse sees
    (fft1_desired analog; flat == band-limited Dirichlet pulses).

    Returns (bank (n_pulses, pul_size) complex64,
             phasefunc (pul_size,) complex64,
             pulsewidth int) — pulsewidth is the -15 dB half width
    (buf.c:1852-1855, min 2)."""
    n = len(freq_response)
    k = np.fft.fftfreq(n) * n  # signed bin numbers
    half = pul_size // 2
    fracs = np.arange(n_pulses) / n_pulses - 0.5
    bank = np.zeros((n_pulses, pul_size), np.complex128)
    for j, d in enumerate(fracs):
        ramp = np.exp(-2j * np.pi * k * d / n)
        pulse = np.fft.ifft(freq_response * ramp)
        rolled = np.roll(pulse, half)[:pul_size]
        peak = rolled[half]
        if abs(peak) < 1e-12:
            peak = 1.0
        bank[j] = rolled / peak
    # phase function from the unshifted response (blanker_phasefunc)
    p0 = np.roll(np.fft.ifft(freq_response), half)[:pul_size]
    mag = np.abs(p0)
    unit = np.where(mag > 1e-9 * mag.max(), p0 / np.maximum(mag, 1e-30),
                    1.0)
    phasefunc = np.conj(unit)
    # -15 dB pulse width (power > 0.033 of peak), minimum 2
    pw = 2
    ppow = np.abs(p0) ** 2
    while half + pw < pul_size and ppow[half + pw] > 0.033 * ppow[half]:
        pw += 1
    pw = min(pw, half - 2)
    return (bank.astype(np.complex64), phasefunc.astype(np.complex64),
            max(pw, 2))


@pytree_dataclass(frozen=True)
class BlankerTables:
    refbank: jax.Array    # (n_pulses, pul_size) complex64
    phasefunc: jax.Array  # (pul_size,) complex64

    @classmethod
    def create(cls, geo: Geometry,
               freq_response: np.ndarray | None = None,
               pul_size: int = 64) -> tuple["BlankerTables", int]:
        if freq_response is None:
            freq_response = np.ones(geo.fft1_size, np.complex128)
        bank, pf, pw = make_refpulse_bank(freq_response, pul_size)
        from ..utils.xfer import device_complex
        return (cls(refbank=device_complex(bank),
                    phasefunc=device_complex(pf)),
                pw)


@pytree_dataclass
class BlankerState:
    noise_floor: jax.Array  # () float32 — despiked weak power / point

    @classmethod
    def create(cls, geo: Geometry) -> "BlankerState":
        # start 23 dB above one-bit amplitude (buf.c:415-427)
        return cls(noise_floor=jnp.asarray(200.0, jnp.float32))


def clever_blanker(weak: jax.Array, pwr: jax.Array,
                   tables: BlankerTables, noise_floor: jax.Array,
                   limit_amp: float, pulsewidth: int, max_pulses: int,
                   block_size: int = 256, rounds: int = 0,
                   eligible: jax.Array | None = None
                   ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Fit-and-subtract up to ``max_pulses`` pulses from the weak stream.

    weak: (S, C) complex64; pwr: (S,) float32 channel-summed power.
    Returns (weak', pwr', fitted_count).

    The candidate search is hierarchical: block maxima of the candidate
    power are maintained incrementally, so each of the ``max_pulses``
    sequential iterations reads O(S/block_size + block_size) values
    instead of re-scanning all S — each subtraction only perturbs the
    two blocks around the pulse.  (The reference's ring scan is O(S)
    total but strictly sequential, blank1.c:709-1000; a flat global
    argmax per iteration would be O(S·max_pulses) of HBM traffic.)
    ``block_size=0`` selects the flat scan (kept for cross-checking).

    ``rounds>0`` selects the parallel variant instead: per round, the
    strongest candidate of every locally-dominant block is fitted and
    subtracted simultaneously (selected blocks are never adjacent, so
    fit windows are disjoint and the subtractions commute exactly with
    the sequential order); the sequential depth drops from
    ``max_pulses`` to ``rounds`` while each round is one batched
    gather/fit/scatter.

    ``eligible`` (S,) bool restricts *candidate centres* (fit windows
    still read every sample) — the sharded path marks halo samples
    ineligible so each pulse is fitted by exactly one shard.
    """
    if rounds:
        return _clever_blanker_parallel(weak, pwr, tables, noise_floor,
                                        limit_amp, pulsewidth, rounds,
                                        block_size or 256, eligible)
    if block_size:
        return _clever_blanker_blocked(weak, pwr, tables, noise_floor,
                                       limit_amp, pulsewidth, max_pulses,
                                       block_size, eligible)
    s, c = weak.shape
    pul = tables.refbank.shape[1]
    half = pul // 2
    pw = pulsewidth
    thr = jnp.float32(limit_amp * limit_amp) * noise_floor

    wpad = jnp.pad(weak, ((pul, pul), (0, 0)))
    ppad = jnp.pad(pwr, (pul, pul))
    act0 = jnp.ones(s, bool) if eligible is None else eligible
    active = jnp.pad(act0, (pul, pul))

    def body(i, carry):
        # iterations after the last candidate are masked no-ops (`valid`
        # below) — a while_loop early exit would save them, but this
        # backend does not execute while_loop+dynamic-update bodies, and
        # a masked no-op iteration costs only one reduction pass
        wpad, ppad, active, nfit = carry
        cand = jnp.where(active, ppad, -1.0)
        p = jnp.argmax(cand).astype(jnp.int32)
        valid = cand[p] > thr

        start = p - half
        win = cdynamic_slice(wpad, (start, 0), (pul, c))
        derot = win * tables.phasefunc[:, None]
        ctr = derot[half - 1: half + 2]                      # (3, C)
        ph = jnp.sum(jnp.abs(ctr) * ctr, axis=0)             # (C,)
        unit = ph / jnp.maximum(jnp.abs(ph), 1e-20)
        rot = derot * jnp.conj(unit)[None, :]
        seg = rot[half - pw: half + pw + 1]
        ipow = jnp.sum(jnp.real(seg) ** 2)
        qpow = jnp.sum(jnp.imag(seg) ** 2)
        shape_ok = qpow <= 0.25 * ipow                       # blank1.c:121

        a = jnp.sum(jnp.real(rot), axis=1)                   # (pul,)
        t3 = 2.0 * (a[half - 1] + a[half + 1] - 2.0 * a[half])
        t4 = jnp.where(jnp.abs(t3) > 1e-20,
                       (a[half - 1] - a[half + 1]) / t3, 0.0)
        frac = jnp.sign(t4) * jnp.sqrt(0.5 * jnp.abs(t4))
        nref = tables.refbank.shape[0]
        j = jnp.clip((nref * (frac + 0.5) + 0.5).astype(jnp.int32), 0,
                     nref - 1)
        ref = cgather(tables.refbank, j)                              # (pul,)

        # a true pulse is win = coef * bank_j with coef = A*e^{i*phi};
        # the bank rows are raw (non-derotated) pulses, so subtract
        # coef * ref directly (blank1.c:157-162)
        coef = unit * jnp.real(rot[half])                    # (C,) complex
        sub = ref[:, None] * coef[None, :]
        neww = win - sub
        newp = jnp.sum(jnp.real(neww) ** 2 + jnp.imag(neww) ** 2, axis=1)
        oldp = cdynamic_slice(ppad, (start,), (pul,))
        ratio = jnp.sum(newp) / jnp.maximum(jnp.sum(oldp), 1e-20)
        success = valid & shape_ok & (ratio <= 0.5)          # blank1.c:188

        wpad2 = cdynamic_update_slice(
            wpad, jnp.where(success, neww, win), (start, 0))
        ppad2 = cdynamic_update_slice(
            ppad, jnp.where(success, newp, oldp), (start,))
        # always retire the candidate region so the loop progresses
        retire = jnp.zeros(2 * pw + 1, bool)
        act2 = cdynamic_update_slice(active, retire, (p - pw,))
        active2 = jnp.where(valid, act2, active)
        return wpad2, ppad2, active2, nfit + success.astype(jnp.int32)

    wpad, ppad, _, nfit = jax.lax.fori_loop(
        0, max_pulses, body, (wpad, ppad, active, jnp.int32(0)))
    return wpad[pul: pul + s], ppad[pul: pul + s], nfit


def _fit_subtract(wpad, ppad, tables, pw, p, valid):
    """One fit-and-subtract attempt at candidate position ``p`` —
    identical math to the flat loop body (blank1.c:36-232)."""
    c = wpad.shape[1]
    pul = tables.refbank.shape[1]
    half = pul // 2
    start = p - half
    win = cdynamic_slice(wpad, (start, 0), (pul, c))
    derot = win * tables.phasefunc[:, None]
    ctr = derot[half - 1: half + 2]
    ph = jnp.sum(jnp.abs(ctr) * ctr, axis=0)
    unit = ph / jnp.maximum(jnp.abs(ph), 1e-20)
    rot = derot * jnp.conj(unit)[None, :]
    seg = rot[half - pw: half + pw + 1]
    ipow = jnp.sum(jnp.real(seg) ** 2)
    qpow = jnp.sum(jnp.imag(seg) ** 2)
    shape_ok = qpow <= 0.25 * ipow                           # blank1.c:121
    a = jnp.sum(jnp.real(rot), axis=1)
    t3 = 2.0 * (a[half - 1] + a[half + 1] - 2.0 * a[half])
    t4 = jnp.where(jnp.abs(t3) > 1e-20,
                   (a[half - 1] - a[half + 1]) / t3, 0.0)
    frac = jnp.sign(t4) * jnp.sqrt(0.5 * jnp.abs(t4))
    nref = tables.refbank.shape[0]
    j = jnp.clip((nref * (frac + 0.5) + 0.5).astype(jnp.int32), 0,
                 nref - 1)
    ref = cgather(tables.refbank, j)
    coef = unit * jnp.real(rot[half])
    sub = ref[:, None] * coef[None, :]
    neww = win - sub
    newp = jnp.sum(jnp.real(neww) ** 2 + jnp.imag(neww) ** 2, axis=1)
    oldp = cdynamic_slice(ppad, (start,), (pul,))
    ratio = jnp.sum(newp) / jnp.maximum(jnp.sum(oldp), 1e-20)
    success = valid & shape_ok & (ratio <= 0.5)              # blank1.c:188
    wpad2 = cdynamic_update_slice(
        wpad, jnp.where(success, neww, win), (start, 0))
    ppad2 = cdynamic_update_slice(
        ppad, jnp.where(success, newp, oldp), (start,))
    return wpad2, ppad2, success


def _clever_blanker_blocked(weak, pwr, tables, noise_floor, limit_amp,
                            pulsewidth, max_pulses, blk, eligible=None):
    """Hierarchical candidate search: incrementally-maintained block
    maxima make each sequential iteration O(S/blk + blk) instead of
    O(S).  Selection order matches the flat scan (the global argmax is
    the max over block maxima); only tie-breaking can differ."""
    s, c = weak.shape
    pul = tables.refbank.shape[1]
    half = pul // 2
    pw = pulsewidth
    assert pul + 2 * pw + 1 < blk, (pul, pw, blk)
    thr = jnp.float32(limit_amp * limit_amp) * noise_floor

    # pad so the fit window never leaves the array and the length is a
    # whole number of blocks
    lead = pul
    total = max(-(-(s + 2 * pul) // blk) * blk, 2 * blk)
    trail = total - s - lead
    wpad = jnp.pad(weak, ((lead, trail), (0, 0)))
    ppad = jnp.pad(pwr, (lead, trail))
    act0 = jnp.ones(s, bool) if eligible is None else eligible
    active = jnp.pad(act0, (lead, trail))
    candp = jnp.where(active, ppad, -1.0)
    nblk = total // blk
    bmax = jnp.max(candp.reshape(nblk, blk), axis=1)

    def body(i, carry):
        wpad, ppad, candp, bmax, nfit = carry
        b = jnp.argmax(bmax).astype(jnp.int32)
        cblk = cdynamic_slice(candp, (b * blk,), (blk,))
        p = b * blk + jnp.argmax(cblk).astype(jnp.int32)
        valid = bmax[b] > thr
        wpad2, ppad2, success = _fit_subtract(wpad, ppad, tables, pw, p,
                                              valid)
        # retire the candidate region so the loop progresses, refresh
        # powers where the subtraction changed them, and rebuild the
        # two touched block maxima
        b0 = jnp.clip((p - half - pw) // blk, 0, nblk - 2)
        w0 = b0 * blk
        pos = w0 + jnp.arange(2 * blk)
        pwin = cdynamic_slice(ppad2, (w0,), (2 * blk,))
        cwin = cdynamic_slice(candp, (w0,), (2 * blk,))
        retired = jnp.abs(pos - p) <= pw
        was_active = cwin >= 0.0
        act2 = was_active & ~jnp.where(valid, retired,
                                       jnp.zeros_like(retired))
        cwin2 = jnp.where(act2, pwin, -1.0)
        candp2 = cdynamic_update_slice(candp, cwin2, (w0,))
        bm2 = jnp.max(cwin2.reshape(2, blk), axis=1)
        bmax2 = cdynamic_update_slice(bmax, bm2, (b0,))
        return (wpad2, ppad2, candp2, bmax2,
                nfit + success.astype(jnp.int32))

    wpad, ppad, _, _, nfit = jax.lax.fori_loop(
        0, max_pulses, body, (wpad, ppad, candp, bmax, jnp.int32(0)))
    return wpad[lead: lead + s], ppad[lead: lead + s], nfit


def _clever_blanker_parallel(weak, pwr, tables, noise_floor, limit_amp,
                             pulsewidth, rounds, blk, eligible=None):
    """Round-parallel fit-subtract: every round fits the strongest
    candidate of each locally-dominant block simultaneously.

    A block is selected only when its candidate beats both neighbour
    blocks' maxima, so selected blocks are never adjacent: their
    candidates are ≥ blk+1 > pul + 2·pw apart, the fit windows are
    disjoint, and the parallel subtractions are bit-identical to
    performing them sequentially (they commute).  Dominance also keeps
    the strongest-first order where it matters — an interacting weaker
    pulse in the adjacent block is deferred until the stronger one has
    been subtracted.  Sequential depth is ``rounds`` instead of
    ``max_pulses``; up to nblk/2 pulses are fitted per round.
    """
    s, c = weak.shape
    pul = tables.refbank.shape[1]
    half = pul // 2
    pw = pulsewidth
    nref = tables.refbank.shape[0]
    assert pul + 2 * pw + 1 <= blk, (pul, pw, blk)
    thr = jnp.float32(limit_amp * limit_amp) * noise_floor

    # one full padding block on each side: every fit window at a real
    # candidate stays in-bounds, and padded candidates never win a
    # block argmax (candp = -1 there)
    lead = blk
    total = (-(-(lead + s) // blk) + 1) * blk
    trail = total - s - lead
    wpad = jnp.pad(weak, ((lead, trail), (0, 0)))
    ppad = jnp.pad(pwr, (lead, trail))
    cand0 = pwr if eligible is None else jnp.where(eligible, pwr, -1.0)
    candp = jnp.pad(cand0, (lead, trail), constant_values=-1.0)
    nblk = total // blk
    bidx = jnp.arange(nblk, dtype=jnp.int32)
    rel = jnp.arange(pul, dtype=jnp.int32) - half            # (pul,)

    def body(r, carry):
        wpad, ppad, candp, nfit = carry
        cand2 = candp.reshape(nblk, blk)
        bmax = jnp.max(cand2, axis=1)                        # (nblk,)
        p = bidx * blk + jnp.argmax(cand2, axis=1).astype(jnp.int32)
        # locally-dominant blocks only: the candidate must beat both
        # neighbour blocks' maxima (left wins ties, like argmax).  Two
        # adjacent blocks can never both be selected, so selected fit
        # windows are ≥ blk+1 > pul+2·pw apart (disjoint), and an
        # interacting stronger neighbour is always fitted first —
        # preserving the strongest-first order where it matters.
        bprev = jnp.concatenate([jnp.full((1,), -jnp.inf), bmax[:-1]])
        bnext = jnp.concatenate([bmax[1:], jnp.full((1,), -jnp.inf)])
        sel = (bmax > thr) & (bmax > bprev) & (bmax >= bnext)

        rows = p[:, None] + rel[None, :]                     # (nblk, pul)
        rows_g = jnp.clip(rows, 0, total - 1)
        win = cgather(wpad, rows_g)                          # (nblk, pul, C)
        derot = win * tables.phasefunc[None, :, None]
        ctr = derot[:, half - 1: half + 2]                   # (nblk, 3, C)
        ph = jnp.sum(jnp.abs(ctr) * ctr, axis=1)             # (nblk, C)
        unit = ph / jnp.maximum(jnp.abs(ph), 1e-20)
        rot = derot * jnp.conj(unit)[:, None, :]
        seg = rot[:, half - pw: half + pw + 1]
        ipow = jnp.sum(jnp.real(seg) ** 2, axis=(1, 2))
        qpow = jnp.sum(jnp.imag(seg) ** 2, axis=(1, 2))
        shape_ok = qpow <= 0.25 * ipow                       # blank1.c:121
        a = jnp.sum(jnp.real(rot), axis=2)                   # (nblk, pul)
        t3 = 2.0 * (a[:, half - 1] + a[:, half + 1] - 2.0 * a[:, half])
        t4 = jnp.where(jnp.abs(t3) > 1e-20,
                       (a[:, half - 1] - a[:, half + 1]) / t3, 0.0)
        frac = jnp.sign(t4) * jnp.sqrt(0.5 * jnp.abs(t4))
        j = jnp.clip((nref * (frac + 0.5) + 0.5).astype(jnp.int32), 0,
                     nref - 1)
        ref = cgather(tables.refbank, j)                              # (nblk, pul)
        coef = unit * jnp.real(rot[:, half])                 # (nblk, C)
        neww = win - ref[:, :, None] * coef[:, None, :]
        newp = jnp.sum(jnp.real(neww) ** 2 + jnp.imag(neww) ** 2, axis=2)
        oldp = ppad[rows_g]                                  # (nblk, pul)
        ratio = (jnp.sum(newp, axis=1)
                 / jnp.maximum(jnp.sum(oldp, axis=1), 1e-20))
        success = sel & shape_ok & (ratio <= 0.5)            # blank1.c:188

        # scatter the disjoint windows back; unselected blocks write
        # out-of-bounds and are dropped
        rows_s = jnp.where(sel[:, None], rows, total)
        wvals = jnp.where(success[:, None, None], neww, win)
        pvals = jnp.where(success[:, None], newp, oldp)
        wpad2 = cset(wpad, rows_s, wvals, mode="drop")
        ppad2 = ppad.at[rows_s].set(pvals, mode="drop")
        # retire ±pw around each fitted candidate (pw < half so the
        # retire span lies inside the same window), refresh the rest
        cold = candp[rows_g]
        retired = jnp.abs(rows - p[:, None]) <= pw
        cvals = jnp.where(retired | (cold < 0.0), -1.0, pvals)
        candp2 = candp.at[rows_s].set(cvals, mode="drop")
        return (wpad2, ppad2, candp2,
                nfit + jnp.sum(success.astype(jnp.int32)))

    wpad, ppad, _, nfit = jax.lax.fori_loop(
        0, rounds, body, (wpad, ppad, candp, jnp.int32(0)))
    return wpad[lead: lead + s], ppad[lead: lead + s], nfit


def stupid_blanker(weak: jax.Array, pwr: jax.Array,
                   noise_floor: jax.Array, limit_amp: float,
                   pulsewidth: int
                   ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Hard-clear every run above threshold, widened by the
    sqrt(peak/noise)/100 rule (blank1.c:1013-1083).

    Returns (weak', pwr', cleared_count)."""
    s = pwr.shape[0]
    thr = jnp.float32(limit_amp * limit_amp) * noise_floor
    flagged = pwr > thr
    runmax = segment_max(pwr, flagged)
    t = jnp.sqrt(jnp.clip(runmax / jnp.maximum(noise_floor, 1e-20),
                          0.0, 1e4)) / 100.0
    widen = flagged & (runmax > 4.0 * noise_floor)
    before = jnp.where(widen,
                       ((pulsewidth + 1) // 2) * t + 0.5, 0.0)
    after = jnp.where(widen, (pulsewidth + 1) * t + 0.5, 0.0)
    pos = jnp.arange(s, dtype=jnp.float32)
    reach_l = jnp.where(widen, pos - before, jnp.inf)
    reach_r = jnp.where(widen, pos + after, -jnp.inf)
    suf_min = jax.lax.cummin(reach_l, axis=0, reverse=True)
    pre_max = jax.lax.cummax(reach_r, axis=0)
    cleared = flagged | (suf_min <= pos) | (pre_max >= pos)
    weak2 = jnp.where(cleared[:, None], 0.0, weak)
    pwr2 = jnp.where(cleared, 0.0, pwr)
    return weak2, pwr2, jnp.sum(cleared.astype(jnp.int32))


def despiked_mean(pwr: jax.Array) -> jax.Array:
    """Mean power excluding pulse outliers: two O(n) passes (mean, then
    mean of samples below 4x mean) instead of a quantile sort — a sort
    of the whole step is far more expensive than two passes, and the
    threshold only steers a 1-s EMA (buf.c:336-346 semantics)."""
    m0 = jnp.mean(pwr)
    keep = pwr <= 4.0 * m0
    return jnp.sum(jnp.where(keep, pwr, 0.0)) / jnp.maximum(
        jnp.sum(keep), 1)


def update_noise_floor(state: BlankerState, pwr: jax.Array,
                       step_seconds: float) -> BlankerState:
    """~1 s time-constant despiked noise tracker (buf.c:336-346)."""
    mean = despiked_mean(pwr)
    alpha = jnp.float32(min(1.0, step_seconds))
    nf = state.noise_floor * (1 - alpha) + mean * alpha
    return BlankerState(noise_floor=jnp.maximum(nf, 1e-20))
