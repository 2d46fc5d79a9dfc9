"""Adaptive dual-channel polarization.

JAX re-design of the reference polarization layer (pol_graph.c,
1391 LoC; channel combination applied in the mix1/mix2 paths, XG_*
controls globdef.h:706-730): from a 2-channel (X/Y antenna) baseband,
estimate the signal's polarization state from the 2x2 coherency matrix
and project onto the matched polarization — the adaptive combination
that maximises S/N for an arbitrarily polarized (EME-libration-rotating)
signal.  The ellipse parameters (tilt angle, axial ratio) are the
numbers the reference's POL graph displays and its phasing controls
set."""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass

# the 2x2 contractions are tiny and memory-bound: full float32, no TF32
HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass
class PolState:
    """Smoothed coherency matrix (2x2 Hermitian)."""

    coherency: jax.Array  # (2, 2) complex64

    @classmethod
    def create(cls) -> "PolState":
        return cls(coherency=jnp.eye(2, dtype=jnp.complex64))


@dataclass
class PolInfo:
    """Polarization ellipse readout (the POL graph numbers)."""

    tilt_deg: float       # polarization plane angle
    axial_ratio_db: float  # circularity: 0 dB = circular, inf = linear
    coherence: float      # fraction of power in the dominant state


def update_polarization(state: PolState, baseb2: jax.Array,
                        alpha: float = 0.1
                        ) -> tuple[PolState, jax.Array, jax.Array]:
    """One block update: estimate + project.

    baseb2: (S, 2) complex64 two-channel baseband.
    Returns (state, combined (S,) complex64, weights (2,) complex64).

    The dominant eigenvector of the smoothed coherency matrix is the
    matched polarization; projecting onto it is the reference's adaptive
    channel combination."""
    r = jnp.einsum("si,sj->ij", baseb2, jnp.conj(baseb2),
                   precision=HIGHEST) / baseb2.shape[0]
    coh = (1.0 - alpha) * state.coherency + alpha * r
    # closed-form dominant eigenvector of a 2x2 Hermitian matrix
    a = jnp.real(coh[0, 0])
    d = jnp.real(coh[1, 1])
    b = coh[0, 1]
    tr = a + d
    det = a * d - jnp.abs(b) ** 2
    lam = 0.5 * (tr + jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0)))
    # eigenvector for lam: (A - lam I) v = 0 -> v ~ [b, lam - a]
    v_gen = jnp.stack([b, (lam - a).astype(coh.dtype)])
    v_axis = jnp.where(a >= d,
                       jnp.array([1.0 + 0.0j, 0.0 + 0.0j]),
                       jnp.array([0.0 + 0.0j, 1.0 + 0.0j]))
    v = jnp.where(jnp.abs(b) > 1e-12 * jnp.maximum(a, d), v_gen, v_axis)
    v = v / jnp.maximum(jnp.linalg.norm(v), 1e-20)
    combined = jnp.matmul(baseb2, jnp.conj(v), precision=HIGHEST)
    return PolState(coherency=coh), combined, v


def pol_info(state: PolState) -> PolInfo:
    """Ellipse parameters from the coherency matrix (host-side)."""
    coh = np.asarray(state.coherency)
    w, vecs = np.linalg.eigh(coh)
    v = vecs[:, -1]  # dominant
    # Stokes-like parameters
    ex, ey = v[0], v[1]
    tilt = 0.5 * np.degrees(np.arctan2(
        2 * np.real(ex * np.conj(ey)),
        np.abs(ex) ** 2 - np.abs(ey) ** 2))
    s3 = 2 * np.imag(ex * np.conj(ey))
    s0 = np.abs(ex) ** 2 + np.abs(ey) ** 2
    chi = 0.5 * np.arcsin(np.clip(s3 / max(s0, 1e-20), -1, 1))
    t = abs(np.tan(chi))
    ar_db = 20 * np.log10(1.0 / max(t, 1e-6)) if t < 1 else 0.0
    coherence = float(w[-1] / max(w.sum(), 1e-20))
    return PolInfo(tilt_deg=float(tilt), axial_ratio_db=float(ar_db),
                   coherence=coherence)
