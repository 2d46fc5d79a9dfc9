"""Associative-scan formulations of the sample-rate recurrences.

Linrad implements AGC tracking, noise-floor averaging, DC removal and
squelch as per-sample IIR loops inside its per-thread C code (AGC
mix2.c:1517-1620, noise floor buf.c:336-346, AM DC mix2.c:1804-1834).
A sequential loop is poison on an accelerator; every one of those recurrences is an
associative operation, so they run as ``jax.lax.associative_scan`` in
O(log n) depth, data-parallel:

- one-pole lowpass  y[t] = a*y[t-1] + b*x[t]   — affine composition
- decaying max      y[t] = max(a*y[t-1], x[t]) — max-plus (log domain)

Both accept a carried initial value so block-streamed results are
bit-identical to an infinite scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def one_pole(x: jax.Array, a: float | jax.Array, y0: jax.Array,
             b: float | jax.Array | None = None, axis: int = 0
             ) -> tuple[jax.Array, jax.Array]:
    """y[t] = a*y[t-1] + b*x[t] along ``axis`` with initial state y0.

    Returns (y, y_last) where y_last carries to the next block.  b
    defaults to (1-a) (unity DC gain).
    """
    if b is None:
        b = 1.0 - a
    x = jnp.moveaxis(x, axis, 0)
    n = x.shape[0]
    a_arr = jnp.broadcast_to(jnp.asarray(a, x.dtype), x.shape)
    bx = jnp.asarray(b, x.dtype) * x
    # include y0 as a virtual first element with coefficient composition
    bx = bx.at[0].add(a_arr[0] * y0)

    def combine(left, right):
        (a1, v1), (a2, v2) = left, right
        return a1 * a2, a2 * v1 + v2

    _, y = jax.lax.associative_scan(combine, (a_arr, bx), axis=0)
    y_last = y[-1]
    return jnp.moveaxis(y, 0, axis), y_last


def decay_max(x: jax.Array, decay: float | jax.Array, y0: jax.Array,
              axis: int = 0) -> tuple[jax.Array, jax.Array]:
    """y[t] = max(decay*y[t-1], x[t]) — peak tracker with exponential
    release, computed in the log domain as a max-plus associative scan.

    x must be > 0 (envelope magnitudes); returns (y, y_last).
    """
    x = jnp.moveaxis(x, axis, 0)
    eps = jnp.asarray(1e-30, x.dtype)
    lx = jnp.log(jnp.maximum(x, eps))
    ld = jnp.log(jnp.asarray(decay, x.dtype))
    lx = lx.at[0].set(jnp.maximum(lx[0],
                                  jnp.log(jnp.maximum(y0, eps)) + ld))
    steps = jnp.ones_like(lx)

    def combine(left, right):
        (n1, v1), (n2, v2) = left, right
        # v decays by ld per step while crossing the right segment
        return n1 + n2, jnp.maximum(v1 + ld * n2, v2)

    _, ly = jax.lax.associative_scan(combine, (steps, lx), axis=0)
    y = jnp.exp(ly)
    y_last = y[-1]
    return jnp.moveaxis(y, 0, axis), y_last


def sliding_max(x: jax.Array, window: int, axis: int = 0) -> jax.Array:
    """Causal sliding-window maximum (for AGC hang, mix2.c:1569-1620).
    Output[t] = max(x[t-window+1 .. t]) with edge clamping."""
    if window <= 1:
        return x
    x = jnp.moveaxis(x, axis, 0)
    n = x.shape[0]
    pad = [(window - 1, 0)] + [(0, 0)] * (x.ndim - 1)
    xp = jnp.pad(x, pad, mode="edge")
    # sparse-table doubling: d covers a 2^K window, then the exact window
    # is the max of two overlapping 2^K windows (RMQ trick)
    big_k = (window - 1).bit_length() - 1 if window > 1 else 0
    d = xp
    for k in range(big_k):
        s = 1 << k
        d = jnp.maximum(d[s:], d[:-s])
    # d[t] = max over 2^big_k samples ending at t (in padded coords)
    span = 1 << big_k
    off = window - span
    y = jnp.maximum(d[off:], d[: d.shape[0] - off] if off else d[off:])
    y = y[-n:]
    return jnp.moveaxis(y, 0, axis)
