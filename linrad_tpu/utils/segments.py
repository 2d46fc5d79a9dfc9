"""Segmented reductions along the frequency axis.

The reference's sellim walks strong-signal regions bin by bin with
pointer loops (sellim.c:790-860).  Here, contiguous regions are
segments of a boolean mask and per-region reductions are segmented
associative scans — O(log n) depth, no sequential walk.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _seg_combine(op):
    def combine(left, right):
        s1, v1 = left
        s2, v2 = right
        return jnp.logical_or(s1, s2), jnp.where(s2, v2, op(v1, v2))

    return combine


def _segscan(values: jax.Array, starts: jax.Array, op) -> jax.Array:
    """Prefix-``op`` within segments delimited by ``starts`` flags."""
    _, out = jax.lax.associative_scan(_seg_combine(op), (starts, values),
                                      axis=0)
    return out


def segment_starts(mask: jax.Array) -> jax.Array:
    """True at the first bin of each contiguous True-run of ``mask``."""
    prev = jnp.concatenate([jnp.zeros((1,), bool), mask[:-1]])
    return mask & ~prev


def segment_reduce(values: jax.Array, mask: jax.Array, op,
                   fill) -> jax.Array:
    """Broadcast the full-segment reduction to every member of each
    contiguous True-run of ``mask``; ``fill`` outside the mask."""
    starts = segment_starts(mask)
    ends = segment_starts(mask[::-1])
    v = jnp.where(mask, values, fill)
    fwd = _segscan(v, starts, op)
    bwd = _segscan(v[::-1], ends, op)[::-1]
    return jnp.where(mask, op(fwd, bwd), fill)


def segment_max(values, mask):
    return segment_reduce(values, mask, jnp.maximum, -jnp.inf)


def segment_min(values, mask):
    return segment_reduce(values, mask, jnp.minimum, jnp.inf)


def segment_sum(values, mask):
    """Per-segment sum broadcast to members (used for region widths)."""
    starts = segment_starts(mask)
    ends = segment_starts(mask[::-1])
    v = jnp.where(mask, values, 0.0)
    add = lambda a, b: a + b
    fwd = _segscan(v, starts, add)
    bwd = _segscan(v[::-1], ends, add)[::-1]
    # fwd + bwd counts the element itself twice
    return jnp.where(mask, fwd + bwd - v, 0.0)
