"""Float-pair forms of complex indexing.

Each helper performs a gather, dynamic slice, scatter or constant fill
of complex data as the same operation on the float32 real and
imaginary parts, then recombines them.  Every helper is bit-exact
equivalent to the direct op (gathers/scatters move data, they do not
compute), and XLA fuses the real/imag views.

Used at every complex gather/scatter/dynamic-slice in the hot path
(framing, mix1 bin selection, blanker pulse windows, fft1 mirror,
spur templates).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _is_c(a: jax.Array) -> bool:
    return jnp.iscomplexobj(a)


def czeros(shape, dtype=jnp.complex64) -> jax.Array:
    """Complex zeros built from two float fills and ``lax.complex``
    (no complex-constant broadcast)."""
    f = jnp.float32 if dtype == jnp.complex64 else jnp.float64
    return lax.complex(jnp.zeros(shape, f), jnp.zeros(shape, f))


def cfull(shape, value, dtype=jnp.complex64) -> jax.Array:
    f = jnp.float32 if dtype == jnp.complex64 else jnp.float64
    c = complex(value)
    return lax.complex(jnp.full(shape, c.real, f),
                       jnp.full(shape, c.imag, f))


def cgather(buf: jax.Array, idx) -> jax.Array:
    """``buf[idx]`` via float-pair gathers for complex operands."""
    if _is_c(buf):
        return lax.complex(jnp.real(buf)[idx], jnp.imag(buf)[idx])
    return buf[idx]


def ctake_along_axis(a: jax.Array, idx: jax.Array, axis: int
                     ) -> jax.Array:
    if _is_c(a):
        return lax.complex(
            jnp.take_along_axis(jnp.real(a), idx, axis=axis),
            jnp.take_along_axis(jnp.imag(a), idx, axis=axis))
    return jnp.take_along_axis(a, idx, axis=axis)


def cdynamic_slice(a: jax.Array, starts, sizes) -> jax.Array:
    if _is_c(a):
        return lax.complex(
            lax.dynamic_slice(jnp.real(a), starts, sizes),
            lax.dynamic_slice(jnp.imag(a), starts, sizes))
    return lax.dynamic_slice(a, starts, sizes)


def cdynamic_update_slice(a: jax.Array, upd: jax.Array, starts
                          ) -> jax.Array:
    if _is_c(a):
        upd = jnp.asarray(upd, a.dtype)
        return lax.complex(
            lax.dynamic_update_slice(jnp.real(a), jnp.real(upd), starts),
            lax.dynamic_update_slice(jnp.imag(a), jnp.imag(upd), starts))
    return lax.dynamic_update_slice(a, upd, starts)


def cdynamic_slice_in_dim(a: jax.Array, start, size: int, axis: int = 0
                          ) -> jax.Array:
    if _is_c(a):
        return lax.complex(
            lax.dynamic_slice_in_dim(jnp.real(a), start, size, axis),
            lax.dynamic_slice_in_dim(jnp.imag(a), start, size, axis))
    return lax.dynamic_slice_in_dim(a, start, size, axis)


def cset(a: jax.Array, idx, vals: jax.Array, mode: str | None = None
         ) -> jax.Array:
    """``a.at[idx].set(vals)`` via float-pair scatters for complex."""
    kw = {"mode": mode} if mode else {}
    if _is_c(a):
        vals = jnp.asarray(vals, a.dtype)
        return lax.complex(
            jnp.real(a).at[idx].set(jnp.real(vals), **kw),
            jnp.imag(a).at[idx].set(jnp.imag(vals), **kw))
    return a.at[idx].set(vals, **kw)


def cadd(a: jax.Array, idx, vals: jax.Array, mode: str | None = None
         ) -> jax.Array:
    """``a.at[idx].add(vals)`` via float-pair scatters for complex."""
    kw = {"mode": mode} if mode else {}
    if _is_c(a):
        vals = jnp.asarray(vals, a.dtype)
        return lax.complex(
            jnp.real(a).at[idx].add(jnp.real(vals), **kw),
            jnp.imag(a).at[idx].add(jnp.imag(vals), **kw))
    return a.at[idx].add(vals, **kw)
