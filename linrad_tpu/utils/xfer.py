"""Host<->device transfer helpers that move complex data as float pairs.

Complex arrays cross between host and device as float32 (re, im)
pairs, and the complex values are formed or split on the device (one
fused elementwise op).  The same bytes move as for a complex transfer.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.cache
def _packer(ndim: int):
    return jax.jit(lambda v: jax.lax.complex(v[..., 0], v[..., 1]))


@functools.cache
def _unpacker(ndim: int):
    return jax.jit(lambda z: jnp.stack([jnp.real(z), jnp.imag(z)],
                                       axis=-1))


def device_complex(x, dtype=jnp.complex64) -> jax.Array:
    """Upload a (numpy or list) complex array as float32 pairs and form
    complex64 on device.  Non-complex inputs pass through jnp.asarray.
    Device arrays pass through (no transfer involved)."""
    if isinstance(x, jax.Array):
        return x.astype(dtype) if x.dtype != dtype else x
    a = np.asarray(x)
    if not np.iscomplexobj(a):
        return jnp.asarray(a, dtype)
    a = np.ascontiguousarray(a, np.complex64)
    pairs = a.view(np.float32).reshape(a.shape + (2,))
    return _packer(a.ndim)(jnp.asarray(pairs))


def fetch(x) -> np.ndarray:
    """Device -> host that never transfers complex: complex arrays are
    split to float32 pairs on device and re-viewed on the host."""
    x = jnp.asarray(x)
    if not jnp.iscomplexobj(x):
        return np.asarray(x)
    pairs = np.ascontiguousarray(np.asarray(_unpacker(x.ndim)(x)))
    return pairs.view(np.complex64).reshape(x.shape)
