"""ops/cplx.py — the float-pair indexing helpers must be BIT-exact vs
the direct ops (they are pure data movement: complex gathers, slices
and scatters done on the real and imaginary float32 parts).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from linrad_tpu.ops.cplx import (cadd, cdynamic_slice,
                                 cdynamic_slice_in_dim,
                                 cdynamic_update_slice, cgather, cset,
                                 ctake_along_axis)

RNG = np.random.default_rng(7)


def _z(*shape):
    return jnp.asarray((RNG.normal(size=shape)
                        + 1j * RNG.normal(size=shape)
                        ).astype(np.complex64))


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestCplxExact:
    def test_gather_2d_index(self):
        z = _z(512)
        idx = jnp.arange(8)[:, None] * 32 + jnp.arange(64)[None, :]
        _eq(cgather(z, idx), z[idx])

    def test_gather_tuple_key(self):
        z = _z(4, 256, 2)
        idx = jnp.asarray([[3, 5, 250], [0, 1, 2]])
        key = (slice(None), idx, slice(None))
        _eq(cgather(z, key), z[key])

    def test_gather_float_passthrough(self):
        x = jnp.asarray(RNG.normal(size=64).astype(np.float32))
        _eq(cgather(x, jnp.arange(0, 64, 3)), x[jnp.arange(0, 64, 3)])

    def test_take_along_axis(self):
        z = _z(6, 128, 2)
        idx = jnp.asarray(RNG.integers(0, 128, size=(6, 16, 1)))
        _eq(ctake_along_axis(z, idx, axis=1),
            jnp.take_along_axis(z, idx, axis=1))

    def test_dynamic_slice(self):
        z = _z(128, 3)
        _eq(cdynamic_slice(z, (jnp.int32(7), jnp.int32(1)), (16, 2)),
            lax.dynamic_slice(z, (jnp.int32(7), jnp.int32(1)), (16, 2)))

    def test_dynamic_slice_in_dim(self):
        z = _z(9, 64, 2)
        _eq(cdynamic_slice_in_dim(z, jnp.int32(3), 4, 0),
            lax.dynamic_slice_in_dim(z, jnp.int32(3), 4, 0))

    def test_dynamic_update_slice(self):
        z = _z(128, 3)
        u = _z(16, 3)
        _eq(cdynamic_update_slice(z, u, (jnp.int32(5), jnp.int32(0))),
            lax.dynamic_update_slice(z, u, (jnp.int32(5), jnp.int32(0))))

    def test_set_and_add(self):
        z = _z(256)
        idx = jnp.asarray([3, 9, 200, 255])
        v = _z(4)
        _eq(cset(z, idx, v), z.at[idx].set(v))
        _eq(cadd(z, idx, v), z.at[idx].add(v))

    def test_set_drop_mode(self):
        z = _z(32)
        idx = jnp.asarray([1, 40])          # 40 out of bounds
        v = _z(2)
        _eq(cset(z, idx, v, mode="drop"),
            z.at[idx].set(v, mode="drop"))

    def test_add_tuple_key(self):
        z = _z(4, 64, 2)
        idx = jnp.asarray([[1, 2], [5, 6]])
        v = _z(4, 2, 2, 2)
        key = (slice(None), idx, slice(None))
        _eq(cadd(z, key, v), z.at[key].add(v))
