"""Structural invariant: no complex-operand gather/scatter in any
jitted production path.

The hot path routes all complex indexing (gather, dynamic slice,
scatter) through the ops/cplx.py float-pair forms, which move the
real and imaginary float32 parts separately.  This test walks the jaxpr of every production step
(plain chain, fractional-tune Receiver step, spur/squelch-enabled,
batched scan, multi-rx) and fails on any regression of that class —
the code-review pass that introduced it found three missed sites
(round-parallel blanker, mix2 selection, squelch band).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from linrad_tpu import RxParams, derive_geometry
from linrad_tpu.ops.blanker import BlankerTables
from linrad_tpu.pipeline.chain import RxState, RxTables, make_rx_step

# the primitives proven (or strongly suspected) to fail at execution
# with complex operands.  Fetch-verified probe evidence (2026-08-21
# 11:35 window): complex SCATTER-ADD executes fine (op probe OK), so
# overlap_add's slice-adds stay direct; complex GATHER fails
# (frame_stream probe), so gather (which take_along_axis also lowers
# to) is banned; dynamic_slice stayed unproven (the probe window
# closed first) but every complex site is wrapped, so it is banned
# defensively.  dynamic_update_slice pending op_bisect evidence.
BANNED = {"gather", "dynamic_slice"}


def _complex_banned_eqns(jaxpr, found, path=""):
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in BANNED and any(
                jnp.issubdtype(v.aval.dtype, jnp.complexfloating)
                for v in eqn.invars
                if hasattr(v, "aval") and hasattr(v.aval, "dtype")):
            found.append(f"{path}{name}: {eqn}"[:200])
        for sub in jax.core.jaxprs_in_params(eqn.params) \
                if hasattr(jax.core, "jaxprs_in_params") else []:
            _complex_banned_eqns(sub, found, path + name + "/")
        # generic recursion over params holding jaxprs
        for k, v in eqn.params.items():
            vals = v if isinstance(v, (list, tuple)) else [v]
            for item in vals:
                inner = getattr(item, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    _complex_banned_eqns(inner, found,
                                         path + name + "/")
                elif hasattr(item, "eqns"):
                    _complex_banned_eqns(item, found, path + name + "/")


def _check(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found: list[str] = []
    _complex_banned_eqns(jaxpr.jaxpr, found)
    assert not found, "complex gather/scatter in jitted path:\n" + \
        "\n".join(found[:8])


def _setup(**kw):
    p = RxParams(rx_ad_speed=96_000, fft1_n_override=9,
                 mix1_bandwidth_reduction_n=4,
                 target_fft1_frames_per_step=16, **kw)
    geo = derive_geometry(p)
    tables = RxTables.create(geo, p)
    state = RxState.create(geo, spur=p.spur_enable,
                           fir_len=(int(tables.mix2.fir.shape[0])
                                    if tables.mix2.fir is not None
                                    else 0))
    pw = 2
    if geo.second_fft_enable:
        _, pw = BlankerTables.create(geo)
    rng = np.random.default_rng(0)
    block = jnp.asarray((rng.normal(size=(geo.samples_per_step, 1))
                         + 1j * rng.normal(size=(geo.samples_per_step, 1))
                         ).astype(np.complex64))
    return p, geo, tables, state, block, pw


class TestNoComplexGather:
    def test_flagship_chain(self):
        p, geo, tables, state, block, pw = _setup(
            second_fft_enable=True, blanker_enable=True,
            agc_enable=True, blanker_rounds=8,
            max_pulses_per_block=16)
        step = make_rx_step(geo, p, blanker_pulsewidth=pw)
        _check(step, tables, state, block, jnp.int32(16))

    def test_flat_blanker_chain(self):
        p, geo, tables, state, block, pw = _setup(
            second_fft_enable=True, blanker_enable=True,
            blanker_rounds=0, max_pulses_per_block=16)
        step = make_rx_step(geo, p, blanker_pulsewidth=pw)
        _check(step, tables, state, block, jnp.int32(16))

    def test_spur_squelch_fractional(self):
        p, geo, tables, state, block, pw = _setup(
            second_fft_enable=True, blanker_enable=True,
            spur_enable=True, squelch_enable=True,
            max_pulses_per_block=16)
        step = make_rx_step(geo, p, blanker_pulsewidth=pw,
                            fractional_tune=True)
        f = geo.fftx_frames_per_step
        _check(step, tables, state, block,
               jnp.full((f,), 16, jnp.int32),
               jnp.zeros((f,), jnp.float32),
               jnp.full((f,), 1e-4, jnp.float32))

    @pytest.mark.parametrize("demod", ["FM", "AM", "COHERENT"])
    def test_demod_modes(self, demod):
        from linrad_tpu.params import Demod
        kw = dict(second_fft_enable=True, blanker_enable=True,
                  agc_enable=True, max_pulses_per_block=16,
                  demod=getattr(Demod, demod))
        if demod == "COHERENT":
            kw["coherent_mode"] = 2
        p, geo, tables, state, block, pw = _setup(**kw)
        step = make_rx_step(geo, p, blanker_pulsewidth=pw)
        _check(step, tables, state, block, jnp.int32(16))

    def test_real_input_mode(self):
        from linrad_tpu.params import InputMode
        p = RxParams(rx_ad_speed=96_000, fft1_n_override=9,
                     input_mode=InputMode.REAL,
                     mix1_bandwidth_reduction_n=4,
                     target_fft1_frames_per_step=16,
                     second_fft_enable=True, blanker_enable=True,
                     max_pulses_per_block=16)
        geo = derive_geometry(p)
        tables = RxTables.create(geo, p)
        state = RxState.create(geo)
        _, pw = BlankerTables.create(geo)
        step = make_rx_step(geo, p, blanker_pulsewidth=pw)
        rng = np.random.default_rng(0)
        block = jnp.asarray(rng.normal(
            size=(2 * geo.samples_per_step, 1)).astype(np.float32))
        _check(step, tables, state, block, jnp.int32(16))

    def test_multi_rx(self):
        from linrad_tpu.pipeline.chain import (NBState,
                                               make_multi_rx_step)
        p, geo, tables, state, block, pw = _setup(
            second_fft_enable=True, blanker_enable=True,
            max_pulses_per_block=16)
        fir_len = (int(tables.mix2.fir.shape[0])
                   if tables.mix2.fir is not None else 0)
        nbs = NBState.create_stacked(geo, 3, fir_len=fir_len)
        step = make_multi_rx_step(geo, p, blanker_pulsewidth=pw)
        _check(step, tables, state, nbs, block,
               jnp.asarray([4, 8, 12], jnp.int32))

    def test_sharded_step(self):
        import jax
        from jax.sharding import Mesh
        from linrad_tpu.parallel.sharded import (AXIS,
                                                 make_sharded_rx_step)
        devs = jax.devices()[:2]
        if len(devs) < 2:
            pytest.skip("needs 2 devices")
        mesh = Mesh(np.array(devs), (AXIS,))
        p = RxParams(rx_ad_speed=96_000, fft1_n_override=9,
                     mix1_bandwidth_reduction_n=4,
                     target_fft1_frames_per_step=16,
                     second_fft_enable=True, blanker_enable=True,
                     max_pulses_per_block=16, shards=2)
        geo = derive_geometry(p)
        tables = RxTables.create(geo, p)
        state = RxState.create(geo)
        _, pw = BlankerTables.create(geo)
        step = make_sharded_rx_step(geo, p, mesh, pw)
        rng = np.random.default_rng(0)
        block = jnp.asarray(
            (rng.normal(size=(geo.samples_per_step, 1))
             + 1j * rng.normal(size=(geo.samples_per_step, 1))
             ).astype(np.complex64))
        _check(step, tables, state, block, jnp.int32(16))

    def test_batched_scan(self):
        from linrad_tpu.pipeline.batch import BatchRunner
        p = RxParams(rx_ad_speed=96_000, fft1_n_override=9,
                     mix1_bandwidth_reduction_n=4,
                     target_fft1_frames_per_step=16,
                     second_fft_enable=True, blanker_enable=True,
                     blanker_rounds=8, max_pulses_per_block=16)
        br = BatchRunner(p, k_steps=2, outputs=("audio",))
        rng = np.random.default_rng(0)
        blocks = jnp.asarray(
            (rng.normal(size=(2, br.geo.samples_per_step, 1))
             + 1j * rng.normal(size=(2, br.geo.samples_per_step, 1))
             ).astype(np.complex64))
        def run(tables, state, blocks, tune):
            return br._run_k.__wrapped__(tables, state, blocks, tune)
        _check(run, br.tables, br.state, blocks, jnp.int32(16))
