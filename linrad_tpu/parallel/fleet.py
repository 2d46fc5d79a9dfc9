"""Fleet mode: many independent receivers as one batched device program.

The reference scales over *one* signal by splitting its pipeline across
machines (z_NETWORK.txt master/slave); the other production axis —
many independent channels/recordings at once (N dial frequencies, N
antennas, N capture files) — is N Linrad instances on N machines.  Here
that axis is a pure ``vmap``: the whole rx_step is vectorized over a
leading stream axis and that axis is sharded across the device mesh, so
each chip runs a fleet of receivers in lockstep with zero cross-chip
communication (embarrassingly data-parallel, the ideal mesh workload).

Per-stream state (tune bins included) is carried batched; K steps run
per dispatch via ``lax.scan`` exactly like pipeline/batch.py.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import derive_geometry
from ..params import RxParams
from ..pipeline.chain import RxState, RxTables, make_rx_step

AXIS = "streams"


class FleetRunner:
    """Process ``n_streams`` independent IQ streams in lockstep.

    n_streams must be a multiple of the device count (each device gets
    n_streams/D receivers).  Each stream has its own carried state and
    its own tune frequency; the parameters/geometry are shared (the
    jitted program is one vmapped step).
    """

    def __init__(self, params: RxParams, n_streams: int,
                 k_steps: int = 8, outputs: tuple = ("audio",),
                 devices=None):
        if devices is None:
            devices = jax.devices()
        d = len(devices)
        assert n_streams % d == 0, (n_streams, d)
        self.mesh = Mesh(np.array(devices), (AXIS,))
        self.params = params
        self.geo = derive_geometry(params)
        self.n = n_streams
        self.k = k_steps
        self.outputs = tuple(outputs)
        self.tables = RxTables.create(self.geo, params)
        one = RxState.create(self.geo, spur=params.spur_enable, pol=params.pol_adapt_enable)
        self.state = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x, (n_streams,) + x.shape).copy(),
            one)
        pw = 2
        if self.geo.second_fft_enable:
            from ..ops.blanker import BlankerTables
            _, pw = BlankerTables.create(self.geo)
        step = make_rx_step(self.geo, params, blanker_pulsewidth=pw,
                            fractional_tune=True)
        vstep = jax.vmap(step, in_axes=(None, 0, 0, 0, 0))
        fields = self.outputs

        def run_k(tables, state, blocks, tune_bins, tune_fracs):
            # blocks: (K, R, S, C); state/tune_bins batched over R
            def body(s, blk):
                s, out = vstep(tables, s, blk, tune_bins, tune_fracs)
                return s, tuple(getattr(out, f) for f in fields)

            return jax.lax.scan(body, state, blocks)

        self._run_k = jax.jit(run_k, donate_argnums=(1,))
        self._tune_bins = jnp.zeros((n_streams,), jnp.int32)
        self._tune_fracs = jnp.zeros((n_streams,), jnp.float32)
        self._stream_sharding = NamedSharding(self.mesh,
                                              P(None, AXIS, None, None))
        state_sharding = jax.tree_util.tree_map(
            lambda x: NamedSharding(
                self.mesh, P(AXIS, *([None] * (x.ndim - 1)))), self.state)
        self.state = jax.device_put(self.state, state_sharding)

    def tune(self, freqs_hz) -> None:
        """Per-stream tune frequencies (scalar broadcasts); continuous
        like Receiver.tune (fractional-bin mixer ramp)."""
        f = np.broadcast_to(np.asarray(freqs_hz, np.float64), (self.n,))
        n = self.geo.fftx_size
        fs = self.geo.timf1_sampling_speed
        t1 = f / fs * n
        bins = np.round(t1).astype(np.int64)
        self._tune_fracs = jnp.asarray(t1 - bins, jnp.float32)
        self._tune_bins = jnp.asarray(bins % n, jnp.int32)

    @property
    def samples_per_call(self) -> int:
        return self.k * self.geo.samples_per_step

    def process(self, iq: np.ndarray) -> dict[str, np.ndarray]:
        """iq: (n_streams, T) or (n_streams, T, C).  Returns output
        streams stacked (n_streams, T_out, C); trailing samples short of
        a K-step call are dropped."""
        if iq.ndim == 2:
            iq = iq[:, :, None]
        assert iq.shape[0] == self.n, (iq.shape, self.n)
        s = self.geo.samples_per_step
        per = self.samples_per_call
        collected: dict[str, list] = {f: [] for f in self.outputs}
        for i in range(iq.shape[1] // per):
            seg = jnp.asarray(iq[:, i * per:(i + 1) * per],
                              jnp.complex64)
            # (R, K*S, C) -> (K, R, S, C)
            blocks = jnp.moveaxis(
                seg.reshape(self.n, self.k, s, self.geo.channels), 0, 1)
            blocks = jax.device_put(blocks, self._stream_sharding)
            self.state, outs = self._run_k(self.tables, self.state,
                                           blocks, self._tune_bins,
                                           self._tune_fracs)
            for f, v in zip(self.outputs, outs):
                a = np.asarray(v)             # (K, R, S_f, C)
                collected[f].append(
                    np.moveaxis(a, 0, 1).reshape(self.n, -1, a.shape[-1]))
        return {f: (np.concatenate(v, axis=1) if v
                    else np.zeros((self.n, 0, 1)))
                for f, v in collected.items()}
