"""AGC — peak tracking with attack / release / hang.

JAX form of the reference AGC (mix2.c:1517-1620; factor
derivation baseb_graph.c:435-437).  The release recurrence
``env[t] = max(|x[t]|, r * env[t-1])`` is a max-plus associative scan
(utils/scanops.decay_max); hang is a causal sliding-window max before the
release tracker; attack is a one-pole smoothing of the *gain* so gain
reductions engage within the attack time constant while the envelope
itself responds instantly (the reference achieves the same with its
delayed signal path + hang list).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from ..utils.scanops import decay_max, one_pole, sliding_max


@pytree_dataclass
class AGCState:
    env: jax.Array   # (C,) float32 — release-tracked envelope
    gain: jax.Array  # (C,) float32 — smoothed gain

    @classmethod
    def create(cls, channels: int) -> "AGCState":
        return cls(env=jnp.full((channels,), 1e-6, jnp.float32),
                   gain=jnp.ones((channels,), jnp.float32))


def agc(state: AGCState, x: jax.Array, fs: float, attack_ms: float,
        release_ms: float, hang_ms: float = 0.0, target: float = 1.0
        ) -> tuple[AGCState, jax.Array, jax.Array]:
    """Apply AGC to audio (S, C) float32 (or complex baseband).

    Returns (new_state, audio_out, gain_series)."""
    mag = jnp.abs(x).astype(jnp.float32)
    if hang_ms > 0:
        hang_n = max(1, int(fs * hang_ms * 1e-3))
        mag = sliding_max(mag, hang_n, axis=0)
    release = jnp.float32(0.5 ** (1e3 / (fs * max(release_ms, 1e-3))))
    env, env_last = decay_max(jnp.maximum(mag, 1e-9), release, state.env,
                              axis=0)
    raw_gain = target / env
    attack = jnp.float32(0.5 ** (1e3 / (fs * max(attack_ms, 1e-3))))
    gain, gain_last = one_pole(raw_gain, attack, state.gain, axis=0)
    # never exceed the instantaneous safe gain (fast attack on peaks)
    gain = jnp.minimum(gain, raw_gain * 1.412)
    out = x * gain.astype(x.dtype)
    return AGCState(env=env_last, gain=gain_last), out, gain
