"""Multi-host ingest: one host reads the recording, every host computes.

The reference's multi-machine story is UDP multicast of stage payloads
(network.c, z_NETWORK.txt); the JAX equivalent across hosts is
host-0 file ingest + a global sharded array per step, with XLA moving
the shards host-to-host over the network and device-to-device over
the host's interconnect
(SURVEY.md §7: "host 0 reads file, make_array_from_process_local_data
scatter").

Usage (same script on every host, after jax.distributed.initialize):

    mesh = global_time_mesh()
    for block in read_blocks_on_host0(path, geo):   # None off host 0
        garr = scatter_step_block(mesh, geo, block)
        state, out = sharded_step(tables, state, garr, tune)

On a single process (this repo's test environment) the helpers degrade
to ordinary device_put, so the code path is testable without a pod.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..geometry import Geometry

AXIS = "t"


def global_time_mesh(devices=None) -> Mesh:
    """A 1-D mesh over every device of every host (XLA picks the
    transport per edge)."""
    if devices is None:
        devices = jax.devices()          # global across processes
    return Mesh(np.array(devices), (AXIS,))


def scatter_step_block(mesh: Mesh, geo: Geometry,
                       local_block: np.ndarray | None) -> jax.Array:
    """Turn host-0's step block into a global array sharded along time.

    local_block: the full (samples_per_step, C) block on host 0; other
    hosts pass their share or None.  Single-process: plain device_put.
    With multiple processes each host must pass the rows its devices
    own (jax.make_array_from_process_local_data contract); a None from
    a non-reader host raises — stream the file bytes to every host
    (io/taps.py TapSender, format NET_RXIN_RAW16) or use a shared
    filesystem so each host can read its slice.
    """
    sharding = NamedSharding(mesh, P(AXIS, None))
    if jax.process_count() == 1:
        assert local_block is not None
        return jax.device_put(jnp.asarray(local_block, jnp.complex64),
                              sharding)
    if local_block is None:
        raise ValueError(
            "every host must supply its local rows; ship the raw block "
            "to the other hosts first (io.taps multicast or shared fs)")
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_block, np.complex64))


def host_rows(mesh: Mesh, geo: Geometry) -> tuple[int, int]:
    """The [start, stop) sample rows of a step block that this host's
    devices own under P(AXIS, None) sharding — what a per-host reader
    should load from the recording for the current step."""
    d = mesh.shape[AXIS]
    per = geo.samples_per_step // d
    devs = [dev for dev in mesh.devices.flat
            if dev.process_index == jax.process_index()]
    idxs = sorted(list(mesh.devices.flat).index(dev) for dev in devs)
    return idxs[0] * per, (idxs[-1] + 1) * per
