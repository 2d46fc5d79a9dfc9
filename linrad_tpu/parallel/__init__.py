"""Multi-chip / multi-host scaling — the replacement for Linrad's
UDP-multicast distributed operation (reference network.c, SURVEY.md §2.6).

Where Linrad splits the pipeline across machines at stage boundaries via
multicast taps, this framework shards the *time-block batch* of every
stage across a ``jax.sharding.Mesh`` and exchanges the overlap-save
halos and overlap-add carries between neighbouring shards with
``lax.ppermute`` collectives (SURVEY.md §7 sharding design)."""

from .fleet import FleetRunner
from .multihost import global_time_mesh, host_rows, scatter_step_block
from .sharded import (ShardedBatchRunner, ShardedMultiReceiver,
                      ShardedReceiver, make_sharded_multi_rx_step,
                      make_sharded_rx_step)

__all__ = ["ShardedReceiver", "ShardedMultiReceiver",
           "ShardedBatchRunner", "FleetRunner",
           "make_sharded_rx_step", "make_sharded_multi_rx_step",
           "global_time_mesh", "scatter_step_block", "host_rows"]
