"""Multi-device scale-out: the sharded steps and the mesh session."""
from .session import ShardedSession  # noqa: F401
from .sharding import (make_mesh, make_sharded_decay_step,  # noqa: F401
                       make_sharded_multi, make_sharded_span,
                       make_sharded_step, make_sharded_xfade_step,
                       shard_bank, shard_span_tables, shard_state)
