from .mesh import (COLUMNS, SPEC, batch_sharding,
                   global_batch_from_host_shards, make_mesh, replicated,
                   shard_batch, spec_sharding)
from .api import make_sharded_grad_step, make_sharded_step, make_wire_step
from .metrics import flux_error_norms, flux_stats, make_metrics_fn
from .stream import prefetch, run_epoch
from . import wire

__all__ = [
    "COLUMNS", "SPEC", "batch_sharding", "make_mesh", "replicated",
    "shard_batch", "spec_sharding", "global_batch_from_host_shards",
    "make_sharded_step",
    "make_sharded_grad_step", "make_wire_step", "prefetch", "run_epoch",
    "flux_stats", "flux_error_norms", "make_metrics_fn", "wire",
]
