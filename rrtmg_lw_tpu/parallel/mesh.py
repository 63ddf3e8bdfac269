"""Device mesh + sharding layout for the column batch.

The reference processes columns in a serial loop
(``rrtmg_lw_rad.f90:486``) with no parallelism of any kind (SURVEY §2.4).
The design shards the *column batch* (pure data parallelism — the
physics is fully independent per column) and optionally the *spectral
g-point axis* (a model-parallel-like split: each device computes a slice
of the 140 g-points and the band-weighted flux sum becomes a psum over
the ``spec`` axis, inserted automatically by GSPMD from the sharding
constraint).

Axes:
  columns — batch data parallelism (embarrassingly parallel)
  spec    — spectral partition of the g-point axis
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

COLUMNS = "columns"
SPEC = "spec"


def make_mesh(devices: Optional[Sequence] = None, spec: int = 1) -> Mesh:
    """1-D (columns) or 2-D (columns, spec) device mesh."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n % spec != 0:
        raise ValueError(f"{n} devices not divisible by spec={spec}")
    arr = np.asarray(devices).reshape(n // spec, spec)
    return Mesh(arr, (COLUMNS, SPEC))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (columns) of a batch array; replicate the rest."""
    return NamedSharding(mesh, P(COLUMNS))


def spec_sharding(mesh: Mesh) -> NamedSharding:
    """(B, L, G) intermediate: columns on axis 0, g-points on axis -1."""
    return NamedSharding(mesh, P(COLUMNS, None, SPEC))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shardings_for(tree, mesh: Mesh):
    """Matching pytree of NamedShardings with the columns axis placed
    per leaf layout: batch-first (B, ...) leaves shard axis 0; the
    compact cloud layout carries columns on the LAST axis of its
    (L, G_pad, B) mask."""
    from ..types import McicaCloudsCompact
    from .wire import WireBatch
    bs = batch_sharding(mesh)
    last = NamedSharding(mesh, P(None, None, COLUMNS))
    if isinstance(tree, McicaCloudsCompact):
        return McicaCloudsCompact(last, bs, bs, bs, bs)
    if isinstance(tree, WireBatch):
        # codes shard over columns; reference profiles replicate
        rep = replicated(mesh)
        return WireBatch(
            {k: bs for k in tree.cols},
            jax.tree_util.tree_map(lambda x: rep, tree.refs))
    from .wire import CompactCloudsWire
    if isinstance(tree, CompactCloudsWire):
        return CompactCloudsWire(last, shardings_for(tree.fields, mesh))
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return type(tree)(shardings_for(t, mesh) for t in tree)
    if isinstance(tree, dict):
        return {k: shardings_for(t, mesh) for k, t in tree.items()}
    return jax.tree_util.tree_map(lambda x: bs, tree)


def shard_batch(tree, mesh: Mesh):
    """Device-put every leaf with its column-batch sharding (layout
    aware — see shardings_for)."""
    sh = shardings_for(tree, mesh)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), tree, sh)


def global_batch_from_host_shards(mesh: Mesh, per_host_arrays):
    """Multi-host entry: assemble a jax.Array from per-host shards.

    Each host passes the column shard it loaded; the result is a global
    array sharded over the ``columns`` axis (host boundary handled by the
    JAX runtime).  Layout aware like shard_batch: compact cloud masks
    concatenate hosts along their LAST (column) axis, batch-first
    leaves along axis 0.  Single-host fallback: equivalent to
    shard_batch.
    """
    from jax.experimental import multihost_utils
    specs = jax.tree_util.tree_map(
        lambda s: None if s is None else s.spec,
        shardings_for(per_host_arrays, mesh),
        is_leaf=lambda x: x is None)
    return multihost_utils.host_local_array_to_global_array(
        per_host_arrays, mesh, specs)
