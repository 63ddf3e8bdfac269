"""pjit'd radiation steps over a device mesh.

Replaces the reference's serial ``do iplon = 1, ncol`` column loop
(rrtmg_lw_rad.f90:486) with a single XLA program partitioned by GSPMD:
inputs/outputs sharded over ``columns``, the (B, L, 140) spectral
intermediates optionally sharded over ``spec`` (the band-weighted flux
reduction then becomes an automatic psum over ``spec``).
"""

from __future__ import annotations

import jax

from jax.sharding import PartitionSpec as P

from .mesh import COLUMNS, SPEC, batch_sharding, shardings_for, \
    spec_sharding


def _pspecs_for(tree, mesh):
    """Matching pytree of PartitionSpecs (for shard_map in_specs).
    ``None`` sub-trees (clouds=None, optional Atmosphere fields) map to
    None specs — shard_map sees them as empty pytrees."""
    return jax.tree_util.tree_map(
        lambda s: None if s is None else s.spec,
        shardings_for(tree, mesh), is_leaf=lambda x: x is None)


def _forward(model, mesh, use_shard_map=None):
    """``(atm, clouds) -> Fluxes`` over the mesh.

    ``use_shard_map``: run the model per shard under ``jax.shard_map``
    instead of whole-program GSPMD.  The physics is independent per
    column, so per-shard execution is exact, and it is what keeps the
    Pallas RT kernel per shard (GSPMD cannot partition a pallas_call).
    Default: on when the model runs the Pallas RT sweep and there is no
    spectral partition (with one, the model keeps the XLA sweep).
    """
    if use_shard_map is None:
        use_shard_map = (getattr(model, "rt_pallas", False)
                         and mesh.shape[SPEC] == 1)
    if use_shard_map:
        def fwd(atm, clouds=None):
            f = jax.shard_map(
                lambda a, c: model(a, c, spec_constraint=None),
                mesh=mesh,
                in_specs=(_pspecs_for(atm, mesh),
                          _pspecs_for(clouds, mesh)),
                out_specs=P(COLUMNS), check_vma=False)
            return f(atm, clouds)
        return fwd

    # Call-scoped (not a model mutation): the same model instance can
    # serve steps compiled for several meshes concurrently.
    spec_c = spec_sharding(mesh) if mesh.shape[SPEC] > 1 else None

    def fwd(atm, clouds=None):
        return model(atm, clouds, spec_constraint=spec_c)
    return fwd


def make_sharded_step(model, mesh, donate: bool = False,
                      use_shard_map: bool | None = None):
    """jit-compile ``model(atm, clouds) -> Fluxes`` over the mesh.

    Inputs are placed by ``shard_batch`` (layout aware: batch-first
    leaves shard axis 0, compact cloud masks their last axis);
    jit inherits those shardings, so any cloud layout works.
    ``use_shard_map``: see ``_forward``.
    """
    return jax.jit(_forward(model, mesh, use_shard_map),
                   out_shardings=batch_sharding(mesh),
                   donate_argnums=(0,) if donate else ())


def make_sharded_grad_step(model, mesh, loss_fn=None,
                           use_shard_map: bool | None = None):
    """Differentiable radiation: grad of a scalar flux objective w.r.t.
    the atmospheric state (new capability — the reference is
    forward-only).  Default objective: mean total-sky heating rate
    squared (exercises the full backward pass through taumol + scans).
    """
    fwd = _forward(model, mesh, use_shard_map)
    if loss_fn is None:
        def loss_fn(fl):
            return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()

    def step(atm, clouds=None):
        return jax.value_and_grad(lambda a: loss_fn(fwd(a, clouds)))(atm)

    # inputs are placed layout-aware by shard_batch (a blanket
    # in_shardings would shard the L axis of compact cloud masks over
    # columns); jit inherits the argument shardings.
    # The gradient mirrors the batch-first Atmosphere tree -> bs.
    return jax.jit(step, out_shardings=(None, batch_sharding(mesh)))


def make_wire_step(model, mesh):
    """jit: decode the streaming wire (``parallel.wire``: atmosphere +
    compact clouds, sanitized) inside the sharded step.  Called as
    ``step(wire_atm, wire_clouds, tauaer)``; ``Fluxes.wire_ok`` flags
    the columns whose inputs the decoder replaced."""
    from . import wire
    fwd = _forward(model, mesh)

    def step(wire_atm, wire_clouds, tauaer):
        a, ok_a = wire.decode_atmosphere(wire_atm, tauaer, sanitize=True)
        c, ok_c = wire.decode_compact_clouds(wire_clouds, sanitize=True)
        return fwd(a, c)._replace(wire_ok=ok_a & ok_c)

    return jax.jit(step, out_shardings=batch_sharding(mesh))
