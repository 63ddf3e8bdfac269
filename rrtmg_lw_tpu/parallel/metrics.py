"""Mesh-global validation / monitoring reductions.

SURVEY §2.4: the only cross-device communication the forward physics
needs is *metric* reduction — flux error norms for validation and
throughput counters — as the computation itself is embarrassingly
parallel over columns.  These helpers reduce column-sharded ``Fluxes``
to replicated scalars inside jit; GSPMD turns the reductions into
``psum``/``pmax`` collectives (NCCL across cards).

The accuracy norms mirror the reference's regression contract
(README.md:19 via SURVEY §4): max-abs flux difference in W/m² and
max-abs heating-rate difference in K/day against a reference solution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mesh import replicated


def flux_stats(fl):
    """Global summary scalars of a (possibly sharded) Fluxes batch.

    Returns a dict of 0-d arrays: column count, OLR (TOA upward flux)
    mean/min/max, surface downward flux mean, mean column radiative
    divergence (net TOA minus net surface, W/m²), and the extreme
    heating rates — the quantities a production monitor watches.
    """
    olr = fl.uflx[:, -1]
    ncol = jnp.asarray(olr.shape[0], jnp.float32)
    net_toa = fl.uflx[:, -1] - fl.dflx[:, -1]
    net_sfc = fl.uflx[:, 0] - fl.dflx[:, 0]
    return {
        "ncol": ncol,
        "olr_mean": olr.mean(), "olr_min": olr.min(),
        "olr_max": olr.max(),
        "sfc_dflx_mean": fl.dflx[:, 0].mean(),
        "col_divergence_mean": (net_toa - net_sfc).mean(),
        "hr_min": fl.hr.min(), "hr_max": fl.hr.max(),
    }


def flux_error_norms(fl, ref):
    """Validation norms of ``fl`` against a reference ``Fluxes``:
    the reference accuracy contract is flux <= 0.5 W/m² and heating
    rate <= 0.1 K/day (max-abs over all columns/levels)."""
    return {
        "uflx_maxabs": jnp.abs(fl.uflx - ref.uflx).max(),
        "dflx_maxabs": jnp.abs(fl.dflx - ref.dflx).max(),
        "hr_maxabs": jnp.abs(fl.hr - ref.hr).max(),
        "uflx_rms": jnp.sqrt(((fl.uflx - ref.uflx) ** 2).mean()),
    }


def make_metrics_fn(mesh, with_reference: bool = False):
    """jit-compiled mesh-global metrics: sharded Fluxes in, replicated
    scalars out (the reductions lower to collectives)."""
    rep = replicated(mesh)

    if with_reference:
        def fn(fl, ref):
            out = flux_stats(fl)
            out.update(flux_error_norms(fl, ref))
            return out
    else:
        def fn(fl):
            return flux_stats(fl)

    # a single sharding broadcasts to every output leaf
    return jax.jit(fn, out_shardings=rep)
