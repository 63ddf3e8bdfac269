"""Deterministic synthetic inputs (atmospheres, clouds) for tests/benchmarks.

These are physically-plausible analytic profiles — NOT the reference's
standard atmospheres (those live in the column-mode RRTATM port,
rrtmg_lw_tpu.io.atmospheres). They exist so every part of the framework
can be exercised end-to-end without external data.

All arrays are returned as HOST numpy arrays: these generators feed
the streaming pipeline (parallel.stream.prefetch / shard_batch does
the one H2D transfer), and a jnp.asarray here would ship every
intermediate to the device.  JAX consumes numpy-backed pytrees as jit
arguments transparently.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..types import (Atmosphere, BandClouds, McicaClouds,
                     McicaCloudsCompact)


def make_atmosphere(ncol=4, nlay=51, seed=0, dtype=jnp.float64,
                    aod=0.0):
    """A smooth, physically-plausible batch of mid-latitude-ish columns.

    ``aod`` > 0 fills tauaer with a boundary-layer aerosol: total
    column optical depth ~aod per band, decaying over ~2 km (the
    IN_AER_RRTM examples put 12 layers of per-band AOD near the
    surface)."""
    rng = np.random.default_rng(seed)
    # sigma-coordinate pressure levels, surface ~1013 mb to 0.03 mb;
    # the top is reached exactly (no clamp: a floor would collapse the
    # topmost layers to zero thickness at large nlay -> coldry = 0)
    lev = np.linspace(0, 1, nlay + 1)
    plev = 1013.0 * (0.03 / 1013.0) ** (lev ** 1.15)
    plev = np.broadcast_to(plev, (ncol, nlay + 1)).copy()
    plev *= (1.0 + 0.02 * rng.standard_normal((ncol, 1)))
    play = 0.5 * (plev[:, :-1] + plev[:, 1:])

    # temperature: lapse to tropopause at ~12 km, warming stratosphere
    z = -7.0 * np.log(play / plev[:, :1])
    tsfc = 288.0 + 5.0 * rng.standard_normal(ncol)
    tlay = np.where(z < 12.0, tsfc[:, None] - 6.5 * z,
                    np.where(z < 20.0, tsfc[:, None] - 6.5 * 12.0,
                             tsfc[:, None] - 78.0 + 1.5 * (z - 20.0)))
    tlay = np.clip(tlay, 180.0, 320.0)
    zlev = -7.0 * np.log(plev / plev[:, :1])
    tlev = np.where(zlev < 12.0, tsfc[:, None] - 6.5 * zlev,
                    np.where(zlev < 20.0, tsfc[:, None] - 6.5 * 12.0,
                             tsfc[:, None] - 78.0 + 1.5 * (zlev - 20.0)))
    tlev = np.clip(tlev, 180.0, 320.0)

    h2o = 0.02 * (play / 1013.0) ** 3 + 3e-6
    o3 = 1e-6 * np.exp(-((np.log(play) - np.log(10.0)) ** 2) / 2.0) + 1e-8

    ones = np.ones_like(play)

    tauaer = np.zeros((ncol, nlay, 16))
    if aod > 0.0:
        w = np.exp(-z / 2.0)                    # boundary-layer decay
        w /= w.sum(axis=1, keepdims=True)
        band = 1.0 - 0.4 * np.arange(16) / 15.0     # mild spectral slope
        tauaer = aod * w[:, :, None] * band

    def arr(x):
        return np.asarray(x, dtype)

    return Atmosphere(
        play=arr(play), plev=arr(plev), tlay=arr(tlay), tlev=arr(tlev),
        tsfc=arr(tsfc),
        h2ovmr=arr(h2o), co2vmr=arr(3.55e-4 * ones), o3vmr=arr(o3),
        n2ovmr=arr(3.2e-7 * ones), covmr=arr(1.5e-7 * ones),
        ch4vmr=arr(1.7e-6 * ones), o2vmr=arr(0.209 * ones),
        cfc11vmr=arr(2.6e-10 * ones), cfc12vmr=arr(5.4e-10 * ones),
        cfc22vmr=arr(1.0e-10 * ones), ccl4vmr=arr(1.0e-10 * ones),
        emis=arr(np.full((ncol, 16), 0.95)),
        tauaer=arr(tauaer),
    )


def make_band_clouds(ncol=4, nlay=51, seed=1, dtype=jnp.float64):
    """A plausible two-deck per-band cloud state (non-McICA paths)."""
    rng = np.random.default_rng(seed)
    cldfrac = np.zeros((ncol, nlay))
    ciwp = np.zeros((ncol, nlay))
    clwp = np.zeros((ncol, nlay))
    lo = 3 + rng.integers(0, 3, ncol)
    hi = nlay // 2 + rng.integers(0, 3, ncol)
    cols = np.arange(ncol)
    # clip to the top layer for tiny nlay (the old slice assignments
    # silently clipped out-of-range layers; keep that tolerance)
    lo_rows = np.minimum(lo[:, None] + np.arange(3), nlay - 1)  # (ncol, 3)
    hi_rows = np.minimum(hi[:, None] + np.arange(2), nlay - 1)  # (ncol, 2)
    cldfrac[cols[:, None], lo_rows] = \
        (0.4 + 0.4 * rng.random((ncol, 1)))
    clwp[cols[:, None], lo_rows] = \
        (20.0 + 30.0 * rng.random((ncol, 1)))
    cldfrac[cols[:, None], hi_rows] = \
        (0.3 + 0.5 * rng.random((ncol, 1)))
    ciwp[cols[:, None], hi_rows] = \
        (10.0 + 20.0 * rng.random((ncol, 1)))

    def arr(x):
        return np.asarray(x, dtype)

    return BandClouds(
        cldfrac=arr(cldfrac), tauc=arr(np.zeros((ncol, nlay, 16))),
        ciwp=arr(ciwp), clwp=arr(clwp),
        reic=arr(np.full((ncol, nlay), 30.0)),
        relq=arr(np.full((ncol, nlay), 10.0)))


def make_mcica_clouds(ncol=4, nlay=51, seed=2, dtype=jnp.float64,
                      ngpt=140, layout="batch", mask_dtype=None,
                      clear_frac=0.0):
    """A plausible binary per-g-point McICA cloud state (for tests/bench
    that don't exercise the stochastic generator itself).

    layout="compact" emits the generator form (McicaCloudsCompact,
    mask in the g-major (L, NGPT_PAD, B) layout).  ``clear_frac``
    leaves that fraction of columns cloud-free (mixed GCM-mode
    populations)."""
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == jnp.float32 else np.float64
    lo = 3 + rng.integers(0, 3, ncol)
    first = int(round(clear_frac * ncol))
    ncld = ncol - first
    cols = np.arange(first, ncol)
    rows = np.minimum(lo[cols, None] + np.arange(4), nlay - 1)  # (ncld, 4)
    if ncld:
        m = rng.random((ncld, 4, ngpt)) < 0.6
        cw = 25.0 + 20.0 * rng.random((ncld, 1, 1))
        ci = 5.0 * rng.random((ncld, 1, 1))
    else:
        m = np.zeros((0, 4, ngpt), bool)
        cw = ci = np.zeros((0, 1, 1))

    def arr(x):
        return np.asarray(x, dtype)

    reic = np.full((ncol, nlay), 30.0)
    relq = np.full((ncol, nlay), 10.0)
    gp = -(-ngpt // 8) * 8

    if layout == "compact":
        # generator form: binary mask + per-layer water paths (the
        # synthetic per-g paths are constant across g inside a layer
        # by construction, like mcica_subcol_lw's outputs).  Only the
        # ~4 cloudy layers per column are written, so no (B, L, G)
        # transpose/pad pass over the mostly zero batch layout is
        # materialized.
        mask = np.zeros((nlay, gp, ncol),
                        npdt if mask_dtype is None else mask_dtype)
        for j in range(4):                 # 4 scattered row-writes
            mask[rows[:, j], :ngpt, cols] = m[:, j, :]
        anyc = m.any(axis=2)                        # (ncld, 4)
        ciwp_l = np.zeros((ncol, nlay))
        clwp_l = np.zeros((ncol, nlay))
        ciwp_l[cols[:, None], rows] = np.where(anyc, ci[:, :, 0], 0.0)
        clwp_l[cols[:, None], rows] = np.where(anyc, cw[:, :, 0], 0.0)
        return McicaCloudsCompact(
            cldfmc=mask, ciwp=arr(ciwp_l), clwp=arr(clwp_l),
            reicmc=arr(reic), relqmc=arr(relq))
    if layout != "batch":
        raise ValueError(f"layout={layout!r}")
    cldf = np.zeros((ncol, nlay, ngpt), npdt)
    ciwp = np.zeros((ncol, nlay, ngpt), npdt)
    clwp = np.zeros((ncol, nlay, ngpt), npdt)
    if ncld:
        cldf[cols[:, None], rows] = m
        clwp[cols[:, None], rows] = np.where(m, cw, 0.0)
        ciwp[cols[:, None], rows] = np.where(m, ci, 0.0)
    tauc = np.zeros((ncol, nlay, ngpt), npdt)
    return McicaClouds(
        cldfmc=arr(cldf), ciwpmc=arr(ciwp), clwpmc=arr(clwp),
        taucmc=arr(tauc), reicmc=arr(reic), relqmc=arr(relq))


def make_cloud_profile_fields(ncol=4, nlay=51, seed=0):
    """(B, L) cloud profile fields {cldfrac, ciwp, clwp, rei, rel} —
    the device-side McICA generator's inputs (mcica_subcol_lw_compact).
    One 4-layer deck of partial cloud per column; the SINGLE source for
    the streaming bench, the wire tests, the on-chip verify and the
    examples (previously four hand-mirrored copies)."""
    rng = np.random.default_rng(seed)
    cldfrac = np.zeros((ncol, nlay), np.float32)
    lo = 3 + rng.integers(0, 3, ncol)
    rows = np.minimum(lo[:, None] + np.arange(4), nlay - 1)
    cols = np.arange(ncol)[:, None]
    cldfrac[cols, rows] = (0.3 + 0.5 * rng.random((ncol, 1))
                           ).astype(np.float32)
    wet = cldfrac > 0
    return dict(
        cldfrac=cldfrac,
        ciwp=np.where(wet, 20.0 + 15.0 * rng.random((ncol, nlay)),
                      0.0).astype(np.float32),
        clwp=np.where(wet, 15.0 + 10.0 * rng.random((ncol, nlay)),
                      0.0).astype(np.float32),
        rei=np.full((ncol, nlay), 25.0, np.float32),
        rel=np.full((ncol, nlay), 12.0, np.float32))
