"""Pytree types for the batched LW radiation framework.

Batched layout conventions:
  * leading axis = columns (the batch / sharded axis),
  * then layers (bottom -> top, matching the reference's vertical indexing,
    rrtmg_lw_rad.f90:785-795),
  * g-points or bands LAST (vector lanes).

All types are NamedTuples (automatic pytrees).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

NBANDS = 16
NGPT = 140
NMOL = 7


class Atmosphere(NamedTuple):
    """GCM-style input state (vmr units; pressures hPa; temperatures K).

    Mirrors the argument list of ``rrtmg_lw`` (rrtmg_lw_rad.f90:99-125).
    """
    play: jnp.ndarray          # (B, L)
    plev: jnp.ndarray          # (B, L+1)   bottom -> top
    tlay: jnp.ndarray          # (B, L)
    tlev: jnp.ndarray          # (B, L+1)
    tsfc: jnp.ndarray          # (B,)
    h2ovmr: jnp.ndarray        # (B, L)
    co2vmr: jnp.ndarray        # (B, L)
    o3vmr: jnp.ndarray         # (B, L)
    n2ovmr: jnp.ndarray        # (B, L)
    covmr: jnp.ndarray         # (B, L)  (zero in GCM mode; column mode reads it)
    ch4vmr: jnp.ndarray        # (B, L)
    o2vmr: jnp.ndarray         # (B, L)
    cfc11vmr: jnp.ndarray      # (B, L)
    cfc12vmr: jnp.ndarray      # (B, L)
    cfc22vmr: jnp.ndarray      # (B, L)
    ccl4vmr: jnp.ndarray       # (B, L)
    emis: jnp.ndarray          # (B, NBANDS)
    tauaer: jnp.ndarray        # (B, L, NBANDS)


class Profile(NamedTuple):
    """Processed per-column profile (output of inatm; molec/cm2 units)."""
    pavel: jnp.ndarray         # (B, L) layer pressure (mb)
    tavel: jnp.ndarray         # (B, L)
    pz: jnp.ndarray            # (B, L+1) level pressure (mb), pz[:,0]=surface
    tz: jnp.ndarray            # (B, L+1)
    tbound: jnp.ndarray        # (B,)
    semiss: jnp.ndarray        # (B, NBANDS)
    coldry: jnp.ndarray        # (B, L) dry-air column (molec/cm2)
    wkl: jnp.ndarray           # (B, L, NMOL) molecular amounts (molec/cm2)
    wbrodl: jnp.ndarray        # (B, L) broadening-gas column
    wx: jnp.ndarray            # (B, L, 4) xsec amounts * 1e-20
    pwvcm: jnp.ndarray         # (B,) precipitable water (cm)
    taua: jnp.ndarray          # (B, L, NBANDS) aerosol od per band
    dtbound: Optional[jnp.ndarray] = None  # (B,) surface dT for idrv adjust


class McicaClouds(NamedTuple):
    """Per-g-point stochastic cloud state (McICA)."""
    cldfmc: jnp.ndarray        # (B, L, NGPT) 0/1 cloud fraction
    ciwpmc: jnp.ndarray        # (B, L, NGPT) in-cloud ice water path
    clwpmc: jnp.ndarray        # (B, L, NGPT)
    taucmc: jnp.ndarray        # (B, L, NGPT) in-cloud optical depth
    reicmc: jnp.ndarray        # (B, L)
    relqmc: jnp.ndarray        # (B, L)


NGPT_PAD = 144             # NGPT padded to a multiple of 8


class McicaCloudsCompact(NamedTuple):
    """Generator-form McICA clouds: the binary sub-column mask at g
    resolution, g-major and column-last like the reference's
    cldfmcl(ngptlw, ncol, nlay), plus per-layer water paths.  The
    stochastic generator constructs ciwpmcl/clwpmcl exactly as
    ``per-layer value x binary mask`` (mcica_subcol_gen_lw.f90:655-668),
    so carrying the factors instead of the products is numerically
    identical at ~1/4 the bytes of the per-g McicaClouds (it is the
    streaming wire's cloud form, parallel/wire.py).  Valid for the
    inflag=2 parameterized-optics path (ice/liquid water paths; per-g taucmc is identically zero
    there — rrtmg_lw_cldprmc.f90:128-142)."""
    cldfmc: jnp.ndarray        # (L, NGPT_PAD, B) 0/1 mask (f32 or int8)
    ciwp: jnp.ndarray          # (B, L) in-cloud ice water path
    clwp: jnp.ndarray          # (B, L) in-cloud liquid water path
    reicmc: jnp.ndarray        # (B, L)
    relqmc: jnp.ndarray        # (B, L)

    def to_batch(self) -> "McicaClouds":
        """Form the per-g products in the (B, L, NGPT) batch layout."""
        m = jnp.transpose(self.cldfmc[:, :NGPT, :], (2, 0, 1)).astype(
            self.ciwp.dtype)
        return McicaClouds(m, self.ciwp[..., None] * m,
                           self.clwp[..., None] * m, jnp.zeros_like(m),
                           self.reicmc, self.relqmc)


class BandClouds(NamedTuple):
    """Per-band deterministic cloud state (non-McICA paths)."""
    cldfrac: jnp.ndarray       # (B, L)
    tauc: jnp.ndarray          # (B, L, NBANDS) input cloud od
    ciwp: jnp.ndarray          # (B, L)
    clwp: jnp.ndarray          # (B, L)
    reic: jnp.ndarray          # (B, L)
    relq: jnp.ndarray          # (B, L)


class SetcoefOut(NamedTuple):
    """Interpolation indices/fractions + Planck sources (setcoef.f90:50-434).

    Index arrays are 0-based here (Fortran 1-based minus 1).
    """
    laytrop_mask: jnp.ndarray  # (B, L) True below the ~100mb switch
    jp: jnp.ndarray            # (B, L) int32, 0-based (0..57)
    jt: jnp.ndarray            # (B, L) int32, 0-based (0..3)
    jt1: jnp.ndarray           # (B, L)
    planklay: jnp.ndarray      # (B, L, NBANDS)
    planklev: jnp.ndarray      # (B, L+1, NBANDS)
    plankbnd: jnp.ndarray      # (B, NBANDS)
    dplankbnd_dt: jnp.ndarray  # (B, NBANDS)
    colh2o: jnp.ndarray        # (B, L)  (units 1e20 molec/cm2)
    colco2: jnp.ndarray
    colo3: jnp.ndarray
    coln2o: jnp.ndarray
    colco: jnp.ndarray
    colch4: jnp.ndarray
    colo2: jnp.ndarray
    colbrd: jnp.ndarray
    fac00: jnp.ndarray         # (B, L)
    fac01: jnp.ndarray
    fac10: jnp.ndarray
    fac11: jnp.ndarray
    rat_h2oco2: jnp.ndarray    # (B, L) paired ratios at jp and jp+1
    rat_h2oco2_1: jnp.ndarray
    rat_h2oo3: jnp.ndarray
    rat_h2oo3_1: jnp.ndarray
    rat_h2on2o: jnp.ndarray
    rat_h2on2o_1: jnp.ndarray
    rat_h2och4: jnp.ndarray
    rat_h2och4_1: jnp.ndarray
    rat_n2oco2: jnp.ndarray
    rat_n2oco2_1: jnp.ndarray
    rat_o3co2: jnp.ndarray
    rat_o3co2_1: jnp.ndarray
    selffac: jnp.ndarray       # (B, L)
    selffrac: jnp.ndarray
    indself: jnp.ndarray       # (B, L) int32 0-based
    forfac: jnp.ndarray
    forfrac: jnp.ndarray
    indfor: jnp.ndarray        # int32 0-based
    minorfrac: jnp.ndarray
    scaleminor: jnp.ndarray
    scaleminorn2: jnp.ndarray
    indminor: jnp.ndarray      # int32 0-based


class Fluxes(NamedTuple):
    """Outputs (W/m2, K/day); level axis bottom->top, size L+1."""
    uflx: jnp.ndarray          # (B, L+1) total-sky upward flux
    dflx: jnp.ndarray          # (B, L+1)
    hr: jnp.ndarray            # (B, L)   heating rate
    uflxc: jnp.ndarray         # (B, L+1) clear-sky
    dflxc: jnp.ndarray         # (B, L+1)
    hrc: jnp.ndarray           # (B, L)
    duflx_dt: Optional[jnp.ndarray] = None   # (B, L+1)
    duflxc_dt: Optional[jnp.ndarray] = None  # (B, L+1)
    # per-(column, layer) input-validity diagnostic: False where cloud
    # particle sizes were outside the parameterization range and were
    # clamped.  The reference hard-stops instead
    # (rrtmg_lw_cldprmc.f90:204-253); a jitted batched kernel cannot,
    # so the flag is surfaced for post-hoc checking.
    cld_bounds_ok: Optional[jnp.ndarray] = None  # (B, L) bool
    # per-column bool (B,): False where the streaming wire decode
    # (parallel/wire.py, sanitize=True) replaced corrupted inputs —
    # non-finite references/ranges or physically impossible decoded
    # values — with finite fallbacks.  The ingest step threads the
    # decoder's ok flag here so corruption at the production wire
    # boundary is flagged, never silently propagated as NaN fluxes.
    wire_ok: Optional[jnp.ndarray] = None
