"""Cloud optical depths (per band and per g-point / McICA).

Vectorized equivalents of ``cldprop`` (rrtmg_lw_cldprop.f90:50-295) and
``cldprmc`` (rrtmg_lw_cldprmc.f90:51-273).

Parameterizations (selected by static inflag/iceflag/liqflag):
  ice: 0 CCM3 (absice0), 1 Ebert-Curry 5-region (absice1),
       2 Key/Streamer (absice2, 43x16), 3 Fu generalized size (absice3,
       46x16)
  liq: 0 CCM3 constant (absliq0), 1 Hu & Stamnes (absliq1, 58x16)

The reference hard-stops on out-of-range particle sizes
(cldprmc.f90:204-253); inside jit we clamp instead and return a boolean
``bounds_ok`` diagnostic.

Non-McICA cloud bands: for the configurations where the reference's
runtime ``ncbands`` is statically 16 (``cloud_bands_static``: inflag
0/1, or iceflag 2/3 with liqflag 1 — ipat(iband,2) is the identity,
rrtmg_lw_rtrn.f90:252-254, covering all 14 reference example cases)
``cldprop`` expands cloud optical depth straight to the 16 spectral
bands, which keeps the runtime-valued ``ncbands`` out of the RT hot
path.  The remaining configurations (iceflag 0/1, or liqflag=0) go
through ``cldprop_ncbands`` + ``expand_cloud_bands``, which reproduce
the reference's running-scalar ncbands, the ipat cloud-band mapping,
the secdiff(cloud-band) weighting alias, and the layer-order
dependence exactly (see cldprop_ncbands' docstring).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..types import BandClouds, McicaClouds

CLDMIN = 1.0e-20

# Ebert & Curry 5-region -> RRTM band mapping (cldprmc.f90:164)
ICB = np.array([1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5]) - 1


def _ice_liq_coeffs(reic, relq, iceflag, liqflag, tables, dtype):
    """Per-band ice/liquid absorption coefficients, (B, L, 16) each,
    plus a bounds-ok flag (B, L)."""
    absice0 = jnp.asarray(tables["absice0"], dtype)
    absice1 = jnp.asarray(tables["absice1"], dtype)      # (2, 5)
    absice2 = jnp.asarray(tables["absice2"], dtype)      # (43, 16)
    absice3 = jnp.asarray(tables["absice3"], dtype)      # (46, 16)
    absliq1 = jnp.asarray(tables["absliq1"], dtype)      # (58, 16)
    absliq0 = float(tables["absliq0"])

    ok = jnp.ones(reic.shape, bool)
    if iceflag == 0:
        ok &= reic >= 10.0
        coef = absice0[0] + absice0[1] / jnp.maximum(reic, 10.0)
        abscoice = jnp.broadcast_to(coef[..., None], reic.shape + (16,))
    elif iceflag == 1:
        ok &= (reic >= 13.0) & (reic <= 130.0)
        r = jnp.clip(reic, 13.0, 130.0)
        per_region = absice1[0][None, None, :] + \
            absice1[1][None, None, :] / r[..., None]     # (B, L, 5)
        abscoice = per_region[..., ICB]                  # -> (B, L, 16)
    elif iceflag in (2, 3):
        tab = absice2 if iceflag == 2 else absice3
        rmax = 131.0 if iceflag == 2 else 140.0
        nmax = 43 if iceflag == 2 else 46
        ok &= (reic >= 5.0) & (reic <= rmax)
        factor = (reic - 2.0) / 3.0
        index = factor.astype(jnp.int32)                 # 1-based in ref
        index = jnp.where(index == nmax, nmax - 1, index)
        index = jnp.clip(index, 1, nmax - 1)
        fint = factor - index.astype(dtype)
        lo = jnp.take(tab, index - 1, axis=0)
        hi = jnp.take(tab, index, axis=0)
        abscoice = lo + fint[..., None] * (hi - lo)
    else:
        raise ValueError(f"iceflag {iceflag}")

    if liqflag == 0:
        abscoliq = jnp.full(relq.shape + (16,), absliq0, dtype)
    elif liqflag == 1:
        ok &= (relq >= 2.5) & (relq <= 60.0)
        index = (relq - 1.5).astype(jnp.int32)
        index = jnp.where(index == 0, 1, index)
        index = jnp.where(index == 58, 57, index)
        index = jnp.clip(index, 1, 57)
        fint = relq - 1.5 - index.astype(dtype)
        lo = jnp.take(absliq1, index - 1, axis=0)
        hi = jnp.take(absliq1, index, axis=0)
        abscoliq = lo + fint[..., None] * (hi - lo)
    else:
        raise ValueError(f"liqflag {liqflag}")
    return abscoice, abscoliq, ok


def cldprmc(clouds: McicaClouds, tables: dict, *, inflag: int,
            iceflag: int, liqflag: int):
    """McICA per-g-point cloud optical depth. Returns (taucmc, bounds_ok)."""
    dtype = clouds.taucmc.dtype
    if inflag == 0:
        return clouds.taucmc, jnp.ones(clouds.reicmc.shape, bool)
    if inflag == 1:
        raise ValueError("INFLAG=1 not available with McICA "
                         "(cldprmc.f90:191)")
    abscoice_b, abscoliq_b, ok = _ice_liq_coeffs(
        clouds.reicmc, clouds.relqmc, iceflag, liqflag, tables, dtype)
    ngb = np.asarray(tables["ngb"]) - 1                 # band of g, 0-based
    abscoice = abscoice_b[..., ngb]                     # (B, L, 140)
    abscoliq = abscoliq_b[..., ngb]
    abscoice = jnp.where(clouds.ciwpmc == 0.0, 0.0, abscoice)
    abscoliq = jnp.where(clouds.clwpmc == 0.0, 0.0, abscoliq)
    cwp = clouds.ciwpmc + clouds.clwpmc
    active = (clouds.cldfmc >= CLDMIN) & (
        (cwp >= CLDMIN) | (clouds.taucmc >= CLDMIN))
    taucmc = jnp.where(
        active,
        clouds.ciwpmc * abscoice + clouds.clwpmc * abscoliq,
        clouds.taucmc)
    return taucmc, ok


# rtrn/rtrnmr cloud-band patterns (rrtmg_lw_rtrn.f90:252-254): row 0
# for ncbands=1, row 1 for ncbands=5, row 2 for ncbands=16 (identity)
IPAT = np.array([[1] * 16,
                 [1, 2, 3, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5],
                 list(range(1, 17))]) - 1


def cloud_bands_static(inflag: int, iceflag: int, liqflag: int) -> bool:
    """True when ncbands is statically 16 for every possible cloudy
    layer, making the cloud-band -> spectral-band map the identity
    (rrtmg_lw_cldprop.f90:191,197,229,245,278): inflag 0/1, or
    inflag 2 with a 16-band ice parameterization AND Hu&Stamnes
    liquid (a liquid-only layer under liqflag=0 would leave the
    running ncbands untouched)."""
    return inflag in (0, 1) or (iceflag in (2, 3) and liqflag == 1)


def cldprop_ncbands(clouds: BandClouds, tables: dict, *, inflag: int,
                    iceflag: int, liqflag: int):
    """Faithful ``cldprop`` with the reference's running-scalar
    ``ncbands`` semantics (rrtmg_lw_cldprop.f90:173-295) for the
    configurations where the cloud-band space is NOT statically the
    16 spectral bands (inflag=2 with iceflag 0/1, or liqflag=0).

    Per cloudy layer the reference assigns ncbands (5 for an
    Ebert&Curry ice layer, 16 when Hu&Stamnes liquid is present, both
    in that order) and then writes ``taucloud(lay, 1..ncbands)`` with
    the *current* value — so a layer whose composition assigns nothing
    (pure ice with iceflag=0, or liquid-only with liqflag=0) writes
    only as many slots as the running value left by earlier layers,
    and rtrn/rtrnmr map spectral bands through ipat using the value
    left by the LAST cloudy layer.  The iceind promotion quirk is
    included: a pure-ice Ebert&Curry layer (no liquid contribution)
    promotes iceind 1->2 (:263,268), storing the 5 regional
    coefficients identity-mapped into cloud bands 1-5 instead of
    through the icb regional map.

    Returns (taucloud_cb (B, L, 16) in CLOUD-band slots,
    ncbands_final (B,) int32 in {1, 5, 16}, bounds_ok (B, L)).
    """
    assert inflag == 2, "static configs use cldprop()"
    dtype = clouds.tauc.dtype
    B, L = clouds.cldfrac.shape
    cwp = clouds.ciwp + clouds.clwp
    tauctot = clouds.tauc.sum(axis=-1)
    active = (clouds.cldfrac >= CLDMIN) & (
        (cwp >= CLDMIN) | (tauctot >= CLDMIN))
    has_ice = active & (clouds.ciwp > 0.0)
    has_liq = active & (clouds.clwp > 0.0)

    # per-layer ncbands assignment (0 = no assignment this layer):
    # the ice block runs first, the liquid block second
    upd = jnp.zeros((B, L), jnp.int32)
    if iceflag == 1:
        upd = jnp.where(has_ice, 5, upd)
    elif iceflag in (2, 3):
        upd = jnp.where(has_ice, 16, upd)
    if liqflag == 1:
        upd = jnp.where(has_liq, 16, upd)
    # running value: forward-fill of the last assignment, init 1
    lay_idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    marked = jnp.where(upd > 0, lay_idx, -1)
    last = jax.lax.cummax(marked, axis=1)
    upd_at = jnp.take_along_axis(upd, jnp.maximum(last, 0), axis=1)
    ncb_lay = jnp.where(last >= 0, upd_at, 1)          # (B, L)
    ncbands = ncb_lay[:, -1]                           # (B,)

    # per-cloud-band absorption coefficients
    abscoice, abscoliq, ok = _ice_liq_coeffs(
        clouds.reic, clouds.relq, iceflag, liqflag, tables, dtype)
    if iceflag == 1:
        # pure-ice layer (liqind=0): iceind 1->2, identity slots 1-5;
        # mixed layer: icb regional map over 16 (what _ice_liq_coeffs
        # already produced).  Rebuild the per-region values and select.
        absice1 = jnp.asarray(tables["absice1"], dtype)
        r = jnp.clip(clouds.reic, 13.0, 130.0)
        per_region = absice1[0][None, None, :] + \
            absice1[1][None, None, :] / r[..., None]   # (B, L, 5)
        pure = jnp.pad(per_region, ((0, 0), (0, 0), (0, 11)),
                       mode="edge")                    # slots 5+ unused
        liq_present = has_liq if liqflag == 1 else \
            jnp.zeros_like(has_liq)
        abscoice = jnp.where(liq_present[..., None], abscoice, pure)
    abscoice = jnp.where(clouds.ciwp[..., None] == 0.0, 0.0, abscoice)
    abscoliq = jnp.where(clouds.clwp[..., None] == 0.0, 0.0, abscoliq)
    taucloud = (clouds.ciwp[..., None] * abscoice
                + clouds.clwp[..., None] * abscoliq)
    # write bound: slots ib < ncbands(as of this layer); others stay 0
    slot = jnp.arange(16, dtype=jnp.int32)
    taucloud = jnp.where(slot[None, None, :] < ncb_lay[..., None],
                         taucloud, 0.0)
    taucloud = jnp.where(active[..., None], taucloud, 0.0)
    return taucloud, ncbands, ok


def expand_cloud_bands(taucloud_cb, ncbands, sec_band):
    """Cloud-band taucloud -> per-SPECTRAL-band effective optical
    depth, folding the reference's ``secdiff(ib)`` aliasing
    (rrtmg_lw_rtrn.f90:321,343-348: the cloud od is weighted by the
    diffusivity of the *cloud* band index, not the spectral band's).
    ``sec_band`` is rtrn.secdiff(pwvcm) shaped (B, 16).

    Returns the fully-weighted od
    ``sec[b, ipat(iband)] * taucloud_cb[b, l, ipat(iband)]`` exactly as
    the Fortran forms it, so the consumer must NOT re-apply secdiff
    (rtrn/rtrnmr ``odcld_weighted``).  A ratio prefold onto the
    spectral band's secdiff would perturb the od by an ulp, which the
    f64 LUT quantizer can resolve.
    """
    row = ((ncbands == 5).astype(jnp.int32)
           + 2 * (ncbands == 16).astype(jnp.int32))    # (B,) in 0..2
    ipat_sel = jnp.asarray(IPAT, jnp.int32)[row]       # (B, 16)
    tau_sel = jnp.take_along_axis(taucloud_cb,
                                  ipat_sel[:, None, :], axis=2)
    sec_sel = jnp.take_along_axis(sec_band, ipat_sel, axis=1)
    return sec_sel[:, None, :] * tau_sel


def cldprop(clouds: BandClouds, tables: dict, *, inflag: int,
            iceflag: int, liqflag: int):
    """Per-band cloud optical depth expanded to the 16 real bands.

    Valid for the statically-16-cloud-band configurations
    (``cloud_bands_static``); the model routes the others through
    ``cldprop_ncbands`` + ``expand_cloud_bands``.
    Returns (taucloud (B, L, 16), bounds_ok (B, L)).
    """
    dtype = clouds.tauc.dtype
    cwp = clouds.ciwp + clouds.clwp
    tauctot = clouds.tauc.sum(axis=-1)
    active = (clouds.cldfrac >= CLDMIN) & (
        (cwp >= CLDMIN) | (tauctot >= CLDMIN))

    if inflag == 0:
        taucloud = jnp.where(active[..., None], clouds.tauc, 0.0)
        return taucloud, jnp.ones(clouds.cldfrac.shape, bool)
    if inflag == 1:
        abscld1 = float(tables["abscld1"])
        taucloud = jnp.where(active[..., None],
                             (abscld1 * cwp)[..., None]
                             * jnp.ones((16,), dtype), 0.0)
        return taucloud, jnp.ones(clouds.cldfrac.shape, bool)

    abscoice, abscoliq, ok = _ice_liq_coeffs(
        clouds.reic, clouds.relq, iceflag, liqflag, tables, dtype)
    abscoice = jnp.where(clouds.ciwp[..., None] == 0.0, 0.0, abscoice)
    abscoliq = jnp.where(clouds.clwp[..., None] == 0.0, 0.0, abscoliq)
    taucloud = (clouds.ciwp[..., None] * abscoice
                + clouds.clwp[..., None] * abscoliq)
    taucloud = jnp.where(active[..., None], taucloud, 0.0)
    return taucloud, ok
