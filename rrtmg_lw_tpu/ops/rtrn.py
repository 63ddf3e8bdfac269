"""Longwave radiative transfer: linear-in-tau level recurrence.

Batched re-design of ``rtrnmc`` (rrtmg_lw_rtrnmc.f90:51-595) and
``rtrn`` (rrtmg_lw_rtrn.f90:51-606).  After expanding the per-band cloud
arrays of ``rtrn`` to per-g-point arrays, the two solvers share identical
recurrences, so one core serves both (random-overlap / McICA).  The
maximum-random solver (``rtrnmr``) lives in rtrnmr.py.

Structure: every quantity that does not depend on the running radiance
(absorptivity, Planck sources, lookup-table factors) is computed
elementwise over (batch, layer, g-point) first; the inherently
sequential part is a pair of `lax.scan`s over layers carrying only the
radiance vector (batch, g-point).

Numerical semantics preserved from the reference:
  * 3-regime optical-depth treatment with the 10k-entry exp/tfn lookup
    tables and Pade index `int(tblint*tblind + 0.5)` (rtrnmc.f90:361-425),
  * gas optical depth *quantized* through tau_tbl in the thick-cloud
    regime (rtrnmc.f90:405),
  * water-vapor-dependent diffusivity angle secant per band
    (rtrnmc.f90:273-281),
  * clear-sky stream that tracks the total-sky stream until the first
    cloudy layer along the path (rtrnmc.f90:448-454, 509-527),
  * dF/dT(surface) recursion for idrv=1 (rtrnmc.f90:495-527).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (BPADE, FLUXFAC, REC_6, SECDIFF_A0, SECDIFF_A1,
                         SECDIFF_A2, SECDIFF_FIXED, TBLINT, WTDIFF)


class RTOut(NamedTuple):
    totuflux: jnp.ndarray     # (B, L+1)
    totdflux: jnp.ndarray
    htr: jnp.ndarray          # (B, L)
    totuclfl: jnp.ndarray
    totdclfl: jnp.ndarray
    htrc: jnp.ndarray
    dtotuflux_dt: Optional[jnp.ndarray] = None
    dtotuclfl_dt: Optional[jnp.ndarray] = None


def secdiff(pwvcm, dtype):
    """Per-band diffusivity secant (B, 16); rtrnmc.f90:273-281."""
    a0 = jnp.asarray(SECDIFF_A0, dtype)
    a1 = jnp.asarray(SECDIFF_A1, dtype)
    a2 = jnp.asarray(SECDIFF_A2, dtype)
    var = a0[None, :] + a1[None, :] * jnp.exp(a2[None, :] * pwvcm[:, None])
    var = jnp.clip(var, 1.50, 1.80)
    fixed = jnp.asarray(SECDIFF_FIXED)
    return jnp.where(fixed[None, :], jnp.asarray(1.66, dtype), var)


def _lut_index(x, dtype):
    tblind = x / (BPADE + x)
    return (TBLINT * tblind + 0.5).astype(jnp.int32)


def _gas_factors(od, luts, use_lut):
    """atrans, tf_gas (Planck transition), od_eff (quantized in the
    table branch, rtrnmc.f90:403-405)."""
    small = od <= 0.06
    atrans_small = od - 0.5 * od * od
    tf_small = REC_6 * od
    if use_lut:
        it = _lut_index(od, od.dtype)
        atrans_big = 1.0 - jnp.take(luts["exp_tbl"], it)
        tf_big = jnp.take(luts["tfn_tbl"], it)
        od_big = jnp.take(luts["tau_tbl"], it)
    else:
        # clamp at the branch threshold: values in the selected region
        # (od > 0.06, where od_safe == od) are unchanged and the
        # unselected branch stays finite under reverse-mode AD
        # (1/od would give inf cotangents at od=0).  One exp serves
        # both outputs — the small branch never reads it.
        od_safe = jnp.maximum(od, 0.06)
        e_safe = jnp.exp(-od_safe)
        atrans_big = 1.0 - e_safe
        tf_big = 1.0 - 2.0 * (1.0 / od_safe - e_safe / (1.0 - e_safe))
        od_big = od
    atrans = jnp.where(small, atrans_small, atrans_big)
    tf = jnp.where(small, tf_small, tf_big)
    od_eff = jnp.where(small, od, od_big)
    return atrans, tf, od_eff


def _tot_factors(odtot, luts, use_lut):
    """atot, tf_tot for gas+cloud total optical depth."""
    small = odtot < 0.06
    atot_small = odtot - 0.5 * odtot * odtot
    tf_small = REC_6 * odtot
    if use_lut:
        it = _lut_index(odtot, odtot.dtype)
        atot_big = 1.0 - jnp.take(luts["exp_tbl"], it)
        tf_big = jnp.take(luts["tfn_tbl"], it)
    else:
        ots = jnp.maximum(odtot, 0.06)        # see _gas_factors
        e_safe = jnp.exp(-ots)
        atot_big = 1.0 - e_safe
        tf_big = 1.0 - 2.0 * (1.0 / ots - e_safe / (1.0 - e_safe))
    return (jnp.where(small, atot_small, atot_big),
            jnp.where(small, tf_small, tf_big))


def precompute(taut, cldf_g, odcld_g, cloudy_lay, cld_gate, fracs,
               planklay, planklev, pwvcm, ngb0, luts, use_lut,
               odcld_weighted=False):
    """Elementwise (B, L, G) precompute shared by all RT variants.

    Returns dict with atrans, atot, bbd (down source), bbugas, bbutot,
    bbdtot, gassrc_dn, efclfrac, secd_g.
    """
    dtype = taut.dtype
    sec_band = secdiff(pwvcm, dtype)                     # (B, 16)
    secd_g = sec_band[:, ngb0]                           # (B, G)

    od = jnp.maximum(secd_g[:, None, :] * taut, 0.0)
    atrans, tf_gas, od_eff = _gas_factors(od, luts, use_lut)

    blay = planklay[..., ngb0]                           # (B, L, G)
    dpup = planklev[:, 1:, :][..., ngb0] - blay
    dpdn = planklev[:, :-1, :][..., ngb0] - blay

    bbd = fracs * (blay + tf_gas * dpdn)
    bbugas = fracs * (blay + tf_gas * dpup)
    gassrc_dn = atrans * bbd

    # reference computes odcld only where the per-g/per-layer cloud gate
    # holds (rtrnmc.f90:317-328 uses cldfmc==1; rtrn.f90:322 cldfrac>=1e-6).
    # odcld_weighted: odcld_g already carries its secdiff factor (the
    # runtime-ncbands path weights by the CLOUD band's secdiff,
    # rtrn.f90:321 — it must not be re-applied, and folding a ratio
    # instead would perturb the LUT quantization by an ulp)
    odcld_eff = jnp.where(
        cld_gate,
        odcld_g if odcld_weighted else secd_g[:, None, :] * odcld_g,
        0.0)
    abscld = 1.0 - jnp.exp(-odcld_eff)
    efclfrac = jnp.where(cld_gate, abscld * cldf_g, 0.0)

    odtot = od_eff + odcld_eff
    atot, tf_tot = _tot_factors(odtot, luts, use_lut)
    bbdtot = fracs * (blay + tf_tot * dpdn)
    bbutot = fracs * (blay + tf_tot * dpup)

    return dict(atrans=atrans, atot=atot, bbd=bbd, bbugas=bbugas,
                bbutot=bbutot, bbdtot=bbdtot, gassrc_dn=gassrc_dn,
                efclfrac=efclfrac)


def _band_weights(delwave, ngb0, dtype):
    w = WTDIFF * np.asarray(delwave)[ngb0] * FLUXFAC
    return jnp.asarray(w, dtype)


def band_flux(x, wg):
    """(L+1, B, G) level radiances -> (B, L+1) band-weighted flux.  The
    contraction runs at full precision: a GPU's default f32 dot may
    use TF32 (~3 digits), worth ~0.1-0.4 W/m2 over 140 g-points."""
    return jnp.einsum("lbg,g->bl", x, wg,
                      precision=jax.lax.Precision.HIGHEST)


def rt_random_overlap(taut, fracs, planklay, planklev, plankbnd,
                      dplankbnd_dt, semiss, pwvcm, pz, cldf_g, odcld_g,
                      *, cloudy_lay, cld_gate, static, luts, use_lut=True,
                      idrv=0, heatfac_val, istart=1, iend=16,
                      odcld_weighted=False):
    """Random-overlap / McICA RT (rtrnmc.f90 & rtrn.f90 semantics).

    All cloud inputs already per-g-point: cldf_g, odcld_g (B, L, G).
    Returns RTOut with fluxes on levels 0..L (bottom->top).
    """
    dtype = taut.dtype
    B, L, G = taut.shape
    ngb_full = np.asarray(static["ngb"]) - 1             # (140,)
    gsel = np.nonzero((ngb_full >= istart - 1) & (ngb_full <= iend - 1))[0]
    if len(gsel) != G:
        raise ValueError("taut g-dim must match selected bands")
    ngb0 = ngb_full[gsel]

    # rematerialized under autodiff: the ~8 (B, L, G) source/
    # absorptivity arrays are cheap elementwise chains off taut; saving
    # them as residuals (instead of recomputing in the backward) is
    # what pushes the RT vjp footprint past HBM at large B.  Pure
    # forward execution is unaffected by jax.checkpoint.
    pre = jax.checkpoint(
        lambda t, cf, od, fr, pl_, pv, pw: precompute(
            t, cf, od, cloudy_lay, cld_gate, fr, pl_, pv, pw, ngb0,
            luts, use_lut, odcld_weighted=odcld_weighted),
    )(taut, cldf_g, odcld_g, fracs, planklay, planklev, pwvcm)

    # cloud-in-path-above flag, per level (reverse cumulative OR)
    iclddn = jnp.flip(jnp.cumsum(jnp.flip(
        cloudy_lay.astype(jnp.int32), axis=1), axis=1), axis=1) > 0  # (B,L)
    any_cld = iclddn[:, 0]                               # (B,)

    cl = cloudy_lay[..., None]
    cldf = cldf_g

    def to_scan(x):  # (B, L, G) -> (L, B, G)
        return jnp.moveaxis(x, 1, 0)

    atrans = to_scan(pre["atrans"])
    atot = to_scan(pre["atot"])
    bbd = to_scan(pre["bbd"])
    bbugas = to_scan(pre["bbugas"])
    bbutot = to_scan(pre["bbutot"])
    bbdtot = to_scan(pre["bbdtot"])
    gassrc = to_scan(pre["gassrc_dn"])
    efc = to_scan(pre["efclfrac"])
    cldfs = to_scan(cldf)
    cls = to_scan(jnp.broadcast_to(cl, cldf.shape))
    icld_lev = jnp.moveaxis(iclddn, 1, 0)                # (L, B)

    # ---- downward sweep (lev = L-1 .. 0), radiance at layer bottoms ----
    def down_step(carry, xs):
        radld, radclrd = carry
        at, atot_l, bbd_l, bbdtot_l, gs, ef, cf, cly, icl = xs
        rad_cld = (radld - radld * (at + ef * (1.0 - at)) + gs
                   + cf * (bbdtot_l * atot_l - gs))
        rad_clr = radld + (bbd_l - radld) * at
        radld_n = jnp.where(cly, rad_cld, rad_clr)
        radclrd_n = jnp.where(icl[:, None],
                              radclrd + (bbd_l - radclrd) * at, radld_n)
        return (radld_n, radclrd_n), (radld_n, radclrd_n)

    zero = jnp.zeros((B, G), dtype)
    xs_down = (atrans[::-1], atot[::-1], bbd[::-1], bbdtot[::-1],
               gassrc[::-1], efc[::-1], cldfs[::-1], cls[::-1],
               icld_lev[::-1])
    (radld_sfc, radclrd_sfc), (drad_rev, cdrad_rev) = jax.lax.scan(
        down_step, (zero, zero), xs_down)
    drad = drad_rev[::-1]       # (L, B, G): downward radiance at level l-1
    cdrad = cdrad_rev[::-1]

    # ---- surface reflection ----
    sem_g = semiss[:, ngb0]
    rad0 = fracs[:, 0, :] * plankbnd[:, ngb0]
    reflect = 1.0 - sem_g
    radlu0 = rad0 + reflect * radld_sfc
    radclru0 = rad0 + reflect * radclrd_sfc

    # ---- upward sweep (lev = 1 .. L) ----
    anyc = any_cld[:, None]

    def up_step(carry, xs):
        radlu, radclru, dlu, dclru = carry
        at, atot_l, bbu, bbut, cf, cly, ef = xs
        gs = bbu * at
        rad_cld = (radlu - radlu * (at + ef * (1.0 - at)) + gs
                   + cf * (bbut * atot_l - gs))
        rad_clr = radlu + (bbu - radlu) * at
        radlu_n = jnp.where(cly, rad_cld, rad_clr)
        radclru_n = jnp.where(anyc, radclru + (bbu - radclru) * at, radlu_n)
        dlu_n = jnp.where(cly,
                          dlu * cf * (1.0 - atot_l)
                          + dlu * (1.0 - cf) * (1.0 - at),
                          dlu * (1.0 - at))
        dclru_n = jnp.where(anyc, dclru * (1.0 - at), dlu_n)
        return ((radlu_n, radclru_n, dlu_n, dclru_n),
                (radlu_n, radclru_n, dlu_n, dclru_n))

    d_rad0 = fracs[:, 0, :] * dplankbnd_dt[:, ngb0] if idrv else zero
    xs_up = (atrans, atot, bbugas, bbutot, cldfs, cls, efc)
    (_, _, _, _), (urad_s, curad_s, durad_s, dcurad_s) = jax.lax.scan(
        lambda c, x: up_step(c, x), (radlu0, radclru0, d_rad0, d_rad0),
        xs_up)

    # assemble level arrays: level 0 = surface
    urad = jnp.concatenate([radlu0[None], urad_s], axis=0)     # (L+1, B, G)
    clrurad = jnp.concatenate([radclru0[None], curad_s], axis=0)
    dradf = jnp.concatenate([drad, jnp.zeros((1, B, G), dtype)], axis=0)
    cdradf = jnp.concatenate([cdrad, jnp.zeros((1, B, G), dtype)], axis=0)
    durad = jnp.concatenate([d_rad0[None], durad_s], axis=0)
    dcurad = jnp.concatenate([d_rad0[None], dcurad_s], axis=0)

    wg = _band_weights(static["delwave"], ngb0, dtype)          # (G,)

    def flux(x):
        return band_flux(x, wg)

    totuflux = flux(urad)
    totdflux = flux(dradf)
    totuclfl = flux(clrurad)
    totdclfl = flux(cdradf)

    fnet = totuflux - totdflux
    fnetc = totuclfl - totdclfl
    dp = pz[:, :-1] - pz[:, 1:]
    htr = heatfac_val * (fnet[:, :-1] - fnet[:, 1:]) / dp
    htrc = heatfac_val * (fnetc[:, :-1] - fnetc[:, 1:]) / dp

    if idrv:
        return RTOut(totuflux, totdflux, htr, totuclfl, totdclfl, htrc,
                     flux(durad), flux(dcurad))
    return RTOut(totuflux, totdflux, htr, totuclfl, totdclfl, htrc)
