"""Pressure/temperature interpolation indices and Planck sources.

Vectorized equivalent of ``setcoef`` (rrtmg_lw_setcoef.f90:50-434).  The
reference's serial layer loop with a `laytrop` split becomes per-layer
select masks; integer index arithmetic replicates Fortran truncation
(real->int assignment truncates toward zero) exactly.

Index arrays returned are 0-based.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import Profile, SetcoefOut

STPFAC = 296.0 / 1013.0


def _trunc_int(x):
    """Fortran real->integer assignment (truncate toward zero)."""
    return x.astype(jnp.int32)


def _planck_index(t):
    """181-entry Planck table index (1-based, clamped) + fraction.

    rrtmg_lw_setcoef.f90:173-206: ind = int(T - 159), clamped to [1,180],
    frac = T - 159 - ind (can exceed [0,1) when clamped).
    """
    ind = jnp.clip(_trunc_int(t - 159.0), 1, 180)
    frac = t - 159.0 - ind.astype(t.dtype)
    return ind, frac


def _interp_planck(table, ind, frac):
    """table (181, nb); ind (..., ) 1-based -> (..., nb)."""
    lo = jnp.take(table, ind - 1, axis=0)
    hi = jnp.take(table, ind, axis=0)
    return lo + frac[..., None] * (hi - lo)


def _interp_planck16(table, ind, frac):
    lo = jnp.take(table, ind - 1, axis=0)
    hi = jnp.take(table, ind, axis=0)
    return lo + frac * (hi - lo)


def setcoef(prof: Profile, static: dict, *, istart: int = 1,
            idrv: int = 0) -> SetcoefOut:
    """static: dict with jnp arrays preflog(59), tref(59), chi_mls(7,59),
    totplnk(181,16), totplk16(181), totplnkderiv(181,16), totplk16deriv(181).
    """
    dtype = prof.pavel.dtype
    totplnk = static["totplnk"].astype(dtype)
    totplk16 = static["totplk16"].astype(dtype)
    totplnkd = static["totplnkderiv"].astype(dtype)
    totplk16d = static["totplk16deriv"].astype(dtype)
    preflog = static["preflog"].astype(dtype)
    tref = static["tref"].astype(dtype)
    chi = static["chi_mls"].astype(dtype)

    pavel, tavel, tz, tbound = prof.pavel, prof.tavel, prof.tz, prof.tbound

    # ----- Planck sources --------------------------------------------------
    indb, fracb = _planck_index(tbound)                 # (B,)
    indlay, fraclay = _planck_index(tavel)              # (B, L)
    indlev, fraclev = _planck_index(tz)                 # (B, L+1)

    planklay = _interp_planck(totplnk, indlay, fraclay)  # (B, L, 16)
    planklev = _interp_planck(totplnk, indlev, fraclev)  # (B, L+1, 16)
    plankbnd = prof.semiss * _interp_planck(totplnk, indb, fracb)
    dplankbnd = prof.semiss * _interp_planck(totplnkd, indb, fracb)

    if istart == 16:
        # Band-16-only mode integrates only 2600-3250 cm-1 for band 16
        # (setcoef.f90:233-251); note planklev(0) keeps the totplnk slope.
        p16lay = _interp_planck16(totplk16, indlay, fraclay)
        p16lev = _interp_planck16(totplk16, indlev, fraclev)
        p16bnd = prof.semiss[:, 15] * _interp_planck16(totplk16, indb, fracb)
        d16bnd = prof.semiss[:, 15] * _interp_planck16(totplk16d, indb, fracb)
        planklay = planklay.at[..., 15].set(p16lay)
        lev0_16 = (jnp.take(totplk16, indlev[:, 0] - 1)
                   + fraclev[:, 0] * (jnp.take(totplnk[:, 15], indlev[:, 0])
                                      - jnp.take(totplnk[:, 15],
                                                 indlev[:, 0] - 1)))
        planklev = planklev.at[..., 15].set(p16lev)
        planklev = planklev.at[:, 0, 15].set(lev0_16)
        plankbnd = plankbnd.at[:, 15].set(p16bnd)
        dplankbnd = dplankbnd.at[:, 15].set(d16bnd)

    # ----- pressure / temperature interpolation ----------------------------
    plog = jnp.log(pavel)
    jp = jnp.clip(_trunc_int(36.0 - 5.0 * (plog + 0.04)), 1, 58)   # 1-based

    preflog_jp = jnp.take(preflog, jp - 1)
    tref_jp = jnp.take(tref, jp - 1)
    tref_jp1 = jnp.take(tref, jp)
    fp = 5.0 * (preflog_jp - plog)
    jt = jnp.clip(_trunc_int(3.0 + (tavel - tref_jp) / 15.0), 1, 4)
    ft = (tavel - tref_jp) / 15.0 - (jt - 3).astype(dtype)
    jt1 = jnp.clip(_trunc_int(3.0 + (tavel - tref_jp1) / 15.0), 1, 4)
    ft1 = (tavel - tref_jp1) / 15.0 - (jt1 - 3).astype(dtype)

    water = prof.wkl[..., 0] / prof.coldry
    scalefac = pavel * STPFAC / tavel
    lower = plog > 4.56                                  # laytrop split

    forfac = scalefac / (1.0 + water)
    fac_lo = (332.0 - tavel) / 36.0
    indfor_lo = jnp.clip(_trunc_int(fac_lo), 1, 2)
    forfrac_lo = fac_lo - indfor_lo.astype(dtype)
    fac_hi = (tavel - 188.0) / 36.0
    indfor = jnp.where(lower, indfor_lo, 3)
    forfrac = jnp.where(lower, forfrac_lo, fac_hi - 1.0)

    selffac = water * forfac
    fself = (tavel - 188.0) / 7.2
    indself = jnp.clip(_trunc_int(fself) - 7, 1, 9)
    selffrac = fself - (indself + 7).astype(dtype)

    scaleminor = pavel / tavel
    scaleminorn2 = scaleminor * (prof.wbrodl / (prof.coldry + prof.wkl[..., 0]))
    fminor = (tavel - 180.8) / 7.2
    indminor = jnp.clip(_trunc_int(fminor), 1, 18)
    minorfrac = fminor - indminor.astype(dtype)

    # reference-atmosphere mixing-ratio ratios at jp, jp+1 (1-based)
    def rat(g1, g2):
        a = jnp.take(chi[g1 - 1], jp - 1) / jnp.take(chi[g2 - 1], jp - 1)
        b = jnp.take(chi[g1 - 1], jp) / jnp.take(chi[g2 - 1], jp)
        return a, b

    rat_h2oco2, rat_h2oco2_1 = rat(1, 2)
    rat_h2oo3, rat_h2oo3_1 = rat(1, 3)
    rat_h2on2o, rat_h2on2o_1 = rat(1, 4)
    rat_h2och4, rat_h2och4_1 = rat(1, 6)
    rat_n2oco2, rat_n2oco2_1 = rat(4, 2)
    rat_o3co2, rat_o3co2_1 = rat(3, 2)

    # column amounts (scaled by 1e-20); zero -> 1e-32*coldry substitution
    def col(i, subst=True):
        c = 1.0e-20 * prof.wkl[..., i]
        if subst:
            c = jnp.where(c == 0.0, 1.0e-32 * prof.coldry, c)
        return c

    colh2o = col(0, subst=False)
    colco2 = col(1)
    colo3 = col(2)
    coln2o = col(3)
    colco = col(4)
    colch4 = col(5)
    colo2 = col(6, subst=False)
    colbrd = 1.0e-20 * prof.wbrodl

    compfp = 1.0 - fp
    fac10 = compfp * ft
    fac00 = compfp * (1.0 - ft)
    fac11 = fp * ft1
    fac01 = fp * (1.0 - ft1)

    selffac = colh2o * selffac
    forfac = colh2o * forfac

    return SetcoefOut(
        laytrop_mask=lower,
        jp=jp - 1, jt=jt - 1, jt1=jt1 - 1,
        planklay=planklay, planklev=planklev, plankbnd=plankbnd,
        dplankbnd_dt=dplankbnd,
        colh2o=colh2o, colco2=colco2, colo3=colo3, coln2o=coln2o,
        colco=colco, colch4=colch4, colo2=colo2, colbrd=colbrd,
        fac00=fac00, fac01=fac01, fac10=fac10, fac11=fac11,
        rat_h2oco2=rat_h2oco2, rat_h2oco2_1=rat_h2oco2_1,
        rat_h2oo3=rat_h2oo3, rat_h2oo3_1=rat_h2oo3_1,
        rat_h2on2o=rat_h2on2o, rat_h2on2o_1=rat_h2on2o_1,
        rat_h2och4=rat_h2och4, rat_h2och4_1=rat_h2och4_1,
        rat_n2oco2=rat_n2oco2, rat_n2oco2_1=rat_n2oco2_1,
        rat_o3co2=rat_o3co2, rat_o3co2_1=rat_o3co2_1,
        selffac=selffac, selffrac=selffrac, indself=indself - 1,
        forfac=forfac, forfrac=forfrac, indfor=indfor - 1,
        minorfrac=minorfrac, scaleminor=scaleminor,
        scaleminorn2=scaleminorn2, indminor=indminor - 1)
