"""Maximum-random cloud-overlap radiative transfer.

Batched re-design of ``rtrnmr`` (rrtmg_lw_rtrnmr.f90:51-806).  Two per-column
pre-passes compute the clear/cloud overlap transfer factors between
adjacent layers in each sweep direction (:347-428 up, :430-506 down),
carrying the (rat1, rat2) state across contiguous cloudy blocks; the
radiance recursion then tracks separate cloudy/clear sub-streams
(cldradd/clrradd) that exchange a correction radiance ``rad``
(:591-615 down, :678-703 up).

Implementation notes:
  * the reference leaves several factor entries formally uninitialized
    on paths where they are never read; we zero-initialize, which matches
    the effective behavior (the stream-restart iterations have rad = 0).
  * all division guards (1-fmax, fmin, cldfrac deltas) are exercised only
    on branches where the reference guarantees nonzero denominators; we
    use safe division so unselected lanes cannot produce NaN/Inf.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .rtrn import RTOut, _band_weights, band_flux, precompute


def _safe_div(a, b):
    return a / jnp.where(b == 0.0, 1.0, b)


def _overlap_factors_up(cldfrac, cloudy):
    """Up-sweep overlap factors; entry [lev] holds fac*(lev+1) of the
    reference, i.e. the factors used by the upward radiance recursion at
    layer lev.  cldfrac/cloudy: (B, L)."""
    B, L = cldfrac.shape
    dtype = cldfrac.dtype
    cm = jnp.concatenate([jnp.zeros((B, 1), dtype), cldfrac[:, :-1]], axis=1)
    cp = jnp.concatenate([cldfrac[:, 1:], jnp.zeros((B, 1), dtype)], axis=1)
    cloudy_m = jnp.concatenate([jnp.zeros((B, 1), bool),
                                cloudy[:, :-1]], axis=1)
    istcld = ~cloudy_m
    istcld = istcld.at[:, 0].set(True)
    is_top = jnp.zeros((B, L), bool).at[:, L - 1].set(True)

    def step(carry, xs):
        rat1, rat2 = carry
        c, cmv, cpv, cly, ist, top = xs
        inc = cpv >= c

        fmax = jnp.maximum(c, cmv)
        clr2_ist = jnp.where(c < 1.0, _safe_div(cpv - c, 1.0 - c), 0.0)
        gt = cpv > fmax
        lt = cpv < fmax
        clr1_e = jnp.where(lt, _safe_div(cpv - c, cmv - c), rat2)
        clr2_e = jnp.where(gt, _safe_div(cpv - fmax, 1.0 - fmax), 0.0)
        facclr1 = jnp.where(ist, 0.0, clr1_e)
        facclr2 = jnp.where(ist, clr2_ist, clr2_e)

        fmin = jnp.minimum(c, cmv)
        cld2_ist = _safe_div(c - cpv, c)
        le = cpv <= fmin
        cld1_e = jnp.where(le, rat1, _safe_div(c - cpv, c - fmin))
        cld2_e = jnp.where(le, _safe_div(fmin - cpv, fmin), 0.0)
        faccld1 = jnp.where(ist, 0.0, cld1_e)
        faccld2 = jnp.where(ist, cld2_ist, cld2_e)

        zero = jnp.zeros_like(c)
        facclr1 = jnp.where(inc, facclr1, zero)
        facclr2 = jnp.where(inc, facclr2, zero)
        faccld1 = jnp.where(inc, zero, faccld1)
        faccld2 = jnp.where(inc, zero, faccld2)

        faccmb1 = jnp.where(ist, zero,
                            jnp.maximum(0.0, jnp.minimum(cpv - c, cmv - c)))
        faccmb2 = jnp.where(ist, zero,
                            jnp.maximum(0.0, jnp.minimum(c - cpv, c - cmv)))

        live = cly & ~top
        outs = tuple(jnp.where(live, v, zero) for v in
                     (facclr1, facclr2, faccld1, faccld2, faccmb1, faccmb2))

        anyclr = (facclr1 > 0.0) | (facclr2 > 0.0)
        anycld = (faccld1 > 0.0) | (faccld2 > 0.0)
        rat1_n = jnp.where(inc & anyclr, 1.0, 0.0)
        rat2_n = jnp.where(~inc & anycld, 1.0, 0.0)
        rat1_out = jnp.where(live, rat1_n, rat1)
        rat2_out = jnp.where(live, rat2_n, rat2)
        return (rat1_out, rat2_out), outs

    xs = tuple(jnp.moveaxis(x, 1, 0) for x in
               (cldfrac, cm, cp, cloudy, istcld, is_top))
    zero = jnp.zeros((B,), dtype)
    _, outs = jax.lax.scan(step, (zero, zero), xs)
    return tuple(jnp.moveaxis(o, 0, 1) for o in outs), istcld


def _overlap_factors_down(cldfrac, cloudy):
    """Down-sweep factors; entry [lev] holds fac*d(lev-1) used by the
    downward recursion at layer lev."""
    B, L = cldfrac.shape
    dtype = cldfrac.dtype
    cm = jnp.concatenate([jnp.zeros((B, 1), dtype), cldfrac[:, :-1]], axis=1)
    cp = jnp.concatenate([cldfrac[:, 1:], jnp.zeros((B, 1), dtype)], axis=1)
    cloudy_p = jnp.concatenate([cloudy[:, 1:],
                                jnp.zeros((B, 1), bool)], axis=1)
    istcldd = ~cloudy_p
    istcldd = istcldd.at[:, L - 1].set(True)
    is_bot = jnp.zeros((B, L), bool).at[:, 0].set(True)

    def step(carry, xs):
        rat1, rat2 = carry
        c, cmv, cpv, cly, ist, bot = xs
        inc = cmv >= c

        fmax = jnp.maximum(c, cpv)
        clr2_ist = jnp.where(c < 1.0, _safe_div(cmv - c, 1.0 - c), 0.0)
        gt = cmv > fmax
        lt = cmv < fmax
        clr1_e = jnp.where(lt, _safe_div(cmv - c, cpv - c), rat2)
        clr2_e = jnp.where(gt, _safe_div(cmv - fmax, 1.0 - fmax), 0.0)
        facclr1 = jnp.where(ist, 0.0, clr1_e)
        facclr2 = jnp.where(ist, clr2_ist, clr2_e)

        fmin = jnp.minimum(c, cpv)
        cld2_ist = _safe_div(c - cmv, c)
        le = cmv <= fmin
        cld1_e = jnp.where(le, rat1, _safe_div(c - cmv, c - fmin))
        cld2_e = jnp.where(le, _safe_div(fmin - cmv, fmin), 0.0)
        faccld1 = jnp.where(ist, 0.0, cld1_e)
        faccld2 = jnp.where(ist, cld2_ist, cld2_e)

        zero = jnp.zeros_like(c)
        facclr1 = jnp.where(inc, facclr1, zero)
        facclr2 = jnp.where(inc, facclr2, zero)
        faccld1 = jnp.where(inc, zero, faccld1)
        faccld2 = jnp.where(inc, zero, faccld2)

        faccmb1 = jnp.where(ist, zero,
                            jnp.maximum(0.0, jnp.minimum(cpv - c, cmv - c)))
        faccmb2 = jnp.where(ist, zero,
                            jnp.maximum(0.0, jnp.minimum(c - cpv, c - cmv)))

        live = cly & ~bot
        outs = tuple(jnp.where(live, v, zero) for v in
                     (facclr1, facclr2, faccld1, faccld2, faccmb1, faccmb2))

        anyclr = (facclr1 > 0.0) | (facclr2 > 0.0)
        anycld = (faccld1 > 0.0) | (faccld2 > 0.0)
        rat1_n = jnp.where(inc & anyclr, 1.0, 0.0)
        rat2_n = jnp.where(~inc & anycld, 1.0, 0.0)
        rat1_out = jnp.where(live, rat1_n, rat1)
        rat2_out = jnp.where(live, rat2_n, rat2)
        return (rat1_out, rat2_out), outs

    # iterate from the top layer downward
    xs = tuple(jnp.moveaxis(x, 1, 0)[::-1] for x in
               (cldfrac, cm, cp, cloudy, istcldd, is_bot))
    zero = jnp.zeros((B,), dtype)
    _, outs = jax.lax.scan(step, (zero, zero), xs)
    return (tuple(jnp.moveaxis(o[::-1], 0, 1) for o in outs), istcldd)


def rt_maxrandom(taut, fracs, planklay, planklev, plankbnd,
                 dplankbnd_dt, semiss, pwvcm, pz, cldfrac, odcld_g,
                 *, static, luts, use_lut=True, idrv=0, heatfac_val,
                 istart=1, iend=16, odcld_weighted=False):
    """Maximum-random overlap RT (rtrnmr.f90).  cldfrac (B, L) per layer;
    odcld_g (B, L, G) per-g cloud od (per-band cloud od expanded by
    band-of-g; ``odcld_weighted`` when it already carries secdiff)."""
    dtype = taut.dtype
    B, L, G = taut.shape
    ngb_full = np.asarray(static["ngb"]) - 1
    gsel = np.nonzero((ngb_full >= istart - 1) & (ngb_full <= iend - 1))[0]
    ngb0 = ngb_full[gsel]

    cloudy_lay = cldfrac >= 1.0e-6
    cldf_g = jnp.broadcast_to(cldfrac[..., None], taut.shape)
    gate = jnp.broadcast_to(cloudy_lay[..., None], taut.shape)
    pre = precompute(taut, cldf_g, odcld_g, cloudy_lay, gate, fracs,
                     planklay, planklev, pwvcm, ngb0, luts, use_lut,
                     odcld_weighted=odcld_weighted)

    (up_facs, istcld) = _overlap_factors_up(cldfrac, cloudy_lay)
    (dn_facs, istcldd) = _overlap_factors_down(cldfrac, cloudy_lay)

    iclddn = jnp.flip(jnp.cumsum(jnp.flip(
        cloudy_lay.astype(jnp.int32), axis=1), axis=1), axis=1) > 0
    any_cld = iclddn[:, 0]

    def to_scan(x):
        return jnp.moveaxis(x, 1, 0)

    atrans = to_scan(pre["atrans"])
    atot = to_scan(pre["atot"])
    bbd = to_scan(pre["bbd"])
    bbugas = to_scan(pre["bbugas"])
    bbutot = to_scan(pre["bbutot"])
    bbdtot = to_scan(pre["bbdtot"])
    gassrc = to_scan(pre["gassrc_dn"])
    cf_l = to_scan(cldfrac)[..., None]                    # (L, B, 1)
    cly_l = to_scan(cloudy_lay)[..., None]
    icld_lev = to_scan(iclddn.astype(bool))

    dnf = [to_scan(f)[..., None] for f in dn_facs]
    upf = [to_scan(f)[..., None] for f in up_facs]
    ist_dn = to_scan(istcldd)[..., None]
    ist_up = to_scan(istcld)[..., None]

    zero = jnp.zeros((B, G), dtype)

    # ---- downward sweep ----
    def down_step(carry, xs):
        radld, radclrd, cldradd, clrradd, rad = carry
        (at, atot_l, bbd_l, bbdtot_l, gs, cf, cly, icl, ist,
         fclr1, fclr2, fcld1, fcld2, fcmb1, fcmb2) = xs
        # stream restart at the first cloudy layer of a block
        cldradd0 = jnp.where(ist, cf * radld, cldradd)
        clrradd0 = jnp.where(ist, radld - cf * radld, clrradd)
        rad0 = jnp.where(ist, 0.0, rad)

        ttot = 1.0 - atot_l
        cldsrc = bbdtot_l * atot_l
        cldradd1 = cldradd0 * ttot + cf * cldsrc
        clrradd1 = clrradd0 * (1.0 - at) + (1.0 - cf) * gs
        radld_cld = cldradd1 + clrradd1
        radmod = (rad0 * (fclr1 * (1.0 - at) + fcld1 * ttot)
                  - fcmb1 * gs + fcmb2 * cldsrc)
        oldcld = cldradd1 - radmod
        oldclr = clrradd1 + radmod
        rad_n = -radmod + fclr2 * oldclr - fcld2 * oldcld
        cldradd_n = cldradd1 + rad_n
        clrradd_n = clrradd1 - rad_n

        radld_clr = radld + (bbd_l - radld) * at
        radld_out = jnp.where(cly, radld_cld, radld_clr)
        cldradd_out = jnp.where(cly, cldradd_n, cldradd)
        clrradd_out = jnp.where(cly, clrradd_n, clrradd)
        rad_out = jnp.where(cly, rad_n, rad)

        radclrd_n = jnp.where(icl[:, None],
                              radclrd + (bbd_l - radclrd) * at, radld_out)
        return ((radld_out, radclrd_n, cldradd_out, clrradd_out, rad_out),
                (radld_out, radclrd_n))

    xs_down = (atrans[::-1], atot[::-1], bbd[::-1], bbdtot[::-1],
               gassrc[::-1], cf_l[::-1], cly_l[::-1], icld_lev[::-1],
               ist_dn[::-1], dnf[0][::-1], dnf[1][::-1], dnf[2][::-1],
               dnf[3][::-1], dnf[4][::-1], dnf[5][::-1])
    (radld_sfc, radclrd_sfc, _, _, _), (drad_rev, cdrad_rev) = jax.lax.scan(
        down_step, (zero, zero, zero, zero, zero), xs_down)
    drad = drad_rev[::-1]
    cdrad = cdrad_rev[::-1]

    sem_g = semiss[:, ngb0]
    rad0s = fracs[:, 0, :] * plankbnd[:, ngb0]
    reflect = 1.0 - sem_g
    radlu0 = rad0s + reflect * radld_sfc
    radclru0 = rad0s + reflect * radclrd_sfc
    anyc = any_cld[:, None]

    # ---- upward sweep ----
    def up_step(carry, xs):
        radlu, radclru, cldradu, clrradu, rad, dlu, dclru = carry
        (at, atot_l, bbu, bbut, cf, cly, ist,
         fclr1, fclr2, fcld1, fcld2, fcmb1, fcmb2) = xs
        gs = bbu * at
        cldradu0 = jnp.where(ist, cf * radlu, cldradu)
        clrradu0 = jnp.where(ist, radlu - cf * radlu, clrradu)
        rad0 = jnp.where(ist, 0.0, rad)

        ttot = 1.0 - atot_l
        cldsrc = bbut * atot_l
        cldradu1 = cldradu0 * ttot + cf * cldsrc
        clrradu1 = clrradu0 * (1.0 - at) + (1.0 - cf) * gs
        radlu_cld = cldradu1 + clrradu1
        radmod = (rad0 * (fclr1 * (1.0 - at) + fcld1 * ttot)
                  - fcmb1 * gs + fcmb2 * cldsrc)
        oldcld = cldradu1 - radmod
        oldclr = clrradu1 + radmod
        rad_n = -radmod + fclr2 * oldclr - fcld2 * oldcld
        cldradu_n = cldradu1 + rad_n
        clrradu_n = clrradu1 - rad_n

        radlu_clr = radlu + (bbu - radlu) * at
        radlu_out = jnp.where(cly, radlu_cld, radlu_clr)
        cldradu_out = jnp.where(cly, cldradu_n, cldradu)
        clrradu_out = jnp.where(cly, clrradu_n, clrradu)
        rad_out = jnp.where(cly, rad_n, rad)

        radclru_n = jnp.where(anyc, radclru + (bbu - radclru) * at,
                              radlu_out)
        dlu_n = jnp.where(cly,
                          dlu * cf * (1.0 - atot_l)
                          + dlu * (1.0 - cf) * (1.0 - at),
                          dlu * (1.0 - at))
        dclru_n = jnp.where(anyc, dclru * (1.0 - at), dlu_n)
        return ((radlu_out, radclru_n, cldradu_out, clrradu_out, rad_out,
                 dlu_n, dclru_n),
                (radlu_out, radclru_n, dlu_n, dclru_n))

    d_rad0 = fracs[:, 0, :] * dplankbnd_dt[:, ngb0] if idrv else zero
    xs_up = (atrans, atot, bbugas, bbutot, cf_l, cly_l, ist_up,
             upf[0], upf[1], upf[2], upf[3], upf[4], upf[5])
    _, (urad_s, curad_s, durad_s, dcurad_s) = jax.lax.scan(
        up_step, (radlu0, radclru0, zero, zero, zero, d_rad0, d_rad0),
        xs_up)

    urad = jnp.concatenate([radlu0[None], urad_s], axis=0)
    clrurad = jnp.concatenate([radclru0[None], curad_s], axis=0)
    dradf = jnp.concatenate([drad, jnp.zeros((1, B, G), dtype)], axis=0)
    cdradf = jnp.concatenate([cdrad, jnp.zeros((1, B, G), dtype)], axis=0)
    durad = jnp.concatenate([d_rad0[None], durad_s], axis=0)
    dcurad = jnp.concatenate([d_rad0[None], dcurad_s], axis=0)

    wg = _band_weights(static["delwave"], ngb0, dtype)

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
