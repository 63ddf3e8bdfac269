"""Scalar NumPy spec-oracle for the LW physics.

A *literal* per-column, per-layer transcription of the reference
algorithms (rrtmg_lw_setcoef/taumol/rtrn/rtrnmc/rtrnmr/cldprmc), with
explicit if/else branches and Fortran 1-based index arithmetic mapped
one-to-one.  Used only in tests, as the oracle for the vectorized
implementation: the production code re-architects the computation
(masks, fused tables, scans); this file does not, so disagreements
expose vectorization/indexing bugs.

Follows the Fortran semantics exactly; all loops are plain Python.
"""

from __future__ import annotations

import numpy as np

ONEMINUS = 1.0 - 1.0e-6
REC_6 = 0.166667
WTDIFF = 0.5
TBLINT = 10000.0
PADE = 0.278
BPADE = 1.0 / PADE
NG = (10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2)
NGS = np.concatenate([[0], np.cumsum(NG)])
NSPA = (1, 1, 9, 9, 9, 1, 9, 1, 9, 1, 1, 9, 9, 1, 9, 9)
NSPB = (1, 1, 5, 5, 5, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0)

A0 = [1.66, 1.55, 1.58, 1.66, 1.54, 1.454, 1.89, 1.33,
      1.668, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66, 1.66]
A1 = [0.00, 0.25, 0.22, 0.00, 0.13, 0.446, -0.10, 0.40,
      -0.006, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00]
A2 = [0.00, -12.0, -11.7, 0.00, -0.72, -0.243, 0.19, -0.062,
      0.414, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00, 0.00]


def ftrunc(x):
    return int(x)  # Python int() truncates toward zero like Fortran


# ---------------------------------------------------------------------------
# setcoef (rrtmg_lw_setcoef.f90:50-434)
# ---------------------------------------------------------------------------

def setcoef_1col(nlayers, pavel, tavel, tz, tbound, semiss, coldry, wkl,
                 wbroad, static, istart=1, idrv=0):
    totplnk = static["totplnk"]
    totplk16 = static["totplk16"]
    totplnkd = static["totplnkderiv"]
    totplk16d = static["totplk16deriv"]
    preflog = static["preflog"]
    tref = static["tref"]
    chi = static["chi_mls"]

    stpfac = 296.0 / 1013.0
    o = {}
    o["planklay"] = np.zeros((nlayers, 16))
    o["planklev"] = np.zeros((nlayers + 1, 16))
    o["plankbnd"] = np.zeros(16)
    o["dplankbnd_dt"] = np.zeros(16)
    for name in ("jp", "jt", "jt1", "indself", "indfor", "indminor"):
        o[name] = np.zeros(nlayers, np.int64)
    for name in ("colh2o colco2 colo3 coln2o colco colch4 colo2 colbrd "
                 "fac00 fac01 fac10 fac11 selffac selffrac forfac forfrac "
                 "minorfrac scaleminor scaleminorn2 rat_h2oco2 rat_h2oco2_1 "
                 "rat_h2oo3 rat_h2oo3_1 rat_h2on2o rat_h2on2o_1 rat_h2och4 "
                 "rat_h2och4_1 rat_n2oco2 rat_n2oco2_1 rat_o3co2 "
                 "rat_o3co2_1").split():
        o[name] = np.zeros(nlayers)

    indbound = min(180, max(1, ftrunc(tbound - 159.0)))
    tbndfrac = tbound - 159.0 - indbound
    indlev0 = min(180, max(1, ftrunc(tz[0] - 159.0)))
    t0frac = tz[0] - 159.0 - indlev0
    laytrop = 0

    for lay in range(1, nlayers + 1):
        i = lay - 1
        indlay = min(180, max(1, ftrunc(tavel[i] - 159.0)))
        tlayfrac = tavel[i] - 159.0 - indlay
        indlev = min(180, max(1, ftrunc(tz[lay] - 159.0)))
        tlevfrac = tz[lay] - 159.0 - indlev

        for ib in range(1, 17):
            use16 = (ib == 16 and istart == 16)
            tab = totplk16 if use16 else totplnk[:, ib - 1]
            tabd = totplk16d if use16 else totplnkd[:, ib - 1]
            if lay == 1:
                dbdt = tab[indbound] - tab[indbound - 1]
                o["plankbnd"][ib - 1] = semiss[ib - 1] * (
                    tab[indbound - 1] + tbndfrac * dbdt)
                if idrv == 1:
                    dbdt = tabd[indbound] - tabd[indbound - 1]
                    o["dplankbnd_dt"][ib - 1] = semiss[ib - 1] * (
                        tabd[indbound - 1] + tbndfrac * dbdt)
                # planklev(0,16) keeps the totplnk slope (setcoef.f90:244-246)
                dbdt0 = (totplnk[indlev0, ib - 1]
                         - totplnk[indlev0 - 1, ib - 1])
                base0 = tab[indlev0 - 1]
                o["planklev"][0, ib - 1] = base0 + t0frac * dbdt0
            dbdtlev = tab[indlev] - tab[indlev - 1]
            dbdtlay = tab[indlay] - tab[indlay - 1]
            o["planklay"][i, ib - 1] = tab[indlay - 1] + tlayfrac * dbdtlay
            o["planklev"][lay, ib - 1] = tab[indlev - 1] + tlevfrac * dbdtlev

        plog = np.log(pavel[i])
        jp = min(58, max(1, ftrunc(36.0 - 5.0 * (plog + 0.04))))
        o["jp"][i] = jp
        jp1 = jp + 1
        fp = 5.0 * (preflog[jp - 1] - plog)
        jt = min(4, max(1, ftrunc(3.0 + (tavel[i] - tref[jp - 1]) / 15.0)))
        o["jt"][i] = jt
        ft = (tavel[i] - tref[jp - 1]) / 15.0 - (jt - 3)
        jt1 = min(4, max(1, ftrunc(3.0 + (tavel[i] - tref[jp1 - 1]) / 15.0)))
        o["jt1"][i] = jt1
        ft1 = (tavel[i] - tref[jp1 - 1]) / 15.0 - (jt1 - 3)
        water = wkl[0, i] / coldry[i]
        scalefac = pavel[i] * stpfac / tavel[i]

        if plog > 4.56:
            laytrop += 1
            o["forfac"][i] = scalefac / (1.0 + water)
            factor = (332.0 - tavel[i]) / 36.0
            o["indfor"][i] = min(2, max(1, ftrunc(factor)))
            o["forfrac"][i] = factor - o["indfor"][i]
            o["selffac"][i] = water * o["forfac"][i]
            factor = (tavel[i] - 188.0) / 7.2
            o["indself"][i] = min(9, max(1, ftrunc(factor) - 7))
            o["selffrac"][i] = factor - (o["indself"][i] + 7)
            o["rat_h2oo3"][i] = chi[0, jp - 1] / chi[2, jp - 1]
            o["rat_h2oo3_1"][i] = chi[0, jp] / chi[2, jp]
            o["rat_h2on2o"][i] = chi[0, jp - 1] / chi[3, jp - 1]
            o["rat_h2on2o_1"][i] = chi[0, jp] / chi[3, jp]
            o["rat_h2och4"][i] = chi[0, jp - 1] / chi[5, jp - 1]
            o["rat_h2och4_1"][i] = chi[0, jp] / chi[5, jp]
            o["rat_n2oco2"][i] = chi[3, jp - 1] / chi[1, jp - 1]
            o["rat_n2oco2_1"][i] = chi[3, jp] / chi[1, jp]
        else:
            o["forfac"][i] = scalefac / (1.0 + water)
            factor = (tavel[i] - 188.0) / 36.0
            o["indfor"][i] = 3
            o["forfrac"][i] = factor - 1.0
            o["selffac"][i] = water * o["forfac"][i]
            # indself/selffrac left stale in the reference above laytrop;
            # mirror the lower-region formula (never used there)
            factor2 = (tavel[i] - 188.0) / 7.2
            o["indself"][i] = min(9, max(1, ftrunc(factor2) - 7))
            o["selffrac"][i] = factor2 - (o["indself"][i] + 7)
            o["rat_o3co2"][i] = chi[2, jp - 1] / chi[1, jp - 1]
            o["rat_o3co2_1"][i] = chi[2, jp] / chi[1, jp]

        o["rat_h2oco2"][i] = chi[0, jp - 1] / chi[1, jp - 1]
        o["rat_h2oco2_1"][i] = chi[0, jp] / chi[1, jp]
        o["scaleminor"][i] = pavel[i] / tavel[i]
        o["scaleminorn2"][i] = (pavel[i] / tavel[i]) * (
            wbroad[i] / (coldry[i] + wkl[0, i]))
        factor = (tavel[i] - 180.8) / 7.2
        o["indminor"][i] = min(18, max(1, ftrunc(factor)))
        o["minorfrac"][i] = factor - o["indminor"][i]

        o["colh2o"][i] = 1e-20 * wkl[0, i]
        o["colco2"][i] = 1e-20 * wkl[1, i]
        o["colo3"][i] = 1e-20 * wkl[2, i]
        o["coln2o"][i] = 1e-20 * wkl[3, i]
        o["colco"][i] = 1e-20 * wkl[4, i]
        o["colch4"][i] = 1e-20 * wkl[5, i]
        o["colo2"][i] = 1e-20 * wkl[6, i]
        for name in ("colco2", "colo3", "coln2o", "colco", "colch4"):
            if o[name][i] == 0.0:
                o[name][i] = 1e-32 * coldry[i]
        o["colbrd"][i] = 1e-20 * wbroad[i]

        compfp = 1.0 - fp
        o["fac10"][i] = compfp * ft
        o["fac00"][i] = compfp * (1.0 - ft)
        o["fac11"][i] = fp * ft1
        o["fac01"][i] = fp * (1.0 - ft1)
        o["selffac"][i] = o["colh2o"][i] * o["selffac"][i]
        o["forfac"][i] = o["colh2o"][i] * o["forfac"][i]

    o["laytrop"] = laytrop
    return o


# ---------------------------------------------------------------------------
# taumol (rrtmg_lw_taumol.f90) - scalar, explicit branches
# ---------------------------------------------------------------------------

def _spec(colk1, colk2, rat, mult):
    speccomb = colk1 + rat * colk2
    specparm = colk1 / speccomb
    if specparm >= ONEMINUS:
        specparm = ONEMINUS
    specmult = mult * specparm
    js = 1 + ftrunc(specmult)
    fs = specmult % 1.0
    return speccomb, specparm, js, fs


def _tau_major_lower(absa, ind0, specparm, fs, fac00, fac10, speccomb, ig):
    """taumol.f90:569-663 exactly; ind0 1-based into absa rows."""
    A = lambda r: absa[r - 1, ig]
    if specparm < 0.125:
        p = fs - 1.0
        p4 = p ** 4
        fk0, fk1, fk2 = p4, 1.0 - p - 2.0 * p4, p + p4
        return speccomb * (fk0 * fac00 * A(ind0) + fk1 * fac00 * A(ind0 + 1)
                           + fk2 * fac00 * A(ind0 + 2)
                           + fk0 * fac10 * A(ind0 + 9)
                           + fk1 * fac10 * A(ind0 + 10)
                           + fk2 * fac10 * A(ind0 + 11))
    elif specparm > 0.875:
        p = -fs
        p4 = p ** 4
        fk0, fk1, fk2 = p4, 1.0 - p - 2.0 * p4, p + p4
        return speccomb * (fk2 * fac00 * A(ind0 - 1) + fk1 * fac00 * A(ind0)
                           + fk0 * fac00 * A(ind0 + 1)
                           + fk2 * fac10 * A(ind0 + 8)
                           + fk1 * fac10 * A(ind0 + 9)
                           + fk0 * fac10 * A(ind0 + 10))
    else:
        return speccomb * ((1.0 - fs) * fac00 * A(ind0)
                           + fs * fac00 * A(ind0 + 1)
                           + (1.0 - fs) * fac10 * A(ind0 + 9)
                           + fs * fac10 * A(ind0 + 10))


def taumol_1col(nlayers, sc, pavel, wx, coldry, ktab, static):
    """All 16 bands; returns taug, fracs (nlayers, 140)."""
    chi = static["chi_mls"]
    taug = np.zeros((nlayers, 140))
    fracs = np.zeros((nlayers, 140))
    laytrop = sc["laytrop"]

    def adjcol(i, gas_idx, colgas, thresh, base, expnt, chi_const=None):
        jp = sc["jp"][i]
        chiref = chi_const if chi_const is not None else chi[gas_idx - 1, jp]
        rat = 1e20 * (colgas / coldry[i]) / chiref
        if rat > thresh:
            adjfac = base + (rat - base) ** expnt
            return adjfac * chiref * coldry[i] * 1e-20
        return colgas

    def cont(i, t, self_too=True):
        inds = sc["indself"][i]
        indf = sc["indfor"][i]
        out_self = np.zeros(t["selfref"].shape[1])
        if self_too:
            s = t["selfref"]
            out_self = sc["selffac"][i] * (
                s[inds - 1] + sc["selffrac"][i] * (s[inds] - s[inds - 1]))
        f = t["forref"]
        out_for = sc["forfac"][i] * (
            f[indf - 1] + sc["forfrac"][i] * (f[indf] - f[indf - 1]))
        return out_self, out_for

    def minor_flat(i, tab):
        indm = sc["indminor"][i]
        return tab[indm - 1] + sc["minorfrac"][i] * (tab[indm] - tab[indm - 1])

    def minor_eta(i, tab, colk1, colk2, refrat, mult):
        # tab: (19, nk, ng) [indm, jm, g]
        _, _, jm, fm = _spec(colk1, colk2, refrat, mult)
        indm = sc["indminor"][i]
        m1 = tab[indm - 1, jm - 1] + fm * (tab[indm - 1, jm]
                                           - tab[indm - 1, jm - 1])
        m2 = tab[indm, jm - 1] + fm * (tab[indm, jm] - tab[indm, jm - 1])
        return m1 + sc["minorfrac"][i] * (m2 - m1)

    def frac_eta(i, ftab, colk1, colk2, refrat, mult):
        _, _, jpl, fpl = _spec(colk1, colk2, refrat, mult)
        return ftab[jpl - 1] + fpl * (ftab[jpl] - ftab[jpl - 1])

    def ind_lower(i, b, js):
        return ((sc["jp"][i] - 1) * 5 + (sc["jt"][i] - 1)) * NSPA[b - 1] + js

    def ind1_lower(i, b, js1):
        return (sc["jp"][i] * 5 + (sc["jt1"][i] - 1)) * NSPA[b - 1] + js1

    def ind_upper(i, b, js):
        return ((sc["jp"][i] - 13) * 5 + (sc["jt"][i] - 1)) * NSPB[b - 1] + js

    def ind1_upper(i, b, js1):
        return ((sc["jp"][i] - 12) * 5 + (sc["jt1"][i] - 1)) * NSPB[b - 1] + js1

    def tau_1key_lower(i, t, colx, b):
        ind0 = ind_lower(i, b, 1)
        ind1 = ind1_lower(i, b, 1)
        A = t["absa"]
        return colx * (sc["fac00"][i] * A[ind0 - 1]
                       + sc["fac10"][i] * A[ind0]
                       + sc["fac01"][i] * A[ind1 - 1]
                       + sc["fac11"][i] * A[ind1])

    def tau_1key_upper(i, t, colx, b):
        ind0 = ind_upper(i, b, 1)
        ind1 = ind1_upper(i, b, 1)
        Bt = t["absb"]
        return colx * (sc["fac00"][i] * Bt[ind0 - 1]
                       + sc["fac10"][i] * Bt[ind0]
                       + sc["fac01"][i] * Bt[ind1 - 1]
                       + sc["fac11"][i] * Bt[ind1])

    def tau_2key_lower(i, t, colk1, colk2, ratname, b, ig_count):
        rat0 = sc["rat_" + ratname][i]
        rat1 = sc["rat_" + ratname + "_1"][i]
        speccomb, specparm, js, fs = _spec(colk1, colk2, rat0, 8.0)
        speccomb1, specparm1, js1, fs1 = _spec(colk1, colk2, rat1, 8.0)
        ind0 = ind_lower(i, b, js)
        ind1 = ind1_lower(i, b, js1)
        out = np.zeros(ig_count)
        for ig in range(ig_count):
            out[ig] = (_tau_major_lower(t["absa"], ind0, specparm, fs,
                                        sc["fac00"][i], sc["fac10"][i],
                                        speccomb, ig)
                       + _tau_major_lower(t["absa"], ind1, specparm1, fs1,
                                          sc["fac01"][i], sc["fac11"][i],
                                          speccomb1, ig))
        return out

    def tau_2key_upper(i, t, colk1, colk2, ratname, b):
        rat0 = sc["rat_" + ratname][i]
        rat1 = sc["rat_" + ratname + "_1"][i]
        speccomb, _, js, fs = _spec(colk1, colk2, rat0, 4.0)
        speccomb1, _, js1, fs1 = _spec(colk1, colk2, rat1, 4.0)
        ind0 = ind_upper(i, b, js)
        ind1 = ind1_upper(i, b, js1)
        Bt = t["absb"]
        out = (speccomb * ((1 - fs) * sc["fac00"][i] * Bt[ind0 - 1]
                           + fs * sc["fac00"][i] * Bt[ind0]
                           + (1 - fs) * sc["fac10"][i] * Bt[ind0 + 4]
                           + fs * sc["fac10"][i] * Bt[ind0 + 5])
               + speccomb1 * ((1 - fs1) * sc["fac01"][i] * Bt[ind1 - 1]
                              + fs1 * sc["fac01"][i] * Bt[ind1]
                              + (1 - fs1) * sc["fac11"][i] * Bt[ind1 + 4]
                              + fs1 * sc["fac11"][i] * Bt[ind1 + 5]))
        return out

    def refrat(g1, g2, p):
        return chi[g1 - 1, p - 1] / chi[g2 - 1, p - 1]

    col = lambda name, i: sc["col" + name][i]

    for i in range(nlayers):
        lower = i < laytrop
        g0 = 0

        # ---- band 1 ----
        t = ktab["b01"]
        tsel, tfor = cont(i, t, self_too=lower)
        scalen2 = sc["colbrd"][i] * sc["scaleminorn2"][i]
        if lower:
            taun2 = scalen2 * minor_flat(i, t["ka_mn2"])
            pp = pavel[i]
            corradj = 1.0 - 0.15 * (250.0 - pp) / 154.4 if pp < 250.0 else 1.0
            taug[i, :10] = corradj * (tau_1key_lower(i, t, col("h2o", i), 1)
                                      + tsel + tfor + taun2)
            fracs[i, :10] = t["fracrefa"]
        else:
            taun2 = scalen2 * minor_flat(i, t["kb_mn2"])
            corradj = 1.0 - 0.15 * (pavel[i] / 95.6)
            taug[i, :10] = corradj * (tau_1key_upper(i, t, col("h2o", i), 1)
                                      + tfor + taun2)
            fracs[i, :10] = t["fracrefb"]
        g0 = 10

        # ---- band 2 ----
        t = ktab["b02"]
        tsel, tfor = cont(i, t, self_too=lower)
        if lower:
            corradj = 1.0 - 0.05 * (pavel[i] - 100.0) / 900.0
            taug[i, g0:g0+12] = corradj * (
                tau_1key_lower(i, t, col("h2o", i), 2) + tsel + tfor)
            fracs[i, g0:g0+12] = t["fracrefa"]
        else:
            taug[i, g0:g0+12] = tau_1key_upper(i, t, col("h2o", i), 2) + tfor
            fracs[i, g0:g0+12] = t["fracrefb"]
        g0 += 12

        # ---- band 3 ----
        t = ktab["b03"]
        tsel, tfor = cont(i, t, self_too=lower)
        an2o = adjcol(i, 4, col("n2o", i), 1.5, 0.5, 0.65)
        if lower:
            absn2o = minor_eta(i, t["ka_mn2o"], col("h2o", i),
                               col("co2", i), refrat(1, 2, 3), 8.0)
            taug[i, g0:g0+16] = (
                tau_2key_lower(i, t, col("h2o", i), col("co2", i),
                               "h2oco2", 3, 16)
                + tsel + tfor + an2o * absn2o)
            fracs[i, g0:g0+16] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                          col("co2", i), refrat(1, 2, 9), 8.0)
        else:
            absn2o = minor_eta(i, t["kb_mn2o"], col("h2o", i),
                               col("co2", i), refrat(1, 2, 13), 4.0)
            taug[i, g0:g0+16] = (
                tau_2key_upper(i, t, col("h2o", i), col("co2", i),
                               "h2oco2", 3)
                + tfor + an2o * absn2o)
            fracs[i, g0:g0+16] = frac_eta(i, t["fracrefb"], col("h2o", i),
                                          col("co2", i), refrat(1, 2, 13), 4.0)
        g0 += 16

        # ---- band 4 ----
        t = ktab["b04"]
        tsel, tfor = cont(i, t, self_too=lower)
        if lower:
            taug[i, g0:g0+14] = (
                tau_2key_lower(i, t, col("h2o", i), col("co2", i),
                               "h2oco2", 4, 14) + tsel + tfor)
            fracs[i, g0:g0+14] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                          col("co2", i), refrat(1, 2, 11), 8.0)
        else:
            v = tau_2key_upper(i, t, col("o3", i), col("co2", i), "o3co2", 4)
            for gg, fac in zip((8, 9, 10, 11, 12, 13, 14),
                               (0.92, 0.88, 1.07, 1.1, 0.99, 0.88, 0.943)):
                v[gg - 1] *= fac
            taug[i, g0:g0+14] = v
            fracs[i, g0:g0+14] = frac_eta(i, t["fracrefb"], col("o3", i),
                                          col("co2", i), refrat(3, 2, 13), 4.0)
        g0 += 14

        # ---- band 5 ----
        t = ktab["b05"]
        tsel, tfor = cont(i, t, self_too=lower)
        if lower:
            abso3 = minor_eta(i, t["ka_mo3"], col("h2o", i), col("co2", i),
                              refrat(1, 2, 7), 8.0)
            taug[i, g0:g0+16] = (
                tau_2key_lower(i, t, col("h2o", i), col("co2", i),
                               "h2oco2", 5, 16)
                + tsel + tfor + abso3 * col("o3", i)
                + wx[0, i] * t["ccl4"])
            fracs[i, g0:g0+16] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                          col("co2", i), refrat(1, 2, 5), 8.0)
        else:
            taug[i, g0:g0+16] = (
                tau_2key_upper(i, t, col("o3", i), col("co2", i), "o3co2", 5)
                + wx[0, i] * t["ccl4"])
            fracs[i, g0:g0+16] = frac_eta(i, t["fracrefb"], col("o3", i),
                                          col("co2", i), refrat(3, 2, 43), 4.0)
        g0 += 16

        # ---- band 6 ----
        t = ktab["b06"]
        tsel, tfor = cont(i, t, self_too=lower)
        if lower:
            aco2 = adjcol(i, 2, col("co2", i), 3.0, 2.0, 0.77)
            absco2 = minor_flat(i, t["ka_mco2"])
            taug[i, g0:g0+8] = (tau_1key_lower(i, t, col("h2o", i), 6)
                                + tsel + tfor + aco2 * absco2
                                + wx[1, i] * t["cfc11adj"]
                                + wx[2, i] * t["cfc12"])
        else:
            taug[i, g0:g0+8] = (wx[1, i] * t["cfc11adj"]
                                + wx[2, i] * t["cfc12"])
        fracs[i, g0:g0+8] = t["fracrefa"]
        g0 += 8

        # ---- band 7 ----
        t = ktab["b07"]
        tsel, tfor = cont(i, t, self_too=lower)
        if lower:
            aco2 = adjcol(i, 2, col("co2", i), 3.0, 3.0, 0.79)
            absco2 = minor_eta(i, t["ka_mco2"], col("h2o", i), col("o3", i),
                               refrat(1, 3, 3), 8.0)
            taug[i, g0:g0+12] = (
                tau_2key_lower(i, t, col("h2o", i), col("o3", i),
                               "h2oo3", 7, 12)
                + tsel + tfor + aco2 * absco2)
            fracs[i, g0:g0+12] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                          col("o3", i), refrat(1, 3, 3), 8.0)
        else:
            aco2 = adjcol(i, 2, col("co2", i), 3.0, 2.0, 0.79)
            absco2 = minor_flat(i, t["kb_mco2"])
            v = tau_1key_upper(i, t, col("o3", i), 7) + aco2 * absco2
            for gg, fac in zip((6, 7, 8, 9, 10, 11),
                               (0.92, 0.88, 1.07, 1.1, 0.99, 0.855)):
                v[gg - 1] *= fac
            taug[i, g0:g0+12] = v
            fracs[i, g0:g0+12] = t["fracrefb"]
        g0 += 12

        # ---- band 8 ----
        t = ktab["b08"]
        tsel, tfor = cont(i, t, self_too=lower)
        aco2 = adjcol(i, 2, col("co2", i), 3.0, 2.0, 0.65)
        if lower:
            taug[i, g0:g0+8] = (
                tau_1key_lower(i, t, col("h2o", i), 8) + tsel + tfor
                + aco2 * minor_flat(i, t["ka_mco2"])
                + col("o3", i) * minor_flat(i, t["ka_mo3"])
                + col("n2o", i) * minor_flat(i, t["ka_mn2o"])
                + wx[2, i] * t["cfc12"] + wx[3, i] * t["cfc22adj"])
            fracs[i, g0:g0+8] = t["fracrefa"]
        else:
            taug[i, g0:g0+8] = (
                tau_1key_upper(i, t, col("o3", i), 8)
                + aco2 * minor_flat(i, t["kb_mco2"])
                + col("n2o", i) * minor_flat(i, t["kb_mn2o"])
                + wx[2, i] * t["cfc12"] + wx[3, i] * t["cfc22adj"])
            fracs[i, g0:g0+8] = t["fracrefb"]
        g0 += 8

        # ---- band 9 ----
        t = ktab["b09"]
        tsel, tfor = cont(i, t, self_too=lower)
        an2o = adjcol(i, 4, col("n2o", i), 1.5, 0.5, 0.65)
        if lower:
            absn2o = minor_eta(i, t["ka_mn2o"], col("h2o", i),
                               col("ch4", i), refrat(1, 6, 3), 8.0)
            taug[i, g0:g0+12] = (
                tau_2key_lower(i, t, col("h2o", i), col("ch4", i),
                               "h2och4", 9, 12)
                + tsel + tfor + an2o * absn2o)
            fracs[i, g0:g0+12] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                          col("ch4", i), refrat(1, 6, 9), 8.0)
        else:
            absn2o = minor_flat(i, t["kb_mn2o"])
            taug[i, g0:g0+12] = (tau_1key_upper(i, t, col("ch4", i), 9)
                                 + an2o * absn2o)
            fracs[i, g0:g0+12] = t["fracrefb"]
        g0 += 12

        # ---- band 10 ----
        t = ktab["b10"]
        tsel, tfor = cont(i, t, self_too=lower)
        if lower:
            taug[i, g0:g0+6] = (tau_1key_lower(i, t, col("h2o", i), 10)
                                + tsel + tfor)
            fracs[i, g0:g0+6] = t["fracrefa"]
        else:
            taug[i, g0:g0+6] = tau_1key_upper(i, t, col("h2o", i), 10) + tfor
            fracs[i, g0:g0+6] = t["fracrefb"]
        g0 += 6

        # ---- band 11 ----
        t = ktab["b11"]
        tsel, tfor = cont(i, t, self_too=lower)
        scaleo2 = col("o2", i) * sc["scaleminor"][i]
        if lower:
            tauo2 = scaleo2 * minor_flat(i, t["ka_mo2"])
            taug[i, g0:g0+8] = (tau_1key_lower(i, t, col("h2o", i), 11)
                                + tsel + tfor + tauo2)
            fracs[i, g0:g0+8] = t["fracrefa"]
        else:
            tauo2 = scaleo2 * minor_flat(i, t["kb_mo2"])
            taug[i, g0:g0+8] = (tau_1key_upper(i, t, col("h2o", i), 11)
                                + tfor + tauo2)
            fracs[i, g0:g0+8] = t["fracrefb"]
        g0 += 8

        # ---- band 12 ----
        t = ktab["b12"]
        if lower:
            tsel, tfor = cont(i, t)
            taug[i, g0:g0+8] = (
                tau_2key_lower(i, t, col("h2o", i), col("co2", i),
                               "h2oco2", 12, 8) + tsel + tfor)
            fracs[i, g0:g0+8] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                         col("co2", i), refrat(1, 2, 10), 8.0)
        g0 += 8

        # ---- band 13 ----
        t = ktab["b13"]
        if lower:
            tsel, tfor = cont(i, t)
            aco2 = adjcol(i, 2, col("co2", i), 3.0, 2.0, 0.68,
                          chi_const=3.55e-4)
            absco2 = minor_eta(i, t["ka_mco2"], col("h2o", i),
                               col("n2o", i), refrat(1, 4, 1), 8.0)
            absco = minor_eta(i, t["ka_mco"], col("h2o", i),
                              col("n2o", i), refrat(1, 4, 3), 8.0)
            taug[i, g0:g0+4] = (
                tau_2key_lower(i, t, col("h2o", i), col("n2o", i),
                               "h2on2o", 13, 4)
                + tsel + tfor + aco2 * absco2 + col("co", i) * absco)
            fracs[i, g0:g0+4] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                         col("n2o", i), refrat(1, 4, 5), 8.0)
        else:
            abso3 = minor_flat(i, t["kb_mo3"])
            taug[i, g0:g0+4] = col("o3", i) * abso3
            fracs[i, g0:g0+4] = t["fracrefb"]
        g0 += 4

        # ---- band 14 ----
        t = ktab["b14"]
        if lower:
            tsel, tfor = cont(i, t)
            taug[i, g0:g0+2] = (tau_1key_lower(i, t, col("co2", i), 14)
                                + tsel + tfor)
            fracs[i, g0:g0+2] = t["fracrefa"]
        else:
            taug[i, g0:g0+2] = tau_1key_upper(i, t, col("co2", i), 14)
            fracs[i, g0:g0+2] = t["fracrefb"]
        g0 += 2

        # ---- band 15 ----
        t = ktab["b15"]
        if lower:
            tsel, tfor = cont(i, t)
            scalen2 = sc["colbrd"][i] * sc["scaleminor"][i]
            taun2 = scalen2 * minor_eta(i, t["ka_mn2"], col("n2o", i),
                                        col("co2", i), refrat(4, 2, 1), 8.0)
            taug[i, g0:g0+2] = (
                tau_2key_lower(i, t, col("n2o", i), col("co2", i),
                               "n2oco2", 15, 2)
                + tsel + tfor + taun2)
            fracs[i, g0:g0+2] = frac_eta(i, t["fracrefa"], col("n2o", i),
                                         col("co2", i), refrat(4, 2, 1), 8.0)
        g0 += 2

        # ---- band 16 ----
        t = ktab["b16"]
        if lower:
            tsel, tfor = cont(i, t)
            taug[i, g0:g0+2] = (
                tau_2key_lower(i, t, col("h2o", i), col("ch4", i),
                               "h2och4", 16, 2) + tsel + tfor)
            fracs[i, g0:g0+2] = frac_eta(i, t["fracrefa"], col("h2o", i),
                                         col("ch4", i), refrat(1, 6, 6), 8.0)
        else:
            taug[i, g0:g0+2] = tau_1key_upper(i, t, col("ch4", i), 16)
            fracs[i, g0:g0+2] = t["fracrefb"]
        g0 += 2
        assert g0 == 140

    return taug, fracs
