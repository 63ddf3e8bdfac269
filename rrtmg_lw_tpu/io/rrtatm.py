"""RRTATM — the column-mode atmosphere builder (IATM=1).

Host-side reimplementation of the LBLATM-derived
atmosphere processor the reference ships as ``src/rrtatm.f`` (7939 lines
of fixed-form F77).  Given LBLRTM-style records 3.1-3.6 it builds the
layered atmosphere (level pressures/temperatures, layer means, absolute
molecular column amounts) that the radiation core consumes.

Scope: the vertical-path slice the RRTM column driver actually uses.
The reference *forces* ``ITYPE=2`` and ``ANGLE=0`` (rrtatm.f:581-583,
789), so every path is a straight vertical ray; the refractive ray-trace
generality of LBLATM collapses to vertical quadrature.  Implemented:

  * MODEL 0 user profiles on an altitude grid (records 3.4-3.6,
    ``NSMDL``/``RDUNIT`` rrtatm.f:3038-3392) and on a pressure grid
    (IMMAX<0, hydrostatic altitudes via ``CMPALT`` rrtatm.f:7817-7939)
  * MODEL 1-6 built-in AFGL standard atmospheres (``MDLATM``
    rrtatm.f:2914-3036; data asset assets/std_atmos.npz)
  * unit conversion JCHAR codes A-H / 1-6 (``JOU``/``CHECK``/``CONVRT``/
    ``WATVAP`` rrtatm.f:3393-3478, 3868-4110) and per-species defaulting
    to a model atmosphere (``DEFALT`` 4-point interpolation,
    rrtatm.f:3480-3673)
  * user layer boundaries in km (IBMAX>0) or mb (IBMAX<0, converted by
    ln-p interpolation blended with hydrostatics, rrtatm.f:903-1125)
  * profile/boundary merge (``AMERGE`` rrtatm.f:5075-5252), vertical
    layer quadrature with exponential sub-layer interpolation in 5-km
    steps (``ALAYER`` rrtatm.f:5253-5495 at SINAI=0), and layer packing
    (``FPACK`` rrtatm.f:5805-5981)

  * automatic layer-boundary selection (``AUTLAY``, IBMAX=0,
    rrtatm.f:5496-5605 with ``HALFWD`` :5713-5745)
  * cross-section molecule profiles with IATM=1 (``XAMNTS``
    rrtatm.f:6089-6591, ``XPROFL``/``XTRACT``/``XINTRP`` :6595-7004,
    standard profiles from BLOCK DATA XMLATM :7008-, name matching per
    ``XSREAD`` extra.f:5-123)

Not implemented (no vertical-path input can reach it): slant/limb
geometry — the driver hard-forces ITYPE=2 with ANGLE=0 at
rrtatm.f:581-583, so RFPATH's refractive ray-trace is dead code for
every RRTM column run; see PARITY.md.

Reference-compatibility note — the AIRMWT quirk: in the reference build
the dry-air molecular weight ``AIRMWT`` lives in COMMON /CONSTS/ but is
never initialized (its DATA statement is commented out, rrtatm.f:1791,
and the column driver fills only the first 9 slots of the common,
rrtmg_lw.1col.f90:792+935).  Static storage makes it 0.0, which zeroes
every species entered as a mass mixing ratio (JCHAR='C', JUNIT=12) via
``WATVAP``/``CONVRT``.  The committed golden output
``output_rrtm_ICRCCM_sonde`` (surface downward flux 106.6 W/m2 for a
290.9 K surface — a bone-dry column) was generated with this behavior,
so ``airmwt=0.0`` is the default here; pass ``airmwt=28.964`` (the
commented-out reference value) for physically-correct conversions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import pathlib
from typing import List, Optional

import numpy as np

from ..constants import ALOSMT, AVOGAD, CLIGHT, GASCON, GRAV, PI
from .fortran_format import ffloat, fint, fstr

PZERO = 1013.25
TZERO = 273.15
GCAIR = 1.0e-3 * GASCON / AVOGAD     # rrtatm.f:664
DELTAS = 5.0                         # nominal path increment, km (:1763)
TOL = 5.0e-4                         # boundary snap tolerance (:5121)
EPSILN = 1.0e-5
AIRMWT_REF = 0.0                     # the uninitialized-common quirk
AIRMWT_PHYS = 28.964                 # rrtatm.f:1791 (commented out)

# molecular weights, rrtatm.f:1792-1802 (AMWT)
AMWT = np.array([
    18.015, 44.010, 47.998, 44.01, 28.011, 16.043, 31.999, 30.01,
    64.06, 46.01, 17.03, 63.01, 17.00, 20.01, 36.46, 80.92,
    127.91, 51.45, 60.08, 30.03, 52.46, 28.014, 27.03, 50.49,
    34.01, 26.03, 30.07, 34.00, 66.01, 146.05, 34.08, 46.03,
    33.00, 15.99, 98.0, 30.00, 97.0, 44.5, 32.04])

# WATVAP saturation-density fit coefficients (rrtatm.f:4023)
_C1, _C2, _C3 = 18.9766, -14.9595, -2.4388

_HMOD_NAMES = ["TROPICAL", "MIDLATITUDE SUMMER", "MIDLATITUDE WINTER",
               "SUBARCTIC SUMMER", "SUBARCTIC WINTER",
               "U. S. STANDARD,  1976"]


@functools.lru_cache()
def load_std_atmos():
    path = pathlib.Path(__file__).resolve().parents[1] / "assets" / \
        "std_atmos.npz"
    d = np.load(path)
    return {k: d[k] for k in d.files}


def jou(char: str) -> int:
    """JCHAR -> JUNIT code (JOU, rrtatm.f:3393-3428)."""
    table = {"1": 1, "2": 2, "3": 3, "4": 4, "5": 5, "6": 6,
             " ": 10, "": 10, "A": 10, "B": 11, "C": 12, "D": 13,
             "E": 14, "F": 15, "G": 16, "H": 17, "I": 18, "J": 19,
             "K": 20}
    if char not in table:
        raise ValueError(f"JOU: bad JCHAR {char!r}")
    return table[char]


def _densat(atemp: float, b: float) -> float:
    return atemp * b * math.exp(_C1 + _C2 * atemp + _C3 * atemp ** 2) * 1e-6


def watvap(p: float, t: float, junit: int, wmol: float,
           airmwt: float) -> float:
    """H2O number density (cm-3) from any input unit (rrtatm.f:3977-4110)."""
    rhoair = ALOSMT * (p / PZERO) * (TZERO / t)
    a = TZERO / t
    b = AVOGAD / AMWT[0]
    r = airmwt / AMWT[0]
    if junit == 10:                       # vmr ppmv
        w = wmol * 1e-6
        return (w / (1.0 + w)) * rhoair
    if junit == 11:                       # number density cm-3
        return wmol
    if junit == 12:                       # mass mixing ratio g/kg
        w = wmol * r * 1.0e-3
        return (w / (1.0 + w)) * rhoair
    if junit == 13:                       # mass density g/m3
        return b * wmol * 1.0e-6
    if junit == 14:                       # partial pressure mb
        return ALOSMT * (wmol / PZERO) * (TZERO / t)
    if junit == 15:                       # dew point K
        atd = TZERO / wmol
        return _densat(atd, b) * wmol / t
    if junit == 16:                       # dew point C
        atd = TZERO / (TZERO + wmol)
        return _densat(atd, b) * (TZERO + wmol) / t
    if junit == 17:                       # relative humidity %
        return _densat(a, b) * (wmol / 100.0)
    raise ValueError(f"WATVAP: bad JUNIT {junit}")


def convrt(p: float, t: float, junit: np.ndarray, wmol: np.ndarray,
           nmol: int, airmwt: float) -> np.ndarray:
    """All-species number densities (cm-3) (CONVRT, rrtatm.f:3868-3976).

    Returns denm(nmol,) with H2O first (via watvap)."""
    rhoair = ALOSMT * (p / PZERO) * (TZERO / t)
    denm = np.zeros(nmol)
    denm[0] = watvap(p, t, int(junit[0]), float(wmol[0]), airmwt)
    dryair = rhoair - denm[0]
    for k in range(1, nmol):
        ju = int(junit[k])
        b = AVOGAD / AMWT[k]
        r = airmwt / AMWT[k]
        if ju <= 10:                      # vmr ppmv (wrt dry air)
            denm[k] = wmol[k] * dryair * 1.0e-6
        elif ju == 11:                    # number density
            denm[k] = wmol[k]
        elif ju == 12:                    # mass mixing ratio g/kg
            denm[k] = r * wmol[k] * 1.0e-3 * dryair
        elif ju == 13:                    # mass density g/m3
            denm[k] = b * wmol[k] * 1.0e-6
        elif ju == 14:                    # partial pressure mb
            denm[k] = ALOSMT * (wmol[k] / PZERO) * (TZERO / t)
        else:
            raise ValueError(f"CONVRT: bad JUNIT({k + 1}) = {ju}")
    return denm


def _four_point(z, grid, i0, i1, i2, i3, x):
    z0, z1, z2, z3 = grid[i0], grid[i1], grid[i2], grid[i3]
    a1 = ((z - z1) * (z - z2) * (z - z3)) / ((z0 - z1) * (z0 - z2) * (z0 - z3))
    a2 = ((z - z2) * (z - z3) * (z - z0)) / ((z1 - z2) * (z1 - z3) * (z1 - z0))
    a3 = ((z - z3) * (z - z0) * (z - z1)) / ((z2 - z3) * (z2 - z0) * (z2 - z1))
    a4 = ((z - z0) * (z - z1) * (z - z2)) / ((z3 - z0) * (z3 - z1) * (z3 - z2))
    return a1 * x[i0] + a2 * x[i1] + a3 * x[i2] + a4 * x[i3]


def defalt(z: float, junitp: int, junitt: int, junit: np.ndarray,
           wmol: np.ndarray, nmol: int):
    """Fill defaulted P/T/species from a model atmosphere at altitude z
    by 4-point Lagrange interpolation (DEFALT, rrtatm.f:3480-3673).

    Mutates wmol/junit in place; returns (p_or_None, t_or_None)."""
    std = load_std_atmos()
    alt = std["alt"]
    im50 = 50
    i2 = im50 - 1
    for im in range(1, im50):
        if alt[im] >= z:
            i2 = im
            break
    i1, i0, i3 = i2 - 1, i2 - 2, i2 + 1
    if i0 < 0:
        i0, i1, i2, i3 = i1, i2, i3, i3 + 1
    elif i3 > im50 - 1:
        if z > alt[im50 - 1]:
            raise ValueError(f"DEFALT: z = {z} above 120 km")
        i3, i2, i1 = i2, i1, i0
        i0 = i1 - 1
    p_out = t_out = None
    if junitp <= 6:
        logp = _four_point(z, alt, i0, i1, i2, i3,
                           np.log(std["pmdl"][junitp - 1]))
        p_out = math.exp(logp)
    if junitt <= 6:
        t_out = _four_point(z, alt, i0, i1, i2, i3, std["tmdl"][junitt - 1])
    for k in range(nmol):
        ju = int(junit[k])
        if ju > 6:
            continue
        if k < 7:
            prof = std["amol"][ju - 1, k]
        else:
            prof = std["trac"][k - 7]     # molecules 8-28: US-std only
        wmol[k] = _four_point(z, alt, i0, i1, i2, i3, prof)
        junit[k] = 10                     # now vmr ppmv
    return p_out, t_out


def cmpalt(pm, tm, denw, ref_z, ref_lat):
    """Hydrostatic altitudes (km) from a pressure/temperature profile
    (CMPALT, rrtatm.f:7817-7939)."""
    n = len(pm)
    ca0, ca1, ca2 = 1.58123e-6, -2.9331e-8, 1.1043e-10
    cb0, cb1 = 5.707e-6, -2.051e-8
    cc0, cc1 = 1.9898e-4, -2.376e-6
    cd, ce = 1.83e-11, -0.0765e-8
    xmass_h2o, xmass_dry = 0.018015, 0.0289654
    xr = xmass_h2o / xmass_dry
    g0 = GRAV * 100.0 - 2.586 * math.cos(2.0 * PI * ref_lat / 180.0)
    # NB the reference uses GRAV from /CONSTS/ in cm/s2 units here; our
    # GRAV is m/s2, converted above.
    boltz_cgs = 1.3806503e-16
    h2o_mix = np.empty(n)
    comp = np.empty(n)
    for j in range(n):
        dt = tm[j] - 273.15
        total_air = pm[j] * 1.0e3 / (boltz_cgs * tm[j])
        dry_air = total_air - denw[j]
        h2o_mix[j] = denw[j] / dry_air
        chim = xr * h2o_mix[j]
        comp[j] = 1.0 - (pm[j] * 100 / tm[j]) * (
            ca0 + ca1 * dt + ca2 * dt ** 2
            + (cb0 + cb1 * dt) * chim + (cc0 + cc1 * dt) * chim ** 2) \
            + (cd + ce * chim ** 2) * (pm[j] * 100.0 / tm[j]) ** 2
    re = 6371.23
    ztemp = np.empty(n)
    zmdl = np.empty(n)
    ztemp[0] = ref_z * 1000.0
    zmdl[0] = ref_z
    for i in range(n - 1):
        gave = g0 * (re / (re + ztemp[i] / 1000.0)) ** 2 / 100.0
        y = math.log(pm[i + 1] / pm[i])
        if y != 0.0:
            chi0 = h2o_mix[i]
            dchi = (h2o_mix[i + 1] - h2o_mix[i]) / y
            t0 = tm[i]
            dt = (tm[i + 1] - tm[i]) / y
            c1 = t0 + t0 * chi0
            c2 = t0 * dchi + dt * chi0 + dt
            c3 = dt * dchi
            bb = 1.0 + xr * chi0
            alpha = xr * dchi / bb
            if abs(alpha * y) >= 0.01:
                raise ValueError("CMPALT: layer too thick")
            xint = c1 * y + 0.5 * (c2 - c1 * alpha) * y ** 2 \
                + 0.3333 * (c3 - c2 * alpha + c1 * alpha ** 2) * y ** 3
            xint = -xint * (GASCON * 1.0e-7) / (xmass_dry * gave * bb)
            ztemp[i + 1] = ztemp[i] + xint * comp[i]
            zmdl[i + 1] = ztemp[i + 1] / 1000.0
        else:
            ztemp[i + 1] = zmdl[i] * 1000.0
            zmdl[i + 1] = zmdl[i]
    return zmdl


def expint(x1: float, x2: float, a: float) -> float:
    """Exponential interpolation (EXPINT, extra.f:223-244)."""
    if x1 == 0.0 or x2 == 0.0:
        return x1 + (x2 - x1) * a
    return x1 * (x2 / x1) ** a


@dataclasses.dataclass
class Profile:
    """The level profile RRTATM integrates (ZMDL grid)."""
    zmdl: np.ndarray         # (n,) km
    pm: np.ndarray           # (n,) mb
    tm: np.ndarray           # (n,) K
    denm: np.ndarray         # (nmol, n) number densities cm-3
    denw: np.ndarray         # (n,) water cm-3
    hmod: str = ""
    dryair: Optional[np.ndarray] = None      # (n,) dry air cm-3 (/DEAMT/)


# ---------------------------------------------------------------------------
# AUTLAY — automatic layer-boundary selection (IBMAX=0)
# ---------------------------------------------------------------------------

# HALFWD constants (rrtatm.f:1766-1770, :526-528): mean Lorentz width at
# STP, mean molecular weight for the Doppler width, Doppler constant.
ALZERO = 0.04
AVMWT = 36.0
ADCON = math.sqrt(2.0 * math.log(2.0) * GASCON / CLIGHT ** 2)


def _halfwd(z: float, xvbar: float, prof: Profile) -> tuple:
    """(P, T, alpha_lorentz, alpha_doppler, alpha_voigt) at altitude z
    (HALFWD, rrtatm.f:5713-5745): P by exponential, T by linear
    interpolation on the ZMDL grid, then the halfwidth functions
    ALPHAL/ALPHAD/ALPHAV (:5727-5729)."""
    zmdl, pm, tm = prof.zmdl, prof.pm, prof.tm
    im = int(np.searchsorted(zmdl, z))        # first ZMDL >= z
    im = min(max(im, 1), len(zmdl) - 1)
    fac = (z - zmdl[im - 1]) / (zmdl[im] - zmdl[im - 1])
    p = expint(pm[im - 1], pm[im], fac)
    t = tm[im - 1] + (tm[im] - tm[im - 1]) * fac
    al = ALZERO * (p / PZERO) * math.sqrt(296.0 / t)
    ad = ADCON * xvbar * math.sqrt(t / AVMWT)
    av = 0.5 * (al + math.sqrt(al * al + 4.0 * ad * ad))
    return p, t, al, ad, av


def autlay(prof: Profile, hmin: float, hmax: float, avtrat: float,
           tdiff1: float, tdiff2: float, altd1: float, altd2: float,
           xvbar: float = 1.0, ibdim: int = 600) -> np.ndarray:
    """Automatic LBLRTM boundary selection (AUTLAY, rrtatm.f:5496-5605).

    Walks the model grid upward, placing a boundary wherever the Voigt
    halfwidth ratio would exceed ``avtrat`` or the temperature span
    would exceed ``tdiff`` (exponentially interpolated from ``tdiff1``
    at ``altd1`` to ``tdiff2`` at ``altd2``); failed boundaries are
    located by log interpolation and rounded DOWN to the nearest
    0.1 km (ZROUND, :5544).  The RRTM driver pins ``xvbar=1.0``
    (rrtatm.f:587).  Returns the boundary altitudes (km).
    """
    zmdl, tm = prof.zmdl, prof.tm
    hmin = max(hmin, zmdl[0])
    htop = min(hmax, zmdl[-1])
    # first model level above hmin (:4930-4970, 1-based IHMIN)
    ihmin = int(np.searchsorted(zmdl, hmin, side="right"))
    ihmin = min(max(ihmin, 1), len(zmdl) - 1)
    avtm = {}
    _, _, _, _, avtm[ihmin - 1] = _halfwd(zmdl[ihmin - 1], xvbar, prof)

    zbnd = [hmin]
    tbnd = [0.0]
    avoigt = [0.0]
    _, tbnd[0], _, _, avoigt[0] = _halfwd(hmin, xvbar, prof)
    im = ihmin

    for _ in range(10 * ibdim):               # outer: one boundary each
        tmin = tmax = tbnd[-1]
        ind = 0
        zb = tb = av = None
        done = False
        for _ in range(len(zmdl) + 2):        # inner IM walk
            ipass = 0
            zb = min(zmdl[im], htop)
            zbndti = zmdl[im]
            _, tb, _, _, av = _halfwd(zb, xvbar, prof)
            avtm[im] = av
            # Voigt halfwidth ratio test (:5320-5490)
            if avoigt[-1] / av >= avtrat:
                ipass = 1
                av = avoigt[-1] / avtrat
                x = avtm[im] / avtm[im - 1]
                if abs(1.0 - x) < 0.001:
                    zb = (zmdl[im] + zmdl[im - 1]) / 2.0
                else:
                    alogx = math.log(x)
                    y = av / avtm[im - 1]
                    alogy = (1.0 - y if abs(1.0 - y) <= 0.001
                             else math.log(y))
                    zb = zmdl[im - 1] \
                        + (zmdl[im] - zmdl[im - 1]) * alogy / alogx
            # temperature difference test (:5520-5660)
            fac = (zbnd[-1] - altd1) / (altd2 - altd1)
            tdiff = expint(tdiff1, tdiff2, fac)
            if tm[im] > tmax:
                ind, tmax = 1, tm[im]
            if tm[im] < tmin:
                ind, tmin = 2, tm[im]
            if tmax - tmin > tdiff:
                tb = tmin + tdiff if ind == 1 else tmax - tdiff
                ipass = 2
                if abs(tm[im] - tm[im - 1]) < 1.0e-4:
                    zbndti = (zmdl[im] + zmdl[im - 1]) / 2.0
                else:
                    zbndti = zmdl[im - 1] + (zmdl[im] - zmdl[im - 1]) \
                        * (tb - tm[im - 1]) / (tm[im] - tm[im - 1])
            if zbndti < zb:
                zb = zbndti
            if zb >= htop:
                if htop - zbnd[-1] <= 0.1:     # merge with previous
                    zbnd[-1] = htop
                    _, tbnd[-1], _, _, avoigt[-1] = _halfwd(htop, xvbar,
                                                            prof)
                else:
                    zbnd.append(htop)
                    _, t2, _, _, a2 = _halfwd(htop, xvbar, prof)
                    tbnd.append(t2)
                    avoigt.append(a2)
                done = True
                break
            if ipass == 0:
                im += 1                        # try the next model level
                continue
            # a test failed: round down and emit this boundary (:5996)
            zb = 0.1 * int(10.0 * zb)
            _, tb, _, _, av = _halfwd(zb, xvbar, prof)
            zbnd.append(zb)
            tbnd.append(tb)
            avoigt.append(av)
            break
        if done:
            break
        if len(zbnd) > ibdim:
            raise ValueError("AUTLAY: boundary count exceeds IBDIM "
                             "(avtrat/tdiff too small?)")
    else:
        raise ValueError("AUTLAY failed to reach the path top")
    return np.asarray(zbnd)


# ---------------------------------------------------------------------------
# XAMNTS — cross-section molecule profiles + amounts (IXSECT=1, IATM=1)
# ---------------------------------------------------------------------------

# Master cross-section molecule list: name/alias -> index 1..14
# (BLOCK DATA BXSECT, extra.f:145-164; indices 15-38 are unmatchable
# ' ZZZZZZZZ ' placeholders).  XSREAD STOPs on an unmatched name.
_XS_MASTER = {}
for _j, _names in enumerate([
        ("CLONO2", "CLNO3"),
        ("HNO4",),
        ("CHCL2F", "CFC21", "F21"),
        ("CCL4",),
        ("CCL3F", "CFCL3", "CFC11", "F11"),
        ("CCL2F2", "CF2CL2", "CFC12", "F12"),
        ("C2CL2F4", "C2F4CL2", "CFC114", "F114"),
        ("C2CL3F3", "C2F3CL3", "CFC113", "F113"),
        ("N2O5",),
        ("HNO3",),
        ("CF4", "CFC14", "F14"),
        ("CHCLF2", "CHF2CL", "CFC22", "F22"),
        ("CCLF3", "CFC13", "F13"),
        ("C2CLF5", "CFC115", "F115")]):
    for _n in _names:
        _XS_MASTER[_n] = _j + 1
del _j, _names, _n


def _xtract(z: float, ix: int, altx: np.ndarray,
            amolx: np.ndarray) -> float:
    """Standard-profile mixing ratio at altitude ``z`` for master
    molecule ``ix`` (XTRACT, rrtatm.f:6865-6921).  Faithful to the
    reference's argument order: ``EXPINT(out, AMOLX(L), AMOLX(L-1), A)``
    with ``A`` measured from ALTX(L-1) — i.e. at A=0 the value of the
    level *above* is returned.  That inversion is the reference's
    behavior, so it is preserved for parity."""
    lx = int(np.searchsorted(altx, z))       # smallest ALTX(L) >= z
    lx = min(max(lx, 1), len(altx) - 1)
    a = (z - altx[lx - 1]) / (altx[lx] - altx[lx - 1])
    return expint(amolx[ix - 1, lx], amolx[ix - 1, lx - 1], a)


def read_xamnts(lines: List[str], i: int, prof: Profile,
                zbnd: np.ndarray, h1: float, h2: float, ref_lat: float,
                ) -> tuple:
    """Records 3.7-3.8.2 -> layer cross-section amounts (XAMNTS,
    rrtatm.f:6089-6591).  Returns (nxmol, ixindx, xamnt, next_line).

    The x-molecule volume-mixing-ratio profiles are assembled on their
    own grid (standard XMLATM profiles for IPRFL=1, or user records 3.8*
    for IPRFL=0, per XPROFL rrtatm.f:6595-6861), interpolated onto the
    model grid and converted to number density (XINTRP :6925-7004), and
    then integrated over the SAME vertical path/layering as the regular
    molecules (the reference re-runs RFPATH with NMOL=IXMOLS,
    :6336-6351; on the forced vertical path that is exactly the
    AMERGE/ALAYER/FPACK quadrature)."""
    std = load_std_atmos()
    altx, amolx = std["altx"], std["amolx"]

    # record 3.7 (3I5): IXMOLS, IPRFL (0 user / 1 standard), IXSBIN
    l = lines[i]; i += 1
    ixmols = fint(l, 1, 5)
    iprfl = fint(l, 6, 5)
    if iprfl not in (0, 1):
        raise ValueError(f"XAMNTS: IPRFL is not 0 or 1 (got {iprfl})")
    # record 3.7.1 (7A10 then 8A10 with format reversion: at most 8
    # names per continuation record, extra.f:70-75): molecule names
    names = []
    l = lines[i]; i += 1
    for k in range(min(ixmols, 7)):
        names.append(fstr(l, 1 + 10 * k, 10).strip().upper())
    m = 7
    while m < ixmols:
        l = lines[i]; i += 1
        n = min(8, ixmols - m)
        for k in range(n):
            names.append(fstr(l, 1 + 10 * k, 10).strip().upper())
        m += n
    ixindx = []
    for n in names:
        if n not in _XS_MASTER:
            raise ValueError(f"XSREAD: the name {n!r} is not one of the "
                             "cross-section molecules")
        ixindx.append(_XS_MASTER[n])

    zmdl, pm, tm = prof.zmdl, prof.pm, prof.tm
    immax = len(zmdl)

    if iprfl > 0:
        # standard profiles: ZX=ALTX, DENX straight from AMOLX (ppmv)
        zx = altx
        denx = np.stack([amolx[ix - 1] for ix in ixindx])
    else:
        # record 3.8 (2I5,A): LAYX, IZORP (0 altitude / 1 pressure grid)
        l = lines[i]; i += 1
        layx = fint(l, 1, 5)
        izorp = fint(l, 6, 5)
        zorp = np.zeros(layx)
        jchar = []
        dtmp = np.zeros((ixmols, layx))
        for lev in range(layx):
            # record 3.8.1 (F10.3,5X,38A1)
            l = lines[i]; i += 1
            zorp[lev] = ffloat(l, 1, 10)
            jchar.append([fstr(l, 16 + k, 1) for k in range(ixmols)])
            # record 3.8.2 (8E10.3, continuation every 8 values)
            m = 0
            while m < ixmols:
                l = lines[i]; i += 1
                n = min(8, ixmols - m)
                for k in range(n):
                    dtmp[m + k, lev] = ffloat(l, 1 + 10 * k, 10)
                m += n
        if izorp == 1:
            # pressure grid -> altitudes, ln-p/hydrostatic blend
            # (rrtatm.f:6741-6814 — same scheme as the 3.3B boundaries)
            zx = _pbnd_to_zbnd(zorp, prof, ref_lat)
            if np.any(np.diff(zx) <= 0):
                raise ValueError("XPROFL: cross-section profile "
                                 "altitudes not ascending")
        else:
            zx = zorp
        # JCHAR '1': take the standard profile at this level (XTRACT)
        for lev in range(layx):
            for k in range(ixmols):
                if jchar[lev][k] == "1":
                    dtmp[k, lev] = _xtract(zx[lev], ixindx[k], altx, amolx)
        denx = dtmp

    layx = len(zx)
    # XINTRP: interpolate DENX(ZX) -> model grid, convert ppmv to
    # number density with the dry-air density (rrtatm.f:6968-6998)
    if prof.dryair is not None:
        dryair = np.where(prof.dryair == 0.0,
                          ALOSMT * (pm / PZERO) / (tm / TZERO),
                          prof.dryair)
    else:
        dryair = ALOSMT * (pm / PZERO) / (tm / TZERO)
    denm_x = np.zeros((ixmols, immax))
    lx = 1
    for lev in range(immax):
        while not (zmdl[lev] <= zx[lx] or lx == layx - 1):
            lx += 1
        a = (zmdl[lev] - zx[lx - 1]) / (zx[lx] - zx[lx - 1])
        for k in range(ixmols):
            denm_x[k, lev] = expint(denx[k, lx - 1], denx[k, lx], a) \
                * dryair[lev] * 1.0e-6

    # integrate over the identical vertical path (RFPATH re-run with
    # NMOL=IXMOLS, rrtatm.f:6336-6359)
    prof_x = Profile(zmdl, pm, tm, denm_x, prof.denw, dryair=prof.dryair)
    res_x = vertical_path(prof_x, zbnd, h1, h2, nmol=ixmols,
                          ref_lat=ref_lat)
    return ixmols, tuple(ixindx), res_x.amount, i


@dataclasses.dataclass
class RRTATMResult:
    nlayers: int
    pavel: np.ndarray        # (L,) layer mean pressure, mb
    tavel: np.ndarray        # (L,) layer mean temperature, K
    pz: np.ndarray           # (L+1,) level pressures
    tz: np.ndarray           # (L+1,) level temperatures
    altz: np.ndarray         # (L+1,) level altitudes, km
    amount: np.ndarray       # (nmol, L) absolute column amounts, mol/cm2
    wn2l: np.ndarray         # (L,) broadening-gas column, mol/cm2
    rhosum: np.ndarray       # (L,) total air column, mol/cm2
    ref_lat: float
    hmod: str
    # cross-section molecules (IXSECT=1, XAMNTS): /PATHX/ contents
    nxmol: int = 0
    ixindx: tuple = ()       # master-list indices 1..14 (extra.f:145-164)
    xamnt: Optional[np.ndarray] = None       # (nxmol, L) mol/cm2


def build_model_profile(model: int, nmol: int = 7,
                        hspace: float = 100.0) -> Profile:
    """MODEL 1-6 built-in AFGL atmosphere (MDLATM, rrtatm.f:2914-3036)."""
    std = load_std_atmos()
    # truncate at hspace (rrtatm.f:3020-3024)
    alt = std["alt"]
    ispace = int(np.nonzero(hspace + 0.001 > alt)[0][-1]) + 1
    zmdl = alt[:ispace].copy()
    pm = std["pmdl"][model - 1, :ispace].copy()
    tm = std["tmdl"][model - 1, :ispace].copy()
    amol = std["amol"][model - 1, :, :ispace]
    denm = np.zeros((nmol, ispace))
    denw = amol[0] * amol[7] * 1.0e-6          # H2O from total density
    dryair = amol[7] - denw
    denm[0] = denw
    for k in range(1, min(nmol, 7)):
        denm[k] = amol[k] * 1.0e-6 * dryair
    for k in range(7, nmol):
        denm[k] = std["trac"][k - 7, :ispace] * 1.0e-6 * dryair
    return Profile(zmdl, pm, tm, denm, denw.copy(),
                   hmod=_HMOD_NAMES[model - 1], dryair=dryair.copy())


def _parse_user_profile(lines: List[str], i: int, nmol: int,
                        immax_b: int, ref_lat: float,
                        airmwt: float) -> tuple:
    """Records 3.5/3.6 level loop (NSMDL/RDUNIT, rrtatm.f:3038-3392)."""
    immax = abs(immax_b)
    zmdl = np.zeros(immax)
    pm = np.zeros(immax)
    tm = np.zeros(immax)
    denm = np.zeros((nmol, immax))
    for im in range(immax):
        l = lines[i]; i += 1
        zmdl[im] = ffloat(l, 1, 10)
        pm[im] = ffloat(l, 11, 10)
        tm[im] = ffloat(l, 21, 10)
        jcharp = fstr(l, 36, 1)
        jchart = fstr(l, 37, 1)
        jlong = fstr(l, 39, 1)
        jchar = [fstr(l, 41 + k, 1) for k in range(nmol)]
        junitp, junitt = jou(jcharp), jou(jchart)
        junit = np.array([jou(c) for c in jchar])
        wmol = np.zeros(nmol)
        width = 15 if jlong == "L" else 10
        per = 8
        m = 0
        while m < nmol:
            l = lines[i]; i += 1
            n = min(per, nmol - m)
            for k in range(n):
                wmol[m + k] = ffloat(l, 1 + width * k, width)
            m += n
        # CHECK: pressure/temperature unit conversion (rrtatm.f:3429-3478)
        if junitp == 11:
            pm[im] *= PZERO
        elif junitp == 12:
            pm[im] *= PZERO / 760.0
        elif junitp > 12:
            raise ValueError(f"CHECK(P): junit {junitp}")
        if junitt == 11:
            tm[im] += TZERO
        elif junitt > 11:
            raise ValueError(f"CHECK(T): junit {junitt}")
        # species defaults from model atmospheres
        if junitp <= 6 or junitt <= 6 or np.any(junit <= 6):
            if immax_b < 0:
                raise NotImplementedError(
                    "DEFALT_P (model defaults on a pressure grid)")
            p_d, t_d = defalt(zmdl[im], junitp, junitt, junit, wmol, nmol)
            if p_d is not None:
                pm[im] = p_d
            if t_d is not None:
                tm[im] = t_d
        denm[:, im] = convrt(pm[im], tm[im], junit, wmol, nmol, airmwt)
    denw = denm[0].copy()
    if immax_b < 0:
        zmdl = cmpalt(pm, tm, denw, zmdl[0], ref_lat)
    if np.any(np.diff(zmdl) <= 0):
        raise ValueError("RRTATM: input altitudes not ascending")
    # dry-air density per level (CONVRT, rrtatm.f:3906-3915)
    dryair = ALOSMT * (pm / PZERO) * (TZERO / tm) - denw
    return Profile(zmdl, pm, tm, denm, denw, dryair=dryair), i


def _pbnd_to_zbnd(pbnd: np.ndarray, prof: Profile,
                  ref_lat: float) -> np.ndarray:
    """Boundary pressures -> altitudes: ln-p interpolation blended with a
    hydrostatic estimate by the cube of the pressure ratio
    (rrtatm.f:903-980)."""
    zmdl, pm, tm, denw = prof.zmdl, prof.pm, prof.tm, prof.denw
    immax = len(pm)
    zbnd = np.empty(len(pbnd))
    istart = 1
    for ip, p in enumerate(pbnd):
        lip = immax - 1
        for j in range(istart, immax):
            if p > pm[j]:
                lip = j
                break
        if p == pm[lip - 1]:
            zbnd[ip] = zmdl[lip - 1]
        elif p == pm[lip]:
            zbnd[ip] = zmdl[lip]
        else:
            rat = math.log(p / pm[lip - 1]) / math.log(pm[lip] / pm[lip - 1])
            zint = zmdl[lip - 1] + rat * (zmdl[lip] - zmdl[lip - 1])
            t2 = tm[lip - 1] + (tm[lip] - tm[lip - 1]) * rat
            wv2 = denw[lip - 1] + (denw[lip] - denw[lip - 1]) * rat
            zhyd = cmpalt(np.array([pm[lip - 1], p]),
                          np.array([tm[lip - 1], t2]),
                          np.array([denw[lip - 1], wv2]),
                          zmdl[lip - 1], ref_lat)[1]
            a = rat ** 3
            zbnd[ip] = a * zint + (1 - a) * zhyd
        istart = lip
    return zbnd


def vertical_path(prof: Profile, zbnd: np.ndarray, h1: float, h2: float,
                  nmol: int, ref_lat: float = 45.0) -> RRTATMResult:
    """Straight vertical path H1->H2: AMERGE + ALAYER + FPACK."""
    zmdl = prof.zmdl.copy()
    pm, tm, denm = prof.pm, prof.tm, prof.denm
    zbnd = zbnd.copy()
    ibmax = len(zbnd)
    if ibmax >= 1 and zbnd[0] < zmdl[0]:
        if abs(zbnd[0] - zmdl[0]) <= 1.0e-4:
            zbnd[0] = zmdl[0]
        else:
            raise ValueError("RRTATM: boundaries outside of atmosphere")

    # ---- AMERGE: merge {h1,h2} with zbnd into zout ------------------
    zh = [h1, h2]
    zout = [0.0]
    i1 = ibmax - 1
    for j in range(ibmax):
        if abs(zbnd[j] - zh[0]) < TOL:
            zh[0] = zbnd[j]
        if zbnd[j] > zh[0]:
            i1 = j
            break
    zout[0] = zh[0]
    ib, ih = i1, 1
    while True:
        if ib < ibmax:
            if abs(zbnd[ib] - zh[ih]) < TOL:
                zh[ih] = zbnd[ib]
            if zbnd[ib] < zh[ih]:
                zout.append(zbnd[ib])      # insert zbnd
                ib += 1
                continue
            if zbnd[ib] == zh[ih]:
                ib += 1
        zout.append(zh[ih])                # insert zh
        ih += 1
        if ih > 1:
            break
    zout = np.array(zout)
    ioutmx = len(zout)

    # merge zout and zmdl into the fine path zpth, interpolating
    hmin = min(h1, h2)
    im = int(np.nonzero(zmdl >= hmin)[0][0])
    zpth, pp, tp = [], [], []
    denp = []
    iout = 0
    immax = len(zmdl)
    while True:
        if im < immax:
            if abs(zout[iout] - zmdl[im]) < TOL:
                zmdl[im] = zout[iout]
            if zout[iout] >= zmdl[im]:
                if zout[iout] == zmdl[im]:
                    iout += 1
                zpth.append(zmdl[im])      # insert model level
                pp.append(pm[im])
                tp.append(tm[im])
                denp.append(denm[:, im].copy())
                im += 1
                if abs(zpth[-1] - zout[-1]) < TOL:
                    zout[-1] = zpth[-1]
                if zpth[-1] == zout[-1]:
                    break
                continue
        # insert boundary level zout[iout], interpolate
        jm = max(im, 1)
        a = (zout[iout] - zmdl[jm - 1]) / (zmdl[jm] - zmdl[jm - 1])
        zpth.append(zout[iout])
        pp.append(expint(pm[jm - 1], pm[jm], a))
        tp.append(tm[jm - 1] + (tm[jm] - tm[jm - 1]) * a)
        denp.append(np.array([expint(denm[k, jm - 1], denm[k, jm], a)
                              for k in range(nmol)]))
        iout += 1
        if abs(zpth[-1] - zout[-1]) < TOL:
            zpth[-1] = zout[-1]
        if zpth[-1] == zout[-1]:
            break
    zpth = np.array(zpth)
    pp = np.array(pp)
    tp = np.array(tp)
    denp = np.array(denp).T                # (nmol, ipmax)
    ipmax = len(zpth)

    # ---- ALAYER: vertical quadrature per fine layer -----------------
    ppsum = np.zeros(ipmax - 1)
    tpsum = np.zeros(ipmax - 1)
    rhopsm = np.zeros(ipmax - 1)
    amtp = np.zeros((nmol, ipmax - 1))
    for j in range(ipmax - 1):
        z1, z2 = zpth[j], zpth[j + 1]
        pa, pb_end = pp[j], pp[j + 1]
        ta, tb = tp[j], tp[j + 1]
        if pb_end == pa:
            raise ValueError("RRTATM: pressures in adjoining layers equal")
        rhoa = pa / (GCAIR * ta)
        rhob_end = pb_end / (GCAIR * tb)
        dz = z2 - z1
        hp = -dz / math.log(pb_end / pa)
        if abs(rhob_end / rhoa - 1.0) >= EPSILN:
            hrho = -dz / math.log(rhob_end / rhoa)
        else:
            hrho = 1.0e30
        hden = np.zeros(nmol)
        dena = denp[:, j].copy()
        dena0 = denp[:, j].copy()
        denb_end = denp[:, j + 1]
        for k in range(nmol):
            if not (dena0[k] == 0.0 or denb_end[k] == 0.0
                    or abs(1.0 - dena0[k] / denb_end[k]) <= EPSILN):
                hden[k] = -dz / math.log(denb_end[k] / dena0[k])
        h1v = z1
        while True:
            h3 = min(h1v + DELTAS, z2)
            dh = h3 - h1v
            ds = dh                        # vertical: DS == DH
            pb = pa * math.exp(-dh / hp)
            rhob = rhoa * math.exp(-dh / hrho)
            if dh / hrho >= EPSILN:
                ppsum[j] += (hp / (1.0 + hp / hrho)) * (pa * rhoa - pb * rhob)
                tpsum[j] += hp * (pa - pb) / GCAIR
                rhopsm[j] += hrho * (rhoa - rhob)
            else:
                ppsum[j] += 0.5 * ds * (pa * rhoa + pb * rhob)
                tpsum[j] += 0.5 * ds * (pa + pb) / GCAIR
                rhopsm[j] += 0.5 * ds * (rhoa + rhob)
            for k in range(nmol):
                if hden[k] == 0.0 or abs(dh / hden[k]) < EPSILN:
                    denb = dena0[k] + (denb_end[k] - dena0[k]) * (h3 - z1) / dz
                    amtp[k, j] += 0.5 * (dena[k] + denb) * ds * 1.0e5
                else:
                    denb = dena0[k] * math.exp(-(h3 - z1) / hden[k])
                    amtp[k, j] += hden[k] * (dena[k] - denb) * 1.0e5
                dena[k] = denb
            pa, rhoa = pb, rhob
            if h3 >= z2:
                break
            h1v = h3

    # ---- FPACK: condense the fine path into output layers -----------
    lmax = ioutmx - 1
    pbar = np.zeros(lmax)
    tbar = np.zeros(lmax)
    rhosum = np.zeros(lmax)
    amount = np.zeros((nmol, lmax))
    pz = np.zeros(lmax + 1)
    tz = np.zeros(lmax + 1)
    pz[0], tz[0] = pp[0], tp[0]
    iout = 0
    for ip in range(ipmax - 1):
        pbar[iout] += ppsum[ip]
        tbar[iout] += tpsum[ip]
        rhosum[iout] += rhopsm[ip]
        amount[:, iout] += amtp[:, ip]
        if zpth[ip + 1] == zout[iout + 1]:
            pz[iout + 1] = pp[ip + 1]
            tz[iout + 1] = tp[ip + 1]
            iout += 1
    if iout != ioutmx - 1:
        raise RuntimeError("FPACK: layer count mismatch")
    pbar /= rhosum
    tbar /= rhosum
    rhosum = rhosum * 1.0e5
    wn2l = rhosum - amount.sum(axis=0)
    return RRTATMResult(
        nlayers=lmax, pavel=pbar, tavel=tbar, pz=pz, tz=tz,
        altz=zout.copy(), amount=amount, wn2l=wn2l, rhosum=rhosum,
        ref_lat=ref_lat, hmod=prof.hmod)


def read_rrtatm(lines: List[str], i: int, ixsect: int = 0,
                airmwt: float = AIRMWT_REF) -> tuple:
    """Parse records 3.1-3.6 starting at line ``i`` and build the layered
    atmosphere (plus, for ``ixsect=1``, records 3.7-3.8.2 -> layer
    cross-section amounts).  Returns (RRTATMResult, next_line_index)."""
    # record 3.1  (7I5,I2,1X,I2,4F10.3,A10)  rrtatm.f:578-580
    l = lines[i]; i += 1
    model = fint(l, 1, 5)
    # itype forced to 2, angle forced to 0 (rrtatm.f:581-583)
    ibmax_b = fint(l, 11, 5)
    nozero = fint(l, 16, 5)
    nmol = fint(l, 26, 5) or 7
    re = ffloat(l, 41, 10)
    hspace = ffloat(l, 51, 10) or 100.0
    sref_lat = fstr(l, 81, 10).strip()
    ref_lat = float(sref_lat) if sref_lat else 45.0
    ibmax = abs(ibmax_b)
    if nozero == 2:
        raise NotImplementedError("NOZERO=2 amount-skip heuristics")
    del re  # earth radius only affects refraction, absent on vertical paths

    # record 3.2  (5F10.4,I5,5X,F10.4)
    l = lines[i]; i += 1
    h1 = ffloat(l, 1, 10)
    h2 = ffloat(l, 11, 10)

    autlay_args = None
    if ibmax == 0:
        # record 3.3A (5F10.3): automatic layering parameters with the
        # reference defaults/validation (rrtatm.f:852-863, :499)
        l = lines[i]; i += 1
        avtrat = ffloat(l, 1, 10) or 1.5
        tdiff1 = ffloat(l, 11, 10) or 5.0
        tdiff2 = ffloat(l, 21, 10) or 8.0
        altd1 = ffloat(l, 31, 10)
        altd2 = ffloat(l, 41, 10)
        if altd2 <= 0.0 or altd2 <= altd1:
            altd1, altd2 = 0.0, 100.0
        if avtrat <= 1.0 or tdiff1 <= 0.0 or tdiff2 <= 0.0:
            raise ValueError("RRTATM: invalid AUTLAY parameters "
                             f"avtrat={avtrat} tdiff={tdiff1}/{tdiff2}")
        autlay_args = (avtrat, tdiff1, tdiff2, altd1, altd2)
        bnd = None
    else:
        # record 3.3B: boundaries (8F10.3/line), km or (ibmax<0) mb
        bnd = np.zeros(ibmax)
        for j0 in range(0, ibmax, 8):
            l = lines[i]; i += 1
            for k in range(min(8, ibmax - j0)):
                bnd[j0 + k] = ffloat(l, 1 + 10 * k, 10)

    # profile
    if model == 0:
        # record 3.4 (I5,3A8)
        l = lines[i]; i += 1
        immax_b = fint(l, 1, 5)
        hmod = fstr(l, 6, 24).strip()
        prof, i = _parse_user_profile(lines, i, nmol, immax_b,
                                      ref_lat, airmwt)
        prof.hmod = hmod
    else:
        prof = build_model_profile(model, nmol, hspace)

    if ibmax_b < 0:
        if np.any(np.diff(bnd) >= 0):
            raise ValueError("RRTATM: PBND not decreasing")
        h1 = _pbnd_to_zbnd(np.array([h1]), prof, ref_lat)[0]
        h2 = _pbnd_to_zbnd(np.array([h2]), prof, ref_lat)[0]

    # FSCGEO endpoint handling for the forced vertical path (ANGLE=0):
    # H1 >= H2 is rejected (rrtatm.f:4232), endpoints above the profile
    # top reduce to ZMAX (REDUCE, :4306-4309, :4440), an entirely
    # above-top path is an error (:4308, format 965)
    if h1 >= h2:
        raise ValueError(f"FSCGEO: H1 ({h1}) must be below H2 ({h2}) "
                         "on the vertical path (ANGLE=0)")
    zmax = prof.zmdl[-1]
    if h1 >= zmax:
        raise ValueError("FSCGEO: the entire path lies above the top "
                         f"ZMAX = {zmax} of the atmospheric profile")
    h2 = min(h2, zmax)

    if autlay_args is not None:
        # HMIN/HMAX from the path endpoints (call site :1202-1205)
        zbnd = autlay(prof, h1, h2, *autlay_args)
    elif ibmax_b < 0:
        zbnd = _pbnd_to_zbnd(bnd, prof, ref_lat)
    else:
        if np.any(np.diff(bnd) <= 0):
            raise ValueError("RRTATM: ZBND not increasing")
        zbnd = bnd

    res = vertical_path(prof, zbnd, h1, h2, nmol, ref_lat)
    if ixsect == 1:
        # records 3.7+ follow the profile records (rrtatm.f:197)
        res.nxmol, res.ixindx, res.xamnt, i = read_xamnts(
            lines, i, prof, zbnd, h1, h2, ref_lat)
    return res, i
