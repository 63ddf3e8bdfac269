"""Gaseous optical depth and Planck fractions for the 16 LW bands.

Batched re-design of ``taumol`` (rrtmg_lw_taumol.f90:299-3164).  The
reference implements 16 near-identical band subroutines with serial layer
loops split at ``laytrop``; here every band is described *declaratively*
(key species, minor-gas terms, CFC terms, empirical adjustments, Planck
fraction layout) and a single vectorized engine evaluates all layers of
all columns at once.  The lower/upper atmosphere split becomes a select
mask, and the lower/upper k-tables are fused into one gather table per
band so each (layer, g-point) needs one set of gathers regardless of
region.

Numerical semantics replicated exactly:
  * index arithmetic ``ind0 = ((jp-1)*5+(jt-1))*nspa + js``
    (taumol.f90:563-564; upper :749-750),
  * eta interpolation with ``oneminus`` clamp and the cubic (p^4)
    endpoint corrections for specparm < 0.125 / > 0.875 (:569-628),
  * minor-gas over-abundance column adjustments (:547-554 etc.),
  * per-band pressure corrections (corradj, :343-345, :374, :429) and
    the empirical stratospheric-cooling g-point rescales (:1027-1034,
    :1664-1669).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..constants import ONEMINUS
from ..types import Profile, SetcoefOut

NBANDS = 16
NG = (10, 12, 16, 14, 16, 8, 12, 8, 12, 6, 8, 8, 4, 2, 2, 2)
NSPA = (1, 1, 9, 9, 9, 1, 9, 1, 9, 1, 1, 9, 9, 1, 9, 9)
NSPB = (1, 1, 5, 5, 5, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0)

# chi_mls gas indices (rrlw_ref.f90): 1 h2o, 2 co2, 3 o3, 4 n2o, 5 co,
# 6 ch4, 7 o2
_GAS_CHI = {"h2o": 1, "co2": 2, "o3": 3, "n2o": 4, "co": 5, "ch4": 6,
            "o2": 7}


@dataclass(frozen=True)
class Adj:
    """Minor-gas over-abundance column adjustment.

    adjcol = adjfac * chi_ref * coldry * 1e-20   if rat > threshold
           = colgas                              otherwise
    where rat = 1e20 * (colgas/coldry) / chi_ref and
    adjfac = base + (rat - base)**expnt; chi_ref is chi_mls(gas, jp+1)
    unless ``chi_const`` is set (band 13: 3.55e-4, taumol.f90:2494-2498).
    """
    gas: str
    threshold: float
    base: float
    expnt: float
    chi_const: Optional[float] = None


@dataclass(frozen=True)
class Minor:
    table: str                     # e.g. 'ka_mn2o'
    kind: str                      # 'flat' | 'eta'
    col: str                       # gas column name or 'scale_*'
    adj: Optional[Adj] = None
    refrat: Optional[tuple] = None  # (gas1, gas2, plev 1-based) for eta


@dataclass(frozen=True)
class RegionSpec:
    key1: Optional[str]            # None -> no key-species term
    key2: Optional[str] = None
    rat: Optional[str] = None      # name pair for SetcoefOut rat arrays
    minors: Sequence[Minor] = field(default_factory=tuple)
    cfcs: Sequence[tuple] = field(default_factory=tuple)  # (wx idx 1-based, vec)
    taufor: bool = True
    tauself: bool = True
    corradj: Optional[str] = None  # 'b1l' | 'b1u' | 'b2'
    frac: str = "fracrefa"         # table name
    frac_eta: Optional[tuple] = None   # (gas1, gas2, plev) -> eta-interp
    postscale: Optional[dict] = None   # {g(1-based): factor}
    zero: bool = False             # taug = fracs = 0 (bands 12, 15 upper)


@dataclass(frozen=True)
class BandSpec:
    band: int
    lower: RegionSpec
    upper: RegionSpec


BAND_SPECS = (
    BandSpec(1,
        RegionSpec("h2o", minors=(Minor("ka_mn2", "flat", "scale_n2"),),
                   corradj="b1l"),
        RegionSpec("h2o", minors=(Minor("kb_mn2", "flat", "scale_n2"),),
                   corradj="b1u", tauself=False, frac="fracrefb")),
    BandSpec(2,
        RegionSpec("h2o", corradj="b2"),
        RegionSpec("h2o", tauself=False, frac="fracrefb")),
    BandSpec(3,
        RegionSpec("h2o", "co2", rat="h2oco2",
                   minors=(Minor("ka_mn2o", "eta", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65),
                                 refrat=("h2o", "co2", 3)),),
                   frac_eta=("h2o", "co2", 9)),
        RegionSpec("h2o", "co2", rat="h2oco2",
                   minors=(Minor("kb_mn2o", "eta", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65),
                                 refrat=("h2o", "co2", 13)),),
                   tauself=False, frac="fracrefb",
                   frac_eta=("h2o", "co2", 13))),
    BandSpec(4,
        RegionSpec("h2o", "co2", rat="h2oco2", frac_eta=("h2o", "co2", 11)),
        RegionSpec("o3", "co2", rat="o3co2", taufor=False, tauself=False,
                   frac="fracrefb", frac_eta=("o3", "co2", 13),
                   postscale={8: 0.92, 9: 0.88, 10: 1.07, 11: 1.1,
                              12: 0.99, 13: 0.88, 14: 0.943})),
    BandSpec(5,
        RegionSpec("h2o", "co2", rat="h2oco2",
                   minors=(Minor("ka_mo3", "eta", "colo3",
                                 refrat=("h2o", "co2", 7)),),
                   cfcs=((1, "ccl4"),), frac_eta=("h2o", "co2", 5)),
        RegionSpec("o3", "co2", rat="o3co2", cfcs=((1, "ccl4"),),
                   taufor=False, tauself=False, frac="fracrefb",
                   frac_eta=("o3", "co2", 43))),
    BandSpec(6,
        RegionSpec("h2o",
                   minors=(Minor("ka_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.77)),),
                   cfcs=((2, "cfc11adj"), (3, "cfc12"))),
        RegionSpec(None, cfcs=((2, "cfc11adj"), (3, "cfc12")),
                   taufor=False, tauself=False, frac="fracrefa")),
    BandSpec(7,
        RegionSpec("h2o", "o3", rat="h2oo3",
                   minors=(Minor("ka_mco2", "eta", "adj_co2",
                                 adj=Adj("co2", 3.0, 3.0, 0.79),
                                 refrat=("h2o", "o3", 3)),),
                   frac_eta=("h2o", "o3", 3)),
        RegionSpec("o3",
                   minors=(Minor("kb_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.79)),),
                   taufor=False, tauself=False, frac="fracrefb",
                   postscale={6: 0.92, 7: 0.88, 8: 1.07, 9: 1.1,
                              10: 0.99, 11: 0.855})),
    BandSpec(8,
        RegionSpec("h2o",
                   minors=(Minor("ka_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.65)),
                           Minor("ka_mo3", "flat", "colo3"),
                           Minor("ka_mn2o", "flat", "coln2o")),
                   cfcs=((3, "cfc12"), (4, "cfc22adj"))),
        RegionSpec("o3",
                   minors=(Minor("kb_mco2", "flat", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.65)),
                           Minor("kb_mn2o", "flat", "coln2o")),
                   cfcs=((3, "cfc12"), (4, "cfc22adj")),
                   taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(9,
        RegionSpec("h2o", "ch4", rat="h2och4",
                   minors=(Minor("ka_mn2o", "eta", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65),
                                 refrat=("h2o", "ch4", 3)),),
                   frac_eta=("h2o", "ch4", 9)),
        RegionSpec("ch4",
                   minors=(Minor("kb_mn2o", "flat", "adj_n2o",
                                 adj=Adj("n2o", 1.5, 0.5, 0.65)),),
                   taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(10,
        RegionSpec("h2o"),
        RegionSpec("h2o", tauself=False, frac="fracrefb")),
    BandSpec(11,
        RegionSpec("h2o", minors=(Minor("ka_mo2", "flat", "scale_o2"),)),
        RegionSpec("h2o", minors=(Minor("kb_mo2", "flat", "scale_o2"),),
                   tauself=False, frac="fracrefb")),
    BandSpec(12,
        RegionSpec("h2o", "co2", rat="h2oco2", frac_eta=("h2o", "co2", 10)),
        RegionSpec(None, zero=True)),
    BandSpec(13,
        RegionSpec("h2o", "n2o", rat="h2on2o",
                   minors=(Minor("ka_mco2", "eta", "adj_co2",
                                 adj=Adj("co2", 3.0, 2.0, 0.68,
                                         chi_const=3.55e-4),
                                 refrat=("h2o", "n2o", 1)),
                           Minor("ka_mco", "eta", "colco",
                                 refrat=("h2o", "n2o", 3))),
                   frac_eta=("h2o", "n2o", 5)),
        RegionSpec(None,
                   minors=(Minor("kb_mo3", "flat", "colo3"),),
                   taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(14,
        RegionSpec("co2"),
        RegionSpec("co2", taufor=False, tauself=False, frac="fracrefb")),
    BandSpec(15,
        RegionSpec("n2o", "co2", rat="n2oco2",
                   minors=(Minor("ka_mn2", "eta", "scale_brd",
                                 refrat=("n2o", "co2", 1)),),
                   frac_eta=("n2o", "co2", 1)),
        RegionSpec(None, zero=True)),
    BandSpec(16,
        RegionSpec("h2o", "ch4", rat="h2och4", frac_eta=("h2o", "ch4", 6)),
        RegionSpec("ch4", taufor=False, tauself=False, frac="fracrefb")),
)


def _trunc_int(x):
    return x.astype(jnp.int32)


def _spec_weights(specparm, fs, dtype):
    """4-tap gather weights at offsets (-1, 0, +1, +2) for the eta
    interpolation, incl. p^4 endpoint corrections (taumol.f90:569-628)."""
    low = specparm < 0.125
    high = specparm > 0.875
    p = jnp.where(low, fs - 1.0, -fs)
    p4 = p ** 4
    fk0 = p4
    fk1 = 1.0 - p - 2.0 * p4
    fk2 = p + p4
    zero = jnp.zeros_like(fs)
    w_m1 = jnp.where(high, fk2, zero)
    w_0 = jnp.where(low, fk0, jnp.where(high, fk1, 1.0 - fs))
    w_p1 = jnp.where(low, fk1, jnp.where(high, fk0, fs))
    w_p2 = jnp.where(low, fk2, zero)
    return (w_m1, w_0, w_p1, w_p2)


def _eta_params(colk1, colk2, rat, scale):
    """speccomb / specparm / js0 (0-based) / fs for one eta interpolation."""
    speccomb = colk1 + rat * colk2
    specparm = jnp.minimum(colk1 / speccomb, ONEMINUS)
    specmult = scale * specparm
    js0 = _trunc_int(specmult)
    fs = specmult - js0.astype(specmult.dtype)
    return speccomb, specparm, js0, fs


class TaumolEngine:
    """Precomputes fused tables + static refrat constants, then evaluates
    taug/fracs for all bands over a (B, L) batch."""

    def __init__(self, ktables: dict, static: dict, dtype=jnp.float64):
        self.dtype = dtype
        self.chi = np.asarray(static["chi_mls"], dtype=np.float64)
        self.tabs = {}
        for b in range(1, NBANDS + 1):
            src = ktables[f"b{b:02d}"]
            t = {k: jnp.asarray(v, dtype=dtype) for k, v in src.items()}
            # fuse absa/absb into one gather table; upper rows offset by na
            absa = t.get("absa")
            absb = t.get("absb")
            if absb is not None:
                t["_abs"] = jnp.concatenate([absa, absb], axis=0)
                t["_na"] = absa.shape[0]
            elif absa is not None:
                t["_abs"] = absa
                t["_na"] = absa.shape[0]
            # flatten eta minor tables (19, nk, ng) -> (19*nk, ng)
            for name in list(t):
                arr = t[name]
                if name.startswith(("ka_m", "kb_m")) and arr.ndim == 3:
                    t[name + "_flat"] = arr.reshape(-1, arr.shape[-1])
                    t[name + "_nk"] = arr.shape[1]
            self.tabs[b] = t

    def _refrat(self, gas1, gas2, plev):
        return float(self.chi[_GAS_CHI[gas1] - 1, plev - 1]
                     / self.chi[_GAS_CHI[gas2] - 1, plev - 1])

    def _col(self, sc: SetcoefOut, gas: str):
        return getattr(sc, "col" + gas)

    def _adjusted_col(self, sc: SetcoefOut, prof: Profile, adj: Adj):
        colgas = self._col(sc, adj.gas)
        chi_gas = colgas / prof.coldry
        if adj.chi_const is not None:
            chiref = jnp.full_like(chi_gas, adj.chi_const)
        else:
            gi = _GAS_CHI[adj.gas] - 1
            chi_row = jnp.asarray(self.chi[gi], dtype=self.dtype)
            chiref = jnp.take(chi_row, sc.jp + 1)   # chi_mls(gas, jp+1)
        ratio = 1.0e20 * chi_gas / chiref
        # double-where: the fractional power's VJP is inf at a clamped
        # 0 base (0**(expnt-1)), and inf*0 = NaN would leak through a
        # single where/maximum into every d(tau)/d(input).  The safe
        # operand never changes the primal because every Adj record
        # has threshold >= base (band 7 lower has equality), so the
        # taken branch strictly satisfies ratio - base > 0.
        excess = jnp.where(ratio > adj.threshold, ratio - adj.base, 1.0)
        adjfac = adj.base + excess ** adj.expnt
        adjcol = adjfac * chiref * prof.coldry * 1.0e-20
        return jnp.where(ratio > adj.threshold, adjcol, colgas)

    # ------------------------------------------------------------------
    def _region(self, spec: RegionSpec, b: int, lower_region: bool,
                sc: SetcoefOut, prof: Profile):
        """taug, fracs for one band/region, evaluated at ALL layers."""
        t = self.tabs[b]
        ng = NG[b - 1]
        dtype = self.dtype
        B, L = sc.jp.shape
        shape_g = (B, L, ng)

        taug = jnp.zeros(shape_g, dtype)
        if spec.zero:
            return taug, jnp.zeros(shape_g, dtype)

        nsp = NSPA[b - 1] if lower_region else NSPB[b - 1]
        scale = 8.0 if lower_region else 4.0

        # --- key-species term ------------------------------------------
        if spec.key1 is not None:
            colk1 = self._col(sc, spec.key1)
            if spec.key2 is not None:
                rat0 = getattr(sc, "rat_" + spec.rat)
                rat1 = getattr(sc, "rat_" + spec.rat + "_1")
                speccomb, specparm, js0, fs = _eta_params(
                    colk1, self._col(sc, spec.key2), rat0, scale)
                speccomb1, specparm1, js1, fs1 = _eta_params(
                    colk1, self._col(sc, spec.key2), rat1, scale)
            else:
                speccomb, speccomb1 = colk1, colk1
                js0 = js1 = jnp.zeros_like(sc.jp)
                fs = fs1 = jnp.zeros_like(colk1)
                specparm = specparm1 = jnp.full_like(colk1, 0.5)

            if lower_region:
                base0 = (sc.jp * 5 + sc.jt) * nsp
                base1 = ((sc.jp + 1) * 5 + sc.jt1) * nsp
                row0 = base0 + js0
                row1 = base1 + js1
            else:
                base0 = ((sc.jp - 12) * 5 + sc.jt) * nsp
                base1 = ((sc.jp - 11) * 5 + sc.jt1) * nsp
                row0 = t["_na"] + base0 + js0
                row1 = t["_na"] + base1 + js1

            if lower_region and spec.key2 is not None:
                w0 = _spec_weights(specparm, fs, dtype)
                w1 = _spec_weights(specparm1, fs1, dtype)
                offs = (-1, 0, 1, 2)
            else:
                w0 = (1.0 - fs, fs)
                w1 = (1.0 - fs1, fs1)
                offs = (0, 1)

            toff = max(nsp, 1)  # temperature(+1) row stride
            tbl = t["_abs"]
            nrow = tbl.shape[0]

            def key_term(row, facA, facB, weights):
                acc = jnp.zeros(shape_g, dtype)
                for o, w in zip(offs, weights):
                    r = jnp.clip(row + o, 0, nrow - 1)
                    gA = jnp.take(tbl, r, axis=0)
                    gB = jnp.take(tbl, jnp.clip(r + toff, 0, nrow - 1),
                                  axis=0)
                    if isinstance(w, float):
                        acc += facA[..., None] * gA + facB[..., None] * gB
                    else:
                        acc += w[..., None] * (facA[..., None] * gA
                                               + facB[..., None] * gB)
                return acc

            tau_major = speccomb[..., None] * key_term(row0, sc.fac00,
                                                       sc.fac10, w0)
            tau_major1 = speccomb1[..., None] * key_term(row1, sc.fac01,
                                                         sc.fac11, w1)
            taug = tau_major + tau_major1

        # --- water-vapor continuum --------------------------------------
        if spec.tauself:
            s = t["selfref"]
            lo = jnp.take(s, sc.indself, axis=0)
            hi = jnp.take(s, sc.indself + 1, axis=0)
            taug += sc.selffac[..., None] * (
                lo + sc.selffrac[..., None] * (hi - lo))
        if spec.taufor:
            f = t["forref"]
            lo = jnp.take(f, sc.indfor, axis=0)
            hi = jnp.take(f, jnp.clip(sc.indfor + 1, 0, 3), axis=0)
            taug += sc.forfac[..., None] * (
                lo + sc.forfrac[..., None] * (hi - lo))

        # --- minor gases -------------------------------------------------
        for m in spec.minors:
            if m.col.startswith("adj_"):
                colm = self._adjusted_col(sc, prof, m.adj)
            elif m.col == "scale_n2":
                colm = sc.colbrd * sc.scaleminorn2
            elif m.col == "scale_o2":
                colm = sc.colo2 * sc.scaleminor
            elif m.col == "scale_brd":
                colm = sc.colbrd * sc.scaleminor
            else:
                colm = self._col(sc, m.col[3:])  # 'colxxx'
            if m.kind == "flat":
                tab = t[m.table]
                lo = jnp.take(tab, sc.indminor, axis=0)
                hi = jnp.take(tab, jnp.clip(sc.indminor + 1, 0, 18), axis=0)
                absm = lo + sc.minorfrac[..., None] * (hi - lo)
            else:
                g1, g2, plev = m.refrat
                refrat = self._refrat(g1, g2, plev)
                _, _, jm0, fm = _eta_params(
                    self._col(sc, g1), self._col(sc, g2),
                    jnp.asarray(refrat, dtype), scale)
                nk = t[m.table + "_nk"]
                flat = t[m.table + "_flat"]
                jm0 = jnp.clip(jm0, 0, nk - 2)
                i00 = sc.indminor * nk + jm0
                m00 = jnp.take(flat, i00, axis=0)
                m10 = jnp.take(flat, i00 + 1, axis=0)
                i01 = jnp.clip(sc.indminor + 1, 0, 18) * nk + jm0
                m01 = jnp.take(flat, i01, axis=0)
                m11 = jnp.take(flat, i01 + 1, axis=0)
                a1 = m00 + fm[..., None] * (m10 - m00)
                a2 = m01 + fm[..., None] * (m11 - m01)
                absm = a1 + sc.minorfrac[..., None] * (a2 - a1)
            taug += colm[..., None] * absm

        # --- CFC / CCl4 cross sections -----------------------------------
        for wx_i, vec in spec.cfcs:
            taug += prof.wx[..., wx_i - 1][..., None] * t[vec][None, None, :]

        # --- pressure correction factors ---------------------------------
        if spec.corradj == "b1l":
            pp = prof.pavel
            corr = jnp.where(pp < 250.0,
                             1.0 - 0.15 * (250.0 - pp) / 154.4, 1.0)
            taug = corr[..., None] * taug
        elif spec.corradj == "b1u":
            corr = 1.0 - 0.15 * (prof.pavel / 95.6)
            taug = corr[..., None] * taug
        elif spec.corradj == "b2":
            corr = 1.0 - 0.05 * (prof.pavel - 100.0) / 900.0
            taug = corr[..., None] * taug

        # --- empirical per-g rescale (bands 4, 7 upper) -------------------
        if spec.postscale:
            fac = np.ones(ng)
            for g1b, v in spec.postscale.items():
                fac[g1b - 1] = v
            taug = taug * jnp.asarray(fac, dtype)

        # --- Planck fractions ---------------------------------------------
        ftab = t[spec.frac]
        if spec.frac_eta is not None:
            g1, g2, plev = spec.frac_eta
            refrat = self._refrat(g1, g2, plev)
            _, _, jpl0, fpl = _eta_params(
                self._col(sc, g1), self._col(sc, g2),
                jnp.asarray(refrat, dtype), scale)
            jpl0 = jnp.clip(jpl0, 0, ftab.shape[0] - 2)
            flo = jnp.take(ftab, jpl0, axis=0)
            fhi = jnp.take(ftab, jpl0 + 1, axis=0)
            fracs = flo + fpl[..., None] * (fhi - flo)
        else:
            fracs = jnp.broadcast_to(ftab[None, None, :], shape_g)
        return taug, fracs

    # ------------------------------------------------------------------
    def __call__(self, sc: SetcoefOut, prof: Profile):
        """Returns taug, fracs with shape (B, L, 140)."""
        mask = sc.laytrop_mask[..., None]
        taug_parts, frac_parts = [], []
        for bspec in BAND_SPECS:
            tl, fl = self._region(bspec.lower, bspec.band, True, sc, prof)
            tu, fu = self._region(bspec.upper, bspec.band, False, sc, prof)
            taug_parts.append(jnp.where(mask, tl, tu))
            frac_parts.append(jnp.where(mask, fl, fu))
        return (jnp.concatenate(taug_parts, axis=-1),
                jnp.concatenate(frac_parts, axis=-1))
