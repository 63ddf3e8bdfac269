"""Physics-invariant tests for the RT core — value anchors INDEPENDENT
of the tests/oracle Fortran transcription and of the k-data.

Closed-form limits of longwave radiative transfer:

* Isothermal enclosure, semiss=1: the linear-in-tau source terms
  vanish (dplank == 0) and the recursion
  ``rad' = rad + (bb - rad) * atrans`` (rrtmg_lw_rtrnmc.f90:486-529)
  has the fixed point rad == bb == fracs * P(T).  With LAYER-CONSTANT
  Planck fractions the band-summed upward flux is therefore exactly
  level-independent — for ANY optical depths, any cloud treatment,
  any exp/LUT quantization.  (Through the full model the Planck
  fractions vary per layer — eta interpolation + the
  fracrefa/fracrefb switch at laytrop — so g-points redistribute
  between layers and the collapse is only approximate: measured
  ~2e-4 clear / ~1e-2 cloudy, identical in f64 and f32 and across
  XLA/Pallas, i.e. a property of the correlated-k discretization,
  not of this implementation.  The full-model tests pin the exact
  parts: the surface emission anchor and the envelope.)
* The common value equals the Planck emission integrated over the 16
  bands — compared against a from-scratch numerical integral of the
  Planck function (CODATA constants, trapezoid quadrature; no
  framework tables involved).
* Transparent limit (taut -> 0, odcld -> 0): atrans == 0 exactly, so
  dflx == 0 everywhere and uflx equals the surface emission at every
  level.
* Opaque limit (taut huge): every level sees only the adjacent
  layers, whose linear-in-tau sources converge to the local level
  Planck value (tfn -> 1, rrtmg_lw_init.f90:134-141): net flux -> 0
  at every level below TOA; heating -> 0 in every layer except the
  top sliver (which cools to space — its upper boundary carries the
  full OLR).
* Heating = net-flux divergence * heatfac with
  heatfac = grav*secdy/(cpdair*1e2) (rrtmg_lw_init.f90:298)
  recomputed here from first principles.
* Exact Schwarzschild solution: for a per-band Planck source LINEAR
  in cumulative diffuse optical depth, dI/dtau = B - I has a closed
  form, and the reference's per-layer linear-in-tau source is its
  exact integral — the recursion must match to f64 roundoff (measured
  4e-16 for od >= 0.06), quantitatively pinning atrans and the tfn
  source factor at every od, not just the limits.

The RT cores (rtrn / rtrnmr / rtrnmc paths and the Pallas sweep
kernel in interpret mode) are driven directly with crafted inputs for
the exact limits; the full model (inatm -> setcoef -> taumol ->
rtrn*) is pinned to the anchors across icld 0/1/2 and McICA on both
the XLA engines (f64) and the Pallas kernels (interpret, f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrtmg_lw_tpu import LWConfig, make_model
from rrtmg_lw_tpu.ops import rtrn as rt
from rrtmg_lw_tpu.ops import rtrnmr as rtmr
from rrtmg_lw_tpu.ops.inatm import inatm
from rrtmg_lw_tpu.ops.setcoef import setcoef
from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                          make_band_clouds,
                                          make_mcica_clouds)

B, L = 8, 43
T_ISO = 288.6


# ---------------------------------------------------------------------------
# Independent Planck anchor: no framework tables, no oracle
# (utils/blackbody.py — direct quadrature from CODATA constants)
# ---------------------------------------------------------------------------
from rrtmg_lw_tpu.utils.blackbody import (band_anchor,  # noqa: E402
                                          sigma_T4)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def isothermal_atmosphere(ncol, nlay, T, dtype):
    atm = make_atmosphere(ncol=ncol, nlay=nlay, dtype=dtype)
    full = lambda x, v: jnp.full_like(jnp.asarray(x), v)
    return atm._replace(
        tlay=full(atm.tlay, T), tlev=full(atm.tlev, T),
        tsfc=full(atm.tsfc, T), emis=jnp.ones_like(jnp.asarray(atm.emis)))


def clouds_for(cfg, dtype, ncol=B, nlay=L):
    if cfg.icld == 0:
        return None
    if cfg.imca == 1:
        return make_mcica_clouds(ncol=ncol, nlay=nlay, dtype=dtype)
    return make_band_clouds(ncol=ncol, nlay=nlay, dtype=dtype)


CONFIGS = [
    # (icld, imca, use_lut) across all three RT cores + LUT/closed-form
    (0, 1, True), (0, 1, False),
    (1, 0, True),               # rtrn   (random overlap)
    (2, 0, True),               # rtrnmr (maximum-random)
    (2, 1, True), (2, 1, False),  # rtrnmc (McICA)
]


# ---------------------------------------------------------------------------
# full-model isothermal anchors (XLA engines, f64)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("icld,imca,use_lut", CONFIGS)
def test_isothermal_full_model(icld, imca, use_lut):
    """Isothermal + black surface through the whole pipeline: the
    surface upward flux equals the independently integrated blackbody
    band emission (Planck fractions sum to 1 per band -> exact up to
    the 1 K totplnk table); every level stays inside the correlated-k
    redistribution envelope of that value; TOA downward flux is zero;
    downward flux grows monotonically toward the surface."""
    cfg = LWConfig(icld=icld, imca=imca, use_lut=use_lut,
                   dtype="float64")
    model = make_model(cfg)
    atm = isothermal_atmosphere(B, L, T_ISO, jnp.float64)
    fl = jax.jit(lambda a, c: model(a, c))(atm, clouds_for(cfg,
                                                           jnp.float64))
    anchor = band_anchor(model.static_np, T_ISO)
    uflx = np.asarray(fl.uflx)
    # surface: rad0 = fracs * plankbnd summed over g — exact
    assert abs(uflx[:, 0] / anchor - 1).max() < 2e-4
    # levels: bounded by the measured g-redistribution envelope (the
    # per-g fixed point is exact; band sums drift where the
    # layer-varying fracs re-partition the band emission)
    env = 5e-4 if icld == 0 else 2e-2
    assert abs(uflx / anchor - 1).max() < env
    uclr = np.asarray(fl.uflxc)
    assert abs(uclr / anchor - 1).max() < 5e-4
    assert np.abs(np.asarray(fl.dflx)[:, -1]).max() < 1e-12
    dflx = np.asarray(fl.dflx)
    assert (dflx[:, :-1] >= dflx[:, 1:] - 1e-12 * anchor).all()
    assert dflx.max() <= anchor * (1 + env)
    # the 10-3250 cm^-1 window captures almost all of sigma T^4
    assert 0.995 * sigma_T4(T_ISO) < anchor < sigma_T4(T_ISO)


# ---------------------------------------------------------------------------
# direct RT-core drives (crafted inputs; exact limits)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def stack64():
    cfg = LWConfig(icld=0, dtype="float64", use_lut=True)
    model = make_model(cfg)
    atm = make_atmosphere(ncol=B, nlay=L, dtype=jnp.float64)
    atm = atm._replace(emis=jnp.ones_like(jnp.asarray(atm.emis)),
                       tsfc=jnp.asarray(atm.tlev)[:, 0])
    prof = inatm(atm, dtype=jnp.float64)
    sc = setcoef(prof, model.static, istart=1, idrv=0)
    # layer-constant fracs summing to exactly 1 per band
    ng = np.asarray(model.static_np["ngb"])
    counts = np.bincount(ng - 1, minlength=16)
    fracs = jnp.broadcast_to(
        jnp.asarray(1.0 / counts[ng - 1], jnp.float64), (B, L, 140))
    return model, prof, sc, fracs


@pytest.fixture(scope="module")
def stack64_iso():
    """Same, but isothermal (planck arrays all equal)."""
    cfg = LWConfig(icld=0, dtype="float64", use_lut=True)
    model = make_model(cfg)
    atm = isothermal_atmosphere(B, L, T_ISO, jnp.float64)
    prof = inatm(atm, dtype=jnp.float64)
    sc = setcoef(prof, model.static, istart=1, idrv=0)
    ng = np.asarray(model.static_np["ngb"])
    counts = np.bincount(ng - 1, minlength=16)
    fracs = jnp.broadcast_to(
        jnp.asarray(1.0 / counts[ng - 1], jnp.float64), (B, L, 140))
    return model, prof, sc, fracs


def _rt(model, prof, sc, fracs, taut, kind, use_lut=True, odcld=0.7):
    kw = dict(static=model.static_np, luts=model.luts, use_lut=use_lut,
              idrv=0, heatfac_val=model.heatfac, istart=1, iend=16)
    zero = jnp.zeros_like(taut)
    if kind == "rtrn":          # clear through the random-overlap core
        return rt.rt_random_overlap(
            taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
            sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz, zero,
            zero, cloudy_lay=jnp.zeros(taut.shape[:2], bool),
            cld_gate=jnp.zeros(taut.shape, bool), **kw)
    if kind == "mcica":         # binary per-g clouds on half the g's
        gate = jnp.zeros(taut.shape, bool).at[:, 5:9, ::2].set(True)
        cldf = gate.astype(taut.dtype)
        od = jnp.where(gate, odcld, 0.0)
        return rt.rt_random_overlap(
            taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
            sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz, cldf,
            od, cloudy_lay=jnp.any(gate, -1), cld_gate=gate, **kw)
    if kind == "rtrnmr":        # deterministic maximum-random overlap
        cldfrac = jnp.zeros(taut.shape[:2], taut.dtype)
        cldfrac = cldfrac.at[:, 5:9].set(0.4)
        od = jnp.where(cldfrac[..., None] > 0, odcld, 0.0
                       ) * jnp.ones_like(taut)
        return rtmr.rt_maxrandom(
            taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
            sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz, cldfrac,
            od, **kw)
    raise ValueError(kind)


KINDS = ["rtrn", "mcica", "rtrnmr"]


@pytest.mark.parametrize("kind", KINDS)
def test_isothermal_exact_collapse(stack64_iso, kind):
    """Layer-constant fracs + isothermal planck: uflx is EXACTLY
    level-independent through all three RT recursions, clouds
    included, to f64 roundoff — the strongest recursion gate.

    Exception bound: the McICA cloudy recursion composes the gas and
    gas+cloud streams through separately-quantized absorptances
    (atrans from od, atot from od+odcld), so the algebraic identity
    (1-atrans)(1-abscld) == 1-atot that makes rad==bb a fixed point
    breaks by the quantization step — the 10^-4 LUT grid and the
    od<0.06 Taylor regime (rrtmg_lw_rtrnmc.f90:361-425); the
    reference behaves identically.  Measured: 8.1e-6 (LUT) / 4.7e-7
    (closed form); gate 3e-5.  rtrn/rtrnmr never form that product
    and collapse exactly."""
    model, prof, sc, fracs = stack64_iso
    rng = np.random.default_rng(3)
    taut = jnp.asarray(rng.gamma(0.6, 1.0, (B, L, 140)))
    out = _rt(model, prof, sc, fracs, taut, kind)
    u = np.asarray(out.totuflux)
    tol = 3e-5 if kind == "mcica" else 1e-12
    assert np.abs(u - u[:, :1]).max() / u.max() < tol
    # and the value is the independently integrated band emission
    anchor = band_anchor(model.static_np, T_ISO)
    assert abs(u[:, 0] / anchor - 1).max() < 2e-4


@pytest.mark.parametrize("kind", KINDS)
def test_transparent_limit(stack64, kind):
    """taut -> 0 and odcld -> 0: zero downward flux everywhere;
    upward flux equals the surface emission at every level; zero
    heating.  (Cloud FRACTIONS stay nonzero: the overlap machinery
    runs, its optics contribute nothing.)"""
    model, prof, sc, fracs = stack64
    taut = jnp.full((B, L, 140), 1e-30, jnp.float64)
    out = _rt(model, prof, sc, fracs, taut, kind, odcld=0.0)
    scale = float(np.asarray(out.totuflux).max())
    assert np.abs(np.asarray(out.totdflux)).max() < 1e-12 * scale
    u = np.asarray(out.totuflux)
    assert np.abs(u - u[:, :1]).max() < 1e-12 * scale
    assert np.abs(np.asarray(out.htr)).max() < 1e-9


@pytest.mark.parametrize("kind", KINDS)
def test_opaque_limit(stack64, kind):
    """taut huge: every level below TOA has up == down == the local
    blackbody emission -> net flux ~0; every layer except the top
    sliver (which cools to space) has ~zero heating.  use_lut=False
    (the closed-form tfn reaches 1 - 2/tau; the LUT saturates at its
    last quantization bin)."""
    model, prof, sc, fracs = stack64
    taut = jnp.full((B, L, 140), 1e7, jnp.float64)
    out = _rt(model, prof, sc, fracs, taut, kind, use_lut=False)
    u = np.asarray(out.totuflux)
    d = np.asarray(out.totdflux)
    fnet = u - d
    rel = np.abs(fnet[:, :-1]).max() / u.max()
    assert rel < 1e-6, rel
    # the common value is the local blackbody: surface-level downward
    # flux vs the independently integrated Planck emission at the
    # bottom level temperature
    tz0 = float(np.asarray(prof.tz)[0, 0])
    anchor = band_anchor(model.static_np, tz0)
    assert abs(d[0, 0] - anchor) / anchor < 2e-4
    # heating ~0 everywhere except the top layer
    assert np.abs(np.asarray(out.htr)[:, :-1]).max() < 1e-2   # K/day
    # ... which cools (to space) in every column
    assert (np.asarray(out.htr)[:, -1] < 0).all()


@pytest.mark.parametrize("icld,imca,use_lut", CONFIGS)
def test_heating_is_flux_divergence(icld, imca, use_lut):
    """htr == heatfac * d(fnet)/dp with heatfac recomputed from first
    principles (g * secdy / (cpdair * 1e2), rrtmg_lw_init.f90:298) —
    on a generic non-limit atmosphere."""
    cfg = LWConfig(icld=icld, imca=imca, use_lut=use_lut,
                   dtype="float64")
    model = make_model(cfg)
    atm = make_atmosphere(ncol=B, nlay=L, dtype=jnp.float64)
    fl = jax.jit(lambda a, c: model(a, c))(atm, clouds_for(cfg,
                                                           jnp.float64))
    heatfac = 9.8066 * 86400.0 / (1.004e3 * 1.0e2)
    pz = np.asarray(inatm(atm, dtype=jnp.float64).pz)
    fnet = np.asarray(fl.uflx) - np.asarray(fl.dflx)
    htr_ind = heatfac * (fnet[:, :-1] - fnet[:, 1:]) / (pz[:, :-1]
                                                        - pz[:, 1:])
    got = np.asarray(fl.hr)
    assert np.abs(got - htr_ind).max() < 1e-10 * np.abs(got).max() + 1e-12


# ---------------------------------------------------------------------------
# exact Schwarzschild solution for linear-in-tau sources
# ---------------------------------------------------------------------------
def _schwarzschild_setup(model, dtau, dtype, nlay=48):
    """A crafted RT problem whose ANALYTIC solution is closed-form:
    per-band Planck source linear in cumulative diffuse optical depth
    (B(tau) = B0 + beta*tau), constant per-layer od, black surface at
    the level-0 Planck value.  dI/dtau = B - I integrates exactly:
      down:  I(tau) = B(tau) - beta - (B(0) - beta) e^-tau
      up:    I(s)   = B_sfc - beta*s + beta - beta e^-s
    The reference's linear-in-tau source (rrtmg_lw_rtrnmc.f90:361-425,
    tfn of rrtmg_lw_init.f90:134-141) is the per-layer exact integral
    of the same ODE, so the recursion must reproduce the closed form
    to roundoff — a QUANTITATIVE anchor for atrans and the tfn source
    factor at every od, not just the limits."""
    from rrtmg_lw_tpu.constants import FLUXFAC, WTDIFF
    from rrtmg_lw_tpu.ops.rtrn import secdiff

    static = model.static_np
    ngb = np.asarray(static["ngb"]) - 1
    counts = np.bincount(ngb, minlength=16)
    Bc, Lc = 2, nlay
    pwvcm = jnp.full((Bc,), 2.0, dtype)
    sec = np.asarray(secdiff(pwvcm, dtype))
    taut = jnp.asarray(np.broadcast_to(
        dtau / sec[:, ngb][:, None, :], (Bc, Lc, 140)).copy(), dtype)
    fracs = jnp.broadcast_to(
        jnp.asarray(1.0 / counts[ngb], dtype), (Bc, Lc, 140))
    tau_lev = np.arange(Lc + 1) * dtau
    beta, B0 = 3.0, 40.0
    Blev = B0 + beta * tau_lev[::-1]
    Blay = 0.5 * (Blev[:-1] + Blev[1:])
    args = dict(
        taut=taut, fracs=fracs, pwvcm=pwvcm,
        planklev=jnp.asarray(np.broadcast_to(
            Blev[None, :, None], (Bc, Lc + 1, 16)).copy(), dtype),
        planklay=jnp.asarray(np.broadcast_to(
            Blay[None, :, None], (Bc, Lc, 16)).copy(), dtype),
        plankbnd=jnp.asarray(np.broadcast_to(
            Blev[0], (Bc, 16)).copy(), dtype),
        semiss=jnp.ones((Bc, 16), dtype),
        pz=jnp.asarray(np.broadcast_to(
            np.linspace(1000, 10, Lc + 1)[None], (Bc, Lc + 1)).copy(),
            dtype))
    taud = tau_lev[::-1]
    I_dn = (B0 + beta * taud) - beta - (B0 - beta) * np.exp(-taud)
    I_up = (Blev[0] - beta * tau_lev) + beta - beta * np.exp(-tau_lev)
    scale = (WTDIFF * np.asarray(static["delwave"]) * FLUXFAC).sum()
    return args, I_up, I_dn, scale


# measured deviations (f64): the closed-form exp path is EXACT
# (4e-16) for od >= 0.06; od < 0.06 runs the reference's own Taylor
# branch (tf = tau/6, rrlw REC_6) at ~4e-5; LUT mode adds the
# 10^4-entry table quantization at ~3e-4
SCHWARZ_CASES = [
    (0.02, False, 1e-4),    # Taylor regime (reference approximation)
    (0.11, False, 1e-14),   # exact
    (2.50, False, 1e-14),   # exact, optically thick
    (0.11, True, 1e-3),     # LUT quantization envelope
]


@pytest.mark.parametrize("dtau,use_lut,tol", SCHWARZ_CASES)
def test_schwarzschild_linear_in_tau(dtau, use_lut, tol):
    model = make_model(LWConfig(icld=0, dtype="float64",
                                use_lut=use_lut))
    a, I_up, I_dn, scale = _schwarzschild_setup(model, dtau,
                                                jnp.float64)
    zero = jnp.zeros_like(a["taut"])
    out = rt.rt_random_overlap(
        a["taut"], a["fracs"], a["planklay"], a["planklev"],
        a["plankbnd"], jnp.zeros_like(a["plankbnd"]), a["semiss"],
        a["pwvcm"], a["pz"], zero, zero,
        cloudy_lay=jnp.zeros(a["taut"].shape[:2], bool),
        cld_gate=jnp.zeros(a["taut"].shape, bool),
        static=model.static_np, luts=model.luts, use_lut=use_lut,
        idrv=0, heatfac_val=model.heatfac, istart=1, iend=16)
    u = np.asarray(out.totuflux)[0] / scale
    d = np.asarray(out.totdflux)[0] / scale
    assert np.abs(u - I_up).max() / np.abs(I_up).max() < tol
    assert np.abs(d - I_dn).max() / np.abs(I_dn).max() < tol


def test_schwarzschild_linear_in_tau_pallas():
    """The same closed-form anchor through the Pallas sweep kernel
    (interpret, f32): bounded by f32 recursion roundoff."""
    from rrtmg_lw_tpu.ops import rtrn_pallas as rtp

    model = make_model(LWConfig(icld=0, dtype="float32",
                                use_lut=False))
    a, I_up, I_dn, scale = _schwarzschild_setup(model, 0.11,
                                                jnp.float32)
    zero = jnp.zeros_like(a["taut"])
    out = rtp.rt_random_overlap_pallas(
        a["taut"], a["fracs"], a["planklay"], a["planklev"],
        a["plankbnd"], jnp.zeros_like(a["plankbnd"]), a["semiss"],
        a["pwvcm"], a["pz"], zero, zero, cloudy=False,
        gate_thresh=2.0, static=model.static_np, idrv=0,
        heatfac_val=model.heatfac, interpret=True)
    u = np.asarray(out.totuflux)[0] / scale
    d = np.asarray(out.totdflux)[0] / scale
    assert np.abs(u - I_up).max() / np.abs(I_up).max() < 1e-5
    assert np.abs(d - I_dn).max() / np.abs(I_dn).max() < 1e-5


# ---------------------------------------------------------------------------
# the same invariants through the Pallas kernels (interpret mode, f32)
# ---------------------------------------------------------------------------
@pytest.mark.slow
def test_isothermal_exact_collapse_pallas():
    """The exact collapse (layer-constant fracs, isothermal planck)
    holds through the Pallas RT sweep kernel in interpret mode, to
    f32 roundoff, cloudy included."""
    from rrtmg_lw_tpu.ops import rtrn_pallas as rtp

    cfg = LWConfig(icld=0, dtype="float32", use_lut=False)
    model = make_model(cfg)
    atm = isothermal_atmosphere(B, L, T_ISO, jnp.float32)
    prof = inatm(atm, dtype=jnp.float32)
    sc = setcoef(prof, model.static, istart=1, idrv=0)
    ng = np.asarray(model.static_np["ngb"])
    counts = np.bincount(ng - 1, minlength=16)
    fracs = jnp.broadcast_to(
        jnp.asarray(1.0 / counts[ng - 1], jnp.float32), (B, L, 140))
    rng = np.random.default_rng(3)
    taut = jnp.asarray(rng.gamma(0.6, 1.0, (B, L, 140)), jnp.float32)
    gate = jnp.zeros(taut.shape, bool).at[:, 5:9, ::2].set(True)
    cldf = gate.astype(jnp.float32)
    od = jnp.where(gate, 0.7, 0.0).astype(jnp.float32)
    out = rtp.rt_random_overlap_pallas(
        taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
        sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz, cldf, od,
        cloudy=True, gate_thresh=0.5, static=model.static_np, idrv=0,
        heatfac_val=model.heatfac, interpret=True)
    u = np.asarray(out.totuflux)
    # f32 + the McICA stream-composition quantization bound (see
    # test_isothermal_exact_collapse)
    assert np.abs(u - u[:, :1]).max() / u.max() < 5e-5
    anchor = band_anchor(model.static_np, T_ISO)
    assert abs(u[:, 0] / anchor - 1).max() < 2e-4


PALLAS_CONFIGS = [(0, 1), (2, 1), (1, 0)]   # clear, McICA, banded


@pytest.mark.parametrize("icld,imca", PALLAS_CONFIGS)
@pytest.mark.slow
def test_isothermal_full_model_pallas(icld, imca):
    """Full model with the Pallas RT sweep (interpret mode, f32): same
    anchors as the f64 full-model test."""
    ncol = 64
    cfg = LWConfig(icld=icld, imca=imca, dtype="float32",
                   use_lut=False, rt_impl="pallas", pallas_interpret=True)
    model = make_model(cfg)
    atm = isothermal_atmosphere(ncol, 24, T_ISO, jnp.float32)
    if icld == 0:
        clouds = None
    elif imca == 1:
        clouds = make_mcica_clouds(ncol=ncol, nlay=24,
                                   dtype=jnp.float32, layout="compact")
    else:
        clouds = make_band_clouds(ncol=ncol, nlay=24, dtype=jnp.float32)
    fl = jax.jit(lambda a, c: model(a, c))(atm, clouds)
    anchor = band_anchor(model.static_np, T_ISO)
    uflx = np.asarray(fl.uflx)
    assert abs(uflx[:, 0] / anchor - 1).max() < 3e-4
    env = 5e-4 if icld == 0 else 5e-2
    assert abs(uflx / anchor - 1).max() < env
    assert np.abs(np.asarray(fl.dflx)[:, -1]).max() < 1e-4
