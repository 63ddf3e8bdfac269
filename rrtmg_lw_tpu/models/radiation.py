"""The flagship model: batched longwave radiative transfer.

Batched equivalent of the reference GCM entry point ``rrtmg_lw``
(rrtmg_lw_rad.f90:99-595, McICA) and ``rrtmg_lw_rad.nomcica.f90`` (the
deterministic rtrn/rtrnmr paths).  The reference's serial
``do iplon = 1, ncol`` column loop (rrtmg_lw_rad.f90:486) becomes a
batched, jit-compiled pipeline over a column axis that can be sharded
across a device mesh (see rrtmg_lw_tpu.parallel).

Pipeline per step (all stages batched over columns):
  inatm -> cldprmc/cldprop -> setcoef -> taumol -> (+aerosol) -> rtrn*
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import LWConfig
from ..constants import heatfac
from ..data import ktables as kt
from ..ops import cldprop as cld_ops
from ..ops import rtrn as rt
from ..ops import rtrnmr as rtmr
from ..ops.inatm import inatm
from ..ops.setcoef import setcoef
from ..ops.tables import build_lookup_tables
from ..ops.taumol import TaumolEngine
from ..types import (Atmosphere, BandClouds, Fluxes, McicaClouds,
                     McicaCloudsCompact, Profile)

# "not passed" marker for per-call spec_constraint (None is meaningful:
# it explicitly disables the spectral partition).
_UNSET = object()


def _resolve_rt_impl(config: LWConfig) -> bool:
    """True when the RT sweep runs the Pallas kernel.  'auto' takes it
    on a GPU for the configs it covers (f32, closed-form exp); an
    explicit 'pallas' outside those, or off a GPU without the
    interpreter, raises instead of quietly running something else."""
    covered = config.jdtype == jnp.float32 and not config.use_lut
    on_gpu = jax.default_backend() == "gpu"
    if config.rt_impl == "auto":
        return covered and on_gpu
    if config.rt_impl == "xla":
        return False
    if config.rt_impl != "pallas":
        raise ValueError(f"rt_impl={config.rt_impl!r}")
    if not covered:
        raise ValueError("rt_impl='pallas' covers float32 with "
                         "use_lut=False only")
    if not (on_gpu or config.pallas_interpret):
        raise ValueError("rt_impl='pallas' needs a GPU backend or "
                         "pallas_interpret=True")
    return True


class RRTMGLW:
    """Holds the static k-tables / lookup tables and exposes jittable
    flux computations."""

    def __init__(self, config: LWConfig = LWConfig(),
                 ktables: Optional[dict] = None):
        self.config = config
        dtype = config.jdtype
        self.static_np = kt.load_static()
        if ktables is None:
            ktables, self.is_real_kdata = kt.load_ktables()
        else:
            self.is_real_kdata = True
        self.ktables = ktables
        self.engine = TaumolEngine(ktables, self.static_np, dtype=dtype)
        self.rt_pallas = _resolve_rt_impl(config)
        luts_np = build_lookup_tables()
        self.luts = {
            "tau_tbl": jnp.asarray(luts_np.tau_tbl, dtype),
            "exp_tbl": jnp.asarray(luts_np.exp_tbl, dtype),
            "tfn_tbl": jnp.asarray(luts_np.tfn_tbl, dtype),
        }
        self.static = dict(self.static_np)
        for k in ("totplnk", "totplk16", "totplnkderiv", "totplk16deriv",
                  "preflog", "tref", "chi_mls"):
            self.static[k] = jnp.asarray(self.static_np[k], dtype)
        self.heatfac = heatfac(config.cpdair)
        self.ngb0 = np.asarray(self.static_np["ngb"]) - 1   # band of g
        # Default NamedSharding for the (B, L, G) spectral intermediates
        # (partitions g-points across a mesh axis).  Prefer passing
        # ``spec_constraint=`` per call (parallel.api does) so one model
        # instance can serve several meshes without cross-contamination.
        self.spec_constraint = None

    # ------------------------------------------------------------------
    def optical_depth(self, prof: Profile, istart: int = 1):
        """setcoef + taumol: per-g-point optical depth & Planck fractions."""
        sc = setcoef(prof, self.static, istart=istart,
                     idrv=self.config.idrv)
        taug, fracs = self.engine(sc, prof)
        taut = taug + prof.taua[..., self.ngb0]
        return sc, taut, fracs

    # ------------------------------------------------------------------
    def _gselect(self):
        cfg = self.config
        gsel = np.nonzero((self.ngb0 >= cfg.istart - 1)
                          & (self.ngb0 <= cfg.iend - 1))[0]
        return gsel

    def __call__(self, atm: Atmosphere,
                 clouds: Union[None, McicaClouds, BandClouds] = None,
                 *, spec_constraint=_UNSET) -> Fluxes:
        cfg = self.config
        dtype = cfg.jdtype
        prof = inatm(atm, dtype=dtype)
        return self.from_profile(prof, clouds,
                                 spec_constraint=spec_constraint)

    def from_profile(self, prof: Profile,
                     clouds: Union[None, McicaClouds, BandClouds] = None,
                     *, spec_constraint=_UNSET) -> Fluxes:
        """Run the radiation from an already-processed Profile (column
        mode enters here).

        ``spec_constraint``: NamedSharding for the (g, L, B) spectral
        intermediates, or None.  Defaults to ``self.spec_constraint``;
        passing it explicitly (as parallel.api does) scopes the
        partitioning to this call instead of mutating shared state.
        """
        if spec_constraint is _UNSET:
            spec_constraint = self.spec_constraint
        cfg = self.config
        dtype = cfg.jdtype
        B, L = prof.pavel.shape

        gsel = self._gselect()
        sc, taut, fracs = self.optical_depth(prof, istart=cfg.istart)
        if spec_constraint is not None:
            taut = jax.lax.with_sharding_constraint(taut, spec_constraint)
            fracs = jax.lax.with_sharding_constraint(fracs,
                                                     spec_constraint)
        if len(gsel) != taut.shape[-1]:
            taut = taut[..., gsel]
            fracs = fracs[..., gsel]
        # GSPMD cannot split a pallas_call along g, so a spectral
        # partition keeps the XLA sweep
        use_kernel = self.rt_pallas and spec_constraint is None

        def run_rt(cldf_g, odcld_g, cloudy, thresh, odcld_weighted=False):
            if use_kernel:
                from ..ops import rtrn_pallas as rtp
                return rtp.rt_random_overlap_pallas(
                    taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
                    sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz,
                    cldf_g, odcld_g, cloudy=cloudy, gate_thresh=thresh,
                    static=self.static_np, idrv=cfg.idrv,
                    heatfac_val=self.heatfac, istart=cfg.istart,
                    iend=cfg.iend, odcld_weighted=odcld_weighted,
                    interpret=cfg.pallas_interpret)
            if cloudy:
                gate = cldf_g >= thresh
            else:
                cldf_g = odcld_g = jnp.zeros(taut.shape, dtype)
                gate = jnp.zeros(taut.shape, bool)
            return rt.rt_random_overlap(
                taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
                sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz,
                cldf_g, odcld_g,
                cloudy_lay=jnp.any(gate, axis=-1), cld_gate=gate,
                static=self.static_np, luts=self.luts,
                use_lut=cfg.use_lut, idrv=cfg.idrv,
                heatfac_val=self.heatfac, istart=cfg.istart,
                iend=cfg.iend, odcld_weighted=odcld_weighted)

        bounds_ok = None
        if cfg.icld == 0 or clouds is None:
            out = run_rt(None, None, False, 2.0)
        elif cfg.imca == 1:
            assert isinstance(clouds, (McicaClouds, McicaCloudsCompact))
            if not isinstance(clouds, McicaClouds):
                clouds = clouds.to_batch()
            taucmc, bounds_ok = cld_ops.cldprmc(
                clouds, self.static_np, inflag=cfg.inflag,
                iceflag=cfg.iceflag, liqflag=cfg.liqflag)
            # cldfmc is binary (0/1): >= 0.5 reproduces the reference's
            # cldfmc == 1 gate (rtrnmc.f90:317)
            out = run_rt(clouds.cldfmc[..., gsel], taucmc[..., gsel],
                         True, 0.5)
        else:
            assert isinstance(clouds, BandClouds)
            weighted = not cld_ops.cloud_bands_static(
                cfg.inflag, cfg.iceflag, cfg.liqflag)
            if weighted:
                # reference runtime-ncbands configs (iceflag 0/1 or
                # liqflag 0): cloud-band taucloud + the ipat/secdiff
                # cloud-band aliasing expanded to spectral bands, with
                # the cloud band's secdiff already applied (a ratio
                # prefold would shift the tau_tbl quantizer by an ulp)
                tau_cb, ncb, bounds_ok = cld_ops.cldprop_ncbands(
                    clouds, self.static_np, inflag=cfg.inflag,
                    iceflag=cfg.iceflag, liqflag=cfg.liqflag)
                taucloud = cld_ops.expand_cloud_bands(
                    tau_cb, ncb, rt.secdiff(prof.pwvcm, dtype))
            else:
                taucloud, bounds_ok = cld_ops.cldprop(
                    clouds, self.static_np, inflag=cfg.inflag,
                    iceflag=cfg.iceflag, liqflag=cfg.liqflag)
            odcld_g = taucloud[..., self.ngb0][..., gsel]
            if cfg.icld == 1:
                cldf_g = jnp.broadcast_to(
                    clouds.cldfrac[..., None], (B, L, len(gsel)))
                out = run_rt(cldf_g, odcld_g, True, 1.0e-6,
                             odcld_weighted=weighted)
            else:
                out = rtmr.rt_maxrandom(
                    taut, fracs, sc.planklay, sc.planklev,
                    sc.plankbnd, sc.dplankbnd_dt, prof.semiss,
                    prof.pwvcm, prof.pz, clouds.cldfrac, odcld_g,
                    static=self.static_np, luts=self.luts,
                    use_lut=cfg.use_lut, idrv=cfg.idrv,
                    heatfac_val=self.heatfac, istart=cfg.istart,
                    iend=cfg.iend, odcld_weighted=weighted)

        uflx, dflx = out.totuflux, out.totdflux
        duflx_dt = out.dtotuflux_dt
        duflxc_dt = out.dtotuclfl_dt
        if cfg.idrv and prof.dtbound is not None:
            # column-mode dtbound flux adjustment (rrtmg_lw.1col.f90:587-610)
            dtb = prof.dtbound[:, None]
            uflx = uflx + duflx_dt * dtb
            uflxc = out.totuclfl + duflxc_dt * dtb
            fnet = uflx - dflx
            fnetc = uflxc - out.totdclfl
            dp = prof.pz[:, :-1] - prof.pz[:, 1:]
            htr = self.heatfac * (fnet[:, :-1] - fnet[:, 1:]) / dp
            htrc = self.heatfac * (fnetc[:, :-1] - fnetc[:, 1:]) / dp
            return Fluxes(uflx, dflx, htr, uflxc, out.totdclfl, htrc,
                          duflx_dt, duflxc_dt, bounds_ok)
        return Fluxes(uflx, dflx, out.htr, out.totuclfl, out.totdclfl,
                      out.htrc, duflx_dt, duflxc_dt, bounds_ok)


@functools.partial(jax.jit, static_argnums=(0,))
def _jitted_call(model, atm, clouds):
    return model(atm, clouds)


def make_model(config: LWConfig = LWConfig(), **kw) -> RRTMGLW:
    return RRTMGLW(config, **kw)
