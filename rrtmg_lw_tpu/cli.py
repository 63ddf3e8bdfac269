"""Column-mode driver: the framework's equivalent of the reference
standalone program ``rrtmg_lw`` (src/rrtmg_lw.1col.f90:80-736).

Reads INPUT_RRTM (+ IN_CLD_RRTM / IN_AER_RRTM), runs the radiation, and
writes OUTPUT_RRTM in the reference format.  McICA mode performs the
200-sample statistical loop (:460-471) with the exact Mersenne-Twister
sub-column generator (permuteseed = sample index, :483) — but batched:
all 200 samples run as one vectorized solver call.

Run:  python -m rrtmg_lw_tpu.cli INPUT_RRTM [-o OUTPUT_RRTM]
                                 [--cld IN_CLD_RRTM] [--aer IN_AER_RRTM]
"""

from __future__ import annotations

import argparse
import os
import pathlib

import numpy as np


def _ensure_f64():
    """Column mode validates against f64 goldens: enable x64 before the
    first JAX dispatch.  It runs on the default backend."""
    import jax
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


NMCA = 200     # rrtmg_lw.1col.f90:460


def run_case(case, iplon: int = 1, nmca: int = NMCA,
             return_raw: bool = False):
    """Run one parsed ColumnCase; returns list of formatted output
    blocks (and, with ``return_raw``, the unformatted per-block flux
    arrays — used by tests/test_cli_vs_oracle.py to pin the CLI's
    values against the scalar spec-oracle at full precision)."""
    _ensure_f64()
    import jax.numpy as jnp

    from . import LWConfig, make_model
    from .ops import mcica
    from .types import BandClouds, McicaClouds, Profile

    L = case.nlayers
    imca = case.imca
    B = nmca if (imca == 1) else 1

    def rep(x, extra=()):
        a = jnp.asarray(np.asarray(x, np.float64))
        return jnp.broadcast_to(a[None], (B,) + a.shape)

    prof = Profile(
        pavel=rep(case.pavel), tavel=rep(case.tavel),
        pz=rep(case.pz), tz=rep(case.tz),
        tbound=jnp.full((B,), float(case.tbound)),
        semiss=rep(case.semiss),
        coldry=rep(case.coldry), wkl=rep(case.wkl.T),
        wbrodl=rep(case.wbrodl), wx=rep(case.wx.T),
        pwvcm=jnp.full((B,), float(case.pwvcm)),
        taua=rep(case.tauaer),
        dtbound=jnp.full((B,), float(case.dtbound)))

    cld = case.clouds
    clouds = None
    cfg_kw = dict(icld=case.icld, idrv=case.idrv, iaer=case.iaer,
                  imca=imca, idcor=case.idcor, dtype="float64",
                  use_lut=True)
    if cld is not None:
        cfg_kw.update(inflag=cld.inflag, iceflag=cld.iceflag,
                      liqflag=cld.liqflag)

    if case.icld >= 1 and imca == 1:
        # exact per-sample Mersenne-Twister generator (irng=1 default,
        # rrtmg_lw.1col.f90:114; permuteseed = ims, :483)
        static = _static()
        alpha = None
        if case.icld in (4, 5):
            alpha = np.asarray(mcica.get_alpha(
                jnp.asarray(case.dz[None, :], jnp.float64), case.icld,
                idcor=case.idcor, decorr_con=case.decorr_con,
                lat=np.array([case.lat]), juldat=case.juldat,
                cldfrac=jnp.asarray(cld.cldfrac[None, :])))[0]
        cldfmc = np.zeros((B, L, 140))
        ciwpmc = np.zeros((B, L, 140))
        clwpmc = np.zeros((B, L, 140))
        taucmc = np.zeros((B, L, 140))
        for s in range(B):
            out = mcica.generate_stochastic_clouds_ref(
                L, case.icld, 1, case.pavel * 100.0, cld.cldfrac,
                cld.clwp, cld.ciwp, alpha, cld.tauc, changeseed=s + 1,
                ngb=static["ngb"])
            cldfmc[s] = out["cldfmc"].T
            ciwpmc[s] = out["ciwpmc"].T
            clwpmc[s] = out["clwpmc"].T
            taucmc[s] = out["taucmc"].T
        clouds = McicaClouds(
            cldfmc=jnp.asarray(cldfmc), ciwpmc=jnp.asarray(ciwpmc),
            clwpmc=jnp.asarray(clwpmc), taucmc=jnp.asarray(taucmc),
            reicmc=rep(cld.rei), relqmc=rep(cld.rel))
    elif case.icld >= 1:
        clouds = BandClouds(
            cldfrac=rep(cld.cldfrac), tauc=rep(cld.tauc.T),
            ciwp=rep(cld.ciwp), clwp=rep(cld.clwp),
            reic=rep(cld.rei), relq=rep(cld.rel))

    from .io.column_output import format_flux_table

    blocks = []
    raws = []
    if case.iout < 0:
        return (blocks, raws) if return_raw else blocks
    iout = case.iout
    iflag = iout
    models = {}
    while True:
        istart, iend = (iflag, iflag) if 1 <= iflag <= 40 else (1, 16)
        key = (istart, iend)
        if key not in models:
            models[key] = make_model(LWConfig(istart=istart, iend=iend,
                                              **cfg_kw))
        fl = models[key].from_profile(prof, clouds)
        uflx = np.asarray(fl.uflx).mean(axis=0)
        dflx = np.asarray(fl.dflx).mean(axis=0)
        htr = np.asarray(fl.hr).mean(axis=0)
        fnet = uflx - dflx
        blocks.append(format_flux_table(istart, iend, iplon, case.pz,
                                        uflx, dflx, fnet, htr))
        raws.append(dict(istart=istart, iend=iend, uflx=uflx, dflx=dflx,
                         fnet=fnet, htr=htr))
        if iout <= 40 or iflag == 16:
            break
        iflag = 1 if iflag == 99 else iflag + 1
    return (blocks, raws) if return_raw else blocks


def _static():
    from .data import ktables as kt
    return kt.load_static()


def run_files(input_path, output_path=None, cld_path=None, aer_path=None,
              nmca: int = NMCA):
    from .io.column_input import read_input_rrtm
    from .io.column_output import write_output_rrtm

    case = read_input_rrtm(input_path, cld_path=cld_path,
                           aer_path=aer_path)
    blocks = run_case(case, nmca=nmca)
    if output_path is None:
        output_path = pathlib.Path(input_path).parent / "OUTPUT_RRTM"
    write_output_rrtm(output_path, blocks)
    return output_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input", help="INPUT_RRTM file")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--cld", default=None, help="IN_CLD_RRTM path")
    p.add_argument("--aer", default=None, help="IN_AER_RRTM path")
    p.add_argument("--nmca", type=int, default=NMCA,
                   help="McICA sample count (reference: 200)")
    a = p.parse_args(argv)
    out = run_files(a.input, a.output, a.cld, a.aer, nmca=a.nmca)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
