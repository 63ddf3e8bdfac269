"""Adjoint sensitivity analysis of longwave fluxes.

The reference's only derivative is idrv=1: dF_up/dT_surface by a
hand-coded linear recursion (rrtmg_lw_rtrnmc.f90:495-527).  Because
this framework is differentiable end-to-end, ONE reverse pass gives
the full sensitivity profile of any scalar flux functional to EVERY
input — per-layer temperature, water vapor, any trace gas, cloud
water — batched over columns and shardable over a mesh.

Examples computed here (clear sky, synthetic atmospheres):

  dOLR/dT(layer)     — the vertically-resolved version of idrv; its
                       surface entry cross-checks against the
                       reference-style dF/dTsfc derivative output.
  dOLR/dln(q)(layer) — water-vapor sensitivity (W/m² per log-vmr),
                       the classic radiative-kernel diagnostic GCM
                       groups compute by finite differences.

Run: python examples/sensitivities.py [--ncol 512] [--nlay 60] [--cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncol", type=int, default=512)
    ap.add_argument("--nlay", type=int, default=60)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from rrtmg_lw_tpu import LWConfig, make_model
    from rrtmg_lw_tpu.utils.synthetic import make_atmosphere

    # the reference's own f64 precision (the GPU has FP64 units)
    dtype = "float64"
    jax.config.update("jax_enable_x64", True)
    model = make_model(LWConfig(icld=0, idrv=1, use_lut=False,
                                dtype=dtype))
    atm = make_atmosphere(ncol=args.ncol, nlay=args.nlay,
                          dtype=jnp.dtype(dtype))

    def mean_olr(tlay, h2o, tsfc):
        fl = model(atm._replace(tlay=tlay, h2ovmr=h2o, tsfc=tsfc))
        return fl.uflx[:, -1].mean(), fl

    grad_fn = jax.jit(jax.grad(mean_olr, argnums=(0, 1, 2),
                               has_aux=True))
    (d_tlay, d_h2o, d_tsfc), fl = grad_fn(atm.tlay, atm.h2ovmr,
                                          atm.tsfc)

    B = args.ncol
    # per-column scale: grads of the batch MEAN -> multiply by B
    kernel_T = np.asarray(d_tlay) * B            # (B, L) W/m2 per K
    kernel_q = np.asarray(d_h2o * atm.h2ovmr) * B  # per log-vmr
    d_tsfc = np.asarray(d_tsfc) * B

    print(f"OLR mean: {float(fl.uflx[:, -1].mean()):.3f} W/m2 "
          f"({B} columns, {args.nlay} layers)")
    lay_T = int(np.argmax(kernel_T.mean(axis=0)))
    lay_q = int(np.argmin(kernel_q.mean(axis=0)))
    print(f"dOLR/dT    peaks at layer {lay_T}: "
          f"{kernel_T.mean(axis=0)[lay_T]:+.4f} W/m2/K (batch mean)")
    print(f"dOLR/dln q strongest at layer {lay_q}: "
          f"{kernel_q.mean(axis=0)[lay_q]:+.4f} W/m2 (greenhouse: <0)")

    # cross-check the surface-temperature adjoint against the
    # reference-style idrv derivative (duflx_dt at TOA).  Small
    # differences are expected: idrv interpolates AER's pre-tabulated
    # dB/dT table (totplnkderiv), the adjoint differentiates the
    # Planck interpolation itself (secant of the 1 K totplnk grid).
    duflx_dt_toa = np.asarray(fl.duflx_dt)[:, -1]
    print(f"dOLR/dTsfc: adjoint {d_tsfc.mean():+.5f}  "
          f"idrv-path {duflx_dt_toa.mean():+.5f}  "
          f"(max |diff| {np.abs(d_tsfc - duflx_dt_toa).max():.2e})")


if __name__ == "__main__":
    main()
