"""GCM-mode driver: large mixed clear/cloudy column batches with
aerosols, sharded over every visible device, with double-buffered
host->device streaming.

This is the production shape of the reference's GCM entry point
(rrtmg_lw_rad.f90:99 `rrtmg_lw`, called per column block from a host
model): here one jit-compiled step radiates the whole sharded batch
and the input pipeline keeps `--depth` batches in flight so the cards
never wait on PCIe.

Run (any backend; a virtual CPU mesh works for a smoke test):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/gcm_step.py --ncol 4096 --steps 10 --cpu

    python examples/gcm_step.py --ncol 65536 --steps 20   # four GPUs
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncol", type=int, default=16384,
                    help="columns per step (global, across the mesh)")
    ap.add_argument("--nlay", type=int, default=60)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--depth", type=int, default=2,
                    help="prefetch depth (batches in flight)")
    ap.add_argument("--cloud-frac", type=float, default=0.5,
                    help="fraction of columns with McICA clouds")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual mesh smoke)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from rrtmg_lw_tpu import LWConfig, make_model
    from rrtmg_lw_tpu import parallel as par
    from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                              make_mcica_clouds)

    devices = jax.devices()
    mesh = par.make_mesh(devices)
    print(f"mesh: {len(devices)} x {devices[0].platform}")

    # Mixed population, one compiled program: clear columns carry a
    # zero cloud mask, aerosols ride the per-band taua input.
    model = make_model(LWConfig(icld=2, imca=1, iaer=10,
                                dtype="float32", use_lut=False))
    step = par.make_sharded_step(model, mesh)

    def host_batches(n):
        for i in range(n):
            atm = make_atmosphere(ncol=args.ncol, nlay=args.nlay,
                                  dtype=jnp.float32, seed=i, aod=0.3)
            clouds = make_mcica_clouds(
                ncol=args.ncol, nlay=args.nlay, dtype=jnp.float32,
                layout="compact", seed=i, mask_dtype=np.int8,
                clear_frac=1.0 - args.cloud_frac)
            yield atm, clouds

    # warm-up compile outside the timed stream
    atm0, cl0 = next(iter(host_batches(1)))
    atm0 = par.shard_batch(atm0, mesh)
    cl0 = par.shard_batch(cl0, mesh)
    jax.block_until_ready(step(atm0, cl0))

    t0 = time.perf_counter()
    out = par.run_epoch(step, host_batches(args.steps), mesh,
                        depth=args.depth)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    total = args.steps * args.ncol
    print(f"{total} columns in {dt:.3f}s -> {total / dt:,.0f} cols/s "
          f"({total / dt / len(devices):,.0f}/chip)")
    print("TOA uflx mean:", float(out.uflx[:, -1].mean()),
          "W/m2; all finite:", bool(np.isfinite(
              np.asarray(out.uflx)).all()))


if __name__ == "__main__":
    main()
