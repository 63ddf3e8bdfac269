"""Production streaming with the compressed wire format.

In a streaming deployment the host link, not the device, can bound
sustained columns/s.  This example shows the device-side dataflow for
that regime:

  host thread:  generate / load (B, L) profile + cloud fields
                -> wire-encode (uint16 codes + per-batch reference
                   profiles, ~1.1 KB/col at nlay=60 — C++ encoder
                   when available)
                -> prefetch (double-buffered H2D)
  device step:  decode -> McICA sub-column masks (threefry, on
                device) -> full radiation -> fluxes

Replaces the reference's per-column text reader
(rrtmg_lw.1col.f90:447) / GCM array passing at production scale.

Run (any backend; virtual CPU mesh works):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/wire_streaming.py --ncol 2048 --steps 6 --cpu

    python examples/wire_streaming.py --ncol 16384 --steps 64   # GPU
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
    ap.add_argument("--ncol", type=int, default=16384)
    ap.add_argument("--nlay", type=int, default=60)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.steps < 2:
        ap.error("--steps must be >= 2 (the first step is compile "
                 "warmup, outside the clock)")

    import jax
    import jax.numpy as jnp
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from rrtmg_lw_tpu import LWConfig, make_model
    from rrtmg_lw_tpu import parallel as par
    from rrtmg_lw_tpu.ops.mcica import mcica_subcol_lw_compact
    from rrtmg_lw_tpu.parallel import wire as w
    from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                              make_cloud_profile_fields
                                              as cloud_fields)

    B, L = args.ncol, args.nlay
    mesh = par.make_mesh(jax.devices())
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False))
    # device-resident state that never crosses the wire
    taua0 = par.shard_batch(np.zeros((B, L, 16), np.float32), mesh)
    keys = jax.device_put(np.stack([
        np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.key(7), i)))
        for i in range(args.steps + 1)]))

    def host_batches():
        """The host side: generate (or load), then wire-encode.  This
        runs on the prefetch worker thread, overlapped with device
        compute.  schema="coded" pins the WireBatch pytree structure:
        with auto-detection, a channel flipping between zero/uniform/
        encoded across batches would change the jit signature and
        force a recompile mid-stream (pin a captured w.schema_of(...)
        instead to keep the smaller auto wire)."""
        for i in range(args.steps):
            atm = make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32,
                                  seed=i)
            yield (w.encode_atmosphere(atm, schema="coded"),
                   w.encode_cloud_profiles(cloud_fields(B, L, i),
                                           schema="coded"))

    @jax.jit
    def step(ea, ec, i):
        atm = w.decode_atmosphere(ea, taua0)
        cp = w.decode_cloud_profiles(ec, like=atm.play)
        clouds = mcica_subcol_lw_compact(
            jax.random.wrap_key_data(keys[i]), 2, cp["cldfrac"],
            cp["ciwp"], cp["clwp"], cp["rei"], cp["rel"])
        return model(atm, clouds)

    out = None
    i = 0
    t0 = None
    for dev_batch in par.prefetch(host_batches(), mesh,
                                  depth=args.depth):
        out = step(*dev_batch, i)
        if i == 0:                      # compile lands outside the clock
            jax.block_until_ready(out.uflx)
            t0 = time.perf_counter()
        i += 1
    jax.block_until_ready(out.uflx)
    wall = time.perf_counter() - t0
    done = (i - 1) * B
    print(f"{done} columns in {wall:.2f}s "
          f"({done / max(wall, 1e-9):,.0f} cols/s sustained); "
          f"OLR mean {float(np.asarray(out.uflx)[:, -1].mean()):.2f} "
          f"W/m2")
    assert np.isfinite(np.asarray(out.uflx)).all()


if __name__ == "__main__":
    main()
