"""Worker for the 2-process distributed-mesh test (run as a script).

Each process owns 4 virtual CPU devices; together they form an
8-device (columns, spec) mesh spanning a process boundary — the
closest approximation of a multi-host mesh on one machine.  The
worker builds its host-local column shard, assembles the global batch
(``global_batch_from_host_shards``), runs the jitted sharded step and
the mesh-global metrics collectives (Gloo across processes), and dumps
its addressable output shards + metrics for the parent test to check
against a single-process reference run.

Usage: python mp_worker.py <process_id> <num_processes> <port> <outdir>
"""

import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    pid, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nproc, process_id=pid)
    assert len(jax.devices()) == 4 * nproc

    import numpy as np
    import jax.numpy as jnp

    from rrtmg_lw_tpu import LWConfig, make_model
    from rrtmg_lw_tpu import parallel as par
    from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                              make_mcica_clouds)

    mesh = par.make_mesh(jax.devices(), spec=2)
    ncolumns = mesh.shape[par.COLUMNS]
    B, L = 4 * ncolumns, 26

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False))

    # every process generates the identical global batch, then feeds
    # only its host-local slice (contiguous along columns in process
    # order, matching host_local_array_to_global_array's contract)
    atm = make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32)
    clouds = make_mcica_clouds(ncol=B, nlay=L, dtype=jnp.float32)
    lo, hi = pid * B // nproc, (pid + 1) * B // nproc
    take = lambda x: np.asarray(x)[lo:hi]
    atm_l = jax.tree_util.tree_map(take, atm)
    clouds_l = jax.tree_util.tree_map(take, clouds)
    atm_g = par.global_batch_from_host_shards(mesh, atm_l)
    clouds_g = par.global_batch_from_host_shards(mesh, clouds_l)

    step = par.make_sharded_step(model, mesh)
    fl = step(atm_g, clouds_g)
    jax.block_until_ready(fl)

    stats = par.make_metrics_fn(mesh)(fl)
    assert stats["olr_mean"].sharding.is_fully_replicated

    out = {f"metric_{k}": np.asarray(v) for k, v in stats.items()}
    for i, sh in enumerate(fl.uflx.addressable_shards):
        sl = sh.index[0]
        out[f"shard_{i}_rows"] = np.array([sl.start or 0,
                                           sl.stop or B])
        out[f"shard_{i}_uflx"] = np.asarray(sh.data)
    np.savez(os.path.join(outdir, f"proc{pid}.npz"), **out)
    print(f"proc {pid} ok", flush=True)


if __name__ == "__main__":
    main()
