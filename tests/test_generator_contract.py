"""The synthetic-generator placement contract.

Generators return HOST numpy arrays (streaming contract: the input
pipeline owns device placement via parallel.shard_batch /
stream.prefetch / an explicit jax.device_put).  Consumers must never
rely on implicit placement — the round-2 bench regression (host args
re-uploaded every timed iteration, 100x collapse) is the failure mode
this contract test pins down.
"""

import numpy as np

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import parallel as par
from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                          make_band_clouds,
                                          make_mcica_clouds)


def _all_leaves_numpy(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    assert leaves, "empty tree"
    return all(isinstance(x, np.ndarray) for x in leaves)


def test_generators_return_host_numpy():
    assert _all_leaves_numpy(make_atmosphere(ncol=4, nlay=12))
    assert _all_leaves_numpy(make_band_clouds(ncol=4, nlay=12))
    for layout in ("batch", "compact"):
        assert _all_leaves_numpy(
            make_mcica_clouds(ncol=8, nlay=12, layout=layout)), layout


def test_generators_tolerate_tiny_nlay():
    # row indices clip to the top layer instead of raising (the old
    # slice assignments silently clipped)
    make_band_clouds(ncol=4, nlay=6)
    make_mcica_clouds(ncol=4, nlay=6)


def test_shard_batch_and_prefetch_accept_host_numpy():
    mesh = par.make_mesh(jax.devices())
    atm = make_atmosphere(ncol=8 * len(jax.devices()), nlay=12,
                          dtype=jnp.float32)
    dev_atm = par.shard_batch(atm, mesh)
    assert all(isinstance(x, jax.Array)
               for x in jax.tree_util.tree_leaves(dev_atm))
    assert all(x.committed
               for x in jax.tree_util.tree_leaves(dev_atm))

    from rrtmg_lw_tpu.parallel.stream import prefetch
    batches = [make_atmosphere(ncol=8 * len(jax.devices()), nlay=12,
                               dtype=jnp.float32, seed=i)
               for i in range(3)]
    got = list(prefetch(iter(batches), mesh, depth=2))
    assert len(got) == 3
    for tree in got:
        assert all(isinstance(x, jax.Array)
                   for x in jax.tree_util.tree_leaves(tree))


def test_bench_asserts_device_residency():
    """bench.py's guard must reject host-numpy timed args — the exact
    round-2 failure mode."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "bench", pathlib.Path(__file__).resolve().parents[1]
        / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    atm = make_atmosphere(ncol=4, nlay=12, dtype=jnp.float32)
    try:
        bench._assert_device_resident(atm, "atm")
    except AssertionError:
        pass
    else:
        raise AssertionError("host-numpy args must be rejected")
    dev = jax.device_put(atm, jax.devices()[0])
    bench._assert_device_resident(dev, "atm")
