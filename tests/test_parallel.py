"""Sharded execution == single-device execution; driver entry points run."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from helpers import make_atmosphere, make_mcica_clouds

from rrtmg_lw_tpu import LWConfig, make_model
from rrtmg_lw_tpu import parallel as par


@pytest.mark.slow
@pytest.mark.parametrize("spec", [1, 2])
def test_sharded_matches_single_device(spec):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = par.make_mesh(jax.devices()[:8], spec=spec)
    cfg = LWConfig(icld=2, imca=1, dtype="float64")
    B, L = 16, 31

    atm = make_atmosphere(ncol=B, nlay=L)
    clouds = make_mcica_clouds(ncol=B, nlay=L)

    ref_model = make_model(cfg)
    ref = ref_model(atm, clouds)

    model = make_model(cfg)
    step = par.make_sharded_step(model, mesh)
    out = step(par.shard_batch(atm, mesh), par.shard_batch(clouds, mesh))

    np.testing.assert_allclose(np.asarray(out.uflx),
                               np.asarray(ref.uflx), rtol=1e-12)
    # hr differences fluxes across levels: reduction-order noise amplified
    np.testing.assert_allclose(np.asarray(out.hr),
                               np.asarray(ref.hr), rtol=1e-6, atol=1e-9)
    # outputs really are sharded over columns
    assert not out.uflx.sharding.is_fully_replicated


def test_prefetch_stream():
    mesh = par.make_mesh(jax.devices()[:8], spec=1)
    batches = [make_atmosphere(ncol=8, nlay=21, seed=s) for s in range(5)]
    seen = list(par.prefetch(batches, mesh, depth=2))
    assert len(seen) == 5
    np.testing.assert_allclose(np.asarray(seen[3].tsfc),
                               np.asarray(batches[3].tsfc))


def test_prefetch_propagates_source_errors():
    # the transfers run on a worker thread; an exception raised by the
    # source iterator must surface at the consumer, in order
    mesh = par.make_mesh(jax.devices()[:8], spec=1)

    def gen():
        yield make_atmosphere(ncol=8, nlay=21, seed=0)
        raise RuntimeError("boom")

    it = par.prefetch(gen(), mesh, depth=2)
    next(it)
    try:
        next(it)
    except RuntimeError as e:
        assert "boom" in str(e)
    else:
        raise AssertionError("source exception swallowed")


def test_prefetch_early_exit_no_hang():
    # breaking out of the stream mid-iteration must shut the worker
    # down without hanging or leaking in-flight transfers
    mesh = par.make_mesh(jax.devices()[:8], spec=1)
    batches = [make_atmosphere(ncol=8, nlay=21, seed=s)
               for s in range(50)]
    for i, b in enumerate(par.prefetch(iter(batches), mesh, depth=2)):
        if i == 2:
            break
    # a fresh stream still works after the abandoned one
    assert len(list(par.prefetch(batches[:3], mesh, depth=2))) == 3


def test_graft_entry_single_chip():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(np.asarray(out.uflx)).all()
    assert out.duflx_dt is not None


@pytest.mark.slow
def test_graft_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@pytest.mark.parametrize("use_shard_map", [False, True])
def test_sharded_compact_clouds(use_shard_map):
    """Layout-aware sharding: compact clouds (mask columns on the last
    axis) shard correctly under both GSPMD and shard_map."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from rrtmg_lw_tpu.utils.synthetic import (
        make_mcica_clouds as mk_clouds)
    mesh = par.make_mesh(jax.devices()[:8], spec=1)
    cfg = LWConfig(icld=2, imca=1, dtype="float64")
    B, L = 16, 31
    atm = make_atmosphere(ncol=B, nlay=L)
    clouds = mk_clouds(ncol=B, nlay=L, layout="compact")

    ref = make_model(cfg)(atm, clouds)

    model = make_model(cfg)
    step = par.make_sharded_step(model, mesh,
                                 use_shard_map=use_shard_map)
    out = step(par.shard_batch(atm, mesh),
               par.shard_batch(clouds, mesh))
    np.testing.assert_allclose(np.asarray(out.uflx),
                               np.asarray(ref.uflx), rtol=1e-12)
    assert not out.uflx.sharding.is_fully_replicated


def test_mesh_global_metrics():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = par.make_mesh(jax.devices()[:8], spec=1)
    cfg = LWConfig(icld=0, dtype="float64")
    B, L = 16, 31
    atm = make_atmosphere(ncol=B, nlay=L)
    model = make_model(cfg)
    step = par.make_sharded_step(model, mesh)
    fl = step(par.shard_batch(atm, mesh))

    metrics = par.make_metrics_fn(mesh)(fl)
    # replicated scalars, consistent with a host-side reduction
    assert metrics["olr_mean"].sharding.is_fully_replicated
    ref = model(atm)
    np.testing.assert_allclose(float(metrics["olr_mean"]),
                               float(np.asarray(ref.uflx)[:, -1].mean()),
                               rtol=1e-12)
    assert float(metrics["ncol"]) == B
    assert float(metrics["olr_min"]) <= float(metrics["olr_max"])

    # validation norms against a perturbed reference
    fl2 = step(par.shard_batch(atm._replace(tsfc=atm.tsfc + 1.0), mesh))
    norms = par.make_metrics_fn(mesh, with_reference=True)(fl, fl2)
    expect = float(np.abs(np.asarray(ref.uflx)
                          - np.asarray(fl2.uflx)).max())
    np.testing.assert_allclose(float(norms["uflx_maxabs"]), expect,
                               rtol=1e-9)
    assert float(norms["hr_maxabs"]) >= 0.0


@pytest.mark.slow
def test_two_process_distributed_mesh(tmp_path):
    """The sharded step + metrics collectives must
    survive a process boundary.  Two fresh processes x 4 virtual CPU
    devices form one 8-device (columns, spec=2) mesh over
    jax.distributed (Gloo collectives); each worker feeds its
    host-local column shard, runs the jitted step, and dumps its
    addressable output shards + the replicated metrics.  The parent
    checks every shard against a single-process reference run and that
    both processes agree on the metrics bitwise."""
    import subprocess
    import sys as _sys
    import pathlib as _pl

    import socket

    worker = _pl.Path(__file__).parent / "mp_worker.py"
    # pick a free port so concurrent/aborted runs cannot collide
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [_sys.executable, str(worker), str(i), "2", port, str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=str(_pl.Path(__file__).parent.parent), env=env)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-3000:]}"

    d0 = np.load(tmp_path / "proc0.npz")
    d1 = np.load(tmp_path / "proc1.npz")
    # replicated metrics identical across processes
    for k in d0.files:
        if k.startswith("metric_"):
            np.testing.assert_array_equal(d0[k], d1[k], err_msg=k)

    # single-process reference on the identical global batch
    from rrtmg_lw_tpu import LWConfig, make_model
    from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                              make_mcica_clouds)
    B, L = 16, 26
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False))
    atm = make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32)
    clouds = make_mcica_clouds(ncol=B, nlay=L, dtype=jnp.float32)
    ref = np.asarray(model(atm, clouds).uflx)

    covered = np.zeros(B, bool)
    for d in (d0, d1):
        for k in d.files:
            if k.endswith("_rows"):
                i = k[: -len("_rows")]
                lo, hi = d[k]
                np.testing.assert_allclose(
                    d[f"{i}_uflx"], ref[lo:hi], rtol=2e-6,
                    err_msg=f"{i} rows {lo}:{hi}")
                covered[lo:hi] = True
    assert covered.all()
    np.testing.assert_allclose(
        float(d0["metric_olr_mean"]), ref[:, -1].mean(), rtol=1e-5)


@pytest.mark.slow
def test_shard_map_clear_sky():
    """Regression: shard_map step with clouds=None (clear sky) used to
    crash in _pspecs_for (None pytree treated as a spec leaf)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = par.make_mesh(jax.devices()[:8], spec=1)
    cfg = LWConfig(icld=0, dtype="float64")
    B, L = 16, 21
    atm = make_atmosphere(ncol=B, nlay=L)
    ref = make_model(cfg)(atm)
    step = par.make_sharded_step(make_model(cfg), mesh,
                                 use_shard_map=True)
    out = step(par.shard_batch(atm, mesh))
    np.testing.assert_allclose(np.asarray(out.uflx),
                               np.asarray(ref.uflx), rtol=1e-12)


@pytest.mark.slow
def test_run_epoch_namedtuple_batches():
    """Regression: run_epoch must not splat NamedTuple batches
    (Atmosphere is a tuple subclass) into positional args."""
    mesh = par.make_mesh(jax.devices()[:8], spec=1)
    cfg = LWConfig(icld=0, dtype="float64")
    model = make_model(cfg)
    step = par.make_sharded_step(model, mesh)
    batches = [make_atmosphere(ncol=8, nlay=15, seed=s) for s in range(3)]
    outs = []
    last = par.run_epoch(step, batches, mesh,
                         callback=lambda o: outs.append(o))
    assert len(outs) == 3 and last is outs[-1]
    ref = model(batches[-1])
    np.testing.assert_allclose(np.asarray(last.uflx),
                               np.asarray(ref.uflx), rtol=1e-12)
