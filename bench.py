"""Throughput benchmark: columns/s for the batched LW radiation step on
one GPU.

Rows (f32, closed-form exp, B=16384 unless BENCH_NCOLS says otherwise):
clear and McICA cloudy at nlay=60, McICA cloudy with independent
consecutive batches (pipelined), the McICA gradient step, and McICA
cloudy at nlay=140 (deep).  Prints one JSON line per row on stderr and
the headline on stdout:
    {"metric": ..., "value": N, "unit": "columns/s", "device": {...}}

Protocol:
- Generators return HOST numpy (streaming contract); the bench
  `jax.device_put`s each workload ONCE before the timed loop and
  asserts every timed argument is a committed `jax.Array`, so an
  input-transfer regression can never masquerade as kernel time.
- Chained timing: each iteration's input depends on the previous
  output (the runtime cannot coalesce identical dispatches).
- Each row runs REPEATS timed windows; the best window is reported
  with the relative spread.

There is no fallback: without a GPU the bench exits non-zero.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu.utils.compile_cache import enable_compile_cache


def _assert_device_resident(tree, what):
    """Every timed argument must already live on the device, committed,
    or the timed loop measures H2D transfers instead of kernels."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if leaf is None:
            continue
        if not isinstance(leaf, jax.Array):
            raise AssertionError(
                f"bench input {what}{jax.tree_util.keystr(path)} is "
                f"{type(leaf).__name__}, not a device-resident "
                f"jax.Array — the timed loop would re-upload it every "
                f"iteration")
        if not leaf.committed:
            raise AssertionError(
                f"bench input {what}{jax.tree_util.keystr(path)} is "
                f"an uncommitted jax.Array — placement is not pinned")


def _windows(run, iters, repeats):
    """(best seconds per iteration, relative spread) over `repeats`
    windows of `iters` calls of run()."""
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(iters))
        times.append((time.perf_counter() - t0) / iters)
    best = min(times)
    return best, (max(times) - best) / best


def _bench_one(step, args, iters, repeats=3):
    """Chained timing: each call's eps comes from the previous output."""
    for i, a in enumerate(args):
        _assert_device_resident(a, f"arg{i}")
    eps = jnp.zeros((), jnp.float32)
    jax.block_until_ready(step(*args, eps))        # compile + warm

    def run(n):
        out, e = None, eps
        for _ in range(n):
            out, e = step(*args, e)
        return out
    return _windows(run, iters, repeats)


def _bench_pipelined(step, args_a, args_b, iters, repeats=3):
    """Deployment steady state: consecutive steps are independent
    (different batches), so dispatch overlaps device execution.
    Alternates two distinct device-resident workloads."""
    eps = jnp.zeros((), jnp.float32)
    jax.block_until_ready([step(*args_a, eps), step(*args_b, eps)])

    def run(n):
        return [step(*(args_a if i % 2 == 0 else args_b), eps)[0]
                for i in range(n)]
    return _windows(run, iters, repeats)


def device_info():
    """Platform, device kind and count as JAX reports them, plus the
    card's name and power limit from nvidia-smi (a child process that
    stays off JAX).  Raises when the default device is not a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench needs a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 else None}


def main():
    from rrtmg_lw_tpu import LWConfig, make_model
    from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                              make_mcica_clouds)

    enable_compile_cache()
    info = device_info()
    print(json.dumps({"device": info}), file=sys.stderr)
    dev = jax.devices()[0]
    ncol = int(os.environ.get("BENCH_NCOLS", 16384))
    nlay = int(os.environ.get("BENCH_NLAY", 60))
    deep_nlay = int(os.environ.get("BENCH_DEEP_NLAY", 140))
    iters = int(os.environ.get("BENCH_ITERS", 10))
    repeats = int(os.environ.get("BENCH_REPEATS", 3))
    dtype = jnp.float32

    def put(tree):
        return jax.device_put(tree, dev)

    def inputs(L, seed=0):
        return (put(make_atmosphere(ncol=ncol, nlay=L, dtype=dtype,
                                    seed=seed)),
                put(make_mcica_clouds(ncol=ncol, nlay=L, dtype=dtype,
                                      seed=seed + 2)))

    clr_model = make_model(LWConfig(icld=0, dtype="float32",
                                    use_lut=False))
    cld_model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                    use_lut=False))

    @jax.jit
    def clr_step(a, eps):
        fl = clr_model(a._replace(tlay=a.tlay + eps), None)
        return fl, fl.uflx[0, 0] * 1e-20

    @jax.jit
    def cld_step(a, c, eps):
        fl = cld_model(a._replace(tlay=a.tlay + eps), c)
        return fl, fl.uflx[0, 0] * 1e-20

    def _grad_loss(a, c):
        fl = cld_model(a, c)
        return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()

    @jax.jit
    def grad_step(a, c, eps):
        loss, g = jax.value_and_grad(_grad_loss)(
            a._replace(tlay=a.tlay + eps), c)
        return g, loss * 1e-20

    def record(name, L, t, spread):
        row = {"workload": name, "ncol": ncol, "nlay": L,
               "ms_per_step": round(t * 1e3, 3),
               "cols_per_sec": round(ncol / t, 1),
               "spread": round(spread, 4), "iters": iters,
               "repeats": repeats}
        print(json.dumps(row), file=sys.stderr)

    atm, clouds = inputs(nlay)
    t_clr, s = _bench_one(clr_step, (atm,), iters, repeats)
    record("clear", nlay, t_clr, s)
    t_cld, s = _bench_one(cld_step, (atm, clouds), iters, repeats)
    record("mcica_cloudy", nlay, t_cld, s)
    atm_b, clouds_b = inputs(nlay, seed=1)
    record("mcica_cloudy_pipelined", nlay, *_bench_pipelined(
        cld_step, (atm, clouds), (atm_b, clouds_b), iters, repeats))
    del atm_b, clouds_b
    record("mcica_cloudy_grad", nlay, *_bench_one(
        grad_step, (atm, clouds), max(3, iters // 3), repeats))
    del atm, clouds
    atm_d, clouds_d = inputs(deep_nlay)
    record("mcica_cloudy_deep", deep_nlay, *_bench_one(
        cld_step, (atm_d, clouds_d), max(3, iters // 2), repeats))

    print(json.dumps({
        "metric": f"columns_per_sec_clr+mcica_nlay{nlay}",
        "value": round(2.0 * ncol / (t_clr + t_cld), 1),
        "unit": "columns/s",
        "device": info,
    }))


if __name__ == "__main__":
    main()
