#!/usr/bin/env python3
"""On-card smoke test of the GCM radiation step.

Drives the main path through the entry points a user calls
(``make_model``, ``parallel.make_sharded_step``,
``parallel.make_sharded_grad_step``) at the GCM call's full width:
16 bands / 140 g-points, f32, B=16384 columns at nlay=60 and 140, clear
sky and McICA cloudy (icld=2, imca=1), plus the gradient step.

Phases of a default run (one GPU):
  device    the platform must be "gpu"; prints the device kind and
            count and the card's name and power limit (nvidia-smi)
  forward   the four forward cases through make_model and
            make_sharded_step; the first 512 columns against the f64
            XLA path on the card, and at nlay=60 four f64 columns
            against the scalar oracle in tests/oracle
  grad      make_sharded_grad_step at B=16384/nlay=60, then on 256
            columns against the all-XLA gradient
  rt_kernel the fused Pallas (Triton) RT sweep against the XLA sweep at
            production shapes: parity of the stage on identical inputs,
            then the stage's time

``--four`` runs only the four-GPU phase: the sharded forward, gradient
and wire-decode steps at B=4x16384/nlay=60 on (columns=4, spec=1) and
(columns=2, spec=2) meshes, each against the one-card result on the
same columns.

Every phase raises on a failed check; the script then exits non-zero
and prints no result line.  The last line of a passing run is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.

Run:  python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

B_FULL = 16384
NLAYS = (60, 140)
N_REF = 512          # columns compared with the f64 XLA path
N_ORACLE = 4         # f64 columns compared with the scalar oracle
N_GRAD = 256         # columns of the gradient comparison
# f32 vs f64 gates: ~100x inside the reference's 0.5 W/m2 / 0.1 K/day
# contract, and ~10x below what TF32 flux sums would cost (0.1-0.4 W/m2).
# Heating rates meet two gates.  Raw, they stay inside the reference's
# 0.1 K/day contract.  Beyond f32 flux storage, they stay within 1e-2
# K/day: a layer's hr is heatfac * (fnet[l] - fnet[l+1]) / dp, and
# rounding four f32 fluxes alone moves it by up to heatfac * 2 ulp(F) /
# dp, which at the model top (dp ~ 0.006 hPa at nlay=60, 0.0025 at 140)
# is 0.03-0.1 K/day on the f64 fluxes themselves.
FLUX_GATE = 1e-3     # W/m2
HR_CONTRACT = 0.1    # K/day, raw
HR_GATE = 1e-2       # K/day beyond the f32 flux-storage bound
ORACLE_RTOL = 1e-9
# kernel vs XLA sweep, f32, relative to the field's largest magnitude:
# the roundoff of a 140-level f32 recursion
KERNEL_RTOL = 2e-5
# gradients, per leaf: max |a - b| over max |b|.  The loss (mean hr^2 +
# mean OLR^2) feeds the backward 2*hr/N, and two f32 forwards that
# round their fluxes differently (the kernel vs the XLA sweep) differ in
# the top-layer hr by up to the f32 storage bound; the cotangent
# inherits that.  A wrong gradient is off by O(1).  Under a spectral
# partition the g-sums also run in another order; there the gate is
# ||a - b|| / ||b||, and the max-relative error is printed beside it.
GRAD_RTOL = 1e-2
WINDOWS = 7          # timing windows (median reported)
STEPS = 5            # chained steps per window

FLUX_FIELDS = ("uflx", "dflx", "uflxc", "dflxc")
HR_FIELDS = ("hr", "hrc")


class CheckFailed(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def check(ok, msg):
    if not ok:
        raise CheckFailed(msg)


def gate(name, err, limit):
    log(f"  {name:<34s} {err:.3e}  (gate {limit:.0e})")
    check(err <= limit, f"{name}: {err:.3e} > {limit:.0e}")


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def max_rel(a, b):
    """max |a - b| over max |b|."""
    b = np.asarray(b, np.float64)
    return max_abs(a, b) / max(float(np.max(np.abs(b))), 1e-300)


def rel_l2(a, b):
    """||a - b|| over ||b||."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b)
                 / max(float(np.linalg.norm(b)), 1e-300))


def gate_hr(name, hr, ref_fl, plev, heatfac, f, sides=1):
    """Heating rate ``f`` against ``ref_fl``: max |hr - ref hr| within
    the reference's contract, and within HR_GATE once what rounding the
    fluxes to f32 may move hr by (heatfac * 2 ulp(F) / dp per f32 side;
    sides=2 when both results are f32) is taken off."""
    u, d = ("uflx", "dflx") if f == "hr" else ("uflxc", "dflxc")
    err = np.abs(np.asarray(hr, np.float64)
                 - np.asarray(getattr(ref_fl, f), np.float64))
    mag = np.maximum(np.abs(np.asarray(getattr(ref_fl, u))),
                     np.abs(np.asarray(getattr(ref_fl, d))))
    mag = np.maximum(mag[:, :-1], mag[:, 1:])
    dp = np.diff(-np.asarray(plev, np.float64), axis=1)
    bound = (sides * heatfac * 2.0 / dp
             * np.spacing(mag.astype(np.float32)).astype(np.float64))
    gate(f"{name} K/day", float(err.max()), HR_CONTRACT)
    gate(f"{name} beyond f32 storage",
         max(0.0, float(np.max(err - bound))), HR_GATE)


def gate_grads(name, got, want, scale=1.0, max_gate=True):
    """Every gradient leaf of ``got`` (times ``scale``) against the same
    leaf of ``want``, by GRAD_RTOL: max-relative, or with ``max_gate``
    False rel L2 (the other printed beside it).  A leaf that is zero in
    ``want`` must be zero in ``got``."""
    import jax
    for (path, g), w in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree_util.tree_leaves(want)):
        leaf = f"{name}{jax.tree_util.keystr(path)}"
        g = np.asarray(g, np.float64) * scale
        if float(np.max(np.abs(np.asarray(w)))) == 0.0:
            check(max_abs(g, w) == 0.0, f"{leaf} should be 0")
            continue
        mr, l2 = max_rel(g, w), rel_l2(g, w)
        if max_gate:
            log(f"  {leaf + ' rel L2':<34s} {l2:.3e}")
            gate(f"{leaf} max rel", mr, GRAD_RTOL)
        else:
            log(f"  {leaf + ' max rel':<34s} {mr:.3e}")
            gate(f"{leaf} rel L2", l2, GRAD_RTOL)


# ----------------------------------------------------------------------
# inputs
def make_inputs(B, L, seed=0):
    """Host inputs: f32 atmosphere + McICA clouds in the generator's
    compact form (binary mask at g resolution, int8)."""
    from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                              make_mcica_clouds)
    atm = make_atmosphere(ncol=B, nlay=L, dtype=np.float32, seed=seed)
    clouds = make_mcica_clouds(ncol=B, nlay=L, dtype=np.float32,
                               layout="compact", mask_dtype=np.int8,
                               seed=seed + 2)
    return atm, clouds


def cols(tree, lo, hi):
    """Columns [lo, hi) of an input tree (compact cloud masks carry
    columns on their last axis)."""
    import jax
    from rrtmg_lw_tpu import McicaCloudsCompact
    if tree is None:
        return None
    if isinstance(tree, McicaCloudsCompact):
        return tree._replace(
            cldfmc=tree.cldfmc[..., lo:hi],
            **{k: getattr(tree, k)[lo:hi]
               for k in ("ciwp", "clwp", "reicmc", "relqmc")})
    return jax.tree_util.tree_map(lambda x: x[lo:hi], tree)


def as_f64(tree):
    import jax
    return jax.tree_util.tree_map(
        lambda x: x.astype(np.float64) if x.dtype == np.float32 else x,
        tree)


def _report(name, compiled, dt):
    ma = compiled.memory_analysis()
    gib = 2.0 ** 30
    if ma is None:
        log(f"  [{name}] compiled in {dt:.1f} s; memory analysis: n/a")
        return
    log(f"  [{name}] compiled in {dt:.1f} s; memory GiB: "
        f"args {ma.argument_size_in_bytes / gib:.3f}, "
        f"out {ma.output_size_in_bytes / gib:.3f}, "
        f"temp {ma.temp_size_in_bytes / gib:.3f}, "
        f"alias {ma.alias_size_in_bytes / gib:.3f}, "
        f"code {ma.generated_code_size_in_bytes / gib:.4f}")


def compile_all(items, workers=4):
    """AOT-compile [(name, jitted fn, args)]: lowered here in turn,
    compiled concurrently (XLA's compiler releases the GIL).  Prints
    each program's compile time and memory analysis; returns the
    executables in order."""
    from concurrent.futures import ThreadPoolExecutor

    lowered = [fn.lower(*args) for _, fn, args in items]

    def build(lo):
        t0 = time.perf_counter()
        return lo.compile(), time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max(1, min(workers, len(items)))) as ex:
        built = list(ex.map(build, lowered))
    for (name, _, _), (exe, dt) in zip(items, built):
        _report(name, exe, dt)
    log(f"  {len(items)} programs compiled in "
        f"{time.perf_counter() - t0:.1f} s wall")
    return [exe for exe, _ in built]


def configs(interpret=False):
    """The two forward configurations.  ``interpret`` (CPU rehearsal)
    runs the Pallas RT sweep in the interpreter, as the GPU runs it
    compiled."""
    from rrtmg_lw_tpu import LWConfig
    base = LWConfig(imca=1, dtype="float32", use_lut=False)
    if interpret:
        base = base.replace(rt_impl="pallas", pallas_interpret=True)
    return {"clear": base.replace(icld=0), "mcica": base.replace(icld=2)}


def check_fluxes(fl, B, L, cloudy):
    import jax.numpy as jnp
    for f in FLUX_FIELDS:
        x = getattr(fl, f)
        check(x.shape == (B, L + 1) and x.dtype == jnp.float32,
              f"{f}: {x.shape} {x.dtype}")
        check(bool(jnp.isfinite(x).all()), f"{f} not finite")
    for f in HR_FIELDS:
        x = getattr(fl, f)
        check(x.shape == (B, L), f"{f}: {x.shape}")
        check(bool(jnp.isfinite(x).all()), f"{f} not finite")
    if cloudy:
        check(bool(jnp.all(fl.cld_bounds_ok)), "cld_bounds_ok false")


# ----------------------------------------------------------------------
# phases
def phase_device(n_expected=None):
    import jax
    devs = jax.devices()
    d = devs[0]
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}
    log(f"device: platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    check(d.platform == "gpu", f"platform is {d.platform!r}, not gpu")
    if n_expected is not None:
        check(len(devs) >= n_expected,
              f"{len(devs)} devices, need {n_expected}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log("nvidia-smi name, power.limit:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    return info


def oracle_fluxes(atm64, clouds64, cfg, n):
    """Per-column scalar oracle (tests/oracle) on the first n columns."""
    import pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "tests"))
    from oracle import rt as ort
    from oracle import spec as osp

    from rrtmg_lw_tpu.constants import heatfac
    from rrtmg_lw_tpu.data import ktables as kt
    from rrtmg_lw_tpu.ops.cldprop import cldprmc
    from rrtmg_lw_tpu.ops.inatm import inatm
    from rrtmg_lw_tpu.ops.tables import build_lookup_tables

    static = kt.load_static()
    ktab, _ = kt.load_ktables()
    t = build_lookup_tables()
    luts = dict(tau_tbl=t.tau_tbl, exp_tbl=t.exp_tbl, tfn_tbl=t.tfn_tbl,
                delwave=static["delwave"])
    prof = inatm(atm64)
    L = prof.pavel.shape[1]
    ngb0 = np.asarray(static["ngb"]) - 1
    if clouds64 is not None:
        mc = clouds64.to_batch()
        taucmc, _ = cldprmc(mc, static, inflag=cfg.inflag,
                            iceflag=cfg.iceflag, liqflag=cfg.liqflag)
        cldfmc = np.asarray(mc.cldfmc)
        taucmc = np.asarray(taucmc)
    P = {k: np.asarray(getattr(prof, k)) for k in (
        "pavel", "tavel", "tz", "tbound", "semiss", "coldry", "wkl",
        "wbrodl", "wx", "pz", "pwvcm")}
    out = {f: [] for f in FLUX_FIELDS}
    for c in range(n):
        o = osp.setcoef_1col(
            L, P["pavel"][c], P["tavel"][c], P["tz"][c],
            float(P["tbound"][c]), P["semiss"][c], P["coldry"][c],
            P["wkl"][c].T, P["wbrodl"][c], static)
        tg, fr = osp.taumol_1col(L, o, P["pavel"][c], P["wx"][c].T,
                                 P["coldry"][c], ktab, static)
        if clouds64 is None:
            cf = tc = np.zeros((140, L))
        else:
            cf, tc = cldfmc[c].T, taucmc[c].T
        r = ort.rtrnmc_1col(
            L, P["pz"][c], P["semiss"][c], ngb0, cf, tc, o["planklay"],
            o["planklev"], o["plankbnd"], float(P["pwvcm"][c]), fr, tg,
            luts, heatfac(), dplankbnd_dt=o["dplankbnd_dt"])
        for f, k in zip(FLUX_FIELDS, ("totuflux", "totdflux", "totuclfl",
                                      "totdclfl")):
            out[f].append(r[k])
    return {f: np.stack(v) for f, v in out.items()}


def _check_vs_f64(fl, ref, a64, heatfac, n_ref):
    for f in FLUX_FIELDS:
        gate(f"f32 vs f64 {f} W/m2",
             max_abs(getattr(fl, f)[:n_ref], getattr(ref, f)), FLUX_GATE)
    for f in HR_FIELDS:
        gate_hr(f"f32 vs f64 {f}", getattr(fl, f)[:n_ref], ref, a64.plev,
                heatfac, f)


def phase_forward(B=B_FULL, nlays=NLAYS, n_ref=N_REF, n_oracle=N_ORACLE,
                  oracle_nlay=60, interpret=False):
    import jax

    from rrtmg_lw_tpu import make_model
    from rrtmg_lw_tpu import parallel as par

    mesh1 = par.make_mesh(jax.devices()[:1])
    dev = jax.devices()[0]
    for L in nlays:
        log(f"forward B={B} nlay={L}")
        atm_h, cl_h = make_inputs(B, L)
        atm = jax.device_put(atm_h, dev)
        cld = jax.device_put(cl_h, dev)
        atm_s = par.shard_batch(atm_h, mesh1)
        cld_s = par.shard_batch(cl_h, mesh1)
        a64 = as_f64(cols(atm_h, 0, n_ref))
        c64 = as_f64(cols(cl_h, 0, n_ref))
        oracle = bool(n_oracle) and L == oracle_nlay
        a_o, c_o = cols(a64, 0, n_oracle), cols(c64, 0, n_oracle)
        items, cases = [], []
        for sky, cfg in configs(interpret).items():
            cloudy = sky == "mcica"
            model = make_model(cfg)
            m64 = make_model(cfg.replace(dtype="float64", rt_impl="xla"))
            c, c_s = (cld, cld_s) if cloudy else (None, None)
            items += [
                (f"{sky} make_model", jax.jit(
                    lambda a, c, m=model: m(a, c)), (atm, c)),
                (f"{sky} make_sharded_step",
                 par.make_sharded_step(model, mesh1), (atm_s, c_s)),
                (f"{sky} f64 reference", jax.jit(
                    lambda a, c, m=m64: m(a, c)),
                 (a64, c64 if cloudy else None))]
            if oracle:
                mlut = make_model(cfg.replace(dtype="float64",
                                              use_lut=True, rt_impl="xla"))
                items.append((f"{sky} f64 LUT (oracle)", jax.jit(
                    lambda a, c, m=mlut: m(a, c)),
                    (a_o, c_o if cloudy else None)))
            cases.append((sky, cfg, cloudy, model, m64, c, c_s))
        exes = iter(compile_all(items))
        for sky, cfg, cloudy, model, m64, c, c_s in cases:
            log(f"forward {sky} B={B} nlay={L}: RT sweep "
                f"{'pallas' if model.rt_pallas else 'xla'}")
            run, sharded, ref64 = next(exes), next(exes), next(exes)
            fl = run(atm, c)
            check_fluxes(fl, B, L, cloudy)
            fl_s = sharded(atm_s, c_s)
            check_fluxes(fl_s, B, L, cloudy)
            for f in FLUX_FIELDS:
                gate(f"sharded vs make_model {f} W/m2",
                     max_abs(getattr(fl_s, f), getattr(fl, f)), FLUX_GATE)
            del fl_s
            ref = ref64(a64, c64 if cloudy else None)
            _check_vs_f64(fl, ref, a64, m64.heatfac, n_ref)
            if oracle:
                got = next(exes)(a_o, c_o if cloudy else None)
                t0 = time.perf_counter()
                want = oracle_fluxes(a_o, c_o if cloudy else None, cfg,
                                     n_oracle)
                log(f"  oracle: {n_oracle} columns in "
                    f"{time.perf_counter() - t0:.1f} s")
                for f in FLUX_FIELDS:
                    gate(f"f64 vs oracle {f} rel",
                         max_rel(getattr(got, f), want[f]), ORACLE_RTOL)


def grad_loss(fl):
    """make_sharded_grad_step's default objective."""
    return (fl.hr ** 2).mean() + (fl.uflx[:, -1] ** 2).mean()


def phase_grad(B=B_FULL, L=60, n_grad=N_GRAD, interpret=False):
    import jax

    from rrtmg_lw_tpu import make_model
    from rrtmg_lw_tpu import parallel as par

    mesh1 = par.make_mesh(jax.devices()[:1])
    cfg = configs(interpret)["mcica"]
    model = make_model(cfg)
    mx = make_model(cfg.replace(rt_impl="xla"))
    atm_h, cl_h = make_inputs(B, L, seed=10)
    log(f"grad mcica B={B} nlay={L}")
    gstep = par.make_sharded_grad_step(model, mesh1)
    atm_s = par.shard_batch(atm_h, mesh1)
    cld_s = par.shard_batch(cl_h, mesh1)
    atm_n = par.shard_batch(cols(atm_h, 0, n_grad), mesh1)
    cld_n = par.shard_batch(cols(cl_h, 0, n_grad), mesh1)
    big, small, xla = compile_all([
        ("make_sharded_grad_step", gstep, (atm_s, cld_s)),
        (f"make_sharded_grad_step B={n_grad}", gstep, (atm_n, cld_n)),
        (f"all-XLA grad B={n_grad}", jax.jit(jax.value_and_grad(
            lambda a, c: grad_loss(mx(a, c)))), (atm_n, cld_n))])
    loss, g = big(atm_s, cld_s)
    log(f"  loss {float(loss):.6e}")
    check(bool(np.isfinite(float(loss))), "loss not finite")
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        check(bool(np.isfinite(np.asarray(leaf)).all()),
              f"grad{jax.tree_util.keystr(path)} not finite")
    del g, atm_s, cld_s

    loss_a, g_a = small(atm_n, cld_n)
    loss_x, g_x = xla(atm_n, cld_n)
    gate("grad loss rel", rel_l2(loss_a, loss_x), GRAD_RTOL)
    gate_grads("grad", g_a, g_x)


def _window_ms(go, n_steps):
    """One window of n chained calls, ms per call."""
    t0 = time.perf_counter()
    go(n_steps)
    return (time.perf_counter() - t0) / n_steps * 1e3


def _alternate(fk, fx, windows, n_steps):
    """Median ms per call of two implementations timed in alternating
    windows (drift hits both alike), plus every window."""
    fk(2)
    fx(2)
    tk, tx = [], []
    for _ in range(windows):
        tk.append(_window_ms(fk, n_steps))
        tx.append(_window_ms(fx, n_steps))
    return statistics.median(tk), statistics.median(tx), tk, tx


def phase_rt_kernel(B=B_FULL, nlays=NLAYS, interpret=False,
                    windows=WINDOWS, n_steps=STEPS):
    """The Pallas RT sweep against the XLA sweep on identical stage
    inputs: parity, then the stage's time in chained calls."""
    import jax
    import jax.numpy as jnp

    from rrtmg_lw_tpu import make_model
    from rrtmg_lw_tpu.ops import rtrn as rt
    from rrtmg_lw_tpu.ops import rtrn_pallas as rtp
    from rrtmg_lw_tpu.ops.cldprop import cldprmc
    from rrtmg_lw_tpu.ops.inatm import inatm

    mx = make_model(configs(interpret)["mcica"].replace(rt_impl="xla"))
    common = dict(static=mx.static_np, idrv=0, heatfac_val=mx.heatfac)
    zero = jnp.zeros((), jnp.float32)

    def nudged(args, eps):
        """pwvcm + eps: a scalar carries the chained calls' dependency
        into the stage, so a window times the sweep alone."""
        return args[:7] + (args[7] + eps,) + args[8:]

    @jax.jit
    def stage_inputs(a, cl):
        prof = inatm(a, dtype=jnp.float32)
        sc, taut, fracs = mx.optical_depth(prof)
        mc = cl.to_batch()
        od, _ = cldprmc(mc, mx.static_np, inflag=2, iceflag=3, liqflag=1)
        return (taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
                sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz,
                mc.cldfmc, od)

    def stage_k(cloudy):
        def f(args, eps):
            args = nudged(args, eps)
            if not cloudy:
                args = args[:9] + (None, None)
            return rtp.rt_random_overlap_pallas(
                *args, cloudy=cloudy, gate_thresh=0.5,
                interpret=interpret, **common)
        return jax.jit(f)

    def stage_x(cloudy):
        def f(args, eps):
            t, f_, pl_, pv, bnd, dbnd, sem, pwv, pz, cf, od = nudged(
                args, eps)
            if not cloudy:
                cf = od = jnp.zeros(t.shape, t.dtype)
            g = cf >= 0.5
            return rt.rt_random_overlap(
                t, f_, pl_, pv, bnd, dbnd, sem, pwv, pz, cf, od,
                cloudy_lay=jnp.any(g, axis=-1), cld_gate=g, luts=None,
                use_lut=False, **common)
        return jax.jit(f)

    def chain(fn, ins):
        def go(n):
            eps = zero
            for _ in range(n):
                out = fn(ins, eps)
                # the next call's input depends on this output
                eps = out[0][0, 0] * 1e-30
            jax.block_until_ready(out)
        return go

    rows = []
    for L in nlays:
        log(f"rt_kernel B={B} nlay={L}")
        atm_h, cl_h = make_inputs(B, L)
        ins = stage_inputs(jax.device_put(atm_h), jax.device_put(cl_h))
        items = []
        for sky in ("clear", "mcica"):
            cloudy = sky == "mcica"
            items += [(f"{sky} rt stage pallas", stage_k(cloudy),
                       (ins, zero)),
                      (f"{sky} rt stage xla", stage_x(cloudy), (ins, zero))]
        exes = iter(compile_all(items))
        for sky in ("clear", "mcica"):
            fk, fx = next(exes), next(exes)
            out_k, out_x = fk(ins, zero), fx(ins, zero)
            for i, name in ((0, "uflx"), (1, "dflx"), (3, "uflxc"),
                            (4, "dflxc")):
                gate(f"{sky} kernel vs xla {name} rel",
                     max_rel(out_k[i], out_x[i]), KERNEL_RTOL)
            del out_k, out_x
            mk, mxl, tk, tx = _alternate(chain(fk, ins), chain(fx, ins),
                                         windows, n_steps)
            row = {"nlay": L, "sky": sky, "B": B,
                   "stage_pallas_ms": mk, "stage_xla_ms": mxl,
                   "stage_pallas_all": tk, "stage_xla_all": tx}
            log("  timing " + json.dumps(
                {k: v for k, v in row.items() if not k.endswith("_all")}))
            rows.append(row)
        del ins
    return rows


def phase_four(B1=B_FULL, L=60, n_dev=4, interpret=False):
    """Sharded forward / grad / wire steps on n_dev cards against the
    one-card result on the same columns."""
    import jax

    from rrtmg_lw_tpu import make_model
    from rrtmg_lw_tpu import parallel as par
    from rrtmg_lw_tpu.parallel import wire as w

    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"need {n_dev} devices")
    B = n_dev * B1
    model = make_model(configs(interpret)["mcica"])
    atm_h, cl_h = make_inputs(B, L, seed=20)
    wire_h = (w.encode_atmosphere(atm_h), w.encode_compact_clouds(cl_h),
              np.asarray(atm_h.tauaer))
    w.validate_wire(wire_h[0])
    w.validate_wire(wire_h[1])

    def chunk(k):
        """Columns of chunk k: the direct inputs, and the same columns
        of the one wire batch (codes sliced, batch references kept)."""
        lo, hi = k * B1, (k + 1) * B1
        wa, wc, taua = wire_h
        return (cols(atm_h, lo, hi), cols(cl_h, lo, hi)), (
            w.WireBatch({n: v[lo:hi] for n, v in wa.cols.items()},
                        wa.refs),
            w.CompactCloudsWire(wc.mask_bits[..., lo:hi], w.WireBatch(
                {n: v[lo:hi] for n, v in wc.fields.cols.items()},
                wc.fields.refs)),
            taua[lo:hi])

    meshes = {"one card": par.make_mesh(devs[:1])}
    for spec in (1, 2):
        meshes[f"columns={n_dev // spec} spec={spec}"] = par.make_mesh(
            devs, spec=spec)
    put = {}
    items = []
    for tag, mesh in meshes.items():
        direct, wire = chunk(0) if tag == "one card" else (
            (atm_h, cl_h), wire_h)
        put[tag] = (par.shard_batch(direct, mesh),
                    par.shard_batch(wire, mesh))
        d, wr = put[tag]
        items += [(f"{tag} make_sharded_step",
                   par.make_sharded_step(model, mesh), d),
                  (f"{tag} make_sharded_grad_step",
                   par.make_sharded_grad_step(model, mesh), d),
                  (f"{tag} make_wire_step", par.make_wire_step(model, mesh),
                   wr)]
    log(f"four: B={B} nlay={L}")
    exes = compile_all(items, workers=len(items))

    f1, g1, w1 = exes[:3]
    mesh1 = meshes["one card"]
    ref_f, ref_g, ref_l, ref_w = [], [], [], []
    for k in range(n_dev):
        direct, wire = chunk(k)
        d = par.shard_batch(direct, mesh1)
        ref_f.append(jax.device_get(f1(*d)))
        loss, g = g1(*d)
        ref_l.append(float(loss))
        ref_g.append(jax.device_get(g))
        ref_w.append(jax.device_get(w1(*par.shard_batch(wire, mesh1))))

    def cat(trees):
        return jax.tree_util.tree_map(
            lambda *x: np.concatenate(x, axis=0), *trees)

    ref_f, ref_g, ref_w = cat(ref_f), cat(ref_g), cat(ref_w)
    for i, tag in enumerate(list(meshes)[1:]):
        fs, gs, ws = exes[3 * (i + 1):3 * (i + 2)]
        d, wr = put[tag]
        log(f"four: mesh {tag}")
        fl = jax.device_get(fs(*d))
        check_fluxes(fl, B, L, True)
        for f in FLUX_FIELDS:
            gate(f"{f} vs one card W/m2",
                 max_abs(getattr(fl, f), getattr(ref_f, f)), FLUX_GATE)
        for f in HR_FIELDS:
            gate_hr(f"{f} vs one card", getattr(fl, f), ref_f, atm_h.plev,
                    model.heatfac, f, sides=2)
        loss, g = gs(*d)
        # the loss is a column mean: one card's chunk gradients are
        # n_dev times the full batch's on the same columns
        gate("loss vs one card rel",
             rel_l2(float(loss), np.mean(ref_l)), GRAD_RTOL)
        gate_grads("grad vs one card", jax.device_get(g), ref_g,
                   scale=n_dev, max_gate=meshes[tag].shape[par.SPEC] == 1)
        fw =jax.device_get(ws(*wr))
        check(bool(np.asarray(fw.wire_ok).all()), "wire_ok false")
        for f in FLUX_FIELDS:
            gate(f"wire {f} vs one card W/m2",
                 max_abs(getattr(fw, f), getattr(ref_w, f)), FLUX_GATE)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)   # the f64 references
    from rrtmg_lw_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    t0 = time.perf_counter()
    try:
        if args.four:
            info = phase_device(n_expected=4)
            phase_four()
        else:
            info = phase_device()
            phase_forward()
            phase_grad()
            phase_rt_kernel()
    except CheckFailed as e:
        log(f"FAILED: {e}")
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
