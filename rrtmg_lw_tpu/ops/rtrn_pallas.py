"""Fused random-overlap / McICA RT sweep: one Pallas kernel, Triton route.

The XLA sweep (``rtrn.rt_random_overlap``) materializes ~8 (B, L, G)
per-level source/absorptivity arrays in ``precompute`` and stacks the
per-level radiances of both ``lax.scan`` sweeps before the band-weighted
flux sum.  This kernel does the same arithmetic without those arrays:

  * one program owns a (``BLOCK_B`` columns x ``BLOCK_G`` g-points) tile;
  * the level index is a ``fori_loop`` inside the program: the downward
    sweep, the surface reflection and the upward sweep run back to back
    with the radiances carried in registers;
  * per-level optics (od, atrans, Planck transition, cloud absorptivity)
    are computed in the kernel from taut/fracs/Planck/cloud inputs and
    never written to memory (the upward sweep recomputes them);
  * each g-block writes its band-weighted partial flux per level, and
    XLA adds the partials.

Coverage: ``rt_random_overlap`` semantics (clear sky, McICA per-g
clouds, banded random overlap icld=1, the runtime-ncbands weighted
cloud od) with idrv 0/1, float32, closed-form exp (``use_lut=False``).
Everything else stays on the XLA sweep.  The gradient is the XLA
sweep's: ``custom_vjp`` backward = ``jax.vjp`` of ``rt_random_overlap``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..constants import FLUXFAC, REC_6, WTDIFF
from . import rtrn as rt

# block shape and launch: the fastest of a sweep on an H100 (PERF.md)
BLOCK_B = 32
BLOCK_G = 32
NUM_WARPS = 4
NUM_STAGES = 1


def _next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _factors(od, small):
    """(absorptivity, Planck transition factor) of optical depth od:
    the small-od series below 0.06, closed-form exp above
    (rtrn._gas_factors / _tot_factors with use_lut=False)."""
    ods = jnp.maximum(od, 0.06)
    e = jnp.exp(-ods)
    a = jnp.where(small, od - 0.5 * od * od, 1.0 - e)
    tf = jnp.where(small, REC_6 * od,
                   1.0 - 2.0 * (1.0 / ods - e / (1.0 - e)))
    return a, tf


def _sweep_kernel(*refs, L, G, bb, bg, cloudy, idrv, weighted, thresh):
    it = iter(refs)
    taut, fracs, play, plev, bnd, dbnd, sem, sec, ngb_r, wg_r = (
        next(it) for _ in range(10))
    if cloudy:
        cldf, odc, cly_r, icl_r = (next(it) for _ in range(4))
    up_o, dn_o, upc_o, dnc_o = (next(it) for _ in range(4))
    if idrv:
        dup_o, dupc_o = next(it), next(it)

    ib = pl.program_id(0)
    igb = pl.program_id(1)
    b = ib * bb + jax.lax.broadcasted_iota(jnp.int32, (bb,), 0)
    g = igb * bg + jax.lax.broadcasted_iota(jnp.int32, (bg,), 0)
    b2 = b[:, None]
    g2 = g[None, :]
    gmask = jnp.broadcast_to(g2 < G, (bb, bg))
    ngb = ngb_r[pl.ds(igb * bg, bg)][None, :]          # band of each g
    wg = wg_r[pl.ds(igb * bg, bg)][None, :]            # 0 on padded g
    bsl = pl.ds(ib * bb, bb)

    def per_g(ref, lev):                               # (B, L, G) tile
        return plgpu.load(ref.at[b2, lev, g2], mask=gmask, other=0.0)

    def per_band(ref, lev):                            # (B, L, 16) tile
        return ref[b2, lev, ngb]

    def put(ref, lev, x):
        ref[igb, lev, bsl] = jnp.sum(x * wg, axis=1)

    sec_g = sec[b2, ngb]

    def layer(lev, up):
        """Per-level optics of layer ``lev`` for the down (up=False) or
        up sweep: (atrans, source, atot, total source, cf, efclfrac)."""
        f = per_g(fracs, lev)
        od = jnp.maximum(sec_g * per_g(taut, lev), 0.0)
        at, tf = _factors(od, od <= 0.06)
        blay = per_band(play, lev)
        dpl = per_band(plev, lev + 1 if up else lev) - blay
        src = f * (blay + tf * dpl)
        if not cloudy:
            return at, src, None, None, None, None
        cf = per_g(cldf, lev)
        oc = per_g(odc, lev)
        gate = cf >= thresh
        oce = jnp.where(gate, oc if weighted else sec_g * oc, 0.0)
        ef = jnp.where(gate, (1.0 - jnp.exp(-oce)) * cf, 0.0)
        odt = od + oce
        atot, tft = _factors(odt, odt < 0.06)
        return at, src, atot, f * (blay + tft * dpl), cf, ef

    def flag(ref, lev):
        return (ref[lev, bsl] != 0)[:, None]

    zero = jnp.zeros((bb, bg), jnp.float32)

    # ---- downward sweep: layer L-1 .. 0, radiance at layer bottoms ----
    put(dn_o, L, zero)
    put(dnc_o, L, zero)

    def down(i, carry):
        radld, radclrd = carry
        lev = L - 1 - i
        at, bbd, atot, bbdtot, cf, ef = layer(lev, False)
        rad_clr = radld + (bbd - radld) * at
        if cloudy:
            gs = at * bbd
            rad_cld = (radld - radld * (at + ef * (1.0 - at)) + gs
                       + cf * (bbdtot * atot - gs))
            radld_n = jnp.where(flag(cly_r, lev), rad_cld, rad_clr)
            radclrd_n = jnp.where(flag(icl_r, lev),
                                  radclrd + (bbd - radclrd) * at, radld_n)
        else:
            radld_n = radclrd_n = rad_clr
        put(dn_o, lev, radld_n)
        put(dnc_o, lev, radclrd_n)
        return radld_n, radclrd_n

    radld, radclrd = jax.lax.fori_loop(0, L, down, (zero, zero))

    # ---- surface reflection ----
    f0 = per_g(fracs, 0)
    rad0 = f0 * bnd[b2, ngb]
    reflect = 1.0 - sem[b2, ngb]
    radlu = rad0 + reflect * radld
    radclru = rad0 + reflect * radclrd
    d0 = f0 * dbnd[b2, ngb] if idrv else zero
    put(up_o, 0, radlu)
    put(upc_o, 0, radclru)
    if idrv:
        put(dup_o, 0, d0)
        put(dupc_o, 0, d0)
    anyc = flag(icl_r, 0) if cloudy else None

    # ---- upward sweep: layer 0 .. L-1, radiance at layer tops ----
    def upward(lev, carry):
        radlu, radclru, dlu, dclru = carry
        at, bbu, atot, bbut, cf, ef = layer(lev, True)
        rad_clr = radlu + (bbu - radlu) * at
        if cloudy:
            cly = flag(cly_r, lev)
            gs = bbu * at
            rad_cld = (radlu - radlu * (at + ef * (1.0 - at)) + gs
                       + cf * (bbut * atot - gs))
            radlu_n = jnp.where(cly, rad_cld, rad_clr)
            radclru_n = jnp.where(anyc, radclru + (bbu - radclru) * at,
                                  radlu_n)
        else:
            radlu_n = radclru_n = rad_clr
        put(up_o, lev + 1, radlu_n)
        put(upc_o, lev + 1, radclru_n)
        if idrv:
            if cloudy:
                dlu_n = jnp.where(cly,
                                  dlu * cf * (1.0 - atot)
                                  + dlu * (1.0 - cf) * (1.0 - at),
                                  dlu * (1.0 - at))
                dclru_n = jnp.where(anyc, dclru * (1.0 - at), dlu_n)
            else:
                dlu_n = dclru_n = dlu * (1.0 - at)
            put(dup_o, lev + 1, dlu_n)
            put(dupc_o, lev + 1, dclru_n)
            return radlu_n, radclru_n, dlu_n, dclru_n
        return radlu_n, radclru_n, dlu, dclru

    jax.lax.fori_loop(0, L, upward, (radlu, radclru, d0, d0))


def _sweep_fluxes(taut, fracs, planklay, planklev, plankbnd, dplankbnd_dt,
                  semiss, pwvcm, cldf_g, odcld_g, *, ngb0, wg, cloudy,
                  thresh, idrv, weighted, interpret):
    """Band-weighted level fluxes from the kernel: a tuple of 4 (or 6
    with idrv) (B, L+1) arrays (up, down, clear up, clear down
    [, d up/dT, d clear up/dT])."""
    B, L, G = taut.shape
    bb = min(BLOCK_B, _next_pow2(B))
    bg = min(BLOCK_G, _next_pow2(G))
    n_gb = -(-G // bg)
    Bp = -(-B // bb) * bb
    f32 = jnp.float32
    sec = rt.secdiff(pwvcm, f32)
    ins = [taut, fracs, planklay, planklev, plankbnd, dplankbnd_dt,
           semiss, sec]
    if cloudy:
        gate = cldf_g >= thresh
        cly = jnp.any(gate, axis=-1)                              # (B, L)
        # cloud anywhere at or above the layer (reverse cumulative OR)
        icl = jnp.flip(jnp.cumsum(jnp.flip(cly.astype(jnp.int32), 1), 1),
                       1) > 0
        ins += [cldf_g, odcld_g]
    if Bp != B:
        ins = [jnp.pad(x, ((0, Bp - B),) + ((0, 0),) * (x.ndim - 1),
                       mode="edge") for x in ins]
    ins = [x.astype(f32) for x in ins]
    consts = [jnp.asarray(np.pad(ngb0, (0, n_gb * bg - G)), jnp.int32),
              jnp.asarray(np.pad(wg, (0, n_gb * bg - G)), f32)]
    ins = ins[:8] + consts + ins[8:]
    if cloudy:
        def lb(x):                                        # (B, L) -> (L, Bp)
            return jnp.pad(x.astype(jnp.int32).T, ((0, 0), (0, Bp - B)))
        ins += [lb(cly), lb(icl)]
    n_out = 6 if idrv else 4
    kernel = functools.partial(
        _sweep_kernel, L=L, G=G, bb=bb, bg=bg, cloudy=cloudy, idrv=idrv,
        weighted=weighted, thresh=thresh)
    parts = pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((n_gb, L + 1, Bp), f32)] * n_out,
        grid=(Bp // bb, n_gb),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="rt_sweep",
    )(*ins)
    return tuple(p.sum(axis=0)[:, :B].T for p in parts)


def rt_random_overlap_pallas(taut, fracs, planklay, planklev, plankbnd,
                             dplankbnd_dt, semiss, pwvcm, pz, cldf_g,
                             odcld_g, *, cloudy, gate_thresh, static, idrv,
                             heatfac_val, istart=1, iend=16,
                             odcld_weighted=False, interpret=False):
    """Drop-in for ``rtrn.rt_random_overlap`` (use_lut=False, f32).

    ``cloudy=False`` ignores ``cldf_g``/``odcld_g`` (pass None).  With
    clouds, the per-g gate is ``cldf_g >= gate_thresh`` (0.5 for McICA's
    binary cldfmc, 1e-6 for banded cldfrac).  Returns ``rtrn.RTOut``.
    """
    G = taut.shape[-1]
    ngb_full = np.asarray(static["ngb"]) - 1
    gsel = np.nonzero((ngb_full >= istart - 1) & (ngb_full <= iend - 1))[0]
    if len(gsel) != G:
        raise ValueError("taut g-dim must match selected bands")
    ngb0 = ngb_full[gsel]
    wg = (WTDIFF * FLUXFAC
          * np.asarray(static["delwave"])[ngb0]).astype(np.float32)

    def reference(args):
        t, f, pl_, pv, bnd, dbnd, sem, pwv, pz_, cf, oc = args
        if cloudy:
            gate = cf >= gate_thresh
        else:
            cf = oc = jnp.zeros(t.shape, t.dtype)
            gate = jnp.zeros(t.shape, bool)
        return rt.rt_random_overlap(
            t, f, pl_, pv, bnd, dbnd, sem, pwv, pz_, cf, oc,
            cloudy_lay=jnp.any(gate, axis=-1), cld_gate=gate,
            static=static, luts=None, use_lut=False, idrv=idrv,
            heatfac_val=heatfac_val, istart=istart, iend=iend,
            odcld_weighted=odcld_weighted)

    def forward(args):
        t, f, pl_, pv, bnd, dbnd, sem, pwv, pz_, cf, oc = args
        fl = _sweep_fluxes(
            t, f, pl_, pv, bnd, dbnd, sem, pwv, cf, oc, ngb0=ngb0, wg=wg,
            cloudy=cloudy, thresh=gate_thresh, idrv=idrv,
            weighted=odcld_weighted, interpret=interpret)
        up, dn, upc, dnc = fl[:4]
        dp = pz_[:, :-1] - pz_[:, 1:]
        fnet = up - dn
        fnetc = upc - dnc
        htr = heatfac_val * (fnet[:, :-1] - fnet[:, 1:]) / dp
        htrc = heatfac_val * (fnetc[:, :-1] - fnetc[:, 1:]) / dp
        return rt.RTOut(up, dn, htr, upc, dnc, htrc, *fl[4:])

    @jax.custom_vjp
    def sweep(args):
        return forward(args)

    def sweep_fwd(args):
        return forward(args), args

    def sweep_bwd(args, ct):
        return jax.vjp(reference, args)[1](ct)

    sweep.defvjp(sweep_fwd, sweep_bwd)
    return sweep((taut, fracs, planklay, planklev, plankbnd, dplankbnd_dt,
                  semiss, pwvcm, pz, cldf_g, odcld_g))
