"""McICA stochastic sub-column cloud generation.

Batched re-design of ``mcica_subcol_gen_lw`` (both the GCM variant
``src/mcica_subcol_gen_lw.f90`` and the single-column variant
``src/mcica_subcol_gen_lw.1col.f90``) plus the supporting RNGs
(``src/mcica_random_numbers.f90``).

Three RNG backends, as in the reference's irng flag plus a native one:

  irng=2 (native, default) — jax.random (threefry): fully vectorized
      on device, batched over columns; statistically equivalent but not
      bit-identical to the reference streams.
  irng=1 (Mersenne Twister)  — bit-exact numpy reimplementation of the
      reference MT19937 (mcica_random_numbers.f90:77-306) with the
      reference's draw ORDER (isubcol outer, level inner,
      mcica_subcol_gen_lw.1col.f90:481-607); used by the column-mode
      CLI to reproduce the stochastic golden outputs exactly
      (permuteseed = sample index, rrtmg_lw.1col.f90:483).
  irng=0 (kissvec)           — bit-exact numpy KISS generator seeded
      from the fractional parts of the bottom-four layer pressures
      (mcica_subcol_gen_lw.1col.f90:529-540).

Overlap options (icld): 1 random, 2 maximum-random, 3 maximum,
4 exponential, 5 exponential-random (generate_stochastic_clouds,
1col:470-607).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..types import McicaClouds, McicaCloudsCompact

NGPT = 140
CLDMIN = 1.0e-20


# ---------------------------------------------------------------------------
# get_alpha (mcica_subcol_gen_lw.f90:68-180)
# ---------------------------------------------------------------------------

def get_alpha(dz, icld, idcor=0, decorr_con=2.5e3, lat=None, juldat=0,
              cldfrac=None):
    """Vertical correlation parameter alpha (B, L) for icld 4/5.

    dz: (B, L) layer thickness in m; lat: (B,) degrees (idcor=1);
    cldfrac required for icld=5 (block decorrelation).
    """
    dz = jnp.asarray(dz)
    dtype = dz.dtype
    B, L = dz.shape
    if icld not in (4, 5):
        return jnp.zeros((B, L), dtype)

    if idcor == 1:
        am1, am2, am4, amr = 1.4315, 2.1219, -25.584, 7.0
        if juldat > 181:
            am3 = -4.0 * amr / 365.0 * (juldat - 272)
        else:
            am3 = 4.0 * amr / 365.0 * (juldat - 91)
        decorr_lat = am1 + am2 * jnp.exp(-(jnp.asarray(lat, dtype) - am3) ** 2
                                         / am4 ** 2)
        decorr_len = decorr_lat * 1.0e3
    else:
        decorr_len = jnp.full((B,), decorr_con, dtype)

    decorr_inv = jnp.where(
        decorr_len > 0.0, 1.0 / jnp.where(decorr_len > 0.0, decorr_len, 1.0),
        jnp.where(decorr_len == 0.0, jnp.inf, 1.0))

    half_dz = 0.5 * (dz[:, 1:] + dz[:, :-1])           # (B, L-1)
    alpha_up = jnp.exp(-half_dz * decorr_inv[:, None])
    alpha = jnp.concatenate([jnp.zeros((B, 1), dtype), alpha_up], axis=1)
    if icld == 5:
        cf = jnp.asarray(cldfrac, dtype)
        decor = (cf[:, 1:] == 0.0) & (cf[:, :-1] > 0.0)
        alpha = alpha.at[:, 1:].set(jnp.where(decor, 0.0, alpha[:, 1:]))
    return alpha


# ---------------------------------------------------------------------------
# Native (jax.random) generator — the production GCM path
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("icld",))
def _native_cdf(key, icld: int, cldf, alpha):
    """CDF array (B, L, G) after overlap correlation."""
    B, L = cldf.shape
    dtype = cldf.dtype
    if icld == 1:
        return jax.random.uniform(key, (B, L, NGPT), dtype)
    if icld == 3:
        one = jax.random.uniform(key, (B, 1, NGPT), dtype)
        return jnp.broadcast_to(one, (B, L, NGPT))
    if icld == 2:
        cdf = jax.random.uniform(key, (B, L, NGPT), dtype)

        # walk up the column: cloudy-below keeps the number, clear-below
        # rescales into the clear part (1col:513-521)
        def step(prev, xs):
            cdf_l, cldf_below = xs
            keep = prev > (1.0 - cldf_below)[:, None]
            new = jnp.where(keep, prev, cdf_l * (1.0 - cldf_below)[:, None])
            return new, new
        cdf0 = cdf[:, 0, :]
        _, rest = jax.lax.scan(
            step, cdf0, (jnp.moveaxis(cdf[:, 1:, :], 1, 0),
                         jnp.moveaxis(cldf[:, :-1], 1, 0)))
        return jnp.concatenate([cdf0[:, None], jnp.moveaxis(rest, 0, 1)],
                               axis=1)
    if icld in (4, 5):
        k1, k2 = jax.random.split(key)
        cdf = jax.random.uniform(k1, (B, L, NGPT), dtype)
        cdf2 = jax.random.uniform(k2, (B, L, NGPT), dtype)

        def step(prev, xs):
            cdf_l, cdf2_l, alpha_l = xs
            new = jnp.where(cdf2_l < alpha_l[:, None], prev, cdf_l)
            return new, new
        cdf0 = cdf[:, 0, :]
        _, rest = jax.lax.scan(
            step, cdf0, (jnp.moveaxis(cdf[:, 1:, :], 1, 0),
                         jnp.moveaxis(cdf2[:, 1:, :], 1, 0),
                         jnp.moveaxis(alpha[:, 1:], 1, 0)))
        return jnp.concatenate([cdf0[:, None], jnp.moveaxis(rest, 0, 1)],
                               axis=1)
    raise ValueError(f"invalid icld={icld}")


def mcica_subcol_lw(key, icld: int, cldfrac, ciwp, clwp, rei, rel, tauc,
                    alpha=None, ngb=None) -> McicaClouds:
    """Native device generator: (B, L) cloud state -> per-g-point
    stochastic sub-columns (B, L, 140).

    tauc: per-band in-cloud optical depth (B, L, 16); ngb: (140,)
    1-based band index of each g-point (static ngb table).
    """
    cldfrac = jnp.asarray(cldfrac)
    dtype = cldfrac.dtype
    B, L = cldfrac.shape
    cldf = jnp.where(cldfrac < CLDMIN, 0.0, cldfrac)
    if alpha is None:
        alpha = jnp.zeros((B, L), dtype)
    cdf = _native_cdf(key, icld, cldf, alpha)

    iscloudy = cdf >= (1.0 - cldf)[..., None]
    ngb0 = np.asarray(ngb) - 1
    tauc_g = jnp.asarray(tauc)[..., ngb0]              # (B, L, G)
    zero = jnp.zeros((), dtype)
    return McicaClouds(
        cldfmc=jnp.where(iscloudy, 1.0, zero),
        ciwpmc=jnp.where(iscloudy, jnp.asarray(ciwp)[..., None], zero),
        clwpmc=jnp.where(iscloudy, jnp.asarray(clwp)[..., None], zero),
        taucmc=jnp.where(iscloudy, tauc_g, zero),
        reicmc=jnp.asarray(rei), relqmc=jnp.asarray(rel))


@partial(jax.jit, static_argnames=("icld",))
def _native_cdf_gmajor(key, icld: int, cldf_t, alpha_t):
    """CDF (L, G, B) after overlap correlation — the compact form's
    g-major layout (like the reference's cldfmcl(ngptlw, ncol, nlay));
    the overlap scan runs over the leading layer axis, so no relayout
    passes appear anywhere.  Same overlap math as _native_cdf
    (generate_stochastic_clouds, mcica_subcol_gen_lw.f90:484-645) with
    independent draws in this layout."""
    L, B = cldf_t.shape
    dtype = cldf_t.dtype
    if icld == 1:
        return jax.random.uniform(key, (L, NGPT, B), dtype)
    if icld == 3:
        one = jax.random.uniform(key, (1, NGPT, B), dtype)
        return jnp.broadcast_to(one, (L, NGPT, B))
    if icld == 2:
        cdf = jax.random.uniform(key, (L, NGPT, B), dtype)

        def step(prev, xs):
            cdf_l, cldf_below = xs
            keep = prev > (1.0 - cldf_below)[None, :]
            new = jnp.where(keep, prev,
                            cdf_l * (1.0 - cldf_below)[None, :])
            return new, new
        _, rest = jax.lax.scan(step, cdf[0], (cdf[1:], cldf_t[:-1]))
        return jnp.concatenate([cdf[0:1], rest], axis=0)
    if icld in (4, 5):
        k1, k2 = jax.random.split(key)
        cdf = jax.random.uniform(k1, (L, NGPT, B), dtype)
        cdf2 = jax.random.uniform(k2, (L, NGPT, B), dtype)

        def step(prev, xs):
            cdf_l, cdf2_l, alpha_l = xs
            new = jnp.where(cdf2_l < alpha_l[None, :], prev, cdf_l)
            return new, new
        _, rest = jax.lax.scan(step, cdf[0],
                               (cdf[1:], cdf2[1:], alpha_t[1:]))
        return jnp.concatenate([cdf[0:1], rest], axis=0)
    raise ValueError(f"invalid icld={icld}")


def mcica_subcol_lw_compact(key, icld: int, cldfrac, ciwp, clwp, rei,
                            rel, alpha=None, g_pad=144,
                            mask_dtype=None) -> McicaCloudsCompact:
    """Generator emitting the compact (binary mask + per-layer water
    path) form with the mask in the padded (L, G_pad, B) layout of
    McicaCloudsCompact and the streaming wire, at 1/4 the bytes of
    the per-g McicaClouds.

    Sub-column statistics match mcica_subcol_lw (identical overlap
    math; independent jax.random draws in g-major order).  For the
    inflag=2 parameterized-optics path, where the per-g taucmc input
    is never read (rrtmg_lw_cldprmc.f90:128-142)."""
    cldfrac = jnp.asarray(cldfrac)
    dtype = cldfrac.dtype
    B, L = cldfrac.shape
    cldf = jnp.where(cldfrac < CLDMIN, 0.0, cldfrac)
    cldf_t = cldf.T
    alpha_t = (jnp.zeros((L, B), dtype) if alpha is None
               else jnp.asarray(alpha).T)
    cdf = _native_cdf_gmajor(key, icld, cldf_t, alpha_t)
    iscloudy = cdf >= (1.0 - cldf_t)[:, None, :]
    mdt = dtype if mask_dtype is None else mask_dtype
    mask = jnp.pad(jnp.where(iscloudy, 1, 0).astype(mdt),
                   ((0, 0), (0, g_pad - NGPT), (0, 0)))
    return McicaCloudsCompact(
        cldfmc=mask, ciwp=jnp.asarray(ciwp), clwp=jnp.asarray(clwp),
        reicmc=jnp.asarray(rei), relqmc=jnp.asarray(rel))


# ---------------------------------------------------------------------------
# Bit-exact reference RNGs (numpy, host) — validation / column-mode path
# ---------------------------------------------------------------------------

class MersenneTwisterRef:
    """Bit-exact MT19937 as in mcica_random_numbers.f90:77-306."""

    N, M = 624, 397
    MATRIX_A = np.uint32(0x9908b0df)
    UMASK = np.uint32(0x80000000)
    LMASK = np.uint32(0x7fffffff)
    TMASKB = np.uint32(0x9d2c5680)
    TMASKC = np.uint32(0xefc60000)

    def __init__(self, seed: int):
        # initialize_scalar (:172-189)
        state = np.zeros(self.N, dtype=np.uint64)
        state[0] = np.uint64(np.uint32(seed))
        for i in range(1, self.N):
            prev = state[i - 1]
            state[i] = (np.uint64(1812433253)
                        * (prev ^ (prev >> np.uint64(30))) + np.uint64(i)) \
                & np.uint64(0xFFFFFFFF)
        self.state = state.astype(np.uint32)
        self.current = self.N

    def _next_state(self):
        s = self.state.astype(np.uint64)
        n, m = self.N, self.M
        for k in range(n):
            y = (s[k] & np.uint64(0x80000000)) | (s[(k + 1) % n]
                                                  & np.uint64(0x7fffffff))
            tw = (y >> np.uint64(1)) ^ (np.uint64(0x9908b0df)
                                        if (s[(k + 1) % n] & np.uint64(1))
                                        else np.uint64(0))
            s[k] = (s[(k + m) % n] ^ tw) & np.uint64(0xFFFFFFFF)
        self.state = s.astype(np.uint32)
        self.current = 0

    def random_int32(self) -> np.uint32:
        if self.current >= self.N:
            self._next_state()
        y = np.uint64(self.state[self.current])
        self.current += 1
        y ^= y >> np.uint64(11)
        y = (y ^ ((y << np.uint64(7)) & np.uint64(0x9d2c5680))) \
            & np.uint64(0xFFFFFFFF)
        y = (y ^ ((y << np.uint64(15)) & np.uint64(0xefc60000))) \
            & np.uint64(0xFFFFFFFF)
        y ^= y >> np.uint64(18)
        return np.uint32(y)

    def random_real(self) -> float:
        """getRandomReal: genrand_real1, [0,1] with 32-bit resolution."""
        return float(self.random_int32()) / (2.0 ** 32 - 1.0)


class KissVecRef:
    """Bit-exact vector KISS generator (mcica_subcol_gen_lw.f90:711-743).

    Seeds from the fractional parts of the bottom-four layer pressures
    in Pa (1col:529-540).
    """

    def __init__(self, pmid_pa: np.ndarray):
        pm = np.atleast_2d(np.asarray(pmid_pa, np.float64))   # (ncol, >=4)
        if pm.shape[1] < 4 or np.any(pm[:, 0] < pm[:, 1]):
            raise ValueError("kissvec seeds need bottom-4 pmid, sfc first")
        frac = pm[:, :4] - np.trunc(pm[:, :4])
        # int32 wraparound of frac*1e9 (Fortran int assignment truncates)
        self.s = [np.trunc(frac[:, i] * 1.0e9).astype(np.int64)
                  .astype(np.uint32).astype(np.uint64) for i in range(4)]

    def draw(self) -> np.ndarray:
        """One vector draw: (ncol,) float64 in [0, 1]."""
        M32 = np.uint64(0xFFFFFFFF)
        s1, s2, s3, s4 = self.s

        def m(k, n):
            if n >= 0:
                return (k ^ ((k << np.uint64(n)) & M32)) & M32
            return (k ^ (k >> np.uint64(-n))) & M32
        s1 = (np.uint64(69069) * s1 + np.uint64(1327217885)) & M32
        s2 = m(m(m(s2, 13), -17), 5)
        s3 = (np.uint64(18000) * (s3 & np.uint64(65535)) +
              (s3 >> np.uint64(16))) & M32
        s4 = (np.uint64(30903) * (s4 & np.uint64(65535)) +
              (s4 >> np.uint64(16))) & M32
        self.s = [s1, s2, s3, s4]
        kiss = (s1 + s2 + ((s3 << np.uint64(16)) & M32) + s4) & M32
        kiss_signed = kiss.astype(np.uint32).view(np.int32).astype(np.float64)
        return kiss_signed * 2.328306e-10 + 0.5


def generate_stochastic_clouds_ref(nlayers: int, icld: int, irng: int,
                                   pmid, cldfrac, clwp, ciwp, alpha, tauc,
                                   changeseed: int, ngb,
                                   ngpt: int = NGPT):
    """Bit-exact single-column generator
    (mcica_subcol_gen_lw.1col.f90:284-654), numpy on host.

    pmid in Pa (sfc first); tauc (nbnd, nlayers); returns dict of
    (ngpt, nlayers) arrays cldfmc/ciwpmc/clwpmc/taucmc in reference
    orientation.
    """
    cldf = np.asarray(cldfrac, np.float64).copy()
    cldf[cldf < CLDMIN] = 0.0
    L, G = nlayers, ngpt

    cdf = np.zeros((G, L))
    cdf2 = np.zeros((G, L))
    if irng == 0:
        kiss = KissVecRef(np.asarray(pmid)[None, :])
        for _ in range(changeseed):
            kiss.draw()

        def draw():
            return kiss.draw()[0]
    else:
        mt = MersenneTwisterRef(changeseed)

        def draw():
            return mt.random_real()

    if icld == 1 or icld == 2:
        for isub in range(G):
            for lev in range(L):
                cdf[isub, lev] = draw()
        if icld == 2:
            for lev in range(1, L):            # 1col:513-521
                keep = cdf[:, lev - 1] > 1.0 - cldf[lev - 1]
                cdf[:, lev] = np.where(keep, cdf[:, lev - 1],
                                       cdf[:, lev] * (1.0 - cldf[lev - 1]))
    elif icld == 3:
        for isub in range(G):
            r = draw()
            cdf[isub, :] = r
    elif icld in (4, 5):
        for isub in range(G):
            for lev in range(L):
                cdf[isub, lev] = draw()
                cdf2[isub, lev] = draw()
        al = np.asarray(alpha, np.float64)
        for lev in range(1, L):                # 1col:573-577, 604-607
            corr = cdf2[:, lev] < al[lev]
            cdf[:, lev] = np.where(corr, cdf[:, lev - 1], cdf[:, lev])
    else:
        raise ValueError(f"invalid icld={icld}")

    iscloudy = cdf >= (1.0 - cldf)[None, :]
    ngb0 = np.asarray(ngb) - 1
    tauc = np.asarray(tauc, np.float64)
    out_tau = np.where(iscloudy, tauc[ngb0, :], 0.0)
    return dict(
        cldfmc=np.where(iscloudy, 1.0, 0.0),
        clwpmc=np.where(iscloudy, np.asarray(clwp)[None, :], 0.0),
        ciwpmc=np.where(iscloudy, np.asarray(ciwp)[None, :], 0.0),
        taucmc=out_tau)
