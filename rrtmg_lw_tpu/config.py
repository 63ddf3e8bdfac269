"""Static configuration for the LW radiation model.

Mirrors the reference's flag system (GCM subroutine args + INPUT_RRTM
record 1.2; see doc/rrtmg_lw_instructions.txt:72-143):

  icld   0 clear, 1 random, 2 max-random, 3 maximum (McICA),
         4 exponential (McICA), 5 exponential-random (McICA)
  idrv   1 -> also compute dF_up/dT_surface (Planck derivative)
  iaer   0 none, 10 per-band aerosol optical depth input
  inflag/iceflag/liqflag  cloud-optics parameterization selectors
  irng   RNG for McICA: 0 kissvec, 1 Mersenne twister, 2 jax.random (native)

All fields are static (hashable) so a config can be a jit static arg.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class LWConfig:
    icld: int = 0
    idrv: int = 0
    iaer: int = 0
    inflag: int = 2
    iceflag: int = 3
    liqflag: int = 1
    irng: int = 2
    imca: int = 1          # 1 -> McICA cloud treatment (rtrnmc path)
    idcor: int = 0         # decorrelation length: 0 const, 1 lat-varying
    istart: int = 1        # first band
    iend: int = 16         # last band
    use_lut: bool = True   # exp/tfn via 10k-entry tables (reference parity)
                           # False -> closed-form exp
    rt_impl: str = "auto"  # RT sweep: 'xla' (lax.scan) | 'pallas' (the
                           # fused Triton sweep, rtrn_pallas.py) |
                           # 'auto' (pallas on a GPU when the config
                           # is one the kernel covers)
    pallas_interpret: bool = False  # run rt_impl='pallas' in the Pallas
                           # interpreter (CPU tests); without it an
                           # explicit 'pallas' off a GPU raises
    dtype: str = "float64" # compute dtype for the column physics
    cpdair: float = 1.004e3

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    def replace(self, **kw) -> "LWConfig":
        return dataclasses.replace(self, **kw)
