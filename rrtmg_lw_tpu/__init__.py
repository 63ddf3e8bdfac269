"""rrtmg_lw_tpu — a batched longwave radiative transfer framework.

Brand-new JAX/XLA implementation with the capabilities of
AER-RC/RRTMG_LW (correlated k-distribution, 16 bands / 140 g-points,
McICA): batched over columns, sharded over device meshes, jit-compiled.
"""

from .config import LWConfig
from .types import (Atmosphere, BandClouds, Fluxes, McicaClouds,
                    McicaCloudsCompact, Profile, SetcoefOut)
from .models.radiation import RRTMGLW, make_model

__version__ = "0.1.0"

__all__ = [
    "LWConfig", "Atmosphere", "BandClouds", "Fluxes", "McicaClouds",
    "McicaCloudsCompact", "Profile", "SetcoefOut",
    "RRTMGLW", "make_model", "__version__",
]
