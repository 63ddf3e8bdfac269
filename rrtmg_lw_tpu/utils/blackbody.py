"""First-principles blackbody fluxes (validation anchor).

Direct numerical integration of the Planck function from CODATA
constants — independent of the framework's totplnk tables, Planck
fractions, and of the tests/oracle transcription.  Used by
tests/test_invariants.py to pin the
isothermal-enclosure fixed point of the RT recursion
(rrtmg_lw_rtrnmc.f90:486-529) to physics.
"""

from __future__ import annotations

import numpy as np

H_PLANCK = 6.62607015e-34       # J s       (CODATA 2018, exact)
C_LIGHT = 2.99792458e8          # m / s     (exact)
K_BOLTZ = 1.380649e-23          # J / K     (exact)
SIGMA_SB = 5.670374419e-8       # W m^-2 K^-4


def planck_band_flux(T, nu1, nu2, npts=20001):
    """pi * integral of B_nu(T) over [nu1, nu2] cm^-1, in W/m^2
    (hemispheric blackbody flux in the band; trapezoid quadrature on
    a fine grid, exact to ~1e-8 relative at these widths)."""
    nu = np.linspace(nu1 * 100.0, nu2 * 100.0, npts)   # m^-1
    B_nu = (2.0 * H_PLANCK * C_LIGHT ** 2 * nu ** 3
            / np.expm1(H_PLANCK * C_LIGHT * nu / (K_BOLTZ * T)))
    return np.pi * np.trapezoid(B_nu, nu)


def band_anchor(static, T):
    """Blackbody flux summed over the model's 16 bands at temperature
    T — what an isothermal enclosure with a black surface must emit."""
    return sum(planck_band_flux(T, a, b)
               for a, b in zip(np.asarray(static["wavenum1"]),
                               np.asarray(static["wavenum2"])))


def sigma_T4(T):
    return SIGMA_SB * T ** 4
