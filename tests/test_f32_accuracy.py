"""The production f32 pipeline must stay far inside the reference
accuracy contract (fluxes <= 0.5 W/m², heating <= 0.1 K/day,
README.md:19) relative to the f64 parity path.

Measured on CPU/XLA with the direct-exp scheme (the one the Pallas RT
kernel uses): ~1e-4 W/m² flux and ~6e-3 K/day heating differences at
nlay=60 — the gates below keep two orders of margin on flux.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig, make_model
from rrtmg_lw_tpu.utils.synthetic import make_atmosphere, make_mcica_clouds

pytestmark = pytest.mark.slow  # full-pipeline accuracy contract sweeps (round gate)


@pytest.mark.parametrize("icld", [0, 2])
def test_f32_within_contract(icld):
    out = {}
    for dt in ("float64", "float32"):
        jdt = jnp.float64 if dt == "float64" else jnp.float32
        atm = make_atmosphere(ncol=8, nlay=60, dtype=jdt)
        cl = make_mcica_clouds(ncol=8, nlay=60, dtype=jdt) if icld \
            else None
        model = make_model(LWConfig(icld=icld, imca=1, dtype=dt,
                                    use_lut=False))
        out[dt] = model(atm, cl)
    a, b = out["float64"], out["float32"]
    assert np.abs(np.asarray(a.uflx) - np.asarray(b.uflx)).max() < 5e-3
    assert np.abs(np.asarray(a.dflx) - np.asarray(b.dflx)).max() < 5e-3
    assert np.abs(np.asarray(a.hr) - np.asarray(b.hr)).max() < 0.05


def test_f32_deep_within_contract():
    """Same contract at production depth (nlay=140): both the XLA f32
    path and the Pallas RT sweep (interpret mode) are gated against
    the f64 run.  Measured: <=2.3e-4 W/m^2 flux, <=0.07 K/day
    heating."""
    B, L = 128, 140
    out = {}
    for tag, cfg in [
        ("f64", LWConfig(icld=2, imca=1, dtype="float64",
                         use_lut=False)),
        ("f32", LWConfig(icld=2, imca=1, dtype="float32",
                         use_lut=False)),
        ("f32_pallas", LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False, rt_impl="pallas",
                                pallas_interpret=True)),
    ]:
        jdt = jnp.float64 if tag == "f64" else jnp.float32
        atm = make_atmosphere(ncol=B, nlay=L, dtype=jdt)
        cl = make_mcica_clouds(
            ncol=B, nlay=L, dtype=jdt,
            layout="compact" if tag == "f32_pallas" else "batch")
        import jax
        model = make_model(cfg)
        out[tag] = jax.jit(lambda a, c, m=model: m(a, c))(atm, cl)
    a = out["f64"]
    for tag in ("f32", "f32_pallas"):
        b = out[tag]
        assert np.abs(np.asarray(a.uflx)
                      - np.asarray(b.uflx)).max() < 5e-3, tag
        assert np.abs(np.asarray(a.dflx)
                      - np.asarray(b.dflx)).max() < 5e-3, tag
        assert np.abs(np.asarray(a.hr)
                      - np.asarray(b.hr)).max() < 0.2, tag


def test_deep_profiles_finite():
    """mxlay parity: the reference supports up to 603 layers
    (parrrtm.f90:31); the pipeline must stay finite at that depth
    (regression: the synthetic generator's old 0.03 mb pressure floor
    collapsed top layers to zero thickness at large nlay)."""
    for L in (140, 603):
        atm = make_atmosphere(ncol=2, nlay=L)
        clouds = make_mcica_clouds(ncol=2, nlay=L)
        fl = make_model(LWConfig(icld=2, imca=1))(atm, clouds)
        assert np.isfinite(np.asarray(fl.uflx)).all(), L
        assert np.isfinite(np.asarray(fl.hr)).all(), L
        assert (np.diff(np.asarray(atm.plev), axis=1) < 0.0).all(), L
