"""Differentiability of the full pipeline (a capability the reference
does not have — it is forward-only Fortran).

``jax.grad`` must flow through inatm -> setcoef -> taumol -> cldprmc ->
rtrn end-to-end, and the gradients must be *correct*: checked against
central finite differences in f64 on the smooth (use_lut=False) path.
The tabulated (use_lut=True) mode is piecewise-constant in the table
lookups by construction, so gradient tests use the direct-exp mode —
the same scheme the Pallas RT kernel uses.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig, make_model
from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                          make_mcica_clouds)


def _fd(f, x, idx, eps):
    x = jnp.asarray(x)     # generators return host numpy (by contract)
    xp = x.at[idx].add(eps)
    xm = x.at[idx].add(-eps)
    return (f(xp) - f(xm)) / (2.0 * eps)


@pytest.fixture(scope="module")
def clear_setup():
    model = make_model(LWConfig(icld=0, use_lut=False))
    atm = make_atmosphere(ncol=2, nlay=12)
    return model, atm


def test_grad_olr_wrt_tlay_matches_fd(clear_setup):
    model, atm = clear_setup

    def loss_t(tlay):
        fl = model(atm._replace(tlay=tlay))
        return fl.uflx[:, -1].sum()          # outgoing longwave at TOA

    g = jax.jit(jax.grad(loss_t))(atm.tlay)
    assert np.isfinite(np.asarray(g)).all()
    # warming any layer must increase OLR in a clear atmosphere
    assert (np.asarray(g) > 0.0).all()
    f = jax.jit(loss_t)
    for idx in [(0, 3), (1, 10)]:
        fd = _fd(f, atm.tlay, idx, 0.05)
        assert g[idx] == pytest.approx(float(fd), rel=2e-3)


@pytest.mark.slow
def test_grad_surface_flux_wrt_h2o_matches_fd(clear_setup):
    model, atm = clear_setup

    def loss_q(q):
        fl = model(atm._replace(h2ovmr=q))
        return fl.dflx[:, 0].sum()           # downward flux at surface

    g = jax.jit(jax.grad(loss_q))(atm.h2ovmr)
    assert np.isfinite(np.asarray(g)).all()
    # more water vapor -> more downwelling longwave at the surface
    assert float(np.asarray(g)[0, 0]) > 0.0
    f = jax.jit(loss_q)
    idx = (0, 1)
    fd = _fd(f, atm.h2ovmr, idx, float(atm.h2ovmr[idx]) * 1e-2)
    assert g[idx] == pytest.approx(float(fd), rel=2e-3)


@pytest.mark.slow
def test_grad_cloudy_mcica_wrt_ciwp_matches_fd():
    model = make_model(LWConfig(icld=2, imca=1, use_lut=False))
    atm = make_atmosphere(ncol=2, nlay=12)
    clouds = make_mcica_clouds(ncol=2, nlay=12)

    def loss(ciwpmc):
        fl = model(atm, clouds._replace(ciwpmc=ciwpmc))
        return fl.uflx[:, -1].sum()

    g = jax.jit(jax.grad(loss))(clouds.ciwpmc)
    g = np.asarray(g)
    assert np.isfinite(g).all()
    # gradients must actually flow into the cloud water path
    assert np.abs(g).max() > 1e-6
    f = jax.jit(loss)
    nz = np.argwhere(np.abs(g) > 1e-6)
    idx = tuple(int(v) for v in nz[len(nz) // 2])
    fd = _fd(f, clouds.ciwpmc, idx, 1e-2)
    assert g[idx] == pytest.approx(float(fd), rel=2e-3)
