"""shard_map x Pallas RT kernel composition.

GSPMD cannot partition a pallas_call, so on a column-sharded mesh the
step runs the model per shard under ``jax.shard_map``
(``parallel.api._forward``).  These tests execute that composition on
the 8-device virtual CPU mesh with the kernel in interpret mode and
gate on value parity against the XLA sweep.  With a spectral
partition (spec > 1) the model keeps the XLA sweep, and the step must
still match.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig, make_model
from rrtmg_lw_tpu import parallel as par
from rrtmg_lw_tpu.utils.synthetic import make_atmosphere, make_mcica_clouds

B, L = 320, 12       # 40 columns per device: a padded column block


def _mesh(spec):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return par.make_mesh(jax.devices()[:8], spec=spec)


def _models(icld):
    kw = dict(icld=icld, imca=1, dtype="float32", use_lut=False)
    return (make_model(LWConfig(rt_impl="xla", **kw)),
            make_model(LWConfig(rt_impl="pallas", pallas_interpret=True,
                                **kw)))


def _assert_parity(fl_p, fl_x):
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        a = np.asarray(getattr(fl_p, name))
        b = np.asarray(getattr(fl_x, name))
        assert np.abs(a - b).max() < 1e-3, (name, np.abs(a - b).max())
    assert not fl_p.uflx.sharding.is_fully_replicated


@pytest.mark.parametrize("spec", [1, 2])
def test_mcica_compact_clouds(spec):
    """McICA with generator-form clouds: per shard under shard_map
    (spec=1, the default for a kernel model) or GSPMD with the XLA
    sweep (spec=2)."""
    mesh = _mesh(spec)
    m_x, m_p = _models(icld=2)
    atm = par.shard_batch(
        make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32), mesh)
    clouds = par.shard_batch(
        make_mcica_clouds(ncol=B, nlay=L, dtype=jnp.float32,
                          layout="compact"), mesh)
    fl_p = par.make_sharded_step(m_p, mesh)(atm, clouds)
    fl_x = par.make_sharded_step(m_x, mesh)(atm, clouds)
    _assert_parity(fl_p, fl_x)


def test_clear_sky_grad_step():
    """The gradient step keeps the kernel per shard too, and its
    gradient equals the XLA sweep's to f32 roundoff."""
    mesh = _mesh(1)
    m_x, m_p = _models(icld=0)
    atm = par.shard_batch(
        make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32), mesh)
    loss_p, g_p = par.make_sharded_grad_step(m_p, mesh)(atm)
    loss_x, g_x = par.make_sharded_grad_step(m_x, mesh)(atm)
    np.testing.assert_allclose(float(loss_p), float(loss_x), rtol=1e-4)
    for a, b in zip(jax.tree_util.tree_leaves(g_p),
                    jax.tree_util.tree_leaves(g_x)):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, atol=1e-2 * np.abs(b).max())
