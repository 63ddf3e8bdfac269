"""Pallas (Triton route) RT sweep kernel vs the XLA sweep.

The kernel runs in the Pallas interpreter here; its Triton lowering is
checked by lowering for CUDA without a card.  Fluxes must agree to f32
rounding; heating rates are excluded because the finite difference
across thin top layers amplifies f32 flux noise identically in both
directions.  Shapes are chosen so that both the column block (B=40 ->
two 32-column blocks) and the g-block (140 -> five 32-point blocks)
need padding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rrtmg_lw_tpu import LWConfig, make_model
from rrtmg_lw_tpu.ops import rtrn as rt
from rrtmg_lw_tpu.ops import rtrn_pallas as rtp
from rrtmg_lw_tpu.ops.inatm import inatm
from rrtmg_lw_tpu.utils.synthetic import (make_atmosphere,
                                          make_band_clouds,
                                          make_mcica_clouds)

B, L = 40, 13
FLUXES = ["totuflux", "totdflux", "totuclfl", "totdclfl"]


@pytest.fixture(scope="module")
def stack():
    model = make_model(LWConfig(icld=0, dtype="float32", use_lut=False))
    atm = make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32)
    prof = inatm(atm, dtype=jnp.float32)
    sc, taut, fracs = model.optical_depth(prof)
    rng = np.random.default_rng(0)
    cldf = (rng.random((B, L, 140)) < 0.3).astype(np.float32)
    odcld = (rng.random((B, L, 140)) * 5).astype(np.float32) * cldf
    return model, prof, sc, taut, fracs, jnp.asarray(cldf), \
        jnp.asarray(odcld)


def _args(stack, cloudy):
    model, prof, sc, taut, fracs, cldf, odcld = stack
    return (taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
            sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz,
            cldf if cloudy else None, odcld if cloudy else None)


def _reference(stack, args, cloudy, idrv, thresh=0.5):
    model = stack[0]
    args = list(args)
    if not cloudy:
        args[9] = args[10] = jnp.zeros_like(args[0])
    gate = (args[9] >= thresh) if cloudy \
        else jnp.zeros(args[0].shape, bool)
    return rt.rt_random_overlap(
        *args, cloudy_lay=jnp.any(gate, -1), cld_gate=gate,
        static=model.static_np, luts=None, use_lut=False, idrv=idrv,
        heatfac_val=model.heatfac)


def _kernel(stack, args, cloudy, idrv, thresh=0.5):
    model = stack[0]
    return rtp.rt_random_overlap_pallas(
        *args, cloudy=cloudy, gate_thresh=thresh, static=model.static_np,
        idrv=idrv, heatfac_val=model.heatfac, interpret=True)


def _assert_fluxes_match(out, ref, names):
    for name in names:
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        scale = max(np.abs(a).max(), 1.0)
        np.testing.assert_allclose(b, a, atol=2e-6 * scale, err_msg=name)


@pytest.mark.parametrize("cloudy,idrv", [(False, 0), (True, 0),
                                         (True, 1), (False, 1)])
def test_flux_parity(stack, cloudy, idrv):
    args = _args(stack, cloudy)
    out = _kernel(stack, args, cloudy, idrv)
    ref = _reference(stack, args, cloudy, idrv)
    names = FLUXES + (["dtotuflux_dt", "dtotuclfl_dt"] if idrv else [])
    _assert_fluxes_match(out, ref, names)
    assert out.htr.shape == (B, L)


@pytest.mark.parametrize("block_b,block_g", [(8, 16), (64, 64)])
def test_block_shapes_agree(stack, block_b, block_g, monkeypatch):
    """Other column/g blocks (one needing no column padding, one wider
    than the batch) give the same fluxes."""
    monkeypatch.setattr(rtp, "BLOCK_B", block_b)
    monkeypatch.setattr(rtp, "BLOCK_G", block_g)
    args = _args(stack, True)
    out = _kernel(stack, args, True, 0)
    _assert_fluxes_match(out, _reference(stack, args, True, 0), FLUXES)


def test_banded_threshold_and_weighted_od(stack):
    """Banded random overlap: a per-layer cldfrac broadcast to g, gated
    at 1e-6, with the cloud od already secdiff-weighted."""
    model, prof, sc, taut, fracs, cldf, odcld = stack
    frac = jnp.asarray(np.random.default_rng(1).random((B, L)) * 0.8,
                       jnp.float32)
    cf = jnp.broadcast_to(frac[..., None], taut.shape)
    args = _args(stack, True)
    args = args[:9] + (cf, odcld)
    out = rtp.rt_random_overlap_pallas(
        *args, cloudy=True, gate_thresh=1e-6, static=model.static_np,
        idrv=0, heatfac_val=model.heatfac, odcld_weighted=True,
        interpret=True)
    gate = cf >= 1e-6
    ref = rt.rt_random_overlap(
        *args, cloudy_lay=jnp.any(gate, -1), cld_gate=gate,
        static=model.static_np, luts=None, use_lut=False, idrv=0,
        heatfac_val=model.heatfac, odcld_weighted=True)
    _assert_fluxes_match(out, ref, FLUXES)


def test_custom_vjp_matches_xla_gradient(stack):
    """The kernel's backward is the XLA sweep's vjp: gradients agree
    with autodiff of rt_random_overlap to f32 roundoff."""
    args = _args(stack, True)

    def loss(fn, t, pl_):
        a = (t,) + args[1:2] + (pl_,) + args[3:]
        out = fn(a)
        return jnp.sum(out.totuflux ** 2) + jnp.sum(out.htr)

    def k(a):
        return _kernel(stack, a, True, 0)

    def x(a):
        return _reference(stack, a, True, 0)

    gk = jax.grad(lambda t, p: loss(k, t, p), argnums=(0, 1))(
        args[0], args[2])
    gx = jax.grad(lambda t, p: loss(x, t, p), argnums=(0, 1))(
        args[0], args[2])
    for a, b in zip(gk, gx):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all() and np.abs(a).max() > 0
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


def test_auto_resolves_to_xla_off_gpu():
    cfg = LWConfig(icld=2, dtype="float32", use_lut=False)
    assert not make_model(cfg).rt_pallas
    assert make_model(cfg.replace(rt_impl="pallas",
                                  pallas_interpret=True)).rt_pallas


@pytest.mark.parametrize("kw", [
    dict(dtype="float32", use_lut=False),             # no GPU here
    dict(dtype="float64", use_lut=False, pallas_interpret=True),
    dict(dtype="float32", use_lut=True, pallas_interpret=True),
])
def test_explicit_pallas_outside_coverage_raises(kw):
    with pytest.raises(ValueError):
        make_model(LWConfig(rt_impl="pallas", **kw))


def test_lowers_to_triton_for_cuda(stack):
    """The kernel lowers through the Triton route (no card needed for
    the Pallas -> Triton IR step)."""
    args = _args(stack, True)
    model = stack[0]

    def f(a):
        return rtp.rt_random_overlap_pallas(
            *a, cloudy=True, gate_thresh=0.5, static=model.static_np,
            idrv=1, heatfac_val=model.heatfac)

    text = jax.jit(f).trace(args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.parametrize("icld,imca,clouds", [
    (0, 1, None), (2, 1, "compact"), (1, 0, "band")])
def test_model_paths_match_xla(icld, imca, clouds):
    """The model's dispatch: kernel (interpret) vs XLA sweep through
    the whole step, for clear, McICA (compact clouds) and banded."""
    kw = dict(icld=icld, imca=imca, dtype="float32", use_lut=False,
              idrv=1)
    mk = make_model(LWConfig(rt_impl="pallas", pallas_interpret=True,
                             **kw))
    mx = make_model(LWConfig(rt_impl="xla", **kw))
    atm = make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32)
    cl = {None: None,
          "compact": make_mcica_clouds(ncol=B, nlay=L, dtype=jnp.float32,
                                       layout="compact"),
          "band": make_band_clouds(ncol=B, nlay=L,
                                   dtype=jnp.float32)}[clouds]
    a = jax.jit(lambda a, c: mk(a, c))(atm, cl)
    b = jax.jit(lambda a, c: mx(a, c))(atm, cl)
    for name in ("uflx", "dflx", "uflxc", "dflxc", "duflx_dt"):
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        np.testing.assert_allclose(x, y, atol=2e-6 * np.abs(y).max(),
                                   err_msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("cloudy,idrv", [(False, 0), (True, 1)])
def test_compiled_kernel_matches_xla_on_gpu(cloudy, idrv):
    """The Triton-compiled kernel (not the interpreter) against the XLA
    sweep at a production layer count."""
    Bg, Lg = 1000, 60
    model = make_model(LWConfig(icld=2, dtype="float32", use_lut=False))
    atm = make_atmosphere(ncol=Bg, nlay=Lg, dtype=jnp.float32)
    cl = make_mcica_clouds(ncol=Bg, nlay=Lg, dtype=jnp.float32)
    prof = inatm(atm, dtype=jnp.float32)
    sc, taut, fracs = model.optical_depth(prof)
    cf = jnp.asarray(cl.cldfmc) if cloudy else None
    od = jnp.asarray(cl.clwpmc) * 0.1 if cloudy else None
    args = (taut, fracs, sc.planklay, sc.planklev, sc.plankbnd,
            sc.dplankbnd_dt, prof.semiss, prof.pwvcm, prof.pz, cf, od)
    stack = (model,)
    out = jax.jit(lambda a: rtp.rt_random_overlap_pallas(
        *a, cloudy=cloudy, gate_thresh=0.5, static=model.static_np,
        idrv=idrv, heatfac_val=model.heatfac))(args)
    ref = jax.jit(lambda a: _reference(stack, a, cloudy, idrv))(args)
    for name in FLUXES:
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        assert np.abs(b - a).max() <= 2e-5 * np.abs(a).max(), name
