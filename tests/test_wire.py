"""Compressed streaming wire format.

Gates: (a) decoded fields land within the documented quantization of
the f32 originals, (b) the FLUX impact of wire quantization is
<= 1e-2 W/m^2 against the same model run on the uncompressed inputs,
(c) the wire really is >= 2x smaller than the f32 dataflow it
replaces (device_gen, ~4.8 KB/col), (d) exact-zero channels stay
exactly zero.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rrtmg_lw_tpu import LWConfig, make_model
from rrtmg_lw_tpu.parallel import wire as w
from rrtmg_lw_tpu.utils.synthetic import make_atmosphere

B, L = 64, 60


from rrtmg_lw_tpu.utils.synthetic import \
    make_cloud_profile_fields as cloud_profiles  # noqa: E402


@pytest.fixture(scope="module")
def atm():
    return make_atmosphere(ncol=B, nlay=L, dtype=jnp.float32)


def test_atmosphere_roundtrip_precision(atm):
    enc = w.encode_atmosphere(atm)
    dec = w.decode_atmosphere(enc, tauaer=jnp.asarray(atm.tauaer))
    for name, kind in w.ATM_FIELDS.items():
        a = np.asarray(getattr(atm, name), np.float64)
        b = np.asarray(getattr(dec, name), np.float64)
        if kind == "logratio":
            nz = a > 0
            assert np.array_equal(b == 0, ~nz), name
            rel = np.abs(b[nz] / a[nz] - 1).max() if nz.any() else 0.0
            assert rel < 2e-4, (name, rel)
        elif kind == "delta":
            span = a.max() - a.min() + 1e-6
            assert np.abs(b - a).max() < 2e-5 * span + 1e-6, name
        else:
            assert np.abs(b - a).max() < 2e-5, name


def test_zero_channels_are_flags(atm):
    zeroed = atm._replace(
        covmr=jnp.zeros_like(jnp.asarray(atm.covmr)),
        cfc11vmr=jnp.zeros_like(jnp.asarray(atm.cfc11vmr)))
    enc = w.encode_atmosphere(zeroed)
    assert "covmr" not in enc.cols and enc.refs["covmr"] is None
    dec = w.decode_atmosphere(enc, tauaer=jnp.asarray(atm.tauaer))
    assert not np.asarray(dec.covmr).any()
    assert not np.asarray(dec.cfc11vmr).any()


def test_cloud_profiles_roundtrip():
    cp = cloud_profiles(B, L)
    dec = w.decode_cloud_profiles(w.encode_cloud_profiles(cp))
    for name in cp:
        a, b = cp[name], np.asarray(dec[name])
        if name in ("ciwp", "clwp"):
            assert np.array_equal(b == 0, a == 0), name
            nz = a > 0
            if nz.any():
                assert np.abs(b[nz] / a[nz] - 1).max() < 2e-4, name
        else:
            assert np.abs(b - a).max() < 2e-4 * (abs(a).max() + 1), name


def test_flux_impact_within_budget(atm):
    """Wire quantization on the CONTINUOUS inputs is pure input
    noise: with identical McICA mask realizations, fluxes from
    decoded inputs sit within 1e-2 W/m^2 of the uncompressed-f32
    run.

    The mask realization itself is DISCONTINUOUS in cldfrac (a
    threshold against RNG draws), so the ~1.5e-5 cldfrac
    quantization can flip individual sub-column bits — a different
    but statistically equivalent cloud sample (exactly like changing
    the RNG seed; the reference's column mode averages 200 such
    samples).  The full-wire run is therefore gated statistically:
    identical clear-sky fluxes (no mask dependence), batch-mean
    total-sky fluxes within 5e-3 W/m^2, and a tiny flipped-bit
    fraction."""
    from rrtmg_lw_tpu.ops.mcica import mcica_subcol_lw_compact

    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False))
    cp = cloud_profiles(B, L)
    key = jax.random.key(11)

    def gen(cldfrac, c):
        return mcica_subcol_lw_compact(
            key, 2, cldfrac, c["ciwp"], c["clwp"], c["rei"], c["rel"])

    @jax.jit
    def step(a, c):
        return model(a, gen(c["cldfrac"], c))

    cpj = jax.tree_util.tree_map(jnp.asarray, cp)
    ref = step(atm, cpj)
    enc_a = w.encode_atmosphere(atm)
    enc_c = w.encode_cloud_profiles(cp)

    @jax.jit
    def step_wire(ea, ec, tauaer, cldfrac_direct):
        a = w.decode_atmosphere(ea, tauaer)
        c = w.decode_cloud_profiles(ec, like=a.play)
        full = model(a, gen(c["cldfrac"], c))
        same_mask = model(a, gen(cldfrac_direct, c))
        flips = (gen(c["cldfrac"], c).cldfmc
                 != gen(cldfrac_direct, c).cldfmc).mean()
        return full, same_mask, flips

    full, same_mask, flips = step_wire(enc_a, enc_c,
                                       jnp.asarray(atm.tauaer),
                                       cpj["cldfrac"])
    # (a) input-noise gate: identical mask realization
    for name in ("uflx", "dflx", "uflxc", "dflxc"):
        d = np.abs(np.asarray(getattr(same_mask, name))
                   - np.asarray(getattr(ref, name))).max()
        assert d < 1e-2, (name, d)
    d = np.abs(np.asarray(same_mask.hr) - np.asarray(ref.hr)).max()
    assert d < 0.1       # K/day; thin-layer divergence amplifies
    # (b) full wire: clear-sky unaffected by masks; total-sky equal
    # in batch mean; few flipped sub-column bits
    for name in ("uflxc", "dflxc"):
        d = np.abs(np.asarray(getattr(full, name))
                   - np.asarray(getattr(ref, name))).max()
        assert d < 1e-2, (name, d)
    for name in ("uflx", "dflx"):
        d = np.abs(np.asarray(getattr(full, name)).mean(0)
                   - np.asarray(getattr(ref, name)).mean(0)).max()
        assert d < 5e-3, (name, d)
    assert float(flips) < 1e-3, float(flips)


def test_schema_pins_pytree_structure(atm):
    """Auto-detected wire structure is data-dependent; a pinned
    schema keeps the treedef identical across batches (no mid-stream
    jit retraces) and raises loudly on a real category change."""
    cp = cloud_profiles(B, L)
    clear = {k: (np.zeros_like(v) if k in ("cldfrac", "ciwp", "clwp")
                 else v) for k, v in cp.items()}
    # auto: clear batch drops channels -> different treedef
    t_cloudy = jax.tree_util.tree_structure(w.encode_cloud_profiles(cp))
    t_clear = jax.tree_util.tree_structure(
        w.encode_cloud_profiles(clear))
    assert t_cloudy != t_clear
    # coded schema: identical treedef, and the clear batch decodes to
    # exact zeros with shape from `like`
    e_cloudy = w.encode_cloud_profiles(cp, schema="coded")
    e_clear = w.encode_cloud_profiles(clear, schema="coded")
    assert (jax.tree_util.tree_structure(e_cloudy)
            == jax.tree_util.tree_structure(e_clear))
    dec = w.decode_cloud_profiles(e_clear, like=cp["cldfrac"])
    assert not np.asarray(dec["cldfrac"]).any()
    assert not np.asarray(dec["ciwp"]).any()
    np.testing.assert_allclose(np.asarray(dec["rei"]), cp["rei"],
                               rtol=2e-4)
    # captured schema round-trips and enforces itself
    sch = w.schema_of(e_cloudy)
    assert set(sch.values()) == {"coded"}
    sch_auto = w.schema_of(w.encode_cloud_profiles(clear))
    assert sch_auto["cldfrac"] == "zero"
    with pytest.raises(ValueError, match="schema violation"):
        w.encode_cloud_profiles(cp, schema=sch_auto)


def test_clear_batch_decode_requires_like():
    cp = cloud_profiles(B, L)
    clear = {k: (np.zeros_like(v) if k in ("cldfrac", "ciwp", "clwp")
                 else v) for k, v in cp.items()}
    enc = w.encode_cloud_profiles(clear)      # auto: no cols at all
    assert not enc.cols
    with pytest.raises(ValueError, match="like"):
        w.decode_cloud_profiles(enc)
    dec = w.decode_cloud_profiles(enc, like=cp["cldfrac"])
    assert not np.asarray(dec["clwp"]).any()


def test_compact_clouds_wire_roundtrip(atm):
    """Host-generated McICA sub-columns (the reference GCM contract,
    rrtmg_lw_rad.f90:117) on the wire: the bit-packed mask must
    round-trip EXACTLY; water paths within codec quantization; the
    decoded clouds must reproduce the direct-compact fluxes within
    the input-noise budget (masks identical by construction)."""
    from rrtmg_lw_tpu.utils.synthetic import make_mcica_clouds

    clouds = make_mcica_clouds(ncol=B, nlay=L, dtype=jnp.float32,
                               layout="compact")
    enc = w.encode_compact_clouds(clouds)
    dec = w.decode_compact_clouds(enc)
    m0 = np.asarray(clouds.cldfmc) != 0
    assert np.array_equal(np.asarray(dec.cldfmc)[:, :m0.shape[1]] != 0,
                          m0)
    for name in ("ciwp", "clwp"):
        a = np.asarray(getattr(clouds, name))
        b = np.asarray(getattr(dec, name))
        nz = a > 0
        assert np.array_equal(b == 0, a == 0), name
        if nz.any():
            assert np.abs(b[nz] / a[nz] - 1).max() < 2e-4, name
    # flux parity: identical masks, quantized waters/sizes only
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False))
    ref = jax.jit(lambda a, c: model(a, c))(atm, clouds)
    got = jax.jit(lambda a, e: model(a, w.decode_compact_clouds(
        e, mask_dtype=clouds.cldfmc.dtype)))(atm, enc)
    for name in ("uflx", "dflx"):
        d = np.abs(np.asarray(getattr(got, name))
                   - np.asarray(getattr(ref, name))).max()
        assert d < 1e-2, (name, d)
    # and it really is small on the wire
    int8_bytes = (np.asarray(clouds.cldfmc).size  # int8 mask form
                  + 4 * sum(np.asarray(getattr(clouds, n)).size
                            for n in ("ciwp", "clwp", "reicmc",
                                      "relqmc")))
    assert w.wire_bytes(enc) * 4 < int8_bytes


def test_frozen_refs_multihost_contract(atm):
    """With frozen references (a previous batch's refs, or
    climatology) the codes are a pure function of the data: encoding
    two host shards separately against the same refs is bitwise
    identical to encoding their concatenation — the multi-host wire
    contract (per-batch medians would differ per host).  Out-of-range
    values saturate instead of re-ranging."""
    a_np = {k: np.asarray(v) for k, v in atm._asdict().items()
            if k != "tauaer"}
    base = w.encode_atmosphere(a_np, schema="coded")
    half = {k: v[:B // 2] for k, v in a_np.items()}
    other = {k: v[B // 2:] for k, v in a_np.items()}
    e1 = w.encode_atmosphere(half, refs=base.refs)
    e2 = w.encode_atmosphere(other, refs=base.refs)
    efull = w.encode_atmosphere(a_np, refs=base.refs)
    for k in efull.cols:
        got = np.concatenate([np.asarray(e1.cols[k]),
                              np.asarray(e2.cols[k])], axis=0)
        assert np.array_equal(got, np.asarray(efull.cols[k])), k
        # refs pass through unchanged
        for x, y in zip(e1.refs[k], base.refs[k]):
            assert np.array_equal(np.asarray(x), np.asarray(y)), k
    # decode accuracy is preserved under frozen refs
    dec = w.decode_atmosphere(efull, tauaer=jnp.asarray(atm.tauaer))
    t_err = np.abs(np.asarray(dec.tlay) - a_np["tlay"]).max()
    assert t_err < 5e-3                           # K
    # saturation: a value far outside the frozen range clamps to the
    # range edge rather than corrupting the shared scale
    hot = dict(a_np)
    hot["tlay"] = a_np["tlay"] + 500.0
    e_hot = w.encode_atmosphere(hot, refs=base.refs)
    d_hot = w.decode_atmosphere(e_hot, tauaer=jnp.asarray(atm.tauaer))
    ref_row, lo, hi = base.refs["tlay"]
    assert np.asarray(d_hot.tlay).max() <= (
        np.asarray(ref_row).max() + float(hi) + 1e-3)


def test_frozen_refs_guardrails(atm):
    """The determinism contract fails LOUDLY, never silently: refs
    captured from a batch where a channel was uniform cannot back a
    coded encode; zero-width frozen ranges reject varying data."""
    a_np = {k: np.asarray(v) for k, v in atm._asdict().items()
            if k != "tauaer"}
    auto = w.encode_atmosphere(a_np)              # gases uniform
    assert isinstance(auto.refs["co2vmr"], dict)
    with pytest.raises(ValueError, match="no coded reference"):
        w.encode_atmosphere(a_np, schema="coded", refs=auto.refs)
    # zero-width frozen range + varying batch -> loud error
    cp = cloud_profiles(B, L)
    base = w.encode_cloud_profiles(cp, schema="coded")  # rei constant
    cp2 = dict(cp)
    cp2["rei"] = cp["rei"] + np.linspace(0, 5, B)[:, None].astype(
        np.float32)
    with pytest.raises(ValueError, match="zero range"):
        w.encode_cloud_profiles(cp2, refs=base.refs)
    # constant-on-the-range data stays fine
    again = w.encode_cloud_profiles(cp, refs=base.refs)
    assert np.array_equal(np.asarray(again.cols["rei"]),
                          np.asarray(base.cols["rei"]))


def test_wire_shard_save_load_roundtrip(atm, tmp_path):
    """On-disk shards (save_wire/load_wire) reproduce the encoded
    batches bit-for-bit — a stored shard IS the wire bytes."""
    from rrtmg_lw_tpu.utils.synthetic import make_mcica_clouds

    def assert_same(a, b):
        assert type(a) is type(b)
        if isinstance(a, w.CompactCloudsWire):
            assert np.array_equal(a.mask_bits, b.mask_bits)
            a, b = a.fields, b.fields
        assert set(a.cols) == set(b.cols)
        for k in a.cols:
            assert np.array_equal(a.cols[k], b.cols[k]), k
        assert set(a.refs) == set(b.refs)
        for k in a.refs:
            ra, rb = a.refs[k], b.refs[k]
            if ra is None:
                assert rb is None, k
            elif isinstance(ra, dict):
                assert np.array_equal(ra["uniform"], rb["uniform"]), k
            else:
                for x, y in zip(ra, rb):
                    assert np.array_equal(np.asarray(x),
                                          np.asarray(y)), k

    zeroed = atm._replace(covmr=jnp.zeros_like(jnp.asarray(atm.covmr)))
    enc_a = w.encode_atmosphere(zeroed)      # has zero+uniform+coded
    w.save_wire(tmp_path / "a.npz", enc_a)
    assert_same(enc_a, w.load_wire(tmp_path / "a.npz"))

    clouds = make_mcica_clouds(ncol=B, nlay=L, dtype=jnp.float32,
                               layout="compact")
    enc_c = w.encode_compact_clouds(clouds)
    w.save_wire(tmp_path / "c.npz", enc_c)
    assert_same(enc_c, w.load_wire(tmp_path / "c.npz"))

    # coded 'unit' (() refs) and 'linear' ((lo, hi) refs) channels —
    # cldfrac/rei/rel under a coded schema (regression: save_wire
    # unpacked every ref as a 3-tuple)
    cp = cloud_profiles(B, L)
    enc_p = w.encode_cloud_profiles(cp, schema="coded")
    w.save_wire(tmp_path / "p.npz", enc_p)
    loaded = w.load_wire(tmp_path / "p.npz")
    assert_same(enc_p, loaded)
    # and the loaded linear refs decode (2-tuple, not a fake 3-tuple)
    dec = w.decode_cloud_profiles(loaded, like=cp["cldfrac"])
    assert np.abs(np.asarray(dec["rei"]) - cp["rei"]).max() < 0.01


def test_native_encoder_matches_numpy(atm):
    """The C++ wirecodec (native/wirecodec.cc) must produce
    bit-identical codes/refs/ranges to the numpy reference encoders
    (same median, op order and round-half-even)."""
    from rrtmg_lw_tpu import native as nat

    if not nat.wire_available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(5)
    pos = np.abs(rng.lognormal(0.0, 1.5, (33, 17)))
    pos[rng.random((33, 17)) < 0.2] = 0.0         # zero holes
    temps = 250.0 + 40.0 * rng.random((34, 12))
    import rrtmg_lw_tpu.parallel.wire as w2
    for enc, x in ((w2._enc_logratio, pos), (w2._enc_delta, temps),
                   (w2._enc_delta, temps[:, 0])):   # 1-D (tsfc-like)
        os.environ["RRTMG_WIRE_NATIVE"] = "0"
        try:
            u_np, r_np = enc(x)
        finally:
            os.environ.pop("RRTMG_WIRE_NATIVE", None)
        u_nat, r_nat = enc(x)
        assert np.array_equal(u_np, u_nat)
        for a, b in zip(r_np, r_nat):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_wire_under_sharded_mesh(atm):
    """WireBatch shards over the 8-device mesh (codes on the columns
    axis, reference profiles replicated) through prefetch and a
    sharded step; fluxes match the single-device decode."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from rrtmg_lw_tpu import parallel as par
    from rrtmg_lw_tpu.ops.mcica import mcica_subcol_lw_compact

    mesh = par.make_mesh(jax.devices()[:8], spec=1)
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False))
    cp = cloud_profiles(B, L)
    enc = (w.encode_atmosphere(atm), w.encode_cloud_profiles(cp))
    key = jax.random.key(3)
    taua0 = jnp.asarray(atm.tauaer)

    def step_fn(ea, ec):
        a = w.decode_atmosphere(ea, taua0)
        c = w.decode_cloud_profiles(ec, like=a.play)
        clouds = mcica_subcol_lw_compact(
            key, 2, c["cldfrac"], c["ciwp"], c["clwp"], c["rei"],
            c["rel"])
        return model(a, clouds)

    ref = jax.jit(step_fn)(*enc)

    dev_batches = list(par.prefetch([enc], mesh, depth=2))
    assert len(dev_batches) == 1
    ea, ec = dev_batches[0]
    assert not ea.cols["tlay"].sharding.is_fully_replicated
    assert ea.refs["tlay"][0].sharding.is_fully_replicated
    out = jax.jit(step_fn, out_shardings=par.batch_sharding(mesh))(
        ea, ec)
    np.testing.assert_allclose(np.asarray(out.uflx),
                               np.asarray(ref.uflx), atol=2e-4)


def test_wire_is_at_least_2x_smaller(atm):
    cp = cloud_profiles(B, L)
    f32_bytes = (sum(np.asarray(v).nbytes
                     for k, v in atm._asdict().items() if k != "tauaer")
                 + sum(v.nbytes for v in cp.values()))
    wire_b = (w.wire_bytes(w.encode_atmosphere(atm))
              + w.wire_bytes(w.encode_cloud_profiles(cp)))
    assert wire_b * 2 <= f32_bytes, (wire_b, f32_bytes)
    # absolute: under 2.4 KB/column at nlay=60
    assert wire_b / B < 2400, wire_b / B


# ---------------------------------------------------------------------------
# adversarial ingest robustness: the wire is the
# production ingest boundary — corrupted/truncated/NaN-ref batches
# must produce FLAGGED, FINITE outputs, never NaN fluxes
# ---------------------------------------------------------------------------
def _corrupt_refs(enc, name, which):
    """Return a copy of ``enc`` with channel ``name``'s refs corrupted."""
    ref, lo, hi = enc.refs[name]
    bad = {"nan_ref": (np.full_like(np.asarray(ref), np.nan), lo, hi),
           "inf_lo": (ref, np.float32(-np.inf), hi),
           "nan_hi": (ref, lo, np.float32(np.nan)),
           "inverted": (ref, hi, lo) if float(hi) > float(lo)
           else (ref, np.float32(1.0), np.float32(0.0))}[which]
    refs = dict(enc.refs)
    refs[name] = bad
    return w.WireBatch(dict(enc.cols), refs)


@pytest.mark.parametrize("which", ["nan_ref", "inf_lo", "nan_hi",
                                   "inverted"])
def test_sanitized_decode_flags_corrupt_refs(atm, which):
    enc = _corrupt_refs(w.encode_atmosphere(atm), "play", which)
    dec, ok = jax.jit(lambda e, t: w.decode_atmosphere(
        e, t, sanitize=True))(enc, jnp.asarray(atm.tauaer))
    assert not np.asarray(ok).any()              # whole batch flagged
    for name in w.ATM_FIELDS:
        assert np.isfinite(np.asarray(getattr(dec, name))).all(), name
    # the corrupted channel fell back to the finite stand-in profile
    assert (np.asarray(dec.play) > 0).all()


def test_sanitized_decode_clean_batch_is_exact(atm):
    """On clean input the sanitize guards are exact pass-throughs."""
    enc = w.encode_atmosphere(atm)
    plain = w.decode_atmosphere(enc, jnp.asarray(atm.tauaer))
    dec, ok = w.decode_atmosphere(enc, jnp.asarray(atm.tauaer),
                                  sanitize=True)
    assert np.asarray(ok).all()
    for name in w.ATM_FIELDS:
        assert np.array_equal(np.asarray(getattr(dec, name)),
                              np.asarray(getattr(plain, name))), name


def test_no_nan_propagation_into_fluxes(atm):
    """End-to-end: NaN-ref atmosphere + corrupt cloud refs through the
    full model — fluxes finite, Fluxes.wire_ok False."""
    model = make_model(LWConfig(icld=2, imca=1, dtype="float32",
                                use_lut=False))
    from rrtmg_lw_tpu.ops.mcica import mcica_subcol_lw_compact
    cp = cloud_profiles(B, L)
    enc_a = _corrupt_refs(w.encode_atmosphere(atm), "tlay", "nan_ref")
    enc_c = _corrupt_refs(w.encode_cloud_profiles(cp), "ciwp",
                          "nan_hi")
    key = jax.random.key(3)

    @jax.jit
    def step(ea, ec, tauaer):
        a, ok_a = w.decode_atmosphere(ea, tauaer, sanitize=True)
        c, ok_c = w.decode_cloud_profiles(ec, like=a.play,
                                          sanitize=True)
        clouds = mcica_subcol_lw_compact(
            key, 2, c["cldfrac"], c["ciwp"], c["clwp"], c["rei"],
            c["rel"])
        fl = model(a, clouds)
        return fl._replace(wire_ok=ok_a & ok_c)

    fl = step(enc_a, enc_c, jnp.asarray(atm.tauaer))
    assert not np.asarray(fl.wire_ok).any()
    for name in ("uflx", "dflx", "hr", "uflxc", "dflxc", "hrc"):
        assert np.isfinite(np.asarray(getattr(fl, name))).all(), name


def test_sanitized_decode_floors_zero_pressure(atm):
    """Corrupted CODES (not refs): zero-sentinel codes in a logratio
    pressure channel decode to 0 hPa — physically impossible, feeds
    log() downstream.  Sanitize floors them and flags the columns."""
    enc = w.encode_atmosphere(atm)
    cols = dict(enc.cols)
    play = np.array(cols["play"])
    play[: B // 2] = 0                 # exact-zero sentinel everywhere
    cols["play"] = play
    dec, ok = w.decode_atmosphere(w.WireBatch(cols, dict(enc.refs)),
                                  jnp.asarray(atm.tauaer),
                                  sanitize=True)
    ok = np.asarray(ok)
    assert not ok[: B // 2].any() and ok[B // 2:].all()
    assert (np.asarray(dec.play) > 0).all()


def test_compact_clouds_sanitized_decode(atm):
    from rrtmg_lw_tpu.ops.mcica import mcica_subcol_lw_compact
    cp = cloud_profiles(B, L)
    clouds = mcica_subcol_lw_compact(
        jax.random.key(5), 2, jnp.asarray(cp["cldfrac"]),
        jnp.asarray(cp["ciwp"]), jnp.asarray(cp["clwp"]),
        jnp.asarray(cp["rei"]), jnp.asarray(cp["rel"]))
    clouds_h = jax.tree_util.tree_map(np.asarray, clouds)
    enc = w.encode_compact_clouds(clouds_h)
    refs = dict(enc.fields.refs)
    ref, lo, hi = refs["clwp"]
    refs["clwp"] = (np.full_like(np.asarray(ref), np.inf), lo, hi)
    bad = w.CompactCloudsWire(enc.mask_bits,
                              w.WireBatch(dict(enc.fields.cols), refs))
    dec, ok = w.decode_compact_clouds(bad, sanitize=True)
    assert not np.asarray(ok).any()
    assert np.isfinite(np.asarray(dec.clwp)).all()
    # mask is bit-packed uint8: survives untouched
    assert np.array_equal(np.asarray(dec.cldfmc),
                          np.asarray(clouds_h.cldfmc))


def test_validate_wire_catches_truncation(atm):
    enc = w.encode_atmosphere(atm)
    assert w.validate_wire(enc) == B

    # truncated channel: half the columns missing
    cols = dict(enc.cols)
    cols["tlay"] = np.asarray(cols["tlay"])[: B // 2]
    with pytest.raises(ValueError, match="batch dim"):
        w.validate_wire(w.WireBatch(cols, dict(enc.refs)))

    # dropped refs entry for present codes
    refs = dict(enc.refs)
    del refs["play"]
    with pytest.raises(ValueError, match="no refs entry"):
        w.validate_wire(w.WireBatch(dict(enc.cols), refs))

    # dropped codes for coded refs
    cols2 = dict(enc.cols)
    del cols2["play"]
    with pytest.raises(ValueError, match="codes are missing"):
        w.validate_wire(w.WireBatch(cols2, dict(enc.refs)))

    # wrong code dtype (bit-flipped container)
    cols3 = dict(enc.cols)
    cols3["play"] = np.asarray(cols3["play"]).astype(np.uint8)
    with pytest.raises(ValueError, match="uint16"):
        w.validate_wire(w.WireBatch(cols3, dict(enc.refs)))

    # refs arity mangled
    refs4 = dict(enc.refs)
    refs4["play"] = refs4["play"][:2]
    with pytest.raises(ValueError, match="arity"):
        w.validate_wire(w.WireBatch(dict(enc.cols), refs4))

    # unknown channel name
    cols5 = dict(enc.cols)
    refs5 = dict(enc.refs)
    cols5["bogus"] = cols5["play"]
    refs5["bogus"] = refs5["play"]
    with pytest.raises(ValueError, match="unknown channel"):
        w.validate_wire(w.WireBatch(cols5, refs5))


def test_validate_wire_compact_clouds(atm):
    from rrtmg_lw_tpu.ops.mcica import mcica_subcol_lw_compact
    cp = cloud_profiles(B, L)
    clouds = mcica_subcol_lw_compact(
        jax.random.key(7), 2, jnp.asarray(cp["cldfrac"]),
        jnp.asarray(cp["ciwp"]), jnp.asarray(cp["clwp"]),
        jnp.asarray(cp["rei"]), jnp.asarray(cp["rel"]))
    enc = w.encode_compact_clouds(
        jax.tree_util.tree_map(np.asarray, clouds))
    assert w.validate_wire(enc) == B
    # truncated mask (batch axis)
    bad = w.CompactCloudsWire(np.asarray(enc.mask_bits)[:, :, : B // 2],
                              enc.fields)
    with pytest.raises(ValueError, match="batch dim"):
        w.validate_wire(bad)
