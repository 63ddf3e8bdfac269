"""Compressed host->device streaming wire format.

A streaming deployment can be H2D-bound: the reference ships full-f64
text/array columns (rrtmg_lw.1col.f90:447), the device_gen pipeline
~4.8 KB/column of f32.  This wire format ships compact integer codes
and dequantizes on device INSIDE the jit step (fused elementwise ops,
negligible device cost):

* per-BATCH f32 reference profiles (one (L,) median profile per
  field — amortized over thousands of columns), plus
* per-column uint16 codes against that reference:
    - ``logratio``: u = quantized log(x / ref_level).  Smooth positive
      fields (pressures, gas vmr, water paths).  With a per-batch
      range of ~[-2, 2] nats the step is 6e-5 RELATIVE — far below
      f16's 4.9e-4 and uniform across magnitudes.  Code 0 is an exact
      zero sentinel (cloud water in clear layers, zero gas channels).
    - ``delta``: u = quantized (x - ref_level).  Temperatures: a
      +-30 K batch range gives 0.9 mK steps.
    - ``unit``: fixed [0, 1] quantization (cloud fraction,
      emissivity).
    - ``linear``: per-batch [lo, hi] quantization (particle sizes).
* all-zero channels (CFCs, CO in GCM feeds) ship as a 1-byte flag.

At nlay=60 with the 6 active gases this is ~1.8 KB/column — ~2.7x
less wire than device_gen — while the decoded fields land within
~1e-4 relative of the f32 originals (the flux impact is gated at
<= 1e-2 W/m^2 by tests/test_wire.py).

Encoding is host-side numpy (vectorized, runs on the prefetch
thread); decoding is jnp inside the step.  WireBatch is a pytree
whose ``cols`` shard over the columns mesh axis and whose ``refs``
replicate (mesh.shardings_for understands the layout).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from ..types import Atmosphere

_U16 = 65535.0


class WireBatch(NamedTuple):
    """cols: name -> (B, ...) uint16 codes (sharded over columns);
    refs: name -> small f32 reference/range arrays (replicated)."""
    cols: dict
    refs: dict


# ---------------------------------------------------------------------------
# host-side encoders (C++ via ctypes when available — bit-identical
# spec, see native/wirecodec.cc — else numpy)
# ---------------------------------------------------------------------------
def _native():
    if os.environ.get("RRTMG_WIRE_NATIVE", "1") == "0":
        return None
    from .. import native
    return native if native.wire_available() else None


def _check_frozen_width(lo, hi, values):
    """A zero-width frozen range is only usable when the data sits ON
    it (a genuinely constant channel; everything decodes to the
    constant).  Data varying beyond the range would silently saturate
    to a single value — raise instead (the refs were captured from a
    constant batch; re-capture from a representative varying one)."""
    width = hi - lo
    if width > 0.0:
        return
    v = np.asarray(values, np.float64)
    if v.size and (np.abs(v - lo).max() > 1e-9 + 1e-6 * abs(lo)):
        raise ValueError(
            "frozen wire refs have zero range but this batch varies "
            "across it — the refs were captured from a constant "
            "batch; capture them from a representative varying batch "
            "(or leave the channel uniform)")


def _enc_logratio(x, frozen=None):
    """(codes uint16, refs (ref_level, lo, hi)).  Code 0 == exact 0.

    ``frozen``: a refs tuple from a previous batch (or climatology) —
    codes are then computed against those FIXED references/ranges
    (values outside the range saturate at the range edges), making
    codes deterministic across batches and hosts (the multi-host
    contract: every host must quantize against the same refs)."""
    if frozen is not None:
        ref32, lo, hi = frozen
        ref = np.asarray(ref32, np.float64)
        x = np.asarray(x, np.float64)
        pos = x > 0.0
        lo, hi = float(lo), float(hi)
        _check_frozen_width(lo, hi, np.where(pos, np.log(
            np.where(pos, x, 1.0) / ref), lo))
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.where(pos, np.log(x / ref), 0.0)
        u = np.clip(np.rint((r - lo) / max(hi - lo, 1e-300)
                            * (_U16 - 1.0)),
                    0, _U16 - 1.0).astype(np.int64) + 1
        u = np.where(pos, u, 0)
        return u.astype(np.uint16), frozen
    nat = _native()
    if nat is not None and np.ndim(x) >= 1:
        u, ref, lo, hi, _npos = nat.wire_enc_logratio(
            np.asarray(x, np.float64))
        return u, (ref.astype(np.float32), np.float32(lo),
                   np.float32(hi))
    x = np.asarray(x, np.float64)
    ref = np.median(x, axis=0)                    # (L,) or ()
    pos = x > 0.0
    ref = np.where(ref > 0.0, ref,
                   np.where(pos, x, 1.0).max(axis=0))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.where(pos, np.log(x / ref), 0.0)
    rv = r[pos] if pos.any() else np.zeros(1)
    lo, hi = float(rv.min()), float(rv.max())
    hi = max(hi, lo + 1e-12)
    u = np.rint((r - lo) / (hi - lo) * (_U16 - 1.0)).astype(np.int64) + 1
    u = np.where(pos, u, 0)
    return u.astype(np.uint16), (ref.astype(np.float32),
                                 np.float32(lo), np.float32(hi))


def _enc_delta(x, frozen=None):
    if frozen is not None:
        ref32, lo, hi = frozen
        d = np.asarray(x, np.float64) - np.asarray(ref32, np.float64)
        lo, hi = float(lo), float(hi)
        _check_frozen_width(lo, hi, d)
        u = np.clip(np.rint((d - lo) / max(hi - lo, 1e-300) * _U16),
                    0, _U16).astype(np.uint16)
        return u, frozen
    nat = _native()
    if nat is not None and np.ndim(x) >= 1:
        u, ref, lo, hi, _ = nat.wire_enc_delta(np.asarray(x, np.float64))
        return u, (ref.astype(np.float32), np.float32(lo),
                   np.float32(hi))
    x = np.asarray(x, np.float64)
    ref = np.median(x, axis=0)
    d = x - ref
    lo, hi = float(d.min()), float(d.max())
    hi = max(hi, lo + 1e-12)
    u = np.rint((d - lo) / (hi - lo) * _U16).astype(np.uint16)
    return u, (ref.astype(np.float32), np.float32(lo), np.float32(hi))


def _enc_unit(x, frozen=None):
    u = np.rint(np.clip(np.asarray(x, np.float64), 0.0, 1.0) * _U16)
    return u.astype(np.uint16), ()


def _enc_linear(x, frozen=None):
    x = np.asarray(x, np.float64)
    if frozen is not None:
        lo, hi = float(frozen[0]), float(frozen[1])
        _check_frozen_width(lo, hi, x)
        u = np.clip(np.rint((x - lo) / max(hi - lo, 1e-300) * _U16),
                    0, _U16).astype(np.uint16)
        return u, frozen
    lo, hi = float(x.min()), float(x.max())
    hi = max(hi, lo + 1e-12)
    u = np.rint((x - lo) / (hi - lo) * _U16).astype(np.uint16)
    return u, (np.float32(lo), np.float32(hi))


# ---------------------------------------------------------------------------
# structural validation (host-side, at the ingest boundary)
# ---------------------------------------------------------------------------
def _validate_batch(fields, wire, where):
    B = None
    for name, u in wire.cols.items():
        u = np.asarray(u)
        if u.dtype != np.uint16:
            raise ValueError(f"{where}: channel {name!r} codes have "
                             f"dtype {u.dtype}, expected uint16")
        if u.ndim < 1 or u.shape[0] == 0:
            raise ValueError(f"{where}: channel {name!r} codes are "
                             f"empty/scalar (shape {u.shape}) — "
                             "truncated batch?")
        if B is None:
            B = u.shape[0]
        elif u.shape[0] != B:
            raise ValueError(
                f"{where}: channel {name!r} has batch dim "
                f"{u.shape[0]} but other channels have {B} — "
                "truncated batch")
        if name not in wire.refs:
            raise ValueError(f"{where}: channel {name!r} has codes "
                             "but no refs entry")
    for name, r in wire.refs.items():
        kind = fields.get(name)
        if kind is None:
            raise ValueError(f"{where}: unknown channel {name!r}")
        if r is None or isinstance(r, dict):
            continue                    # zero / uniform: no codes
        if kind == "unit":
            if len(r) != 0:
                raise ValueError(f"{where}: unit channel {name!r} "
                                 f"carries refs {r!r}")
        elif kind == "linear":
            if len(r) != 2:
                raise ValueError(f"{where}: linear channel {name!r} "
                                 f"refs arity {len(r)} != 2")
        elif len(r) != 3:
            raise ValueError(f"{where}: {kind} channel {name!r} "
                             f"refs arity {len(r)} != 3")
        if name not in wire.cols:
            raise ValueError(f"{where}: coded channel {name!r} has "
                             "refs but its codes are missing — "
                             "truncated batch")
    return B


def validate_wire(wire, *, fields=None) -> int:
    """Structural validation of an incoming WireBatch /
    CompactCloudsWire at the host ingest boundary (BEFORE device_put):
    code dtypes, refs arity, per-channel batch-dim consistency, known
    channel names.  Raises ValueError naming the offending channel;
    returns the batch size.  Value-level corruption (NaN/Inf refs,
    inverted ranges) is the in-jit ``sanitize=True`` decode path's
    job — a device-resident pipeline never re-hosts refs to check
    them."""
    if isinstance(wire, CompactCloudsWire):
        bits = np.asarray(wire.mask_bits)
        if bits.dtype != np.uint8 or bits.ndim != 3:
            raise ValueError(
                f"compact-clouds wire: mask_bits dtype/ndim "
                f"{bits.dtype}/{bits.ndim}, expected uint8 (L, G/8, B)")
        B = _validate_batch(COMPACT_CLOUD_FIELDS, wire.fields,
                            "compact-clouds wire")
        if B is not None and bits.shape[2] != B:
            raise ValueError(
                f"compact-clouds wire: mask batch dim {bits.shape[2]} "
                f"!= field batch dim {B} — truncated batch")
        return bits.shape[2]
    known = dict(ATM_FIELDS)
    known.update(CLOUD_FIELDS)
    B = _validate_batch(fields or known, wire, "wire batch")
    if B is None:
        raise ValueError("wire batch has no per-column codes — pass "
                         "fields= if every channel is zero/uniform")
    return B


# ---------------------------------------------------------------------------
# device-side decoders (jnp, inside jit)
# ---------------------------------------------------------------------------
def _dec_logratio(u, refs, dtype):
    ref, lo, hi = refs
    r = lo + (u.astype(dtype) - 1.0) * ((hi - lo) / (_U16 - 1.0))
    return jnp.where(u == 0, 0.0, ref.astype(dtype) * jnp.exp(r)
                     ).astype(dtype)


def _dec_delta(u, refs, dtype):
    ref, lo, hi = refs
    return (ref.astype(dtype) + lo
            + u.astype(dtype) * ((hi - lo) / _U16)).astype(dtype)


def _dec_unit(u, refs, dtype):
    return (u.astype(dtype) / _U16).astype(dtype)


def _dec_linear(u, refs, dtype):
    lo, hi = refs
    return (lo + u.astype(dtype) * ((hi - lo) / _U16)).astype(dtype)


_CODECS = {"logratio": (_enc_logratio, _dec_logratio),
           "delta": (_enc_delta, _dec_delta),
           "unit": (_enc_unit, _dec_unit),
           "linear": (_enc_linear, _dec_linear)}

# field -> codec kind
ATM_FIELDS = {
    "play": "logratio", "plev": "logratio",
    "tlay": "delta", "tlev": "delta", "tsfc": "delta",
    "h2ovmr": "logratio", "co2vmr": "logratio", "o3vmr": "logratio",
    "n2ovmr": "logratio", "covmr": "logratio", "ch4vmr": "logratio",
    "o2vmr": "logratio", "cfc11vmr": "logratio",
    "cfc12vmr": "logratio", "cfc22vmr": "logratio",
    "ccl4vmr": "logratio",
    "emis": "unit",
}
CLOUD_FIELDS = {
    "cldfrac": "unit", "ciwp": "logratio", "clwp": "logratio",
    "rei": "linear", "rel": "linear",
}


def _encode(fields, tree_dict, schema=None, frozen=None):
    """schema: None (auto-detect zero/uniform/coded per channel — the
    smallest wire, but the WireBatch PYTREE STRUCTURE then depends on
    the data, and a channel changing category between batches retraces
    the consuming jit), or "coded" (every present channel fully
    encoded — stable structure for streams), or a {name: mode} dict
    captured from a representative batch via ``schema_of`` (raises on
    violation instead of silently changing structure).

    frozen: a previous WireBatch.refs — coded channels are then
    quantized against those FIXED references/ranges (out-of-range
    values saturate), so codes are deterministic across batches AND
    across hosts (every host of a multi-host mesh must pass the same
    refs; per-batch medians would differ per host).  Implies the
    frozen batch's schema unless one is given."""
    if frozen is not None and schema is None:
        schema = {name: ("zero" if r is None
                         else "uniform" if isinstance(r, dict)
                         else "coded")
                  for name, r in frozen.items()}
    if schema == "coded":
        schema = {name: "coded" for name in fields}
    cols, refs = {}, {}
    _MISSING = object()
    for name, kind in fields.items():
        if name not in tree_dict:
            continue
        x = np.asarray(tree_dict[name])
        mode = (schema or {}).get(name)
        if mode is None:
            # auto-detect (two full-array scans — skipped when the
            # schema pins the mode, keeping the hot coded path at one
            # pass on the prefetch thread)
            mode = ("zero" if not x.any()
                    else "uniform" if (x.ndim > 1
                                       and bool((x == x[:1]).all()))
                    else "coded")
        if mode == "zero":
            if x.any():
                raise ValueError(
                    f"wire schema violation: channel {name!r} is "
                    "declared all-zero but this batch has data "
                    "(re-capture the schema; the consuming jit must "
                    "recompile for the new structure)")
            refs[name] = None          # all-zero channel: flag only
        elif mode == "uniform":
            if not (x.ndim > 1 and bool((x == x[:1]).all())):
                raise ValueError(
                    f"wire schema violation: channel {name!r} is "
                    "declared column-uniform but this batch varies "
                    "per column (re-capture the schema)")
            # column-uniform channel (well-mixed gases in GCM feeds,
            # constant particle sizes): ship ONE exact f32 row per
            # batch, zero bytes per column
            refs[name] = {"uniform": x[0].astype(np.float32)}
        else:
            enc, _ = _CODECS[kind]
            fz = None
            if frozen is not None and kind != "unit":
                fz = frozen.get(name, _MISSING)
                if fz is _MISSING or fz is None or isinstance(fz, dict):
                    # silently re-ranging per batch/host would defeat
                    # the determinism contract refs= exists for
                    raise ValueError(
                        f"refs= has no coded reference for channel "
                        f"{name!r} (it was "
                        f"{'absent' if fz is _MISSING else 'zero/uniform'} "
                        "in the captured batch) — capture refs with "
                        "schema='coded' from a representative varying "
                        "batch")
            cols[name], refs[name] = enc(x, frozen=fz)
    return WireBatch(cols, refs)


def schema_of(wire: WireBatch) -> dict:
    """{channel: 'zero' | 'uniform' | 'coded'} of an encoded batch —
    pass to encode_* to pin the pytree structure across a stream."""
    return {name: ("zero" if r is None
                   else "uniform" if isinstance(r, dict) else "coded")
            for name, r in wire.refs.items()}


def _refs_ok(r):
    """Scalar bool (in-jit): this channel's references are finite and
    its quantization range is ordered.  Corrupt refs poison every
    decoded element of the batch, so the granularity is per-channel."""
    if r is None or (not isinstance(r, dict) and len(r) == 0):
        return jnp.asarray(True)
    if isinstance(r, dict):
        return jnp.isfinite(jnp.asarray(r["uniform"],
                                        jnp.float32)).all()
    if len(r) == 2:
        lo = jnp.asarray(r[0], jnp.float32)
        hi = jnp.asarray(r[1], jnp.float32)
        return jnp.isfinite(lo) & jnp.isfinite(hi) & (hi >= lo)
    ref, lo, hi = (jnp.asarray(x, jnp.float32) for x in r)
    return (jnp.isfinite(ref).all() & jnp.isfinite(lo)
            & jnp.isfinite(hi) & (hi >= lo))


def _decode(fields, wire, shape_of, dtype, sanitize=False,
            floors=None, fallback_of=None, ok_out=None):
    """``sanitize``: guard every decoded channel — non-finite values,
    values at/below the field's physical floor (``floors``), or any
    value decoded from corrupt refs are replaced by the field's finite
    fallback and the affected columns are recorded in ``ok_out`` (a
    dict of (B,) bools).  On clean input the guards are exact
    pass-throughs (fused elementwise selects, negligible device
    cost)."""
    out = {}
    for name, kind in fields.items():
        if name not in wire.refs:
            continue
        r = wire.refs[name]
        if r is None:
            out[name] = jnp.zeros(shape_of(name), dtype)
            continue                   # exact zeros: nothing to guard
        if isinstance(r, dict):        # uniform channel
            x = jnp.broadcast_to(r["uniform"].astype(dtype),
                                 shape_of(name))
        else:
            _, dec = _CODECS[kind]
            x = dec(wire.cols[name], r, dtype)
        if sanitize:
            cok = _refs_ok(r)
            bad = ~jnp.isfinite(x)
            floor = (floors or {}).get(name)
            if floor is not None:
                bad = bad | (x <= floor)
            fb = (fallback_of(name, x.shape, dtype) if fallback_of
                  else jnp.zeros_like(x))
            x = jnp.where(bad | ~cok, fb, x)
            col_ok = cok & ~bad.reshape(x.shape[0], -1).any(axis=1)
            if ok_out is not None:
                ok_out[name] = col_ok
        out[name] = x
    return out


def encode_atmosphere(atm, schema=None, refs=None) -> WireBatch:
    """Atmosphere (or its field dict; host numpy/jax arrays, f32/f64)
    -> WireBatch.  ``tauaer`` is intentionally NOT shipped (the device
    keeps a resident aerosol state; pass it to decode_atmosphere).
    ``schema``/``refs``: see _encode — pin them across a stream (and
    across hosts) for a stable jit signature and deterministic
    codes."""
    d = atm if isinstance(atm, dict) else atm._asdict()
    d = {k: v for k, v in d.items() if k != "tauaer"}
    return _encode(ATM_FIELDS, d, schema, refs)


# physical floors for sanitized decode: values at/below these feed
# logs/divisions downstream (setcoef's log(pavel), Planck temperature
# indexing), so they are corruption, not data
_ATM_FLOORS = {"play": 0.0, "tlay": 0.0, "tlev": 0.0, "tsfc": 0.0}


def _atm_fallback(name, shape, dtype):
    """A finite, physically valid stand-in per field: corrupted
    channels decode to a standard-ish column (monotone pressure grid,
    temperate profile) so the radiation step stays finite end-to-end;
    the wire_ok flag records which columns were replaced."""
    if name == "plev":
        prof = jnp.linspace(1013.0, 1e-2, shape[1], dtype=dtype)
        return jnp.broadcast_to(prof, shape)
    if name == "play":
        edges = jnp.linspace(1013.0, 1e-2, shape[1] + 1, dtype=dtype)
        return jnp.broadcast_to(0.5 * (edges[:-1] + edges[1:]), shape)
    if name in ("tlay", "tlev"):
        return jnp.full(shape, 250.0, dtype)
    if name == "tsfc":
        return jnp.full(shape, 288.0, dtype)
    if name == "emis":
        return jnp.ones(shape, dtype)
    return jnp.zeros(shape, dtype)     # gas vmr: zero is valid input


def decode_atmosphere(wire: WireBatch, tauaer, dtype=jnp.float32, *,
                      sanitize: bool = False):
    """-> Atmosphere, or (Atmosphere, ok) with ``sanitize=True``.

    ``sanitize`` hardens the production ingest boundary: corrupted
    wire content (NaN/Inf references, inverted quantization ranges,
    codes decoding to nonpositive pressures/temperatures) is replaced
    per channel by finite fallback profiles and ``ok`` — a (B,) bool,
    False for affected columns — is returned for the step to thread
    into ``Fluxes.wire_ok``.  The reference would hard-stop on bad
    input (e.g. rrtmg_lw_cldprmc.f90:204); a jitted streaming step
    cannot, so flag-and-continue is the batched contract."""
    # shapes from the device-resident aerosol state: every wire
    # channel may be uniform/zero, so cols can't be the shape source
    B, L = tauaer.shape[:2]

    def shape_of(name):
        return {"tsfc": (B,), "emis": (B, 16),
                "plev": (B, L + 1), "tlev": (B, L + 1)}.get(name, (B, L))

    ok_out = {} if sanitize else None
    d = _decode(ATM_FIELDS, wire, shape_of, dtype, sanitize=sanitize,
                floors=_ATM_FLOORS, fallback_of=_atm_fallback,
                ok_out=ok_out)
    atm = Atmosphere(tauaer=tauaer, **d)
    if not sanitize:
        return atm
    ok = jnp.ones((B,), bool)
    for v in ok_out.values():
        ok = ok & v
    return atm, ok


def encode_cloud_profiles(cp: dict, schema=None, refs=None
                          ) -> WireBatch:
    """(B, L) cloud profile fields {cldfrac, ciwp, clwp, rei, rel}
    (the device-side McICA generator's inputs) -> WireBatch."""
    return _encode(CLOUD_FIELDS, cp, schema, refs)


def decode_cloud_profiles(wire: WireBatch, dtype=jnp.float32, *,
                          like=None, sanitize: bool = False):
    """``like``: any (B, L) array supplying the output shape (e.g.
    the decoded atmosphere's ``play``) — required when EVERY cloud
    channel is zero/uniform (a fully clear or constant-cloud batch
    ships no per-column codes at all).

    ``sanitize``: guard against corrupt refs (see decode_atmosphere);
    returns (dict, ok (B,) bool).  Cloud fallbacks are all-clear
    (zeros) — particle-size range violations downstream are
    cldprmc's own clamp+flag domain (Fluxes.cld_bounds_ok)."""
    if like is not None:
        shape = like.shape
    elif wire.cols:
        shape = next(iter(wire.cols.values())).shape
    else:
        raise ValueError(
            "decode_cloud_profiles: no per-column codes in this batch "
            "(all channels zero/uniform) — pass like=<any (B, L) "
            "array> for the output shape")
    ok_out = {} if sanitize else None
    d = _decode(CLOUD_FIELDS, wire, lambda name: shape, dtype,
                sanitize=sanitize, ok_out=ok_out)
    if not sanitize:
        return d
    ok = jnp.ones((shape[0],), bool)
    for v in ok_out.values():
        ok = ok & v
    return d, ok


# ---------------------------------------------------------------------------
# host-generated McICA sub-columns (the reference GCM contract takes
# cldfmcl as an INPUT, rrtmg_lw_rad.f90:117): bit-packed mask wire
# ---------------------------------------------------------------------------
class CompactCloudsWire(NamedTuple):
    """McicaCloudsCompact on the wire: the binary sub-column mask
    bit-packed 8-to-1 (columns stay on the last axis, like the blocked
    layouts) + the per-layer water/size fields as uint16 codes.
    ~1.4 KB/col at nlay=60 vs ~9.6 KB for the int8-mask compact form."""
    mask_bits: object          # (L, NGPT_PAD // 8, B) uint8
    fields: WireBatch          # ciwp/clwp (logratio), reic/relq (linear)


COMPACT_CLOUD_FIELDS = {"ciwp": "logratio", "clwp": "logratio",
                        "reicmc": "linear", "relqmc": "linear"}


def encode_compact_clouds(clouds, schema=None) -> CompactCloudsWire:
    """McicaCloudsCompact (host arrays) -> CompactCloudsWire.  The
    mask packs losslessly (bitorder little: g-point 8*b + k is bit k
    of byte b); water paths/particle sizes go through the standard
    uint16 codecs."""
    mask = np.asarray(clouds.cldfmc)
    bits = np.packbits(mask.astype(bool), axis=1, bitorder="little")
    d = {k: np.asarray(getattr(clouds, k))
         for k in COMPACT_CLOUD_FIELDS}
    return CompactCloudsWire(bits, _encode(COMPACT_CLOUD_FIELDS, d,
                                           schema))


def decode_compact_clouds(wire: CompactCloudsWire, dtype=jnp.float32,
                          mask_dtype=None, *, sanitize: bool = False):
    """-> McicaCloudsCompact (or (clouds, ok (B,) bool) with
    ``sanitize=True``), unpacking the mask on device (cheap
    elementwise shifts, fused into the step).  The bit-packed mask
    itself cannot encode non-finite values; corruption enters through
    the uint16 field refs, which sanitize guards."""
    from ..types import McicaCloudsCompact
    bits = wire.mask_bits
    L, nb, B = bits.shape
    shifts = jnp.arange(8, dtype=jnp.uint8)[None, None, :, None]
    mask = ((bits[:, :, None, :] >> shifts) & 1).reshape(L, nb * 8, B)
    mask = mask.astype(jnp.int8 if mask_dtype is None else mask_dtype)
    like = jnp.zeros((B, L), dtype)
    ok_out = {} if sanitize else None
    d = _decode(COMPACT_CLOUD_FIELDS, wire.fields,
                lambda name: like.shape, dtype, sanitize=sanitize,
                ok_out=ok_out)
    clouds = McicaCloudsCompact(cldfmc=mask, **d)
    if not sanitize:
        return clouds
    ok = jnp.ones((B,), bool)
    for v in ok_out.values():
        ok = ok & v
    return clouds, ok


# ---------------------------------------------------------------------------
# on-disk shard format: encoded batches persist as single .npz files
# (the batched replacement for the reference's per-column text
# decks as a bulk input format — rrtmg_lw.1col.f90:447; a stored
# shard is byte-for-byte what crosses the wire)
# ---------------------------------------------------------------------------
def save_wire(path, wire) -> None:
    """Persist a WireBatch or CompactCloudsWire to ``path`` (.npz)."""
    flat = {}
    if isinstance(wire, CompactCloudsWire):
        flat["__kind__"] = np.array("compact_clouds")
        flat["mask_bits"] = np.asarray(wire.mask_bits)
        wb = wire.fields
    else:
        flat["__kind__"] = np.array("batch")
        wb = wire
    for k, v in wb.cols.items():
        flat[f"c:{k}"] = np.asarray(v)
    for k, r in wb.refs.items():
        if r is None:
            flat[f"z:{k}"] = np.array(0, np.uint8)
        elif isinstance(r, dict):
            flat[f"u:{k}"] = np.asarray(r["uniform"])
        elif len(r) == 0:              # unit codec: fixed range
            flat[f"e:{k}"] = np.array(0, np.uint8)
        elif len(r) == 2:              # linear codec: (lo, hi)
            flat[f"s:{k}"] = np.array(r, np.float32)
        else:                          # logratio/delta: (ref, lo, hi)
            ref, lo, hi = r
            flat[f"r:{k}"] = np.asarray(ref)
            flat[f"s:{k}"] = np.array([lo, hi], np.float32)
    np.savez(path, **flat)


def load_wire(path):
    """Load a shard saved by ``save_wire`` (WireBatch or
    CompactCloudsWire, host numpy — ready for prefetch/device_put)."""
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["__kind__"])
        cols, refs = {}, {}
        has_r = {k.partition(":")[2] for k in z.files
                 if k.startswith("r:")}
        for k in z.files:
            tag, _, name = k.partition(":")
            if tag == "c":
                cols[name] = z[k]
            elif tag == "z":
                refs[name] = None
            elif tag == "u":
                refs[name] = {"uniform": z[k]}
            elif tag == "e":
                refs[name] = ()
            elif tag == "r":
                s = z[f"s:{name}"]
                refs[name] = (z[k], np.float32(s[0]), np.float32(s[1]))
            elif tag == "s" and name not in has_r:
                refs[name] = (np.float32(z[k][0]), np.float32(z[k][1]))
        wb = WireBatch(cols, refs)
        if kind == "compact_clouds":
            return CompactCloudsWire(z["mask_bits"], wb)
    return wb


def wire_bytes(wire) -> int:
    if isinstance(wire, CompactCloudsWire):
        return (int(np.asarray(wire.mask_bits).nbytes)
                + wire_bytes(wire.fields))
    n = sum(int(np.asarray(v).nbytes) for v in wire.cols.values())
    for r in wire.refs.values():
        if r is None:
            n += 1
        elif isinstance(r, dict):
            n += int(np.asarray(r["uniform"]).nbytes)
        else:
            n += sum(int(np.asarray(x).nbytes) for x in r)
    return n
