#!/usr/bin/env python
"""Build static data assets for rrtmg_lw_tpu from the reference source.

Extracts the numeric tables embedded as Fortran data statements in the
reference (AER-RC/RRTMG_LW) into ``rrtmg_lw_tpu/assets/static_tables.npz``:

  * Planck integrals        totplnk(181,16), totplk16(181) and d/dT
                            variants             [rrtmg_lw_setcoef.f90:600-2009]
  * reference atmosphere    pref/preflog/tref(59), chi_mls(7,59)
                                                  [rrtmg_lw_setcoef.f90:437-597]
  * band metadata           wavenum1/2, delwave, nspa, nspb
                                                  [rrtmg_lw_init.f90:215-228]
  * g-point reduction maps  ngc/ngs/ngm/ngn/ngb, wt
                                                  [rrtmg_lw_init.f90:325-380]
  * cloud optics tables     absice0/1/2/3, absliq1, abscld1, absliq0
                                                  [rrtmg_lw_init.f90:2037-2675]

These are *data* (model physics coefficients), extracted rather than
re-typed so they match the reference bit-for-bit.

Usage:  python tools/build_assets.py [--reference /root/reference]
                                     [--nc rrtmg_lw.nc | --kg rrtmg_lw_k_g.f90]

With --nc / --kg it additionally converts the public k-table blob
(either form — the reference's KGSRC=nc|dat switch,
build/makefiles/make_rrtmg_lw_linux_pgi:13) into
``assets/ktables_real.npz``; the model then loads real data
automatically and the golden harness gates against the committed
run_examples_std_atm outputs.
"""

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from rrtmg_lw_tpu.data.fparse import FortranArrays, strip_fortran  # noqa: E402


def build_static_tables(ref: pathlib.Path) -> dict:
    setcoef = strip_fortran((ref / "src/rrtmg_lw_setcoef.f90").read_text())
    init = strip_fortran((ref / "src/rrtmg_lw_init.f90").read_text())

    fa = FortranArrays()
    fa.declare("pref", [(1, 59)])
    fa.declare("preflog", [(1, 59)])
    fa.declare("tref", [(1, 59)])
    fa.declare("chi_mls", [(1, 7), (1, 59)])
    fa.declare("totplnk", [(1, 181), (1, 16)])
    fa.declare("totplk16", [(1, 181)])
    fa.declare("totplnkderiv", [(1, 181), (1, 16)])
    fa.declare("totplk16deriv", [(1, 181)])
    fa.fill_from(setcoef)

    fb = FortranArrays()
    fb.declare("wavenum1", [(1, 16)])
    fb.declare("wavenum2", [(1, 16)])
    fb.declare("delwave", [(1, 16)])
    fb.declare("ng", [(1, 16)])
    fb.declare("nspa", [(1, 16)])
    fb.declare("nspb", [(1, 16)])
    fb.declare("ngc", [(1, 16)])
    fb.declare("ngs", [(1, 16)])
    fb.declare("ngm", [(1, 256)])
    fb.declare("ngn", [(1, 140)])
    fb.declare("ngb", [(1, 140)])
    fb.declare("wt", [(1, 16)])
    fb.declare("absice0", [(1, 2)])
    fb.declare("absice1", [(1, 2), (1, 5)])
    fb.declare("absice2", [(1, 43), (1, 16)])
    fb.declare("absice3", [(1, 46), (1, 16)])
    fb.declare("absliq1", [(1, 58), (1, 16)])
    fb.fill_from(init)
    fb.fill_from(init, names=["abscld1", "absliq0"])

    out = {}
    for k in ("pref", "preflog", "tref", "chi_mls", "totplnk", "totplk16",
              "totplnkderiv", "totplk16deriv"):
        out[k] = fa.get(k)
    for k in ("wavenum1", "wavenum2", "delwave", "ng", "nspa", "nspb",
              "ngc", "ngs", "ngm", "ngn", "ngb", "wt",
              "absice0", "absice1", "absice2", "absice3", "absliq1"):
        out[k] = fb.get(k)
    out["abscld1"] = np.float64(fb.scalars["abscld1"])
    out["absliq0"] = np.float64(fb.scalars["absliq0"])

    for k in ("ng", "nspa", "nspb", "ngc", "ngs", "ngm", "ngn", "ngb"):
        out[k] = out[k].astype(np.int32)

    # sanity: consistency with parrrtm.f90 / rrlw_wvn.f90 contracts
    assert out["ngc"].sum() == 140 and out["ngs"][-1] == 140
    assert out["ngn"].sum() == 256
    assert np.all(np.diff(out["totplnk"], axis=0) > 0), "totplnk not monotonic"
    assert abs(out["wt"].sum() - 1.0) < 1e-6
    return out


def verify_manifest(path) -> int:
    """Structural pre-flight for a real k-data blob.

    Loads the candidate ``rrtmg_lw.nc`` / ``rrtmg_lw_k_g.f90`` with the
    production readers and checks every band's original arrays against
    the ``rrlw_kg01..16.f90`` declarations (shape registry
    ``data/ktables.original_shapes``; e.g. kao(9,5,13,no3),
    kbo(5,5,13:59,no3), selfrefo(10,noN)), plus dtype/finiteness and
    value-sanity warnings.  On success prints the golden-gate command
    so the 14 run_examples_std_atm flux values can finally be gated.
    Returns a process exit code."""
    from rrtmg_lw_tpu.data import ktables as kt

    p = pathlib.Path(path)
    loader = (kt.load_netcdf_original_tables
              if p.suffix.lower() == ".nc"
              else kt.load_fortran_original_tables)
    try:
        orig = loader(p)
    except Exception as e:
        print(f"FAIL: loader rejected {p.name}: {type(e).__name__}: {e}")
        return 1
    nbad = nwarn = narr = 0
    for b in range(1, 17):
        want = kt.original_shapes(b)
        have = orig.get(b, {})
        for name, shp in want.items():
            narr += 1
            a = have.get(name)
            if a is None:
                print(f"FAIL band {b:2d} {name}: missing")
                nbad += 1
                continue
            a = np.asarray(a)
            if tuple(a.shape) != tuple(shp):
                print(f"FAIL band {b:2d} {name}: shape {a.shape} != "
                      f"declared {shp}")
                nbad += 1
                continue
            if not np.issubdtype(a.dtype, np.floating):
                print(f"FAIL band {b:2d} {name}: dtype {a.dtype}")
                nbad += 1
                continue
            if not np.isfinite(a).all():
                print(f"FAIL band {b:2d} {name}: non-finite values")
                nbad += 1
                continue
            if name.startswith("fracref"):
                s = a.sum(axis=0)  # g axis first for fracs
                if not np.allclose(s, 1.0, atol=0.2):
                    print(f"WARN band {b:2d} {name}: per-eta g-sum "
                          f"outside [0.8, 1.2] (min {s.min():.3f}, "
                          f"max {s.max():.3f})")
                    nwarn += 1
            elif (a < 0).any():
                print(f"WARN band {b:2d} {name}: "
                      f"{int((a < 0).sum())} negative entries")
                nwarn += 1
    print(f"checked {narr} arrays over 16 bands: "
          f"{nbad} failures, {nwarn} warnings")
    if nbad:
        return 1
    flag = "--nc" if p.suffix.lower() == ".nc" else "--kg"
    print("manifest OK — to build the real asset and gate the goldens:")
    print(f"  python tools/build_assets.py {flag} {p}")
    print("  python tools/run_goldens.py --all  "
          "# value gates: <=0.5 W/m2 flux, <=0.1 K/day heating")
    return 0


def main():  # noqa: C901
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference", default="/root/reference")
    ap.add_argument("--out", default=None)
    ap.add_argument("--nc", default=None,
                    help="path to the public rrtmg_lw.nc k-data")
    ap.add_argument("--kg", default=None,
                    help="path to the public rrtmg_lw_k_g.f90 k-data")
    ap.add_argument("--verify-manifest", default=None, metavar="PATH",
                    help="structural pre-flight of a real k-data blob "
                         "(.nc or k_g.f90): shapes/dtypes vs the "
                         "rrlw_kg declarations; prints the golden-gate "
                         "command on success")
    args = ap.parse_args()

    if args.verify_manifest:
        sys.exit(verify_manifest(args.verify_manifest))

    ref = pathlib.Path(args.reference)
    out_path = pathlib.Path(args.out) if args.out else (
        pathlib.Path(__file__).resolve().parents[1]
        / "rrtmg_lw_tpu/assets/static_tables.npz")

    tables = build_static_tables(ref)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **tables)
    total = sum(v.size for v in tables.values() if hasattr(v, "size"))
    print(f"wrote {out_path} ({len(tables)} arrays, {total} values)")

    if args.nc or args.kg:
        from rrtmg_lw_tpu.data import ktables as kt
        if args.nc:
            kt.build_real_asset_from_netcdf(args.nc)
            src = args.nc
        else:
            kt.build_real_asset_from_k_g(args.kg)
            src = args.kg
        print(f"wrote assets/ktables_real.npz (from {src})")


if __name__ == "__main__":
    main()
