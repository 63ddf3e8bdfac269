"""De-circularized k-data converter cross-check.

The round-1 netCDF test built its synthetic file by inverting the
loader's own transposes, so it could only catch self-inconsistency.
Here ONE shared synthetic table set is encoded through two INDEPENDENT
writers —

  * :mod:`rrtmg_lw_tpu.data.kgwrite`: k_g.f90 text in the reference's
    free-form assignment styles (column-major value streams, per-slice
    and whole-array reshape forms, kbo's 13:59 jp bound), and
  * :mod:`rrtmg_lw_tpu.data.ncwrite`: a NetCDF3 file whose dimension
    order is transcribed from rrtmg_lw_read_nc.f90's nf90_get_var
    count= lists (NOT from the loader) —

and decoded by the two production loaders.  Both decodes must equal
the canonical tables bitwise, and the packed 140-g engine assets from
the two paths must be identical.  A misread of the Fortran index order
in either loader (e.g. a silent (keylower,Tdiff,plower) vs
(plower,Tdiff,keylower) swap) breaks the chain — this is the insurance
that golden gating works on day one of real k-data.
"""

import numpy as np
import pytest

from rrtmg_lw_tpu.data import ktables as kt
from rrtmg_lw_tpu.data.kgwrite import write_k_g
from rrtmg_lw_tpu.data.ncwrite import write_netcdf


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    orig = kt.synthetic_original_tables(seed=77)
    d = tmp_path_factory.mktemp("kdata")
    kg = d / "rrtmg_lw_k_g.f90"
    nc = d / "rrtmg_lw.nc"
    write_k_g(kg, orig)
    write_netcdf(nc, orig)
    return orig, kg, nc


def test_kg_text_decodes_bitwise(paths):
    orig, kg, _ = paths
    loaded = kt.load_fortran_original_tables(kg)
    assert set(loaded) == set(orig)
    for b in orig:
        assert set(loaded[b]) == set(orig[b]), f"band {b}"
        for name, a in orig[b].items():
            np.testing.assert_array_equal(
                loaded[b][name], a, err_msg=f"band {b} {name}")


def test_netcdf_decodes_bitwise(paths):
    orig, _, nc = paths
    loaded = kt.load_netcdf_original_tables(nc)
    assert set(loaded) == set(orig)
    for b in orig:
        assert set(loaded[b]) == set(orig[b]), f"band {b}"
        for name, a in orig[b].items():
            np.testing.assert_array_equal(
                loaded[b][name], a, err_msg=f"band {b} {name}")


def test_kg_and_nc_pack_identically(paths):
    """The KGSRC=dat|nc makefile switch contract: identical results
    from either data source (build/makefiles/make_rrtmg_lw_linux_pgi:13)."""
    orig, kg, nc = paths
    red = kt.GReduction(kt.load_static())
    packed_kg = kt.pack_all(kt.load_fortran_original_tables(kg), red)
    packed_nc = kt.pack_all(kt.load_netcdf_original_tables(nc), red)
    assert set(packed_kg) == set(packed_nc)
    for k in packed_kg:
        a, b = packed_kg[k], packed_nc[k]
        if isinstance(a, dict):
            assert set(a) == set(b), k
            for name in a:
                np.testing.assert_array_equal(a[name], b[name],
                                              err_msg=f"{k}/{name}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(k))


def test_verify_manifest_accepts_and_rejects(paths, capsys):
    """tools/build_assets.py --verify-manifest: the
    structural pre-flight must pass both synthetic blob forms and
    fail loudly on a malformed one."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "build_assets", pathlib.Path(__file__).resolve().parents[1]
        / "tools" / "build_assets.py")
    ba = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ba)

    orig, kg, nc = paths
    assert ba.verify_manifest(kg) == 0
    out = capsys.readouterr().out
    assert "manifest OK" in out and "0 failures" in out
    assert ba.verify_manifest(nc) == 0
    assert "manifest OK" in capsys.readouterr().out

    # corrupt: drop a band subroutine from the k_g text
    bad = kg.parent / "bad_k_g.f90"
    txt = kg.read_text()
    i = txt.lower().find("subroutine lw_kgb16")
    bad.write_text(txt[:i])
    assert ba.verify_manifest(bad) == 1
    assert "FAIL" in capsys.readouterr().out
