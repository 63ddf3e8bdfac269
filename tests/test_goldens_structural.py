"""End-to-end column-mode regression against the reference goldens.

Runs the full CLI path (INPUT_RRTM/IN_CLD_RRTM parse -> RRTATM
atmosphere build -> radiation -> OUTPUT_RRTM writer) on representative
decks from run_examples_std_atm and compares the *structure* of the
output against the committed reference outputs: block count (iout=99
emits 17 blocks), level count, level pressures, and band wavenumber
headers must match the goldens exactly at printed precision.

Flux/heating values are NOT gated here: the sandbox has synthetic
k-tables (the real rrtmg_lw.nc blob is absent from the mount — see
README "k-data"); with assets/ktables_real.npz installed,
tools/run_goldens.py gates values at <=0.5 W/m2 / <=0.1 K/day.
"""

import pathlib
import tempfile

import pytest

REF = pathlib.Path("/root/reference/run_examples_std_atm")

# all 14 reference cases (script.run_std_atm): the 4 clear standard
# atmospheres (RRTATM MODEL 2/3/5/1, MLS with iout=99 per-band blocks),
# the ICRCCM radiosonde user profile, deterministic max-random overlap
# (rtrnmr + cldprop deck), the McICA overlap matrix (icld 2/4/5 x
# idcor 0/1 x cld5/cld7 decks), CFC/CCl4 cross sections, the
# boundary-layer aerosol deck, and the surface-dT derivative
CASES = [
    ("MLS-clr", "input_rrtm_MLS-clr", None, None),
    ("MLW-clr", "input_rrtm_MLW-clr", None, None),
    ("SAW-clr", "input_rrtm_SAW-clr", None, None),
    ("TROP-clr", "input_rrtm_TROP-clr", None, None),
    ("ICRCCM_sonde", "input_rrtm_ICRCCM_sonde", None, None),
    ("MLS-cld5-imca0-icld2", "input_rrtm_MLS-cld-imca0-icld2",
     "in_cld_rrtm-cld5", None),
    ("MLS-cld5-imca1-icld2", "input_rrtm_MLS-cld-imca1-icld2",
     "in_cld_rrtm-cld5", None),
    ("MLS-cld7-imca1-icld2", "input_rrtm_MLS-cld-imca1-icld2",
     "in_cld_rrtm-cld7", None),
    ("MLS-cld7-imca1-icld4-idcor0",
     "input_rrtm_MLS-cld-imca1-icld4-idcor0", "in_cld_rrtm-cld7", None),
    ("MLS-cld7-imca1-icld5-idcor0",
     "input_rrtm_MLS-cld-imca1-icld5-idcor0", "in_cld_rrtm-cld7", None),
    ("MLS-cld7-imca1-icld5-idcor1",
     "input_rrtm_MLS-cld-imca1-icld5-idcor1", "in_cld_rrtm-cld7", None),
    ("MLS-clr-xsec", "input_rrtm_MLS-clr-xsec", None, None),
    ("MLS-clr-aer12", "input_rrtm_MLS-clr-aer12", None,
     "in_aer_rrtm-aer12"),
    ("MLS-clr-idrv1", "input_rrtm_MLS-clr-idrv1", None, None),
]


@pytest.mark.skipif(not REF.exists(), reason="reference mount absent")
@pytest.mark.parametrize("name,inp,cld,aer", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.slow
def test_golden_structure(name, inp, cld, aer):
    from rrtmg_lw_tpu.cli import run_files
    from rrtmg_lw_tpu.io.golden import parse_output_rrtm

    out = pathlib.Path(tempfile.mkdtemp(prefix="golden_")) / name
    run_files(REF / inp, out, cld_path=REF / cld if cld else None,
              aer_path=REF / aer if aer else None, nmca=2)
    gold = REF / f"output_rrtm_{name}"
    ours, ref = parse_output_rrtm(out), parse_output_rrtm(gold)
    assert len(ours) == len(ref), "block count differs"
    for a, b in zip(ours, ref):
        assert (a.wavenum1, a.wavenum2) == (b.wavenum1, b.wavenum2)
        assert len(a.level) == len(b.level), "level count differs"
        assert (a.level == b.level).all()
        assert (a.pz == b.pz).all(), "level pressures differ"


@pytest.mark.slow
@pytest.mark.skipif(not REF.exists(), reason="reference mount absent")
def test_golden_nmca200_full_sample_path():
    """The production 200-sample McICA averaging path (cli.py NMCA=200,
    rrtmg_lw.1col.f90:460-483) end-to-end: every Mersenne-Twister seed
    index 1..200 is drawn in reference order and the 200 flux samples
    are averaged.  nmca=2 CI runs would let a seed-indexing bug at
    sample > 2 slip through.  Values are not gated
    (synthetic k-tables); structure + bitwise determinism are."""
    from rrtmg_lw_tpu.cli import run_files
    from rrtmg_lw_tpu.io.golden import parse_output_rrtm

    name, inp, cld = ("MLS-cld5-imca1-icld2",
                      "input_rrtm_MLS-cld-imca1-icld2",
                      "in_cld_rrtm-cld5")
    d = pathlib.Path(tempfile.mkdtemp(prefix="golden200_"))
    out1, out2 = d / "run1", d / "run2"
    run_files(REF / inp, out1, cld_path=REF / cld, nmca=200)
    run_files(REF / inp, out2, cld_path=REF / cld, nmca=200)
    # bitwise-deterministic across runs (fixed reference seed order)
    assert out1.read_text() == out2.read_text()
    gold = REF / f"output_rrtm_{name}"
    ours, ref = parse_output_rrtm(out1), parse_output_rrtm(gold)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a.wavenum1, a.wavenum2) == (b.wavenum1, b.wavenum2)
        assert len(a.level) == len(b.level)
        assert (a.pz == b.pz).all()
    import numpy as np
    assert np.isfinite(ours[0].uflx).all()
    # the 200-sample mean must differ from a 2-sample mean (averaging
    # actually spans the later seeds)
    out3 = d / "run3"
    run_files(REF / inp, out3, cld_path=REF / cld, nmca=2)
    assert out3.read_text() != out1.read_text()
