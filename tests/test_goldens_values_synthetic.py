"""End-to-end VALUE gating of the golden harness on synthetic tables.

The real k-distribution blobs are absent from this environment (see
.MISSING_LARGE_BLOBS in the reference mount), so the real-data golden
gates (<=0.5 W/m2 / <=0.1 K/day vs run_examples_std_atm outputs,
script.run_std_atm:1-66) cannot fire.  This suite proves the entire
acceptance path anyway: framework-generated f64 outputs for the 14
reference decks are committed in goldens_synthetic/, and CI re-runs the
decks through tools/run_goldens.py with the SAME comparison/gating code
the real goldens would use — parser -> RRTATM -> radiation -> writer ->
golden comparator -> process exit code — at a tightened 1e-6 gate
(same-code f64 reruns are bit-deterministic).  Dropping in the real
rrtmg_lw.nc then exercises zero new code.
"""

import pathlib
import re
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "goldens_synthetic"
REF = pathlib.Path("/root/reference/run_examples_std_atm")

pytestmark = pytest.mark.skipif(not REF.exists(),
                                reason="reference mount absent")


def _run_goldens(*extra, timeout=900):
    return subprocess.run(
        [sys.executable, str(REPO / "tools" / "run_goldens.py"),
         "--nmca", "2", "--golden-dir", str(GOLDEN_DIR),
         "--tol-flux", "1e-6", "--tol-htr", "1e-6", *extra],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)


def test_golden_values_quick_subset():
    """Default-tier gate: one clear deck with cross-sections and one
    McICA cloudy deck, value-compared to the committed goldens through
    the real gating branch (exit code is the contract)."""
    r = _run_goldens("--cases", "xsec,cld7-imca1-icld2")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("PASS") == 2, r.stdout


@pytest.mark.slow
def test_golden_values_all_14_decks():
    """Round gate: every deck of the reference regression suite passes
    the value comparison against its committed synthetic golden."""
    r = _run_goldens(timeout=1800)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("PASS") == 14, r.stdout


def test_golden_gate_fails_on_injected_perturbation(tmp_path):
    """The comparator must actually have teeth: a 1 W/m2 perturbation
    injected into a golden file makes run_goldens exit nonzero."""
    tampered = tmp_path / "goldens"
    tampered.mkdir()
    name = "output_rrtm_MLS-clr-xsec"
    for f in GOLDEN_DIR.glob("output_rrtm_*"):
        shutil.copy(f, tampered / f.name)
    text = (tampered / name).read_text()
    # bump the first data line's upward flux by 1.0 W/m2
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        parts = line.split()
        if len(parts) == 6:
            try:
                vals = [float(p) for p in parts]
            except ValueError:
                continue
            lines[i] = re.sub(re.escape(parts[2]),
                              f"{vals[2] + 1.0:.4f}", line, count=1)
            break
    else:
        pytest.fail("no data line found in golden")
    (tampered / name).write_text("".join(lines))
    r = subprocess.run(
        [sys.executable, str(REPO / "tools" / "run_goldens.py"),
         "--nmca", "2", "--golden-dir", str(tampered),
         "--cases", "xsec"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode != 0, r.stdout + r.stderr
    assert "FAIL" in r.stdout, r.stdout


def test_goldens_committed_for_all_cases():
    """goldens_synthetic/ holds one output per deck in the case matrix
    (drift guard: adding a deck without regenerating goldens fails)."""
    sys.path.insert(0, str(REPO / "tools"))
    from run_goldens import CASES
    missing = [n for n, _, _, _ in CASES
               if not (GOLDEN_DIR / f"output_rrtm_{n}").exists()]
    assert not missing, f"missing synthetic goldens: {missing}"
