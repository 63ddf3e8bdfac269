"""chip_smoke.py off the card: it refuses to pass without a GPU, and
its phases run end to end at a tiny size on the CPU (the RT kernel in
the Pallas interpreter)."""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_fails_without_gpu():
    r = _run(REPO, REPO / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not gpu" in r.stdout


def test_fails_without_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run(tmp_path, tmp_path / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_phases_tiny_on_cpu():
    cs.phase_forward(B=24, nlays=(8,), n_ref=8, n_oracle=1,
                     oracle_nlay=8, interpret=True)
    rows = cs.phase_rt_kernel(B=24, nlays=(8,), interpret=True,
                              windows=1, n_steps=1)
    assert {(r["nlay"], r["sky"]) for r in rows} == {(8, "clear"),
                                                      (8, "mcica")}


def test_grad_phase_tiny_on_cpu():
    cs.phase_grad(B=16, L=8, n_grad=8, interpret=True)


def test_gates_raise():
    with pytest.raises(cs.CheckFailed):
        cs.gate("x", 2e-3, cs.FLUX_GATE)
    cs.gate("x", 0.0, cs.FLUX_GATE)


def test_hr_gate_holds_raw_error_to_the_contract():
    """An error inside the f32 storage allowance still fails once it
    passes the reference's 0.1 K/day."""
    from rrtmg_lw_tpu.types import Fluxes
    B, L = 2, 3
    flux = np.full((B, L + 1), 1e4)
    zero = np.zeros((B, L))
    ref = Fluxes(uflx=flux, dflx=flux, hr=zero, uflxc=flux, dflxc=flux,
                 hrc=zero)
    # layers so thin that the storage allowance is far above 0.1 K/day
    plev = np.tile(1.0 - 1e-7 * np.arange(L + 1), (B, 1))
    cs.gate_hr("hr", np.full((B, L), 0.05), ref, plev, 8.4, "hr")
    with pytest.raises(cs.CheckFailed):
        cs.gate_hr("hr", np.full((B, L), 0.2), ref, plev, 8.4, "hr")


def test_grad_gates():
    want = {"a": np.ones(100), "z": np.zeros(2)}
    near = {"a": np.full(100, 1.0 + 1e-3), "z": np.zeros(2)}
    cs.gate_grads("g", near, want)
    with pytest.raises(cs.CheckFailed):     # a zero leaf must stay 0
        cs.gate_grads("g", {"a": want["a"], "z": np.ones(2)}, want)
    # one element 5% off: inside the L2 gate, outside the max gate
    off = {"a": np.r_[1.05, np.ones(99)], "z": np.zeros(2)}
    cs.gate_grads("g", off, want, max_gate=False)
    with pytest.raises(cs.CheckFailed):
        cs.gate_grads("g", off, want)


def test_bench_refuses_cpu():
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench",
                                                  REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    with pytest.raises(SystemExit):
        bench.device_info()
