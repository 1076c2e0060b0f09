"""chip_smoke.py's phase functions at tiny sizes on the CPU, and its exits.

The script itself runs on the GPU; here its checks run on small shapes so
that a wrong path, argument or tolerance shows before a call to the card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_phase_device_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        cs.phase_device(1)


def test_phase_golden_on_cpu():
    got = cs.phase_golden()
    assert got["patches"] == 16 and got["fine_dofs"] == 81


@pytest.mark.parametrize("problem,dim", [("diffusion", 2),
                                         ("elasticity", 2)])
def test_run_main_config_tiny(problem, dim):
    spec = dict(problem=problem, dim=dim, refine=3, ell=1, chunk=16)
    rep = cs.run_main_config("tiny", spec, precisions=("high",), reps=1)
    err = rep["float32/high"]["rel_l2_vs_f64"]
    assert 0 < err < cs.F32_FIELD_TOL
    assert rep["float32/high"]["patches"] == 64


@pytest.mark.parametrize("problem,dim,refine", [("diffusion", 2, 2),
                                                ("elasticity", 2, 2)])
def test_plain_reference_check_tiny(problem, dim, refine):
    assert cs.plain_reference_check(problem, dim, refine) < cs.F32_FIELD_TOL


@pytest.mark.parametrize("n", [50, 125])
def test_check_spd_inverse(n):
    assert cs.check_spd_inverse(np.random.default_rng(0), 4, n) \
        < cs.inverse_tol(n, 1e3)


@pytest.mark.parametrize("n,k", [(60, 9), (300, 20)])
def test_check_patch_solve(n, k):
    assert cs.check_patch_solve(np.random.default_rng(2), 2, n, k) \
        < cs.inverse_tol(n, 1e3)


def test_phase_cli_small():
    assert cs.phase_cli(refine=3, ell=2, bound=1e-3) < 1e-3


def test_phase_four_cards_on_virtual_devices():
    dA, du, errs = cs.phase_four_cards(refine=2)
    assert dA < 1e-5 and du < 1e-4 and max(errs) < 1e-4


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_result_line_format(monkeypatch, capsys):
    """With every phase stubbed out, the last line is the contract's JSON
    object with the device as JAX reports it."""
    import jax

    import dealii_slod_tpu.utils.runtime as runtime

    monkeypatch.setattr(runtime, "enable_compile_cache", lambda *a: "")
    for name in ("phase_golden", "phase_main", "phase_pieces", "phase_cli"):
        monkeypatch.setattr(cs, name, lambda *a, **k: None)
    monkeypatch.setattr(cs, "phase_device", lambda n: jax.devices()[:1])
    assert cs.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    dev = jax.devices()[0]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": 1}}
