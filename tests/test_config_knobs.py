"""Configuration surface: the options of removed kernels fail loudly, the
solver choices are validated, and no routing depends on the platform."""

import dataclasses

import jax
import pytest

from dealii_slod_tpu.config import REMOVED_KNOBS, SLODConfig
from dealii_slod_tpu.models import DiffusionProblem, LODSolver

REMOVED = sorted(REMOVED_KNOBS)


@pytest.mark.parametrize("knob", REMOVED)
def test_removed_knob_rejected_by_constructor(knob):
    with pytest.raises(ValueError, match=f"removed.*{knob}"):
        SLODConfig(**{knob: 1})


@pytest.mark.parametrize("knob", REMOVED)
def test_removed_knob_rejected_in_prm(knob, tmp_path):
    spelled = knob.replace("_", " ").capitalize()     # "Fused block"
    prm = tmp_path / "p.prm"
    prm.write_text("subsection Problem\n"
                   "  set Number of global refinements = 2\n"
                   f"  set {spelled} = 1\n"
                   "end\n")
    with pytest.raises(ValueError, match=f"removed.*{knob}"):
        SLODConfig.from_prm(str(prm))


def test_removed_knob_rejected_by_replace():
    with pytest.raises(ValueError, match="removed"):
        dataclasses.replace(SLODConfig(), trace_kernel="on")


def test_prm_without_removed_knobs_still_loads(tmp_path):
    prm = tmp_path / "p.prm"
    prm.write_text(SLODConfig(n_global_refinements=3).to_prm())
    assert SLODConfig.from_prm(str(prm)).n_global_refinements == 3


@pytest.mark.parametrize("problem,kernel_mode", [
    ("diffusion", "uniform"), ("elasticity", "uniform"),
    ("diffusion", "classes")])
def test_routing_has_no_platform_branch(problem, kernel_mode, monkeypatch):
    """The compiled step is the same program whatever backend name JAX
    reports: no route depends on the platform."""
    from dealii_slod_tpu.models import ElasticityProblem

    kw = dict(dim=2, n_global_refinements=2, n_subdivisions=2,
              oversampling=1, lod_stabilization=True,
              constant_coefficients=False, dtype="float32", patch_chunk=8,
              solve_fine_problem=False, kernel_mode=kernel_mode, bc="0",
              rhs="1; 1" if problem == "elasticity" else "1")
    prob = ElasticityProblem if problem == "elasticity" else DiffusionProblem
    texts = []
    for backend in ("cpu", "gpu", "rocm"):
        monkeypatch.setattr(jax, "default_backend", lambda b=backend: b)
        cfg = SLODConfig(**kw)
        s = LODSolver(cfg, prob(cfg), verbose=False)
        s.assemble_fine_rhs()
        texts.append(jax.jit(s.build_step()).lower(
            s.coef_q, s.fem_rhs).as_text())
    assert texts[0] == texts[1] == texts[2]
