"""Plane-chunked stencil build == single-shot build.

`_stencil_build_cells_planes` (models/stencil.py) builds and consumes the
(E, K, O C^2) / (E, K2, O C^2) side tables one chunk of slot z-planes at a
time, accumulating the stencil directly — the path taken when the full
tables exceed ``cfg.stencil_side_budget_mb`` (refine-5 3D elasticity:
4.0 + 6.9 GB of full tables).  Both side tables, the
product chunk, the inverse-shift patch-row read, and the slot-correlation
indicator blocks are exercised per chunk; the result must equal the full
build up to f.p. reassociation of the accumulation order."""

import numpy as np
import jax
import pytest

from dealii_slod_tpu.config import SLODConfig
from dealii_slod_tpu.models import (DiffusionProblem, ElasticityProblem,
                                    LODSolver)


def _solver(problem, comp, dim=2, refine=3, ell=1):
    cfg = SLODConfig(dim=dim, n_global_refinements=refine, n_subdivisions=2,
                     oversampling=ell, lod_stabilization=True,
                     constant_coefficients=False, coef_seed=4,
                     rhs="; ".join(["1"] * comp), bc="; ".join(["0"] * comp),
                     dtype="float64")
    prob = (DiffusionProblem(cfg) if problem == "diffusion"
            else ElasticityProblem(cfg))
    s = LODSolver(cfg, prob, verbose=False)
    s.compute_basis()
    return s


@pytest.mark.parametrize("problem,comp", [("diffusion", 1),
                                          ("elasticity", 2)])
def test_planes_build_matches_full(problem, comp):
    s = _solver(problem, comp)
    one = np.asarray(jax.jit(
        lambda p, a: s._stencil_build_cells(p, a, n_chunks=1))(s.Phi, s.APhi))
    # tiny budget -> 1-plane chunks on both side tables (maximal chunking)
    pln = np.asarray(jax.jit(
        lambda p, a: s._stencil_build_cells_planes(p, a, budget_bytes=1))(
            s.Phi, s.APhi))
    np.testing.assert_allclose(pln, one, rtol=1e-13, atol=1e-15)
    # intermediate chunking (multi-plane chunks) hits the partial-tail path
    item = 8
    P = s.topo.n_patches
    kappa = 2 * s.cfg.oversampling + 1
    O = (s.cfg.n_subdivisions + 1) ** s.cfg.dim
    two_planes = 4 * P * 2 * kappa ** (s.cfg.dim - 1) * O * comp**2 * item
    mid = np.asarray(jax.jit(
        lambda p, a: s._stencil_build_cells_planes(
            p, a, budget_bytes=two_planes))(s.Phi, s.APhi))
    np.testing.assert_allclose(mid, one, rtol=1e-13, atol=1e-15)


def test_planes_build_matches_full_3d():
    s = _solver("diffusion", 1, dim=3, refine=2, ell=1)
    one = np.asarray(jax.jit(
        lambda p, a: s._stencil_build_cells(p, a, n_chunks=1))(s.Phi, s.APhi))
    pln = np.asarray(jax.jit(
        lambda p, a: s._stencil_build_cells_planes(p, a, budget_bytes=1))(
            s.Phi, s.APhi))
    np.testing.assert_allclose(pln, one, rtol=1e-13, atol=1e-15)


def test_dispatcher_routes_by_budget(monkeypatch):
    s = _solver("diffusion", 1)
    via_full = np.asarray(jax.jit(s._stencil_build)(s.Phi, s.APhi))
    monkeypatch.setattr(s.cfg, "stencil_side_budget_mb", 0)
    via_planes = np.asarray(jax.jit(s._stencil_build)(s.Phi, s.APhi))
    np.testing.assert_allclose(via_planes, via_full, rtol=1e-13, atol=1e-15)
