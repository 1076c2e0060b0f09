"""Basis / coarse-operator checkpointing.

The reference has no checkpoint/resume (SURVEY.md §5); its closest feature is
the within-run patch-stiffness cache (source/LOD.cc:354-361).  Here the
expensive artifacts — the basis canvases and the stencil coarse operator —
can be saved and reloaded, so repeated solves with new right-hand sides (the
production serving pattern for a multiscale method: the basis depends only on
the coefficients) skip basis construction entirely."""

from __future__ import annotations

import hashlib
import json

import jax.numpy as jnp
import numpy as np


def _config_fingerprint(cfg, n_components: int) -> str:
    payload = {
        "dim": cfg.dim, "n_coarse": cfg.n_coarse,
        "n_subdivisions": cfg.n_subdivisions,
        "oversampling": cfg.oversampling,
        "lod_stabilization": cfg.lod_stabilization,
        "constant_coefficients": cfg.constant_coefficients,
        "coef": [cfg.coef_min, cfg.coef_max, cfg.coef_refinement,
                 cfg.coef_seed, bool(cfg.reference_parity)],
        "coef_field": cfg.coef_field,
        "svd_threshold": cfg.svd_threshold,
        "n_components": n_components,
        "dtype": cfg.dtype,
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


def save_basis(solver, path: str) -> str:
    """Save basis canvases (+ stencil operator if assembled)."""
    data = {
        "fingerprint": np.frombuffer(
            _config_fingerprint(solver.cfg, solver.C).encode(),
            dtype=np.uint8),
        "Phi": np.asarray(solver.Phi),
        "APhi": np.asarray(solver.APhi),
    }
    if hasattr(solver, "A_stencil"):
        data["A_stencil"] = np.asarray(solver.A_stencil)
    np.savez_compressed(path, **data)
    return path


def load_basis(solver, path: str) -> bool:
    """Load basis canvases into the solver; returns False on a config
    mismatch (fingerprint check) instead of silently loading stale data."""
    with np.load(path) as z:
        fp = bytes(z["fingerprint"]).decode()
        if fp != _config_fingerprint(solver.cfg, solver.C):
            return False
        solver.Phi = jnp.asarray(z["Phi"], solver.dtype)
        solver.APhi = jnp.asarray(z["APhi"], solver.dtype)
        if "A_stencil" in z:
            solver.A_stencil = jnp.asarray(z["A_stencil"], solver.dtype)
    return True
