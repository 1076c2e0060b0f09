"""CLI + VTU output tests — mirrors the reference apps' behavior
(app/main_Diffusion.cc: prm-file handling, output files)."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from dealii_slod_tpu.cli import main as cli_main


@pytest.fixture()
def rundir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _vtu_header(path):
    """Parse the XML header of a VTU file (handles the native binary
    appended format, whose payload is raw bytes)."""
    raw = open(path, "rb").read()
    if b"<AppendedData" in raw:
        header = raw.split(b"<AppendedData", 1)[0].decode()
        return ET.fromstring(header + "</VTKFile>"), raw
    return ET.fromstring(raw.decode()), raw


def test_cli_creates_prm_and_outputs(rundir):
    # first run with a missing prm writes the defaults (reference README:3)
    rc = cli_main(["diffusion", "--no-fine-solve"])
    assert rc == 0
    assert (rundir / "parameters.prm").exists()
    assert (rundir / "used_parameters_2.prm").exists()
    for f in ("solution_fine.vtu", "solution_coarse.vtu",
              "solution_coefficients.vtu"):
        root, _ = _vtu_header(rundir / f)
        piece = root.find(".//Piece")
        assert piece is not None
        names = {d.get("Name") for d in piece.iter("DataArray")}
        assert "connectivity" in names

    # fine VTU carries the LOD field with finite values
    root, raw = _vtu_header(rundir / "solution_fine.vtu")
    arrs = {d.get("Name"): d for d in root.iter("DataArray")}
    assert "lod_solution" in arrs
    if b"<AppendedData" in raw:
        off = int(arrs["lod_solution"].get("offset"))
        blob = raw.split(b'encoding="raw">', 1)[1]
        blob = blob[blob.index(b"_") + 1:]
        n = np.frombuffer(blob[off:off + 8], dtype=np.uint64)[0]
        v = np.frombuffer(blob[off + 8:off + 8 + int(n)], dtype=np.float64)
    else:
        v = np.fromstring(arrs["lod_solution"].text.replace("\n", " "),
                          sep=" ")
    assert v.size == 81
    assert np.isfinite(v).all() and np.abs(v).max() > 0


def test_cli_reads_existing_prm(rundir):
    (rundir / "p.prm").write_text(
        "subsection Problem\n"
        "  set Oversampling = 2\n"
        "  set Number of global refinements = 2\n"
        "  set Number of subdivisions = 2\n"
        "  set Stabilize phi_LOD candidates = true\n"
        "  subsection Right hand side\n"
        "    set Function expression = 1\n"
        "  end\n"
        "end\n")
    rc = cli_main(["diffusion", "p.prm", "--no-fine-solve"])
    assert rc == 0
    used = (rundir / "used_parameters_2.prm").read_text()
    assert "set Oversampling = 2" in used
    assert "set Stabilize phi_LOD candidates = true" in used


def test_prm_solver_controls_roundtrip(tmp_path):
    """Reference prm files carry nested ReductionControl + Error sections
    (LOD.h:108-109,126-127,150-156); they must parse and round-trip."""
    from dealii_slod_tpu.config import ReductionControl, SLODConfig
    cfg = SLODConfig(
        fine_solver=ReductionControl(222, 1e-9, 1e-3),
        coarse_solver=ReductionControl(333, 1e-7, 1e-4),
        error_norms=("L2", "Linfty"))
    p = tmp_path / "params.prm"
    p.write_text(cfg.to_prm())
    cfg2 = SLODConfig.from_prm(str(p))
    assert cfg2.fine_solver == ReductionControl(222, 1e-9, 1e-3)
    assert cfg2.coarse_solver == ReductionControl(333, 1e-7, 1e-4)
    assert cfg2.error_norms == ("L2", "Linfty")


def test_prm_solver_controls_dealii_style(tmp_path):
    """A hand-written deal.II-style prm with solver sections is honored."""
    from dealii_slod_tpu.config import SLODConfig
    p = tmp_path / "ref.prm"
    p.write_text("""
subsection Problem
  set Oversampling = 3
  subsection Solver
    subsection Coarse solver control
      set Max steps  = 47
      set Tolerance  = 1.e-12
      set Reduction  = 1.e-6
    end
  end
  subsection Error
    set List of error norms to compute = L2_norm, H1_norm
  end
end
""")
    cfg = SLODConfig.from_prm(str(p))
    assert cfg.oversampling == 3
    assert cfg.coarse_solver.max_steps == 47
    assert cfg.coarse_solver.tolerance == 1e-12
    assert cfg.coarse_solver.reduce == 1e-6
    assert cfg.fine_solver.max_steps == 1000  # untouched default
    assert cfg.error_norms == ("L2", "H1")


def test_prm_lookup_is_segment_anchored(tmp_path):
    """A user parameter whose name merely ENDS with a known key must not
    alias it (endswith-matching could collide across sections);
    the suffix match anchors at subsection boundaries only."""
    from dealii_slod_tpu.config import SLODConfig
    p = tmp_path / "alias.prm"
    p.write_text("""
subsection My app
  set Custom Output name = bogus
  set SuperOversampling  = 9
end
set Output name   = real
set Oversampling  = 2
""")
    cfg = SLODConfig.from_prm(str(p))
    assert cfg.output_name == "real"
    assert cfg.oversampling == 2


def test_cli_reaction_subcommand(rundir):
    """The reaction-diffusion CLI app runs end-to-end (prm-on-missing +
    VTU outputs), like the diffusion/elasticity subcommands."""
    rc = cli_main(["reaction", "--no-fine-solve"])
    assert rc == 0
    assert (rundir / "parameters.prm").exists()
    root, _ = _vtu_header(rundir / "solution_coarse.vtu")
    assert root.find(".//Piece") is not None
