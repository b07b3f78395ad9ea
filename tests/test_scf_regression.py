"""End-to-end SCF parity against the reference regression data.

Runs the full 2-step bcc Fe scalar-Lanczos pipeline (the reference's
``tests/regression/bccFe_lanczos`` case) and compares every checkpoint
quantity against the stored ``Fe.nml.ref`` produced by the Fortran code.
"""

import os
import tempfile

import numpy as np
import pytest

from rslmtoasa.config import JobConfig
from rslmtoasa.models.bulk import BulkSystem
from rslmtoasa.models.scf import SelfConsistency
from rslmtoasa.utils.namelist import read_namelists


@pytest.fixture(scope="module")
def regression_run(reference_dir):
    case = reference_dir / "tests/regression/bccFe_lanczos"
    cfg = JobConfig.from_file(str(case / "input.nml"))
    cfg.atoms.database = str(case)
    wd = tempfile.mkdtemp(prefix="rslmto_scf_")
    sys_ = BulkSystem.build(cfg, wd)
    scf = SelfConsistency(sys_, wd)
    scf.run()
    mine = read_namelists(os.path.join(wd, "Fe_out.nml"))
    ref = read_namelists(str(case / "Fe.nml.ref"))
    return mine, ref


def _arr(nml, key, shape):
    arr = np.zeros(shape)
    nml["par"].fill_array(key, arr)
    return arr


def test_regression_scalars(regression_run):
    """The reference regression gate: etot / ws_r / vmad at abs 1e-6."""
    mine, ref = regression_run
    for key in ("etot", "ws_r", "vmad"):
        assert mine["par"].get_scalar(key) == pytest.approx(
            ref["par"].get_scalar(key), abs=1e-6
        ), key


def test_regression_energies(regression_run):
    mine, ref = regression_run
    for key, tol in (
        ("sumec", 1e-4), ("sumev", 5e-5), ("utot", 1e-4),
        ("ekin", 1e-4), ("rhoeps", 1e-5),
    ):
        assert mine["par"].get_scalar(key) == pytest.approx(
            ref["par"].get_scalar(key), abs=tol
        ), key


def test_regression_parameters(regression_run):
    mine, ref = regression_run
    checks = {
        "pl": ((3, 2), 1e-6),
        "ql": ((3, 3, 2), 1e-6),
        "center_band": ((3, 2), 5e-6),
        "width_band": ((3, 2), 1e-6),
        "enu": ((3, 2), 5e-6),
        "c": ((3, 2), 5e-6),
        "srdel": ((3, 2), 1e-6),
        "qpar": ((3, 2), 1e-6),
        "ppar": ((3, 2), 5e-6),
        "vl": ((3, 2), 1e-4),  # omega+ pole amplifies convergence noise
        "gravity_center": ((3, 2), 5e-6),
        "xi_p": ((2,), 1e-7),
        "xi_d": ((2,), 1e-7),
        "mom": ((3,), 1e-9),
    }
    for key, (shape, tol) in checks.items():
        d = np.abs(_arr(mine, key, shape) - _arr(ref, key, shape)).max()
        assert d < tol, f"{key}: maxdiff {d:.3e} >= {tol}"
