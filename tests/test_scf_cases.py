"""Parity against the reference SCF example-test matrix (tests/scf).

Drives the REAL reference test inputs (``tests/scf/cases/<case>/``) with the
per-case namelist patches of ``tests/scf/cases.json`` through the product
pipeline (:func:`rslmtoasa.cli.run_calculation`) and gates every check
of the stored ``ref.json`` at the reference CTest tolerance (abs/rel 1e-6,
``/root/reference/CMakeLists.txt:48-49``), mirroring
``/root/reference/tests/run_test.py``.

The case matrix covers bulk bcc Fe (nsp 2/3/4 x block/chebyshev x hoh),
the Pt2MnGa Heusler (general ``crystal_sym='file'`` cell), the fccCu001
surface, and the B2FeCo impurity.  MPI rank counts in cases.json are
irrelevant here: the reference's collectives are allreduce-sums whose
result is rank-count independent, and this framework computes the same
sums on one mesh.

Set ``RSLMTO_FAST_MATRIX=1`` to run only one representative per family
(useful while iterating; CI runs everything).
"""

import json
import os
import shutil
import tempfile

import numpy as np
import pytest

from rslmtoasa.cli import run_calculation
from rslmtoasa.config import JobConfig
from rslmtoasa.utils.namelist import read_namelists

CASES_JSON = "/root/reference/tests/scf/cases.json"

# group name in cases.json patch -> JobConfig attribute
_GROUP_ATTR = {
    "control": "control",
    "self": "scf",
    "hamiltonian": "hamiltonian",
    "energy": "energy",
    "lattice": "lattice",
    "mix": "mix",
}

FAST_SET = {
    "Example_bulk_bccFe_nsp2_block_hoh",
    "Example_bulk_bccFe_nsp2_chebyshev",
    "Example_bulk_Pt2MnGa_block",
    "Example_surface_fccCu001_block_hoh",
    "Example_impurity_B2FeCo_block_hoh",
}


#: case names of the reference matrix (ids stay stable whether or not
#: the reference tree is mounted; the cases load inside a fixture)
SCF_CASES = [
    f"Example_bulk_bccFe_nsp{nsp}_{recur}{hoh}"
    for nsp in (2, 3, 4) for recur in ("block", "chebyshev")
    for hoh in ("", "_hoh")
] + [
    f"Example_bulk_Pt2MnGa_{recur}{hoh}"
    for recur in ("block", "chebyshev") for hoh in ("", "_hoh")
] + [
    "Example_surface_fccCu001_block_hoh",
    "Example_impurity_B2FeCo_block_hoh",
]


def load_case(cases_json: str, name: str) -> dict:
    """The case ``name`` of a reference cases.json (skips when the
    reference tree or the case is missing)."""
    if not os.path.exists(cases_json):
        pytest.skip("reference tree not mounted")
    with open(cases_json) as fh:
        cases = {c["name"]: c for c in json.load(fh)["cases"]}
    if name not in cases:
        pytest.skip(f"{name} not in {cases_json}")
    return cases[name]


def apply_patch(cfg: JobConfig, patch: dict) -> None:
    """Apply a cases.json namelist patch onto a built JobConfig (the
    f90nml.patch equivalent of run_test.py:79-84)."""
    for group, vals in patch.items():
        tgt = getattr(cfg, _GROUP_ATTR[group])
        for k, v in vals.items():
            assert hasattr(tgt, k), f"unknown patch key {group}.{k}"
            setattr(tgt, k, v)
    # nmdir follows nsp unless the input pinned it (ControlCfg rule)
    g = cfg.namelists.get("control")
    if "control" in patch and "nsp" in patch["control"] \
            and not (g is not None and g.has("nmdir")):
        cfg.control.nmdir = 3 if cfg.control.nsp == 3 else 1


def run_case(case: dict) -> str:
    case_dir = os.path.join(os.path.dirname(CASES_JSON), "cases",
                            case["case"])
    wd = tempfile.mkdtemp(prefix="rslmto_case_")
    for f in os.listdir(case_dir):
        shutil.copy(os.path.join(case_dir, f), wd)
    cfg = JobConfig.from_file(os.path.join(wd, "input.nml"))
    cfg.atoms.database = wd
    apply_patch(cfg, case.get("namelists", {}))
    rc = run_calculation(cfg, wd)
    assert rc == 0
    return wd


def check_nml(wd: str, spec: dict, abs_tol: float, rel_tol: float):
    mine = read_namelists(os.path.join(wd, spec["file"]))
    ref = spec["_ref"]
    for key in spec.get("scalars", []):
        got = mine["par"].get_scalar(key)
        want = ref[key]
        assert abs(got - want) <= max(abs_tol, rel_tol * abs(want)), (
            f"{spec['file']}:{key} got {got!r} want {want!r}")
    for key, idxs in spec.get("arrays", {}).items():
        arr = np.zeros(max(int(i) for i in idxs))
        mine["par"].fill_array(key, arr)
        for i in idxs:
            got = arr[int(i) - 1]
            want = ref[key][str(i)]
            assert abs(got - want) <= max(abs_tol, rel_tol * abs(want)), (
                f"{spec['file']}:{key}[{i}] got {got!r} want {want!r}")


def check_text(wd: str, spec: dict, abs_tol: float, rel_tol: float):
    lines = open(os.path.join(wd, spec["file"])).readlines()
    ref = spec["_ref"]
    for row, cols in ref.items():
        parts = lines[int(row) - 1].split()
        for col, want in cols.items():
            got = float(parts[int(col) - 1])
            assert abs(got - want) <= max(abs_tol, rel_tol * abs(want)), (
                f"{spec['file']} row {row} col {col} got {got} want {want}")


@pytest.mark.parametrize("name", SCF_CASES)
def test_scf_case(reference_dir, name):
    if os.environ.get("RSLMTO_FAST_MATRIX") and name not in FAST_SET:
        pytest.skip("RSLMTO_FAST_MATRIX: one case per family")
    case = load_case(CASES_JSON, name)
    ref_path = (reference_dir / "tests/scf/references" / case["name"]
                / "ref.json")
    if not ref_path.exists():
        pytest.skip(f"no stored reference for {case['name']}")
    ref = json.loads(ref_path.read_text())
    abs_tol = case.get("abs_tol", 1e-6)
    rel_tol = case.get("rel_tol", 1e-6)

    wd = run_case(case)

    checks = case.get("checks", {})
    for spec in checks.get("nml", []):
        spec = dict(spec, _ref=ref["nml"][spec["file"]])
        check_nml(wd, spec, abs_tol, rel_tol)
    for spec in checks.get("text", []):
        spec = dict(spec, _ref=ref["text"][spec["file"]])
        check_text(wd, spec, abs_tol, rel_tol)
    shutil.rmtree(wd, ignore_errors=True)
