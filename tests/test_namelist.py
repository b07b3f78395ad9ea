import numpy as np
import pytest

from rslmtoasa.utils.namelist import parse_namelists
from rslmtoasa.config import JobConfig


def test_basic_groups():
    text = """
&control
calctype = 'B'
nsp = 2 ! comment
lld = 21
recur = 'block'
/
&mix
beta = 0.3
mixtype = 'linear'
/
"""
    nml = parse_namelists(text)
    assert nml["control"].get_scalar("calctype") == "B"
    assert nml["control"].get_scalar("nsp") == 2
    assert nml["mix"].get_scalar("beta") == pytest.approx(0.3)


def test_array_slices_and_dexp():
    text = """
&par
    lmax = 2
    pl(:, 1) = 4.6656807311, 4.4101846972, 3.8747773735
    ql(1, :, 2) = 0.35, 0.44, 2.13
    ct(1) = 3.0d0
    flag = T
    vals = 3*1.5
/
"""
    nml = parse_namelists(text)
    g = nml["par"]
    pl = np.zeros((3, 2))
    g.fill_array("pl", pl)
    assert pl[:, 0] == pytest.approx([4.6656807311, 4.4101846972, 3.8747773735])
    ql = np.zeros((3, 3, 2))
    g.fill_array("ql", ql)
    assert ql[0, :, 1] == pytest.approx([0.35, 0.44, 2.13])
    ct = np.zeros(50)
    g.fill_array("ct", ct)
    assert ct[0] == pytest.approx(3.0)
    assert g.get_scalar("flag") is True
    vals = np.zeros(5)
    g.fill_array("vals", vals)
    assert vals[:3] == pytest.approx([1.5, 1.5, 1.5])


def test_regression_input(reference_dir):
    cfg = JobConfig.from_file(
        str(reference_dir / "tests/regression/bccFe_lanczos/input.nml")
    )
    assert cfg.lattice.crystal_sym == "bcc"
    assert cfg.lattice.alat == pytest.approx(2.86120)
    assert cfg.lattice.ct[0] == pytest.approx(3.0)
    assert cfg.lattice.r2 == pytest.approx(9.0)
    assert cfg.control.nsp == 1
    assert cfg.control.lld == 16
    assert cfg.control.recur == "lanczos"
    assert cfg.energy.fermi == pytest.approx(-0.070393)
    assert cfg.energy.channels_ldos == 2500
    assert cfg.scf.nstep == 2
    assert cfg.atoms.labels == ["Fe"]


def test_element_file(reference_dir):
    from rslmtoasa.atoms.potential import SymbolicAtom

    at = SymbolicAtom.from_file(
        "Fe", str(reference_dir / "tests/regression/bccFe_lanczos")
    )
    assert at.element.symbol == "Fe"
    assert at.element.valence == 8
    p = at.potential
    assert p.ws_r == pytest.approx(2.6622)
    assert p.center_band[0, 0] == pytest.approx(-0.404970091)
    assert p.width_band[2, 1] == pytest.approx(0.137197964)
    assert p.ql[0, 2, 0] == pytest.approx(4.3676607024)
    # mom defaults to +z and is normalised
    assert p.mom == pytest.approx([0.0, 0.0, 1.0])
