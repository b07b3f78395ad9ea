"""Gradient XC functionals (txc 5 PBE-LDA, 8 PBE-GGA, 9 LAG).

No committed reference outputs exist for GGA runs, so validation is
internal: the PBE LDA limit must reproduce the published PW92
correlation energies, the full atomic-sphere SCF must converge for every
gradient functional, and PBE-LDA must stay close to von Barth-Hedin LDA.
"""

import numpy as np
import pytest

from rslmtoasa.atoms.potential import SymbolicAtom
from rslmtoasa.physics.atomsphere import atomsc
from rslmtoasa.physics.xc_lda import XCFunctional, radgra


def test_pw92_correlation_values():
    # PW92 value (Ha/electron): rs=2 zeta=0 -> ec = -0.044757
    xc = XCFunctional(txc=5)
    rho = 3.0 / (4.0 * np.pi * 2.0**3)
    _, _, exc = xc.xcpot(rho / 2, rho / 2, rho)
    ex = -0.75 * (3.0 / np.pi) ** (1.0 / 3.0) * rho ** (1.0 / 3.0)
    ec = exc / 2.0 - ex  # Ry -> Ha, minus LDA exchange
    assert abs(ec - (-0.0447565)) < 5e-5


def test_pw92_potential_is_energy_derivative():
    # vxc = d(rho exc)/drho: finite-difference consistency of the
    # CORPBE/EXCHPBE derivative code in the unpolarized LDA limit
    xc = XCFunctional(txc=5)

    def e_density(rho):
        _, _, exc = xc.xcpot(rho / 2, rho / 2, rho)
        return rho * exc

    rho = 0.02
    h = 1e-7
    v_fd = (e_density(rho + h) - e_density(rho - h)) / (2 * h)
    v1, v2, _ = xc.xcpot(rho / 2, rho / 2, rho)
    assert abs(v1 - v_fd) < 1e-6
    assert abs(v1 - v2) < 1e-14


def test_radgra_exact_for_polynomial():
    a, b = 0.02, 0.01
    i = np.arange(400)
    rofi = b * (np.exp(a * i) - 1.0)
    f = rofi**3 - 2.0 * rofi
    g = radgra(a, b, rofi, f)
    expect = 3.0 * rofi**2 - 2.0
    # 5-point formula on the exponential mesh: effective step a(r+b)
    # grows with r, so compare relative to the derivative magnitude
    rel = np.abs(g[5:-5] - expect[5:-5]) / np.maximum(
        np.abs(expect[5:-5]), 1.0
    )
    assert rel.max() < 1e-5


@pytest.mark.parametrize("txc", [5, 8, 9])
def test_atomsc_converges_gga(reference_dir, txc):
    at = SymbolicAtom.from_file(
        "Fe", str(reference_dir / "tests/regression/bccFe_lanczos")
    )
    pot = at.potential
    res = atomsc(z=at.element.atomic_number, lmax=pot.lmax, a=0.02,
                 ws_r=pot.ws_r, pl=pot.pl, ql=pot.ql,
                 ifcore=at.element.f_core, txc=txc)
    assert np.isfinite(res.etot)
    # all functionals agree on the gross scale of the Fe total energy
    assert -2700.0 < res.etot < -2500.0
    if txc == 5:
        # PBE's LDA limit is PW92 - close to the BH default
        res_lda = atomsc(z=at.element.atomic_number, lmax=pot.lmax,
                         a=0.02, ws_r=pot.ws_r, pl=pot.pl, ql=pot.ql,
                         ifcore=at.element.f_core, txc=1)
        assert abs(res.etot - res_lda.etot) < 5.0


def test_hyperfine_fe(reference_dir):
    """Fermi-contact hyperfine field of bcc Fe: core and valence s
    contributions both negative (core polarisation opposes the moment),
    total in the known LMTO-ASA ballpark (-20 to -45 T)."""
    at = SymbolicAtom.from_file(
        "Fe", str(reference_dir / "tests/regression/bccFe_lanczos")
    )
    pot = at.potential
    res = atomsc(z=at.element.atomic_number, lmax=pot.lmax, a=0.02,
                 ws_r=pot.ws_r, pl=pot.pl, ql=pot.ql,
                 ifcore=at.element.f_core, txc=1, hyperfine=True)
    h = res.hyper_field
    assert h is not None and np.all(np.isfinite(h))
    assert h[0] < 0 and h[1] < 0
    assert -45.0 < h.sum() < -20.0


def test_spin_dynamics_smoke(reference_dir):
    """SD loop smoke on bcc Fe: both integrators advance moments, keep
    them unit-normalised, and stream a LAMMPS trajectory."""
    import os
    import tempfile

    import jax

    jax.config.update("jax_platforms", "cpu")

    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.bulk import BulkSystem
    from rslmtoasa.models.spin_dynamics import SpinDynamics

    case = reference_dir / "tests/regression/bccFe_lanczos"
    for integ in ("euler", "depondt"):
        cfg = JobConfig.from_file(str(case / "input.nml"))
        cfg.atoms.database = str(case)
        cfg.control.nsp = 2
        cfg.control.recur = "block"
        cfg.control.lld = 8
        cfg.energy.channels_ldos = 300
        cfg.scf.nstep = 1
        wd = tempfile.mkdtemp()
        sys_ = BulkSystem.build(cfg, wd)
        sd = SpinDynamics(sys_, wd)
        sd.params.asd_step = 2
        sd.params.integrator = integ
        sd.params.dt = 1.0e-17
        mom = sd.run()
        assert np.all(np.isfinite(mom))
        assert os.path.exists(os.path.join(wd, "output.lammpstrj"))
        e = np.array(sys_.atoms[0].potential.mom)
        assert abs(np.linalg.norm(e) - 1.0) < 1e-8, integ


def test_mt_gaussian_reproducible_and_constrain():
    """MT19937 thermal field reproducibility (abspinlib mtprng contract)
    and the Lagrange constraining field (constrain.f90 i_cons 2/3)."""
    import numpy as np

    from rslmtoasa.models.spin_dynamics import MTGaussian, constrain_field

    a = MTGaussian(42).standard_normal((3, 5))
    b = MTGaussian(42).standard_normal((3, 5))
    c = MTGaussian(43).standard_normal((3, 5))
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)
    # large-sample moments of the polar gasdev
    big = MTGaussian(7).standard_normal((200000,))
    assert abs(big.mean()) < 0.01 and abs(big.std() - 1.0) < 0.01

    mom_ref = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]])
    mom_in = np.array([[0.2, 0.0], [0.0, 0.0], [0.98, 1.0]])
    b0 = np.zeros((3, 2))
    # i_cons=3: field orthogonal to the reference direction
    f3 = constrain_field(mom_in, mom_ref, b0, 1.0, 3)
    assert abs((f3[:, 0] * mom_ref[:, 0]).sum()) < 1e-12
    # aligned moment -> no constraining force
    assert np.allclose(f3[:, 1], 0.0)
    # i_cons=2: plain penalty opposes the deviation
    f2 = constrain_field(mom_in, mom_ref, b0, 1.0, 2)
    assert f2[0, 0] < 0.0
