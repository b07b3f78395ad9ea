"""Two-spin dimer ASD testbench (the abspinlib ``mndimer.f90``
standalone driver re-expressed as a test): a pair of exchange-coupled
moments integrated with the Depondt predictor-corrector.

Checks the integrator against exact physics: at zero damping the total
moment along the exchange field is conserved, moment norms are
preserved exactly (rotation integrator), and the precession frequency
matches the analytic two-spin Larmor rate.
"""

import numpy as np

from rslmtoasa.models.spin_dynamics import (
    GAMA,
    MTGaussian,
    depondt_evolve_first,
    depondt_evolve_second,
)


def _dimer_run(j_field, m0, nsteps, dt, lam=0.0, temp=0.0):
    """Integrate two moments with field B_i = j_field * m_j (a.u.)."""
    rng = MTGaussian(7)
    mmom = np.linalg.norm(m0, axis=0)
    emom = m0 / mmom[None, :]
    traj = [emom.copy()]
    for _ in range(nsteps):
        beff = j_field * emom[:, ::-1] * mmom[None, ::-1]
        emom_p, b2eff, _ = depondt_evolve_first(lam, beff, emom, mmom,
                                                dt, temp, rng)
        beff2 = j_field * emom_p[:, ::-1] * mmom[None, ::-1]
        emom = depondt_evolve_second(lam, beff2, b2eff, emom, dt)
        traj.append(emom.copy())
    return np.asarray(traj)  # (nsteps+1, 3, 2)


def test_dimer_norm_and_invariants():
    m0 = np.array([[0.0, 5.0], [0.0, 0.0], [5.0, 0.0]])
    j = -3.4e-3
    dt = 0.05 / (GAMA * abs(j) * 5.0)  # ~0.05 rad per step
    traj = _dimer_run(j, m0, nsteps=400, dt=dt)
    norms = np.linalg.norm(traj, axis=1)
    # rotation integrator: unit directions preserved to roundoff
    np.testing.assert_allclose(norms, 1.0, atol=1e-12)
    # zero damping: the total moment projection on the (conserved)
    # total-spin axis is constant
    tot = traj.sum(axis=2)  # (nsteps, 3)
    np.testing.assert_allclose(tot @ tot[0], (tot[0] @ tot[0]),
                               rtol=5e-6)


def test_larmor_precession_frequency():
    """Constant external field: the Depondt rotation advances the
    azimuthal phase at exactly GAMA |B| per unit time (the integrator
    is an exact rotation for a static field)."""
    rng = MTGaussian(3)
    bmag = 1.0e-2
    beff = np.array([[0.0], [0.0], [bmag]])
    mmom = np.array([5.0])
    emom = np.array([[np.sin(0.3)], [0.0], [np.cos(0.3)]])
    dt = 0.04 / (GAMA * bmag)
    phis = []
    for _ in range(500):
        e_p, b2eff, _ = depondt_evolve_first(0.0, beff, emom, mmom, dt,
                                             0.0, rng)
        emom = depondt_evolve_second(0.0, beff, b2eff, emom, dt)
        phis.append(np.arctan2(emom[1, 0], emom[0, 0]))
    phi = np.unwrap(np.asarray(phis))
    rate = np.polyfit(np.arange(len(phi)) * dt, phi, 1)[0]
    want = GAMA * bmag
    assert abs(abs(rate) - want) < 1e-6 * want, (rate, want)


def test_dimer_damped_alignment():
    """With damping and ferromagnetic coupling the dimer aligns: the
    angle between the two spins decays monotonically."""
    m0 = np.array([[0.5, 0.0], [0.0, 0.5], [5.0, 5.0]])
    j = +2.0e-3  # ferromagnetic (field along the partner)
    dt = 0.05 / (GAMA * abs(j) * 5.0)
    traj = _dimer_run(j, m0, nsteps=3000, dt=dt, lam=0.1)
    cosang = np.einsum("tia,tia->t", traj[:, :, :1], traj[:, :, 1:])
    assert cosang[-1] > 0.9999
    assert cosang[-1] > cosang[0]
