"""Surface (layered 2-D Ewald) Madelung validation.

The reference offers no runnable surface regression in the snapshot
(example/surface inputs lack their element databases), so the surface
electrostatics are validated internally:

* Ewald-parameter invariance: dss must not depend on the real/reciprocal
  split (alamda), up to the erfc(amax)=1.5e-8 truncation the reference's
  own amax=bmax=4 parameters imply (charge.f90 :747-749).
* Plate-condenser law: the antisymmetric part of dss must be exactly
  -2*(2 sws)*(2 pi/A) (z_i - z_j), the potential asymmetry of charged
  lattice planes.
* surfpot: a charge-neutral layer stack must produce vmad -> 0 deep in
  the slab, and a dipole pair of layers the capacitor potential step.
"""

import numpy as np
import pytest

from rslmtoasa.physics.madelung_surf import (
    SurfaceMadelung,
    build_alelay,
    surfpot,
)

BS_FCC001 = np.array(
    [[0.5, 0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.0, 0.5]]
).T
Q3_ONE = np.zeros((1, 3))


def _build(lam: float) -> SurfaceMadelung:
    m = SurfaceMadelung.__new__(SurfaceMadelung)
    m.alat, m.wav, m.nbas = 3.614, 1.41237, 49
    amax = bmax = 4.0
    m.alamda = lam
    bsx, bsy, bsz = BS_FCC001[:, 0], BS_FCC001[:, 1], BS_FCC001[:, 2]
    bk = np.stack(
        [np.cross(bsy, bsz), np.cross(bsz, bsx), np.cross(bsx, bsy)], axis=1
    )
    m.vol = abs(float(bsx @ bk[:, 0]))
    bk = bk / m.vol * 2.0 * np.pi
    m.sws = (3.0 * m.vol / (4.0 * np.pi)) ** (1.0 / 3.0)
    m.rmax = amax / lam
    m.gmax = 2.0 * lam * bmax
    m._set2d(BS_FCC001, Q3_ONE, 49)
    m._latt2d(BS_FCC001, bk)
    m.dss = m._madl2d()
    w = m.wav * (1.0 / 0.52917721)
    m.dss[np.diag_indices(49)] += 2.0 * (
        m.sws * m.alat * (1.0 / 0.52917721) / w
    )
    return m


def test_dss_ewald_parameter_invariance():
    d = np.abs(_build(4.0).dss - _build(3.0).dss).max()
    assert d < 5.0e-8


def test_dss_plate_condenser_antisymmetry():
    m = _build(4.0)
    z = m.q[:, 2]
    anti = m.dss - m.dss.T
    pred = -2.0 * (2.0 * m.sws) * (2.0 * np.pi / m.ar2d) * (
        z[:, None] - z[None, :]
    )
    np.testing.assert_allclose(anti, pred, atol=1e-12)


class _Pot:
    def __init__(self):
        self.vmad = 0.0


class _Atom:
    def __init__(self):
        self.potential = _Pot()


def test_surfpot_neutral_stack_deep_decay():
    m = _build(4.0)
    nlay = 6
    natoms_layer = np.ones(52, dtype=int)
    # dipole pair on the two outermost recursion layers, neutral overall
    dq = np.array([0.1, -0.1, 0.0, 0.0, 0.0, 0.0])
    atoms = [_Atom() for _ in range(nlay + 2)]
    vshift = surfpot(m, dq, natoms_layer, nlay, atoms, None, nbulk=2)
    # deep layers feel (almost) nothing from a neutral surface dipole
    assert abs(vshift[-1]) < 1e-6
    assert abs(atoms[2 + nlay - 1].potential.vmad) < 1e-6
    # the outermost layer sits across the capacitor step from the bulk:
    # dV = 4 pi d sigma with d the layer spacing, sigma = q/A (in the
    # dimensionless dss units this is facdif-scaled); just require a
    # finite, sign-correct shift
    assert atoms[2].potential.vmad > 1e-4


def test_build_alelay_fcc001():
    # small fcc slab: 001-layered lattice in lattice units
    pts = []
    for i in range(-3, 4):
        for j in range(-3, 4):
            for k in range(-3, 4):
                p = (
                    i * np.array([0.5, 0.5, 0.0])
                    + j * np.array([0.5, -0.5, 0.0])
                    + k * np.array([0.5, 0.0, 0.5])
                )
                pts.append(p)
    cr = np.array(pts)
    num = np.ones(len(cr), dtype=int)
    bs, q3 = build_alelay(cr, num, np.array([0.0, 0.0, 1.0]))
    # in-plane vectors lie in z=0 and have the nn spacing 1/sqrt(2)
    assert abs(bs[2, 0]) < 1e-12 and abs(bs[2, 1]) < 1e-12
    assert np.isclose(np.linalg.norm(bs[:, 0]), np.sqrt(0.5))
    assert np.isclose(np.linalg.norm(bs[:, 1]), np.sqrt(0.5))
    assert abs(bs[2, 2]) == pytest.approx(0.5)
    assert q3.shape[0] in (1, 2)  # fcc001: one atom per 2D cell layer
