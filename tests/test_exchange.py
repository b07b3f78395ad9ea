"""Exchange (Jij/DMI) parity against tests/postproc references."""

import json
import os
import tempfile

import numpy as np
import pytest

from rslmtoasa.config import JobConfig
from rslmtoasa.models.bulk import BulkSystem
from rslmtoasa.models.exchange import ExchangeCalculation
from rslmtoasa.models.presets import build_synthetic_bcc


@pytest.fixture(scope="module")
def exchange_run(reference_dir):
    cfg = JobConfig.from_file(
        str(reference_dir / "example/exchange/bccFe/input.nml")
    )
    cfg.atoms.database = str(reference_dir / "example/exchange/bccFe")
    cfg.control.nsp = 2
    cfg.control.recur = "block"
    cfg.control.lld = 20
    cfg.scf.nstep = 1
    cfg.hamiltonian.hoh = False
    wd = tempfile.mkdtemp(prefix="rslmto_xc_")
    sys_ = BulkSystem.build(cfg, wd)
    xc = ExchangeCalculation(sys_, cfg.lattice.ijpair, wd)
    xc.run()
    return wd, xc


def test_jij_values(reference_dir, exchange_run):
    ref = json.loads(
        (reference_dir
         / "tests/postproc/references/Example_exchange_bccFe/ref.json"
         ).read_text()
    )
    lines = open(os.path.join(exchange_run[0], "jij.out")).readlines()
    for row, cols in ref["text"]["jij.out"].items():
        parts = lines[int(row) - 1].split()
        for col, val in cols.items():
            mine = float(parts[int(col) - 1])
            assert abs(mine - val) < 1e-4, (row, col, mine, val)


def test_dij_values(reference_dir, exchange_run):
    ref = json.loads(
        (reference_dir
         / "tests/postproc/references/Example_exchange_bccFe/ref.json"
         ).read_text()
    )
    lines = open(os.path.join(exchange_run[0], "dij.out")).readlines()
    for row, cols in ref["text"]["dij.out"].items():
        parts = lines[int(row) - 1].split()
        for col, val in cols.items():
            mine = float(parts[int(col) - 1])
            assert abs(mine - val) < 1e-4, (row, col, mine, val)


def test_twoindex_cross_terms_vanish(exchange_run):
    """The m -> -m density/current split must kill the cross terms:
    tr[d G^{c,0}_ij d G^{c,1}_ji] ~ 0 (that is the symmetry the
    decomposition exploits; a wrong reflection table breaks this)."""
    wd, xc = exchange_run
    from rslmtoasa.physics.energy_mesh import EnergyMesh

    emesh = EnergyMesh.build(xc.cfg.energy)
    cl = xc.sys.cluster
    p = 1  # a true i != j pair
    i, j = xc.pairs[p]
    it, jt = int(cl.iz[i]) - 1, int(cl.iz[j]) - 1
    q = np.arange(1, 10)
    l1 = np.sqrt(q - 0.9).astype(int)
    refl = 2 * (l1 * (l1 + 1) + 1) - q - 1
    sign = (-1.0) ** (np.add.outer(np.arange(9), np.arange(9)))

    def reflect(g):
        return sign[:, :, None] * g[refl][:, refl].transpose(1, 0, 2)

    gi = xc.comps_i["n"][p]
    gj = xc.comps_j["n"][p]
    g0ij = 0.5 * (gi + reflect(gj))
    g1ij = 0.5 * (gi - reflect(gj))
    g0ji = 0.5 * (gj + reflect(gi))
    g1ji = 0.5 * (gj - reflect(gi))
    di = np.stack([np.diag(xc.sys.atoms[it].potential.d_matrix(e))
                   for e in emesh.ene])
    dj = np.stack([np.diag(xc.sys.atoms[jt].potential.d_matrix(e))
                   for e in emesh.ene])
    cross = np.matmul(di[:, :, None] * g0ij.transpose(2, 0, 1),
                      dj[:, :, None] * g1ji.transpose(2, 0, 1))
    keep = np.matmul(di[:, :, None] * g0ij.transpose(2, 0, 1),
                     dj[:, :, None] * g0ji.transpose(2, 0, 1))
    tc = np.abs(np.trace(cross, axis1=1, axis2=2))
    tk = np.abs(np.trace(keep, axis1=1, axis2=2))
    assert tc.max() < 1e-8 * max(tk.max(), 1.0)


def test_twoindex_outputs(exchange_run):
    wd, xc = exchange_run
    xc.calculate_exchange_twoindex()
    for name in ("jijso", "jijfo", "jijparts", "dijso", "aijso",
                 "aijparts"):
        dat = np.loadtxt(os.path.join(wd, name + ".out"))
        assert np.all(np.isfinite(dat))
    so = np.loadtxt(os.path.join(wd, "jijso.out"))
    parts = np.loadtxt(os.path.join(wd, "jijparts.out"))
    # jijso = jcd - jsd + jcc - jsc row by row
    recon = parts[:, 5] - parts[:, 6] + parts[:, 7] - parts[:, 8]
    np.testing.assert_allclose(so[:, 5], recon, atol=1e-6)


def test_gilbert_damping_tensor(exchange_run):
    wd, xc = exchange_run
    alpha = xc.calculate_gilbert_damping()
    assert np.all(np.isfinite(alpha))
    dat = np.loadtxt(os.path.join(wd, "damping-energy.out"), skiprows=1)
    assert np.all(np.isfinite(dat))
    # collinear z magnetisation: in-plane components dominate and match
    assert abs(alpha[0] - alpha[4]) < 0.5 * max(abs(alpha[0]), 1e-12)


def _two_level_setup(tmp_path, monkeypatch, eta=0.05, e0=-0.1):
    """ExchangeCalculation with EXACT Lorentzian intersite GF injected:
    g_ij(E) = 1/(E - e0 + i eta) on orbital (0,0), zero elsewhere, and
    a torque operator T = |0><0| on every type/component.  Every
    downstream quantity then has a closed form (the Kambersky two-level
    limit), making damping/inertia true value tests instead of ratio
    windows."""
    import rslmtoasa.models.exchange as exm
    from rslmtoasa.models.exchange import ExchangeCalculation
    from rslmtoasa.physics.energy_mesh import EnergyMesh

    sys_ = build_synthetic_bcc(rc=8.0, ndim=500, lld=4, nsp=2)
    xc = ExchangeCalculation(sys_, np.array([[1, 2]]), workdir=str(tmp_path))
    em = EnergyMesh.build(sys_.cfg.energy)
    g = 1.0 / (em.ene - e0 + 1j * eta)  # (NE,)
    gfull = np.zeros((1, 18, 18, em.npts), np.complex128)
    gfull[0, 0, 0] = g
    xc.gij_full = gfull
    xc.gji_full = gfull.copy()

    t = np.zeros((1, 3, 18, 18), np.complex128)
    t[:, :, 0, 0] = 1.0
    monkeypatch.setattr(exm, "torque_operator_collinear",
                        lambda atoms: t)
    ief = int(np.argmin(np.abs(em.ene - em.fermi)))
    ef = em.ene[ief]
    pot = sys_.atoms[0].potential
    spin = float((pot.ql[0, :, 0] - pot.ql[0, :, 1]).sum())
    return xc, em, ef, eta, e0, spin


def test_damping_kambersky_two_level(tmp_path, monkeypatch):
    """Gilbert damping against the closed-form two-level Kambersky
    value: with T = |0><0| and g = 1/(E - e0 + i eta),
    A_00 = 2i Im g, so alpha^{kl} = -0.5/(pi m) Re tr[T A T A]
    = 2 (Im g(E_F))^2 / (pi m) for every k, l."""
    xc, em, ef, eta, e0, spin = _two_level_setup(tmp_path, monkeypatch)
    alpha = xc.calculate_gilbert_damping()
    img = -eta / ((ef - e0) ** 2 + eta ** 2)
    expect = 2.0 * img ** 2 / (np.pi * spin)
    np.testing.assert_allclose(alpha, np.full(9, expect), rtol=1e-10)


def test_inertia_kambersky_two_level(tmp_path, monkeypatch):
    """Moment of inertia against the analytic second energy derivative:
    I^{kl} = Re tr[T A T B'' + T B'' T A] with B_00 = 2 Re g and
    B''_00 = Re[4/(E - e0 + i eta)^3] (closed form), A_00 = 2i Im g.
    The module differentiates B on the mesh (O(h^2) central FD), so the
    gate allows the FD truncation error."""
    xc, em, ef, eta, e0, spin = _two_level_setup(tmp_path, monkeypatch)
    inertia = xc.calculate_moment_of_inertia()
    g = 1.0 / (ef - e0 + 1j * eta)
    a00 = 2j * g.imag
    b2_exact = np.real(4.0 / (ef - e0 + 1j * eta) ** 3)
    expect = np.real(a00 * b2_exact + b2_exact * a00)
    h = em.ene[1] - em.ene[0]
    # FD truncation: |B''''| h^2 / 12 with B'''' ~ 48/eta^5 at the peak
    np.testing.assert_allclose(inertia, np.full(9, expect),
                               rtol=5e-3)


def test_moment_of_inertia_outputs(exchange_run):
    wd, xc = exchange_run
    inertia = xc.calculate_moment_of_inertia()
    assert np.all(np.isfinite(inertia))
    assert os.path.exists(os.path.join(wd, "example-real.out"))


def test_gauss_legendre_exchange(exchange_run):
    """Imaginary-axis GL quadrature: same Fermi-sea Jij by a different
    contour (and the onsite-splitting d matrices); must agree with the
    real-axis LKAG result in sign and magnitude for the nn pair."""
    wd, xc = exchange_run
    import shutil

    gl_dir = os.path.join(wd, "gl")
    os.makedirs(gl_dir, exist_ok=True)
    xc_wd = xc.workdir
    xc.workdir = gl_dir
    try:
        xc.run_gauss_legendre()
    finally:
        xc.workdir = xc_wd
    gl = np.loadtxt(os.path.join(gl_dir, "jij.out"))
    ra = np.loadtxt(os.path.join(wd, "jij.out"))
    assert np.all(np.isfinite(gl))
    # nn pair (row 2): ferromagnetic, positive in both schemes
    assert gl[1, 5] > 0 and ra[1, 5] > 0
    assert 0.2 < gl[1, 5] / ra[1, 5] < 5.0


def _small_cfg(reference_dir):
    """Reduced bcc Fe cluster (rc 30 instead of 80) for engine
    cross-checks that don't compare against the stored big-cluster
    reference values."""
    cfg = JobConfig.from_file(
        str(reference_dir / "example/exchange/bccFe/input.nml")
    )
    cfg.atoms.database = str(reference_dir / "example/exchange/bccFe")
    cfg.control.nsp = 2
    cfg.control.recur = "block"
    cfg.scf.nstep = 1
    cfg.hamiltonian.hoh = False
    cfg.lattice.rc = 30.0
    cfg.lattice.ndim = 4000
    return cfg


def test_jijk_trio(reference_dir):
    """Spin-lattice Jijk smoke: trio (center, nn, nn) on bcc Fe with z
    displacement.  Internal checks: finite tensor, and the zz component
    pattern follows the torque structure (xx/yy dominate for collinear
    z moments since the T_z-like combinations vanish)."""
    import tempfile

    cfg = _small_cfg(reference_dir)
    cfg.control.lld = 12
    wd = tempfile.mkdtemp(prefix="rslmto_jijk_")
    sys_ = BulkSystem.build(cfg, wd)
    trio = np.array([[1.0, 2.0, 3.0, 0.0, 0.0, 1.0]])
    pairs = np.array([[1, 2], [1, 3], [2, 3]])
    xc = ExchangeCalculation(sys_, pairs, wd)
    xc.run()
    res = xc.calculate_jijk(trio)
    assert res.shape == (1, 9)
    assert np.all(np.isfinite(res))
    assert os.path.exists(os.path.join(wd, "jijk.out"))
    # at least one in-plane component nonzero at meaningful scale
    assert np.abs(res[0]).max() > 1e-8


def test_chebyshev_pair_exchange(reference_dir):
    """Chebyshev pair recursion (chebyshev_recur_ij path) reproduces the
    block-recursion Jij within the KPM broadening tolerance.

    Engine cross-check on a shared reduced cluster (the stored-reference
    parity of the block engine itself is test_jij_values); nn and 2nn
    pairs of the central atom.
    """
    import tempfile

    cfg = _small_cfg(reference_dir)
    wd = tempfile.mkdtemp(prefix="rslmto_xc_ch_")
    sys_ = BulkSystem.build(cfg, wd)
    # nn and 2nn of atom 1 by distance on this cluster
    cl = sys_.cluster
    d = np.linalg.norm(cl.cr_ang - cl.cr_ang[0], axis=1)
    order = np.argsort(d)
    dd = np.unique(np.round(d[order], 6))
    i_nn = int(order[np.argmax(np.isclose(d[order], dd[1]))])
    i_2nn = int(order[np.argmax(np.isclose(d[order], dd[2]))])
    pairs = np.asarray([[1, i_nn + 1], [1, i_2nn + 1]])

    cfg.control.recur = "block"
    cfg.control.lld = 20
    xc_b = ExchangeCalculation(sys_, pairs, wd)
    res_b = xc_b.run()

    cfg.control.recur = "chebyshev"
    cfg.control.lld = 120
    xc_c = ExchangeCalculation(sys_, pairs, wd)
    res_c = xc_c.run()
    # KPM at lld=120 agrees with the continued-fraction block path
    # within its kernel broadening (~20%)
    for got, ref_v in zip((res_c[0]["jij"], res_c[1]["jij"]),
                          (res_b[0]["jij"], res_b[1]["jij"])):
        assert 0.8 < got / ref_v < 1.2, (got, ref_v)


def test_jij_auxgreen(exchange_run):
    """Auxiliary-GF Jij: the zz tensor element must agree with the LKAG
    Jij for the nn pair within the representation difference (the aux
    route uses the energy-dependent potential-function DeltaP instead of
    the d-matrix), and J0 (i == j) must be positive for a ferromagnet
    (stability sum rule)."""
    wd, xc = exchange_run
    out = xc.calculate_jij_auxgreen()
    assert np.all(np.isfinite(out))
    ra = np.loadtxt(os.path.join(wd, "jij.out"))
    # nn pair: same sign, same magnitude scale as LKAG
    assert out[1, 8] * ra[1, 5] > 0
    assert 0.3 < abs(out[1, 8] / ra[1, 5]) < 3.0
    assert os.path.exists(os.path.join(wd, "jij_aux.out"))
