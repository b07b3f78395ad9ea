"""Recursion + LDOS validation against dense linear algebra on a small
bcc Fe cluster (start-vector moments of the Lanczos tridiagonal must equal
dense Hamiltonian moments)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rslmtoasa.config import JobConfig
from rslmtoasa.models.bulk import BulkSystem
from rslmtoasa.ops.lanczos import lanczos_coefficients, scalar_start_vectors
from rslmtoasa.ops.ldos import orbital_density


@pytest.fixture(scope="module")
def small_fe(reference_dir):
    cfg = JobConfig.from_file(
        str(reference_dir / "tests/regression/bccFe_lanczos/input.nml")
    )
    cfg.atoms.database = str(reference_dir / "tests/regression/bccFe_lanczos")
    # shrink the cluster for test speed (physics checks are internal)
    cfg.lattice.rc = 16.0
    cfg.lattice.ndim = 4000
    sys_ = BulkSystem.build(cfg)
    sys_.build_hamiltonian()
    return sys_


def test_hamiltonian_hermitian(small_fe):
    hb = small_fe.ham
    kk = hb.kk
    cols = np.asarray(hb.cols)
    iz = np.asarray(hb.iz)
    h = np.zeros((kk * 18, kk * 18), complex)
    for i in range(kk):
        for m in range(cols.shape[1]):
            j = cols[i, m]
            if j < kk:
                h[i * 18 : (i + 1) * 18, j * 18 : (j + 1) * 18] += hb.ee[iz[i], m]
    assert np.abs(h - h.conj().T).max() < 1e-12


def test_lanczos_moments_match_dense(small_fe):
    sys_ = small_fe
    hb = sys_.ham
    cl = sys_.cluster
    kk = hb.kk
    a, b2 = sys_.run_lanczos()
    assert a.shape == (16, 18, 1)
    assert b2[0] == pytest.approx(np.ones((18, 1)))

    # dense spin-up Hamiltonian
    cols = np.asarray(hb.cols)
    iz = np.asarray(hb.iz)
    h = np.zeros((kk * 9, kk * 9), complex)
    for i in range(kk):
        for m in range(cols.shape[1]):
            j = cols[i, m]
            if j < kk:
                h[i * 9 : (i + 1) * 9, j * 9 : (j + 1) * 9] += hb.ee[iz[i], m, :9, :9]

    for orb in (0, 4, 8):
        e0 = np.zeros(kk * 9)
        e0[orb] = 1.0
        v = e0.copy()
        dense_moms = []
        for _ in range(10):
            dense_moms.append(np.vdot(e0, v).real)
            v = h @ v
        t = (
            np.diag(a[:, orb, 0])
            + np.diag(np.sqrt(b2[1:, orb, 0]), 1)
            + np.diag(np.sqrt(b2[1:, orb, 0]), -1)
        )
        tv = np.zeros(16)
        tv[0] = 1.0
        vt = tv.copy()
        tri_moms = []
        for _ in range(10):
            tri_moms.append(np.vdot(tv, vt).real)
            vt = t @ vt
        assert np.array(dense_moms) == pytest.approx(np.array(tri_moms), abs=1e-10)


def test_ldos_positive_and_complete(small_fe):
    sys_ = small_fe
    a, b2 = sys_.run_lanczos()
    # wide mesh fully covering the band: each orbital integrates to ~1 state
    ene = np.linspace(-2.5, 2.5, 4001)
    tdens, ainf, binf = orbital_density(
        a[:, :, 0], b2[:, :, 0], ene, np.ones(18), np.zeros(18)
    )
    assert tdens.min() >= -1e-10
    integral = np.trapezoid(tdens, ene, axis=1)
    # the empirical 1.01 terminator widening for s-orbitals (dos%density)
    # truncates a little spectral weight; p/d integrate tightly
    assert integral == pytest.approx(np.ones(18), abs=0.05)
    assert integral[1:9] == pytest.approx(np.ones(8), abs=0.02)
    assert integral[10:] == pytest.approx(np.ones(8), abs=0.02)


def test_local_axis_rotation_invariance():
    """For a collinear z-moment system the local-axis rotation is the
    identity frame change: recursion coefficients' diagonals (and the
    resulting LDOS) must be identical with local_axis on/off."""
    import numpy as np

    from rslmtoasa.models.presets import build_synthetic_bcc

    sys_ = build_synthetic_bcc(rc=9.0, lld=6, nsp=2)
    a0, b0 = sys_.run_block()
    sys_.cfg.hamiltonian.local_axis = True
    a1, b1 = sys_.run_block()
    np.testing.assert_allclose(a1, a0, atol=1e-10)
    np.testing.assert_allclose(b1, b0, atol=1e-10)


def test_block_lanczos_split_parity():
    """Realified (36x36 real) block recursion == complex block recursion
    (realify is a *-homomorphism; eig-based sqrt commutes with it)."""
    import numpy as np
    import jax.numpy as jnp

    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.block_lanczos import (
        block_lanczos,
        block_lanczos_split,
        block_start_vectors,
    )

    sys_ = build_synthetic_bcc(rc=9.0, lld=6, nsp=2)
    hb = sys_.ham
    kk = sys_.cluster.kk
    psi0 = block_start_vectors(kk, [0, 3])
    a1, b1 = block_lanczos(
        jnp.asarray(hb.ee), jnp.asarray(hb.lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), 6,
    )
    a2, b2 = block_lanczos_split(hb.ee, hb.lsham, hb.iz, hb.cols, psi0, 6)
    np.testing.assert_allclose(a2, np.asarray(a1), atol=1e-10)
    np.testing.assert_allclose(b2, np.asarray(b1), atol=1e-10)


def test_chebyshev_split_parity():
    import numpy as np
    import jax.numpy as jnp

    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.ops.chebyshev import (
        chebyshev_moments,
        chebyshev_moments_split,
    )

    sys_ = build_synthetic_bcc(rc=9.0, lld=5, nsp=2)
    hb = sys_.ham
    kk = sys_.cluster.kk
    psi0 = block_start_vectors(kk, [0, 2])
    m1 = chebyshev_moments(
        jnp.asarray(hb.ee), jnp.asarray(hb.lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), 5, 1.9, -0.2,
    )
    m2 = chebyshev_moments_split(hb.ee, hb.lsham, hb.iz, hb.cols, psi0,
                                 5, 1.9, -0.2)
    np.testing.assert_allclose(m2, np.asarray(m1), atol=1e-10)
