import numpy as np
import pytest

from rslmtoasa.geometry import (
    bravais_cluster,
    neighbor_map,
    primitive_cell,
    sbar_for_cluster,
    canonical_sc,
)

ALAT = 2.86120


@pytest.fixture(scope="module")
def bcc_cluster():
    cell = primitive_cell("bcc")
    cl = bravais_cluster(cell, alat=ALAT, rc=50.0, ndim=10000, wav=1.40880)
    neighbor_map(cl, ct1=3.0)
    return cl


def test_bcc_cluster_size(bcc_cluster):
    # reference bravais with ndim=10000, rc=50 gives kk=2974 (even)
    assert bcc_cluster.kk == 2974
    assert bcc_cluster.kk % 2 == 0
    # central atom is first
    assert np.allclose(bcc_cluster.cr[0], 0.0)


def test_bcc_coordination(bcc_cluster):
    # ct=3.0 A covers 8 first + 6 second bcc neighbors
    assert bcc_cluster.nn_count[0] == 14
    assert bcc_cluster.nn.shape[1] == 14
    # the representative atom has all canonical neighbors present
    assert (bcc_cluster.nn[0] >= 0).all()
    # slot vectors match the canonical directions for every interior atom
    pos = bcc_cluster.cr_ang
    dirs = bcc_cluster.dirs[0]
    for i in (0, 1, 100):
        for m in range(14):
            j = bcc_cluster.nn[i, m]
            if j >= 0:
                assert np.allclose(pos[j] - pos[i], dirs[m], atol=1e-8)


def test_canonical_sc_transpose_symmetry():
    # S(dr)[a,b] and S(-dr)[b,a] must agree (hermiticity of the canonical
    # structure constant matrix assembled in STREZE)
    rng = np.random.default_rng(42)
    for _ in range(5):
        dr = rng.normal(size=3)
        dr /= np.linalg.norm(dr) / 1.7
        s1 = canonical_sc(dr)
        s2 = canonical_sc(-dr)
        assert np.allclose(s1, s2.T, atol=1e-12)


def test_sbar_structure(bcc_cluster):
    cl = bcc_cluster
    sbars, vecs = sbar_for_cluster(cl.cr_ang, cl.iu, cl.wav, 9.0)
    assert len(sbars) == 1
    sb, vec = sbars[0], vecs[0]
    # onsite + 14 neighbors
    assert sb.shape == (15, 9, 9)
    assert np.allclose(vec[0], 0.0)
    # screened constants: S(v) blocks pair up as transposes for +/-v
    for m in range(1, 15):
        v = vec[m]
        n = np.argmin(((vec + v) ** 2).sum(axis=1))
        assert np.allclose(vec[n], -v, atol=1e-8)
        assert np.allclose(sb[m], sb[n].T, atol=1e-8)
    # onsite block symmetric positive-ish diagonal
    assert np.allclose(sb[0], sb[0].T, atol=1e-8)
    assert (np.diag(sb[0]) > 0).all()


def test_pbc_wrapped_full_coordination():
    """b1=b2=b3 wrapped box: every atom must have the complete bulk
    coordination (no boundary truncation) and bond vectors matching the
    canonical set (minimum-image wrap)."""
    import numpy as np

    from rslmtoasa.geometry import (
        bravais_cluster,
        neighbor_map,
        primitive_cell,
    )

    cell = primitive_cell("bcc")
    cl = bravais_cluster(cell, alat=2.8612, rc=50.0, wav=1.4088,
                         pbc=True, pbc_dims=(4, 4, 4),
                         pbc_wrap=(True, True, True))
    neighbor_map(cl, ct1=3.0)
    # 4x4x4 box of the one-atom bcc primitive cell: 64 atoms, every one
    # fully coordinated (8 nn + 6 nnn within 3 Angstrom)
    assert cl.kk == 64
    filled = (cl.nn >= 0).sum(axis=1)
    assert np.all(filled == 14), filled.min()


def test_pbc_wrapped_translational_invariance():
    """All atoms of a wrapped perfect crystal are equivalent: scalar
    recursion coefficients must be identical for every start atom."""
    import jax.numpy as jnp
    import numpy as np

    from rslmtoasa.geometry import (
        bravais_cluster,
        neighbor_map,
        primitive_cell,
        sbar_for_cluster,
    )
    from rslmtoasa.models.presets import synthetic_bcc_atom
    from rslmtoasa.ops.lanczos import (
        lanczos_coefficients,
        scalar_start_vectors,
    )
    from rslmtoasa.physics.hamiltonian import build_bulkham

    cell = primitive_cell("bcc")
    cl = bravais_cluster(cell, alat=2.8612, rc=50.0, wav=1.4088,
                         pbc=True, pbc_dims=(4, 4, 4),
                         pbc_wrap=(True, True, True))
    cl._ct1 = 3.0
    neighbor_map(cl, ct1=3.0)
    at = synthetic_bcc_atom()
    at.potential.build_pot()
    sbars, sbarvecs = sbar_for_cluster(cl.cr_ang, cl.iu, cl.wav, 9.0)
    hb = build_bulkham(cl, [at], sbars, sbarvecs)
    psi0 = scalar_start_vectors(cl.kk, [0, 21, 47])
    a, b2 = lanczos_coefficients(
        jnp.asarray(hb.ee[:, :, :9, :9]), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), 8,
    )
    a = np.asarray(a).reshape(8, 3, 9)
    b2 = np.asarray(b2).reshape(8, 3, 9)
    np.testing.assert_allclose(a[:, 1], a[:, 0], atol=1e-10)
    np.testing.assert_allclose(a[:, 2], a[:, 0], atol=1e-10)
    np.testing.assert_allclose(b2[:, 1], b2[:, 0], atol=1e-10)
