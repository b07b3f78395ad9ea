"""Active-set wavefront recursion vs the dense engines.

The wavefront staging (ops/wavefront.py; reference ``create_ll_map``/
``izeroll`` recursion.f90:3277-3303,2570-2577) must reproduce the dense
engines exactly — the rows it skips are exact zeros."""

import numpy as np
import pytest

from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.ops.wavefront import (
    WavefrontPlan,
    block_lanczos_wavefront,
    hop_distances,
    lanczos_coefficients_wavefront,
    make_plan,
)


@pytest.fixture(scope="module")
def bcc():
    return build_synthetic_bcc(rc=45.0, ndim=100000, lld=8, nsp=2)


def test_hop_distances_bfs(bcc):
    cl = bcc.cluster
    hb = bcc.ham
    dist = hop_distances(np.asarray(hb.cols), cl.kk, [0])
    assert dist[0] == 0
    # every onsite slot-0 col is self; 1-hop atoms are exactly the
    # nonsentinel neighbors of atom 0
    nbrs = np.asarray(hb.cols)[0]
    nbrs = np.unique(nbrs[(nbrs < cl.kk) & (nbrs != 0)])
    assert (dist[nbrs] == 1).all()
    # distances grow by at most 1 along any edge
    cols = np.asarray(hb.cols)
    for i in [1, 5, 17]:
        js = cols[i][(cols[i] < cl.kk)]
        assert (np.abs(dist[js] - dist[i]) <= 1).all()


def test_scalar_wavefront_matches_dense(bcc):
    import jax.numpy as jnp

    from rslmtoasa.ops.lanczos import (
        lanczos_coefficients,
        scalar_start_vectors,
    )

    hb = bcc.ham
    kk = bcc.cluster.kk
    lld = 8
    starts = [0, 3]
    psi0 = scalar_start_vectors(kk, starts)
    hs = np.asarray(hb.ee[:, :, :9, :9])
    a_d, b_d = lanczos_coefficients(
        jnp.asarray(hs), jnp.asarray(hb.iz), jnp.asarray(hb.cols),
        jnp.asarray(psi0), lld)
    plan = make_plan(np.asarray(hb.cols), kk, starts, lld, granularity=128)
    assert plan.work < plan.dense_work  # the point of the exercise
    a_w, b_w = lanczos_coefficients_wavefront(
        hs, np.asarray(hb.iz), np.asarray(hb.cols), np.asarray(psi0),
        lld, plan)
    np.testing.assert_allclose(a_w, np.asarray(a_d), atol=1e-12)
    np.testing.assert_allclose(b_w, np.asarray(b_d), atol=1e-12)


def test_block_wavefront_matches_dense(bcc):
    import jax.numpy as jnp

    from rslmtoasa.ops.block_lanczos import (
        block_lanczos,
        block_start_vectors,
    )

    hb = bcc.ham
    kk = bcc.cluster.kk
    lld = 6
    starts = [0]
    psi0 = block_start_vectors(kk, starts)
    ntype = hb.ee.shape[0]
    lsham = np.zeros((ntype, 18, 18), np.complex128)
    a_d, b_d = block_lanczos(
        jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), lld)
    plan = make_plan(np.asarray(hb.cols), kk, starts, lld, granularity=128)
    a_w, b_w = block_lanczos_wavefront(
        np.asarray(hb.ee), lsham, np.asarray(hb.iz), np.asarray(hb.cols),
        np.asarray(psi0), lld, plan)
    np.testing.assert_allclose(a_w, np.asarray(a_d), atol=1e-12)
    np.testing.assert_allclose(b_w, np.asarray(b_d), atol=1e-12)


def test_block_wavefront_hoh_two_hop(bcc):
    """HoH spreads 2 hops per application — the plan must grow 2x."""
    import jax.numpy as jnp

    from rslmtoasa.ops.block_lanczos import (
        block_lanczos,
        block_start_vectors,
    )

    hb = bcc.ham
    kk = bcc.cluster.kk
    lld = 5
    psi0 = block_start_vectors(kk, [0])
    ntype = hb.ee.shape[0]
    rng = np.random.default_rng(7)
    lsham = np.zeros((ntype, 18, 18), np.complex128)
    # synthetic Hermitian overlap blocks for the HoH second SpMV
    hso = 0.05 * (rng.standard_normal(hb.ee.shape)
                  + 1j * rng.standard_normal(hb.ee.shape))
    enim = 0.1 * np.eye(18)[None].repeat(ntype, 0).astype(np.complex128)
    a_d, b_d = block_lanczos(
        jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), lld, hoh=True,
        hso=jnp.asarray(hso), enim=jnp.asarray(enim))
    plan = make_plan(np.asarray(hb.cols), kk, [0], lld,
                     hops_per_step=2, granularity=128)
    a_w, b_w = block_lanczos_wavefront(
        np.asarray(hb.ee), lsham, np.asarray(hb.iz), np.asarray(hb.cols),
        np.asarray(psi0), lld, plan, hoh=True, hso=hso, enim=enim)
    np.testing.assert_allclose(a_w, np.asarray(a_d), atol=1e-12)
    np.testing.assert_allclose(b_w, np.asarray(b_d), atol=1e-12)


def test_chebyshev_wavefront_matches_dense(bcc):
    import jax.numpy as jnp

    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.ops.chebyshev import chebyshev_moments
    from rslmtoasa.ops.wavefront import (
        chebyshev_moments_wavefront,
        make_plan_chebyshev,
    )

    hb = bcc.ham
    kk = bcc.cluster.kk
    lld = 6
    psi0 = block_start_vectors(kk, [0])
    ntype = hb.ee.shape[0]
    lsham = np.zeros((ntype, 18, 18), np.complex128)
    a_s, b_s = 1.5, -0.25
    mu_d = np.asarray(chebyshev_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), lld, a_s, b_s))
    plan = make_plan_chebyshev(np.asarray(hb.cols), kk, [0], lld,
                               granularity=128)
    mu_w = chebyshev_moments_wavefront(
        np.asarray(hb.ee), lsham, np.asarray(hb.iz), np.asarray(hb.cols),
        np.asarray(psi0), lld, a_s, b_s, plan)
    np.testing.assert_allclose(mu_w, mu_d, atol=1e-12)


def test_dispatch_uses_wavefront_above_threshold(bcc, monkeypatch):
    """block_lanczos_auto routes through the wavefront plan when the
    cluster is large and the ball is small."""
    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.parallel import dispatch

    hb = bcc.ham
    kk = bcc.cluster.kk
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "1000")
    monkeypatch.setenv("RSLMTO_NO_MESH", "1")
    dispatch._mesh_cache["mesh"] = None
    dispatch._mesh_cache["checked"] = False
    psi0 = block_start_vectors(kk, [0])
    ntype = hb.ee.shape[0]
    lsham = np.zeros((ntype, 18, 18), np.complex128)
    a_w, b_w = dispatch.block_lanczos_auto(
        np.asarray(hb.ee), lsham, np.asarray(hb.iz), np.asarray(hb.cols),
        psi0, 6, starts=[0])
    monkeypatch.setenv("RSLMTO_WAVEFRONT_KK", "999999999")
    a_d, b_d = dispatch.block_lanczos_auto(
        np.asarray(hb.ee), lsham, np.asarray(hb.iz), np.asarray(hb.cols),
        psi0, 6, starts=[0])
    np.testing.assert_allclose(a_w, a_d, atol=1e-12)
    np.testing.assert_allclose(b_w, b_d, atol=1e-12)
