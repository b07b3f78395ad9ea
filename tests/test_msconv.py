"""Multi-site df64 conv engines vs the complex128 gather engines.

Whole-recursion parity of ops/msconv block-Lanczos and Chebyshev moments
against ops/block_lanczos and ops/chebyshev on single-site (bcc) and
multi-site (B2) synthetic crystals, with and without SOC/HoH.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rslmtoasa.models.presets import build_synthetic_b2, build_synthetic_bcc
from rslmtoasa.ops.block_lanczos import block_lanczos, block_start_vectors
from rslmtoasa.ops.chebyshev import chebyshev_moments
from rslmtoasa.ops.msconv import MSEngine, build_ms_stencil


def _setup(builder, hoh, **kw):
    sys_ = builder(hoh=hoh, **kw)
    cl = sys_.cluster
    hb = sys_.ham
    ntype = hb.ee.shape[0]
    lsham = hb.lsham if hb.lsham is not None else np.zeros(
        (ntype, 18, 18), np.complex128)
    rec = [int(j) - 1 for j in cl.irec]
    psi0 = block_start_vectors(cl.kk, rec)
    return sys_, cl, hb, lsham, psi0


@pytest.mark.parametrize("builder,hoh", [
    (build_synthetic_bcc, False),
    (build_synthetic_bcc, True),
    (build_synthetic_b2, False),
    (build_synthetic_b2, True),
], ids=["bcc", "bcc_hoh", "b2", "b2_hoh"])
def test_block_lanczos_ms_parity(builder, hoh):
    lld = 6
    sys_, cl, hb, lsham, psi0 = _setup(
        builder, hoh, rc=8.0, lld=lld, nsp=2)
    a_ref, b_ref = block_lanczos(
        jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), lld, hoh=hoh,
        hso=jnp.asarray(hb.eeo) if hoh else None,
        enim=jnp.asarray(hb.enim) if hoh else None)
    eng = MSEngine(build_ms_stencil(cl), hb.ee, lsham, hoh=hoh,
                   hso=hb.eeo if hoh else None,
                   enim=hb.enim if hoh else None)
    a_ms, b_ms = eng.block_lanczos(eng.embed(psi0), lld)
    np.testing.assert_allclose(a_ms, np.asarray(a_ref), atol=5e-11)
    np.testing.assert_allclose(b_ms, np.asarray(b_ref), atol=5e-11)


@pytest.mark.parametrize("builder,hoh", [
    (build_synthetic_bcc, False),
    (build_synthetic_b2, False),
    (build_synthetic_b2, True),
], ids=["bcc", "b2", "b2_hoh"])
def test_chebyshev_ms_parity(builder, hoh):
    lld = 6
    a_s, b_s = 1.9, -0.2
    sys_, cl, hb, lsham, psi0 = _setup(
        builder, hoh, rc=8.0, lld=lld, nsp=2)
    mu_ref = np.asarray(chebyshev_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), lld, a_s, b_s, hoh=hoh,
        hso=jnp.asarray(hb.eeo) if hoh else None,
        enim=jnp.asarray(hb.enim) if hoh else None))
    eng = MSEngine(build_ms_stencil(cl), hb.ee, lsham, hoh=hoh,
                   hso=hb.eeo if hoh else None,
                   enim=hb.enim if hoh else None)
    mu_ms = eng.chebyshev_moments(eng.embed(psi0), lld, a_s, b_s)
    np.testing.assert_allclose(mu_ms, mu_ref, atol=5e-10)


def test_ms_wavefront_staging_parity():
    """Wavefront-staged execution (growing subgrids) is exactly the
    dense recursion: outside the k-step ball everything is zero, so
    restricting step k to the ball's bounding box changes nothing."""
    lld = 5
    sys_, cl, hb, lsham, psi0 = _setup(
        build_synthetic_bcc, False, rc=20.0, lld=lld, nsp=2)
    eng = MSEngine(build_ms_stencil(cl), hb.ee, lsham)
    g = eng.embed(psi0)
    bbox = eng.start_bbox(psi0)
    plan = eng.stage_plan(bbox, lld - 1, first_ball=1)
    assert plan is not None and len(plan) > 1, \
        f"staging should engage on this cluster (plan={plan})"
    a_st, b_st = eng.block_lanczos(g, lld, start_bbox=bbox)
    a_dn, b_dn = eng.block_lanczos(g, lld)
    np.testing.assert_allclose(a_st, a_dn, atol=1e-12)
    np.testing.assert_allclose(b_st, b_dn, atol=1e-12)
    mu_st = eng.chebyshev_moments(g, lld, 1.9, -0.2, start_bbox=bbox)
    mu_dn = eng.chebyshev_moments(g, lld, 1.9, -0.2)
    np.testing.assert_allclose(mu_st, mu_dn, atol=1e-12)


def test_ms_stencil_rejects_wrapped_pbc():
    """Wrapped PBC aliases conv taps — the one cluster class with no
    constant-offset embedding (impurity/surface clusters now build)."""
    sys_ = build_synthetic_bcc(rc=8.0, lld=4)
    cl = sys_.cluster
    cl.nmax = 3
    build_ms_stencil(cl)  # impurity-local zones no longer reject
    cl.nmax = 0
    cl.pbc_wrap = (True, False, False)
    with pytest.raises(ValueError):
        build_ms_stencil(cl)


def test_ms_surface_layered_parity(reference_dir):
    """Surface slabs on the conv engine: per-layer types become gather
    corrections (bulk main kernel + (H_t - H_bulk) row deltas gathered
    per special-type atom).  Parity vs the gather engine on a reduced
    real fccCu001 cluster, with and without HoH."""
    import os
    import shutil
    import tempfile

    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.bulk import BulkSystem

    src = str(reference_dir / "tests/scf/cases/surface/fccCu001")
    wd = tempfile.mkdtemp(prefix="rslmto_surf_")
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), wd)
    cfg = JobConfig.from_file(os.path.join(wd, "input.nml"))
    cfg.atoms.database = wd
    cfg.control.nsp = 2
    cfg.lattice.rc = 18.0  # small slab for CPU parity
    cfg.lattice.ndim = 30000
    for hoh in (False, True):
        cfg.hamiltonian.hoh = hoh
        sys_ = BulkSystem.build(cfg, wd)
        sys_.build_hamiltonian()
        cl, hb = sys_.cluster, sys_.ham
        assert hb.blocks is None, "surface should use per-type ELL rows"
        st = build_ms_stencil(cl)
        assert st.atom_type is not None, "layered stencil expected"
        lsham = hb.lsham
        rec = [int(j) - 1 for j in cl.irec]
        psi0 = block_start_vectors(cl.kk, rec)
        lld = 5
        a_ref, b_ref = block_lanczos(
            jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
            jnp.asarray(hb.cols), jnp.asarray(psi0), lld, hoh=hoh,
            hso=jnp.asarray(hb.eeo) if hoh else None,
            enim=jnp.asarray(hb.enim) if hoh else None)
        eng = MSEngine(st, hb.ee, lsham, hoh=hoh,
                       hso=hb.eeo if hoh else None,
                       enim=hb.enim if hoh else None)
        assert eng.gcorr is not None, "surface corrections expected"
        a_ms, b_ms = eng.block_lanczos(eng.embed(psi0), lld)
        np.testing.assert_allclose(a_ms, np.asarray(a_ref), atol=1e-10)
        np.testing.assert_allclose(b_ms, np.asarray(b_ref), atol=1e-10)
    shutil.rmtree(wd, ignore_errors=True)


def test_ms_impurity_local_parity(reference_dir):
    """Impurity clusters on the conv engine: the per-atom hall rows of
    the local zone become small gather corrections (delta_i = hall[i] -
    ee[type_i]) on top of the bulk conv + type-masked corrections.
    Parity vs the gather engine on a reduced real B2FeCo cluster,
    with and without HoH."""
    import os
    import shutil
    import tempfile

    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.bulk import BulkSystem

    src = str(reference_dir / "tests/scf/cases/impurity/B2FeCo")
    wd = tempfile.mkdtemp(prefix="rslmto_imp_")
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), wd)
    cfg = JobConfig.from_file(os.path.join(wd, "input.nml"))
    cfg.atoms.database = wd
    cfg.control.nsp = 2
    cfg.lattice.rc = 16.0  # reduced cluster for CPU parity
    cfg.lattice.ndim = 30000
    for hoh in (False, True):
        cfg.hamiltonian.hoh = hoh
        sys_ = BulkSystem.build(cfg, wd)
        sys_.build_hamiltonian()
        cl, hb = sys_.cluster, sys_.ham
        assert hb.blocks is not None and cl.nmax > 0
        lsham = hb.lsham
        rec = [int(j) - 1 for j in cl.irec]
        psi0 = block_start_vectors(cl.kk, rec)
        lld = 5
        a_ref, b_ref = block_lanczos(
            jnp.asarray(hb.blocks), jnp.asarray(lsham),
            jnp.asarray(hb.iz_eff), jnp.asarray(hb.cols),
            jnp.asarray(psi0), lld, hoh=hoh,
            hso=jnp.asarray(hb.blocks_o) if hoh else None,
            enim=jnp.asarray(hb.enim) if hoh else None,
            iz_onsite=jnp.asarray(hb.iz))
        st = build_ms_stencil(cl)
        eng = MSEngine(st, hb.ee, lsham, hoh=hoh,
                       hso=hb.eeo if hoh else None,
                       enim=hb.enim if hoh else None,
                       local={"nmax": cl.nmax, "cols": hb.cols,
                              "hall": hb.hall, "hallo": hb.hallo})
        assert eng.local is not None
        a_ms, b_ms = eng.block_lanczos(eng.embed(psi0), lld)
        np.testing.assert_allclose(a_ms, np.asarray(a_ref), atol=1e-9)
        np.testing.assert_allclose(b_ms, np.asarray(b_ref), atol=1e-9)
    shutil.rmtree(wd, ignore_errors=True)


def test_ms_staging_with_corrections(reference_dir):
    """Round-4 composition: the wavefront stage plan now composes with
    the gather corrections (impurity hall rows + re-typed zones) by
    remapping the correction indices into each stage box — the round-3
    blocker that kept B2FeCo off the staged conv path.  Staged vs dense
    on a reduced real B2FeCo impurity cluster with HoH."""
    import os
    import shutil
    import tempfile

    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.bulk import BulkSystem

    src = str(reference_dir / "tests/scf/cases/impurity/B2FeCo")
    wd = tempfile.mkdtemp(prefix="rslmto_impstage_")
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), wd)
    cfg = JobConfig.from_file(os.path.join(wd, "input.nml"))
    cfg.atoms.database = wd
    cfg.control.nsp = 2
    cfg.hamiltonian.hoh = True
    cfg.lattice.rc = 24.0
    cfg.lattice.ndim = 30000
    sys_ = BulkSystem.build(cfg, wd)
    sys_.build_hamiltonian()
    cl, hb = sys_.cluster, sys_.ham
    rec = [int(j) - 1 for j in cl.irec]
    psi0 = block_start_vectors(cl.kk, rec)
    lld = 5
    st = build_ms_stencil(cl)
    eng = MSEngine(st, hb.ee, hb.lsham, hoh=True, hso=hb.eeo,
                   enim=hb.enim,
                   local={"nmax": cl.nmax, "cols": hb.cols,
                          "hall": hb.hall, "hallo": hb.hallo})
    assert eng.local is not None and eng.gcorr is not None
    g = eng.embed(psi0)
    bbox = eng.start_bbox(psi0)
    # force=True bypasses the compile-aware work threshold (at lld=5 the
    # saving is below the 40% bar) — this test is about CORRECTNESS of
    # the staged path with corrections, so stage regardless
    plan = eng.stage_plan(bbox, lld - 1, first_ball=1, force=True)
    assert plan is not None and len(plan) > 1, \
        f"staging should engage with corrections (plan={plan})"
    a_st, b_st = eng.block_lanczos(g, lld, start_bbox=bbox, plan=plan)
    a_dn, b_dn = eng.block_lanczos(g, lld)
    np.testing.assert_allclose(a_st, a_dn, atol=1e-11)
    np.testing.assert_allclose(b_st, b_dn, atol=1e-11)
    plan_c = eng.stage_plan(bbox, lld, first_ball=2, force=True)
    mu_st = eng.chebyshev_moments(g, lld, 1.9, -0.2, start_bbox=bbox,
                                  plan=plan_c)
    mu_dn = eng.chebyshev_moments(g, lld, 1.9, -0.2)
    np.testing.assert_allclose(mu_st, mu_dn, atol=1e-11)
    shutil.rmtree(wd, ignore_errors=True)
