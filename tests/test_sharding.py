"""Multi-device sharding parity on the virtual 8-device CPU mesh.

The reference's only distribution axis is atoms/chains with
allreduce-sum collectives (``source/mpi.f90:32-58``; determinism across
rank counts is a stated property of its test suite).  These tests assert
the same property for the device layouts: every sharded formulation must
reproduce the single-device result to f64 round-off.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


@pytest.fixture(scope="module")
def small_system():
    from rslmtoasa.models.presets import build_synthetic_bcc

    sys_ = build_synthetic_bcc(rc=8.0, ndim=2000, lld=6)
    return sys_.ham


def _padded_rows(hb, n_shards):
    """Pad rows to a multiple of the mesh size; sentinel columns >= kk_pad."""
    kk = hb.kk
    kk_pad = -(-kk // n_shards) * n_shards
    iz_p = np.zeros(kk_pad, np.int32)
    iz_p[:kk] = np.asarray(hb.iz)
    cols = np.asarray(hb.cols)
    cols_p = np.full((kk_pad, hb.nslots), kk_pad, np.int32)
    cols_p[:kk] = np.where(cols >= kk, kk_pad, cols)
    return kk_pad, iz_p, cols_p


def test_lanczos_chain_sharded_matches_unsharded(small_system):
    from rslmtoasa.ops.lanczos import (
        lanczos_coefficients,
        scalar_start_vectors,
    )
    from rslmtoasa.parallel.mesh import lanczos_sharded, make_mesh

    hb = small_system
    mesh = make_mesh(8)
    hs = jnp.asarray(hb.ee[:, :, :9, :9])
    iz = jnp.asarray(hb.iz)
    cols = jnp.asarray(hb.cols)
    psi0 = np.asarray(scalar_start_vectors(hb.kk, [0]))
    psi0 = np.tile(psi0, (1, 1, 2))[:, :, :16]  # 16 chains over 8 devices
    a_s, b2_s = lanczos_sharded(mesh, hs, iz, cols, jnp.asarray(psi0), 6)
    a_r, b2_r = lanczos_coefficients(hs, iz, cols, jnp.asarray(psi0), 6)
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_r), atol=1e-12)
    np.testing.assert_allclose(np.asarray(b2_s), np.asarray(b2_r), atol=1e-12)


def test_rowsharded_halo_spmv_matches_dense(small_system):
    from rslmtoasa.ops.lanczos import block_spmv
    from rslmtoasa.parallel.mesh import make_mesh, rowsharded_spmv_halo

    hb = small_system
    mesh = make_mesh(8)
    n_shards = 8
    kk_pad, iz_p, cols_p = _padded_rows(hb, n_shards)
    hs = jnp.asarray(hb.ee[:, :, :9, :9])

    rng = np.random.default_rng(7)
    psi = (rng.standard_normal((kk_pad, 9, 4))
           + 1j * rng.standard_normal((kk_pad, 9, 4)))
    psi[hb.kk:] = 0.0

    y = rowsharded_spmv_halo(
        mesh, hs, jnp.asarray(iz_p), jnp.asarray(cols_p), jnp.asarray(psi)
    )
    psi_ref = jnp.concatenate(
        [jnp.asarray(psi), jnp.zeros((1, 9, 4), jnp.complex128)], axis=0
    )
    y_ref = block_spmv(hs, jnp.asarray(iz_p), jnp.asarray(cols_p), psi_ref)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-12)


def test_lanczos_rowsharded_matches_unsharded(small_system):
    from rslmtoasa.ops.lanczos import (
        lanczos_coefficients,
        scalar_start_vectors,
    )
    from rslmtoasa.parallel.mesh import lanczos_rowsharded, make_mesh

    hb = small_system
    mesh = make_mesh(8)
    n_shards = 8
    kk_pad, iz_p, cols_p = _padded_rows(hb, n_shards)
    hs = jnp.asarray(hb.ee[:, :, :9, :9])
    lld = 6

    psi0_full = np.asarray(scalar_start_vectors(hb.kk, [0]))  # (kk+1, 9, 9)
    psi0 = np.zeros((kk_pad, 9, 9), np.complex128)
    psi0[:hb.kk] = psi0_full[:-1]

    a_s, b2_s = lanczos_rowsharded(
        mesh, hs, jnp.asarray(iz_p), jnp.asarray(cols_p),
        jnp.asarray(psi0), lld
    )
    a_r, b2_r = lanczos_coefficients(
        hs, jnp.asarray(hb.iz), jnp.asarray(hb.cols),
        jnp.asarray(psi0_full), lld
    )
    np.testing.assert_allclose(np.asarray(a_s), np.asarray(a_r), atol=1e-10)
    np.testing.assert_allclose(np.asarray(b2_s), np.asarray(b2_r), atol=1e-10)


def test_total_dos_psum(small_system):
    from rslmtoasa.parallel.mesh import make_mesh, total_dos_psum

    mesh = make_mesh(8)
    rng = np.random.default_rng(3)
    dens = rng.standard_normal((32, 16))
    dtot = total_dos_psum(mesh, jnp.asarray(dens))
    np.testing.assert_allclose(np.asarray(dtot), dens.sum(axis=1),
                               atol=1e-12)


def test_grid_sharded_block_matches_dense():
    """Grid-sharded ms-conv block recursion (x-slab halo exchange,
    ops/msconv_shard.py) vs the dense engine at 1e-10 — the beyond-HBM
    route for clusters whose single-chain state exceeds one chip."""
    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.ops.msconv import MSEngine, build_ms_stencil
    from rslmtoasa.ops.msconv_shard import block_lanczos_ms_sharded
    from rslmtoasa.parallel.mesh import make_mesh

    lld = 5
    sys_ = build_synthetic_bcc(rc=8.0, lld=lld, nsp=2, hoh=True)
    cl, hb = sys_.cluster, sys_.ham
    lsham = hb.lsham
    psi0 = block_start_vectors(cl.kk, [0, 1])
    eng = MSEngine(build_ms_stencil(cl), hb.ee, lsham, hoh=True,
                   hso=hb.eeo, enim=hb.enim)
    grid = eng.embed(psi0)
    a_ref, b_ref = eng.block_lanczos(grid, lld)
    mesh = make_mesh(8)
    a_sh, b_sh = block_lanczos_ms_sharded(eng, mesh, grid, lld)
    np.testing.assert_allclose(a_sh, a_ref, atol=1e-10)
    np.testing.assert_allclose(b_sh, b_ref, atol=1e-10)


@pytest.mark.parametrize("hoh", [False, True])
def test_grid_sharded_chebyshev_matches_dense(hoh):
    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.ops.msconv import MSEngine, build_ms_stencil
    from rslmtoasa.ops.msconv_shard import (
        chebyshev_moments_ms_sharded,
    )
    from rslmtoasa.parallel.mesh import make_mesh

    lld = 5
    a_s, b_s = 1.9, -0.2
    sys_ = build_synthetic_bcc(rc=8.0, lld=lld, nsp=2, hoh=hoh)
    cl, hb = sys_.cluster, sys_.ham
    lsham = hb.lsham if hb.lsham is not None else np.zeros(
        (hb.ee.shape[0], 18, 18), np.complex128)
    psi0 = block_start_vectors(cl.kk, [0])
    eng = MSEngine(build_ms_stencil(cl), hb.ee, lsham, hoh=hoh,
                   hso=hb.eeo if hoh else None,
                   enim=hb.enim if hoh else None)
    grid = eng.embed(psi0)
    mu_ref = eng.chebyshev_moments(grid, lld, a_s, b_s)
    mesh = make_mesh(8)
    mu_sh = chebyshev_moments_ms_sharded(eng, mesh, grid, lld, a_s, b_s)
    np.testing.assert_allclose(mu_sh, mu_ref, atol=1e-10)


def _reduced_case_system(reference_dir, case: str, rc: float, hoh: bool):
    import os
    import shutil
    import tempfile

    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.bulk import BulkSystem

    src = str(reference_dir / f"tests/scf/cases/{case}")
    wd = tempfile.mkdtemp(prefix="rslmto_shard_")
    for f in os.listdir(src):
        shutil.copy(os.path.join(src, f), wd)
    cfg = JobConfig.from_file(os.path.join(wd, "input.nml"))
    cfg.atoms.database = wd
    cfg.control.nsp = 2
    cfg.hamiltonian.hoh = hoh
    cfg.lattice.rc = rc
    cfg.lattice.ndim = 30000
    sys_ = BulkSystem.build(cfg, wd)
    sys_.build_hamiltonian()
    shutil.rmtree(wd, ignore_errors=True)
    return sys_


def test_grid_sharded_block_surface_matches_dense(reference_dir):
    """Grid-sharded block recursion on a CORRECTED stencil (surface
    per-layer types -> gcorr gather corrections routed to the owning
    x-slab) vs the dense engine at 1e-10 — the beyond-HBM route for
    surface slabs."""
    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.ops.msconv import MSEngine, build_ms_stencil
    from rslmtoasa.ops.msconv_shard import block_lanczos_ms_sharded
    from rslmtoasa.parallel.mesh import make_mesh

    lld = 5
    sys_ = _reduced_case_system(reference_dir, "surface/fccCu001",
                                rc=18.0, hoh=True)
    cl, hb = sys_.cluster, sys_.ham
    st = build_ms_stencil(cl)
    assert st.atom_type is not None
    eng = MSEngine(st, hb.ee, hb.lsham, hoh=True, hso=hb.eeo,
                   enim=hb.enim)
    assert eng.gcorr is not None
    rec = [int(j) - 1 for j in cl.irec][:2]
    psi0 = block_start_vectors(cl.kk, rec)
    grid = eng.embed(psi0)
    a_ref, b_ref = eng.block_lanczos(grid, lld)
    mesh = make_mesh(8)
    a_sh, b_sh = block_lanczos_ms_sharded(eng, mesh, grid, lld)
    np.testing.assert_allclose(a_sh, a_ref, atol=1e-10)
    np.testing.assert_allclose(b_sh, b_ref, atol=1e-10)


def test_grid_sharded_block_impurity_matches_dense(reference_dir):
    """Grid-sharded block recursion with impurity hall-row local
    corrections (per-atom deltas owned by their x-slab) vs the dense
    engine at 1e-10."""
    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.ops.msconv import MSEngine, build_ms_stencil
    from rslmtoasa.ops.msconv_shard import block_lanczos_ms_sharded
    from rslmtoasa.parallel.mesh import make_mesh

    lld = 5
    sys_ = _reduced_case_system(reference_dir, "impurity/B2FeCo",
                                rc=16.0, hoh=True)
    cl, hb = sys_.cluster, sys_.ham
    assert hb.blocks is not None and cl.nmax > 0
    st = build_ms_stencil(cl)
    eng = MSEngine(st, hb.ee, hb.lsham, hoh=True, hso=hb.eeo,
                   enim=hb.enim,
                   local={"nmax": cl.nmax, "cols": hb.cols,
                          "hall": hb.hall, "hallo": hb.hallo})
    assert eng.local is not None
    rec = [int(j) - 1 for j in cl.irec]
    psi0 = block_start_vectors(cl.kk, rec)
    grid = eng.embed(psi0)
    a_ref, b_ref = eng.block_lanczos(grid, lld)
    mesh = make_mesh(8)
    a_sh, b_sh = block_lanczos_ms_sharded(eng, mesh, grid, lld)
    np.testing.assert_allclose(a_sh, a_ref, atol=1e-10)
    np.testing.assert_allclose(b_sh, b_ref, atol=1e-10)


def test_grid_shard_gate_engages(monkeypatch):
    """The ms engine's memory gate routes oversized correction-free
    clusters to the grid-sharded engine when a mesh exists, and refuses
    the engine otherwise."""
    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.msconv import ms_engine_for
    from rslmtoasa.parallel import dispatch

    sys_ = build_synthetic_bcc(rc=8.0, lld=4, nsp=2)
    cl, hb = sys_.cluster, sys_.ham
    monkeypatch.setenv("RSLMTO_MS_HBM_BYTES", "20000000")  # < one chain, > chain/8
    # with the 8-device mesh: grid-sharded engine
    dispatch._mesh_cache.update(mesh=None, checked=False)
    assert dispatch.get_mesh() is not None
    eng = ms_engine_for(cl, hb.ee, hb.lsham, False, None, None)
    assert eng is not None and eng._grid_shard
    # without a mesh: engine unavailable (gather fallback)
    dispatch._mesh_cache.update(mesh=None, checked=True)
    eng2 = ms_engine_for(cl, hb.ee, hb.lsham, False, None, None)
    assert eng2 is None
    dispatch._mesh_cache.update(mesh=None, checked=False)
