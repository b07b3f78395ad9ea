"""Production drivers on a multi-device mesh vs single device.

The conftest forces an 8-virtual-device CPU platform, so the dispatch
layer (parallel/dispatch.py) chain-shards the production engines exactly
as it would on eight GPUs.  A full SCF step and an exchange pair
batch must match the single-device result at 1e-12 (the reference's
rank-count-independence property: its collectives are allreduce-sums,
tests/run_binary.sh runs the same cases at 1, 2 and 4 ranks).
"""

import numpy as np
import pytest

from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.parallel import dispatch


@pytest.fixture
def mesh_toggle():
    """Restore the dispatch mesh cache after each test."""
    yield
    dispatch._mesh_cache.update(mesh=None, checked=False)


def _force_single():
    dispatch._mesh_cache.update(mesh=None, checked=True)


def _use_mesh():
    dispatch._mesh_cache.update(mesh=None, checked=False)


def test_run_block_mesh_matches_single(mesh_toggle):
    sys_ = build_synthetic_bcc(rc=8.0, ndim=2000, lld=6, nsp=2)
    sys_.cluster.irec = np.ones(8, dtype=np.int64)  # 8 chains -> 8 shards
    _use_mesh()
    a_m, b_m = sys_.run_block()
    assert dispatch.get_mesh() is not None
    _force_single()
    a_1, b_1 = sys_.run_block()
    np.testing.assert_allclose(a_m, a_1, atol=1e-12)
    np.testing.assert_allclose(b_m, b_1, atol=1e-12)


def test_run_chebyshev_mesh_matches_single(mesh_toggle):
    from rslmtoasa.physics.energy_mesh import EnergyMesh

    sys_ = build_synthetic_bcc(rc=8.0, ndim=2000, lld=6, nsp=2)
    sys_.cfg.control.recur = "chebyshev"
    sys_.cluster.irec = np.ones(8, dtype=np.int64)
    # widen the window to contain the synthetic spectrum — the
    # divergence guard (recursion.f90:2594-2596) fatals otherwise
    sys_.cfg.energy.energy_min = -1.5
    sys_.cfg.energy.energy_max = 1.0
    em = EnergyMesh.build(sys_.cfg.energy)
    _use_mesh()
    mu_m = sys_.run_chebyshev(em)
    _force_single()
    mu_1 = sys_.run_chebyshev(em)
    np.testing.assert_allclose(mu_m, mu_1, atol=1e-12)


def test_exchange_pairs_mesh_matches_single(mesh_toggle):
    """The njij pair partition (calculation.f90:863) as chain sharding."""
    from rslmtoasa.models.exchange import pair_start_vectors
    from rslmtoasa.parallel.dispatch import block_lanczos_auto

    sys_ = build_synthetic_bcc(rc=8.0, ndim=2000, lld=6, nsp=2)
    hb = sys_.ham
    kk = sys_.cluster.kk
    pairs = np.array([[1, 2], [1, 3]])  # 2 pairs x 4 starts = 8 chains
    psi0 = pair_start_vectors(kk, pairs)
    lsham = np.zeros((hb.ee.shape[0], 18, 18), np.complex128)
    _use_mesh()
    a_m, b_m = block_lanczos_auto(hb.ee, lsham, hb.iz, hb.cols, psi0, 6)
    _force_single()
    a_1, b_1 = block_lanczos_auto(hb.ee, lsham, hb.iz, hb.cols, psi0, 6)
    np.testing.assert_allclose(a_m, a_1, atol=1e-12)
    np.testing.assert_allclose(b_m, b_1, atol=1e-12)


def test_lanczos_rowshard_hbm_route(mesh_toggle, monkeypatch):
    """The HBM-threshold row-sharding route (dispatch._rowshard_wanted):
    with a tiny budget the scalar dispatch runs the ppermute-halo
    row-sharded engine and matches the replicated chain-sharded result."""
    from rslmtoasa.ops.lanczos import scalar_start_vectors

    sys_ = build_synthetic_bcc(rc=8.0, ndim=2000, lld=6)
    hb = sys_.ham
    kk = sys_.cluster.kk
    blk = hb.ee[:, :, :9, :9]
    psi0 = np.asarray(scalar_start_vectors(kk, [0]))
    # 9 chains < 8 devices would skip the mesh; tile to 16
    psi0 = np.tile(psi0, (1, 1, 2))[:, :, :16]
    _use_mesh()
    monkeypatch.setenv("RSLMTO_ROWSHARD_BYTES", "1")
    a_rs, b_rs = dispatch.lanczos_auto(blk, hb.iz, hb.cols, psi0, 6)
    monkeypatch.delenv("RSLMTO_ROWSHARD_BYTES")
    a_cs, b_cs = dispatch.lanczos_auto(blk, hb.iz, hb.cols, psi0, 6)
    np.testing.assert_allclose(a_rs, a_cs, atol=1e-10)
    np.testing.assert_allclose(b_rs, b_cs, atol=1e-10)
