"""Conv-stencil df64 Lanczos vs the complex128 ELL engine.

The conv engine is a df64 formulation for single-site crystals that no
production path selects any more; on CPU it runs with f32
conv + df64 compensation, so its coefficients must match the exact
complex128 recursion to the df64 noise floor (~1e-12 on the chain
coefficients after ~20 steps), far inside the 1e-6 reference gate.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.ops.lanczos import (
    lanczos_coefficients,
    scalar_start_vectors,
    split_complex,
)
from rslmtoasa.ops.stencil_conv import (
    build_conv_stencil,
    conv_start_vectors,
    lanczos_coefficients_conv_df64,
    pack_conv_kernel_df64,
)


@pytest.fixture(scope="module")
def small_sys():
    return build_synthetic_bcc(rc=16.0, ndim=4000, lld=12)


def test_conv_lanczos_matches_complex128(small_sys):
    sys_ = small_sys
    hb = sys_.ham
    cl = sys_.cluster
    lld = 12
    blk = hb.ee[:, :, :9, :9]  # spin-up channel

    # exact reference: complex128 ELL recursion
    psi0 = scalar_start_vectors(cl.kk, [0, 3])
    a_ref, b2_ref = lanczos_coefficients(
        jnp.asarray(blk), jnp.asarray(hb.iz), jnp.asarray(hb.cols),
        jnp.asarray(psi0), lld)
    a_ref, b2_ref = np.asarray(a_ref), np.asarray(b2_ref)

    # conv-stencil df64
    st = build_conv_stencil(cl)
    hs_split = np.asarray(split_complex(blk[0]))  # (nslots, 18, 18)
    w, h_scale, radius = pack_conv_kernel_df64(hs_split, st.dcells)
    psi0_ds = conv_start_vectors(st, [0, 3], 18)
    a, b2 = lanczos_coefficients_conv_df64(w, h_scale, st.mask, psi0_ds,
                                           lld, radius=radius)

    assert a.shape == a_ref.shape == (lld, 18)
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=5e-11)
    np.testing.assert_allclose(b2, b2_ref, rtol=5e-11, atol=5e-11)


def test_conv_stencil_consistency(small_sys):
    st = build_conv_stencil(small_sys.cluster)
    # every atom mapped, mask count matches, slot 0 is the center tap
    assert int(st.mask.sum()) == small_sys.cluster.kk
    assert np.all(st.dcells[0] == 0)
    assert np.abs(st.dcells).max() == 1  # bcc ct=3.0 A: 3x3x3 stencil


def test_conv_chebyshev_matches_block(small_sys):
    """Conv-df64 Chebyshev moments vs the complex128 block engine: the
    diagonal of a block-identity start equals the per-orbital scalar
    chains (chebyshev_recur doubling, recursion.f90:3057-3135)."""
    import jax.numpy as jnp

    from rslmtoasa.ops.block_lanczos import block_start_vectors
    from rslmtoasa.ops.chebyshev import chebyshev_moments
    from rslmtoasa.ops.stencil_conv import chebyshev_moments_conv_df64

    sys_ = small_sys
    hb = sys_.ham
    cl = sys_.cluster
    lld = 10
    a, b = 1.3, -0.2
    blk = hb.ee[:, :, :9, :9]
    lsham = np.zeros((1, 9, 9), np.complex128)
    psi0 = block_start_vectors(cl.kk, [0])[:, :, :9, :9]
    mu_blk = np.asarray(chebyshev_moments(
        jnp.asarray(blk), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(psi0), lld, a, b))
    diag_ref = np.einsum("nrll->nrl", mu_blk.real)[:, 0]  # (2lld+2, 9)

    st = build_conv_stencil(cl)
    hs_split = np.asarray(split_complex(blk[0]))
    w, h_scale, radius = pack_conv_kernel_df64(hs_split, st.dcells)
    psi0_ds = conv_start_vectors(st, [0], 18, orbitals=range(9))
    mu = chebyshev_moments_conv_df64(w, h_scale, st.mask, psi0_ds, lld,
                                     a, b, radius=radius)
    np.testing.assert_allclose(mu, diag_ref, rtol=0, atol=5e-11)
