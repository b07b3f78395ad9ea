"""The df64 (double-float + exact-chunk GEMM) recursion must reproduce the
complex128 Haydock recursion far inside the reference parity tolerance
(1e-6, ``tests/scf/README.md:151-156``); we demand ~1e-10 on the
tridiagonal coefficients after a full lld=16 chain."""

import numpy as np
import pytest

from rslmtoasa.ops import df64
from rslmtoasa.ops.lanczos import (
    lanczos_coefficients_split,
    scalar_start_vectors,
    split_complex,
    split_vector,
)
from rslmtoasa.ops.lanczos_df64 import (
    lanczos_coefficients_df64,
    pack_ham_df64,
)


@pytest.fixture(scope="module")
def bcc_system():
    from rslmtoasa.models.presets import build_synthetic_bcc

    return build_synthetic_bcc(rc=12.0, ndim=2000, lld=16)


def test_df64_matches_f64_lanczos(bcc_system):
    hb = bcc_system.ham
    kk = hb.kk
    lld = 16
    starts = [0, kk // 2]
    psi0_c = scalar_start_vectors(kk, starts)

    # f64 reference (split-complex representation, same recurrence)
    import jax.numpy as jnp

    hs = split_complex(hb.ee[:, :, :9, :9])
    cols = jnp.asarray(hb.cols)
    iz = jnp.asarray(hb.iz)
    a_ref, b2_ref = lanczos_coefficients_split(
        hs, iz, cols, split_vector(psi0_c), lld)
    a_ref = np.asarray(a_ref)
    b2_ref = np.asarray(b2_ref)

    # df64 path
    h_chunks, h_scale = pack_ham_df64(np.asarray(hb.ee[:, :, :9, :9]))
    assert h_chunks.shape[1] == 1  # single type
    psi0_r = np.asarray(split_vector(psi0_c), np.float64)
    psi0_ds = df64.ds_from_f64(psi0_r)
    a, b2 = lanczos_coefficients_df64(
        h_chunks[:, 0], h_scale, cols, psi0_ds, lld)

    assert a.shape == a_ref.shape
    np.testing.assert_allclose(a, a_ref, rtol=0, atol=5e-11)
    np.testing.assert_allclose(b2, b2_ref, rtol=5e-11, atol=5e-11)
