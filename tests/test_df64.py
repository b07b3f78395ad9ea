"""Unit tests for the df64 (double-float + exact-chunk GEMM) module.

These validate the error-free transforms and the Ozaki-style chunked GEMM
against f64 references on CPU.
"""

import numpy as np
import jax.numpy as jnp

from rslmtoasa.ops import df64


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1000).astype(np.float32)
    b = (rng.standard_normal(1000) * 1e-6).astype(np.float32)
    s, e = df64.two_sum(jnp.asarray(a), jnp.asarray(b))
    s, e = np.asarray(s), np.asarray(e)
    exact = a.astype(np.float64) + b.astype(np.float64)
    assert np.array_equal(s.astype(np.float64) + e.astype(np.float64), exact)


def test_two_prod_exact():
    """two_prod is near-exact: the FMA-immune partial-product form (see
    df64.two_prod docstring) trades Dekker's error-free guarantee for
    immunity to LLVM FP contraction; the residual is <= 2^-44 relative,
    far below the df64 budget."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal(1000).astype(np.float32)
    b = rng.standard_normal(1000).astype(np.float32)
    p, e = df64.two_prod(jnp.asarray(a), jnp.asarray(b))
    p, e = np.asarray(p), np.asarray(e)
    exact = a.astype(np.float64) * b.astype(np.float64)
    err = np.abs((p.astype(np.float64) + e.astype(np.float64)) - exact)
    assert np.all(err <= 2.0**-44 * np.abs(exact))
    # the pair stays normalised: |e| <= ulp(p)
    assert np.all(np.abs(e) <= np.abs(p) * 2.0**-23 + 1e-38)


def test_ds_roundtrip_and_add():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(500)
    y = rng.standard_normal(500)
    dx = df64.ds_from_f64(x)
    dy = df64.ds_from_f64(y)
    assert np.allclose(df64.ds_to_f64(dx), x, rtol=0, atol=1e-14)
    s = df64.ds_add(dx, dy)
    assert np.allclose(df64.ds_to_f64(s), x + y, rtol=1e-13, atol=1e-15)
    m = df64.ds_mul(dx, dy)
    assert np.allclose(df64.ds_to_f64(m), x * y, rtol=1e-13, atol=1e-15)


def test_ds_sum_tree():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4096, 3))
    dx = df64.ds_from_f64(x)
    s = df64.ds_sum_tree(dx, 0)
    ref = x.sum(axis=0)
    assert np.allclose(df64.ds_to_f64(s), ref, rtol=1e-12, atol=1e-12)


def test_ds_dot():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 18, 5))
    y = rng.standard_normal((300, 18, 5))
    d = df64.ds_dot(df64.ds_from_f64(x), df64.ds_from_f64(y), (0, 1))
    ref = np.einsum("ibc,ibc->c", x, y)
    assert np.allclose(df64.ds_to_f64(d), ref, rtol=1e-12, atol=1e-12)


def test_pack_chunks_host_reconstruction():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((18, 270)) * 0.3
    ch, scale = df64.pack_chunks_host(x)
    rec = np.asarray(ch, np.float64).sum(axis=0) * scale
    assert np.abs(rec - x).max() < 2.0 ** (-7 * df64.DF64_CHUNKS) * scale * 2


def test_extract_chunks_reconstruction():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, 18)) * 0.49
    dx = df64.ds_from_f64(x)
    ch = df64.extract_chunks(dx)
    rec = np.asarray(ch, np.float64).sum(axis=0) * 2.0
    # ~2^-46 floor from the low-word fold
    assert np.abs(rec - x).max() < 1e-13
    # every chunk must be exactly representable in bf16 (<= 64ish quanta)
    for k in range(ch.shape[0]):
        u = 2.0 ** (-df64.CHUNK_BITS * (k + 1))
        m = np.asarray(ch[k], np.float64) / u
        assert np.abs(m).max() <= 128
        assert np.array_equal(m, np.round(m))


def test_gemm_df64_accuracy():
    rng = np.random.default_rng(7)
    h = rng.standard_normal((18, 270))
    x = rng.standard_normal((270, 400)) * 0.4
    hch, hs = df64.pack_chunks_host(h)
    xch = df64.extract_chunks(df64.ds_from_f64(x))

    def contract(hc, xc):
        return jnp.einsum("ak,kn->an", hc, xc,
                          preferred_element_type=jnp.float32)

    out = df64.gemm_df64(hch, hs, xch, 1.0, contract, df64.DF64_CHUNKS)
    ref = h @ x
    err = np.abs(df64.ds_to_f64(out) - ref).max()
    scale = np.abs(ref).max()
    assert err < 1e-11 * scale, f"gemm_df64 err {err:.3e} vs scale {scale:.3e}"
