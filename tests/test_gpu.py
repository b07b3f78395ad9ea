"""Recursion engines on the GPU against the same call on the CPU.

Marked ``gpu``; each test asks for the ``gpu`` fixture, which skips when
JAX sees no GPU.  ``chip_smoke.py`` runs them on the card with
``pytest -m gpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("no GPU visible to JAX")
    return devs[0]


@pytest.fixture(scope="module")
def bcc():
    from rslmtoasa.models.presets import build_synthetic_bcc

    return build_synthetic_bcc(rc=16.0, ndim=4000, lld=8, nsp=2, hoh=True)


def _engine(name, sys_):
    from rslmtoasa.ops.block_lanczos import block_lanczos, block_start_vectors
    from rslmtoasa.ops.chebyshev import chebyshev_moments
    from rslmtoasa.ops.kubo import kubo_moments
    from rslmtoasa.ops.lanczos import lanczos_coefficients, scalar_start_vectors
    from rslmtoasa.ops.ldos import _bprldos_shifted

    hb = sys_.ham
    kk = hb.kk
    tabs = (hb.ee, hb.lsham, hb.iz, hb.cols)
    psi0 = block_start_vectors(kk, [0, 5])
    hoh = dict(hoh=True, hso=hb.eeo, enim=hb.enim)
    if name == "lanczos":
        return lambda: lanczos_coefficients(
            jnp.asarray(hb.ee[:, :, :9, :9]), jnp.asarray(hb.iz),
            jnp.asarray(hb.cols), jnp.asarray(scalar_start_vectors(kk, [0])),
            8)
    if name == "block_hoh":
        return lambda: block_lanczos(
            *map(jnp.asarray, tabs), jnp.asarray(psi0), 8,
            **{k: jnp.asarray(v) if k != "hoh" else v
               for k, v in hoh.items()})
    if name == "chebyshev_hoh":
        return lambda: chebyshev_moments(
            *map(jnp.asarray, tabs), jnp.asarray(psi0), 8, 1.9, -0.2,
            **{k: jnp.asarray(v) if k != "hoh" else v
               for k, v in hoh.items()})
    if name == "block_spin_split":
        from rslmtoasa.parallel.dispatch import block_lanczos_auto

        # no SOC: the collinear problem splits into two 9x9 sectors
        return lambda: block_lanczos_auto(
            hb.ee, np.zeros_like(hb.lsham), hb.iz, hb.cols, psi0, 8,
            hoh=True, hso=hb.eeo, enim=hb.enim)
    if name == "kubo":
        return lambda: kubo_moments(
            *map(jnp.asarray, tabs[:4]), jnp.asarray(hb.ee),
            jnp.asarray(hb.ee), jnp.asarray(psi0[0, :-1]), n_moments=6,
            block_size=4, a=1.9, b=-0.2)
    e = np.linspace(-1.0, 1.0, 9)[:, None] * np.ones((1, 18))
    a = np.linspace(-0.3, 0.3, 8 * 18).reshape(8, 18)
    b2 = np.full((8, 18), 0.04)
    return lambda: _bprldos_shifted(jnp.asarray(e), jnp.asarray(a),
                                    jnp.asarray(b2), -np.ones(18),
                                    np.ones(18))


@pytest.mark.parametrize("name", ["lanczos", "block_hoh", "chebyshev_hoh",
                                  "block_spin_split", "kubo", "ldos"])
def test_engine_on_gpu_matches_cpu(name, gpu, bcc):
    fn = _engine(name, bcc)
    with jax.default_device(gpu):
        got = jax.tree_util.tree_leaves(fn())
    # the dispatch entry returns host arrays; the engines device arrays
    assert all(next(iter(x.devices())).platform == "gpu" for x in got
               if isinstance(x, jax.Array))
    with jax.default_device(jax.devices("cpu")[0]):
        want = jax.tree_util.tree_leaves(fn())
    for g, w in zip(got, want):
        assert g.dtype in (jnp.complex128, jnp.float64)
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   atol=1e-10)
