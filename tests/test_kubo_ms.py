"""df64 ms-conv Kubo moment engine vs the complex128 gather engine.

Whole-moment-matrix parity of ops/kubo_ms (the device conductivity
path) against ops/kubo complex128 on synthetic bcc crystals, with and
without HoH, for per-type unit and random-phase start blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from rslmtoasa.models.conductivity import build_velocity_operators
from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.ops.kubo import kubo_moments
from rslmtoasa.ops.kubo_ms import MSKubo
from rslmtoasa.ops.msconv import MSEngine, build_ms_stencil


def _setup(hoh):
    sys_ = build_synthetic_bcc(rc=8.0, lld=6, nsp=2, hoh=hoh)
    cl = sys_.cluster
    hb = sys_.ham
    ntype = hb.ee.shape[0]
    lsham = hb.lsham if hb.lsham is not None else np.zeros(
        (ntype, 18, 18), np.complex128)
    v_a, v_b, vo_a, vo_b = build_velocity_operators(
        sys_, [0.0, 1.0, 0.0], [1.0, 0.0, 0.0])
    return sys_, cl, hb, lsham, (v_a, v_b, vo_a, vo_b)


@pytest.mark.parametrize("hoh", [False, True], ids=["plain", "hoh"])
def test_kubo_ms_parity(hoh):
    n_moments = 6
    a_s, b_s = 1.9, -0.2
    sys_, cl, hb, lsham, (v_a, v_b, vo_a, vo_b) = _setup(hoh)
    psi0 = np.zeros((cl.kk, 18, 18), np.complex128)
    psi0[int(cl.atlist[0]) - 1] = np.eye(18)

    mu_ref = np.asarray(kubo_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(v_a), jnp.asarray(v_b),
        jnp.asarray(psi0), n_moments=n_moments, block_size=4,
        a=a_s, b=b_s, hoh=hoh,
        vo_a=jnp.asarray(vo_a), vo_b=jnp.asarray(vo_b),
        blocks_o=jnp.asarray(hb.eeo) if hoh else None,
        enim=jnp.asarray(hb.enim) if hoh else None))

    eng = MSEngine(build_ms_stencil(cl), hb.ee, lsham, hoh=hoh,
                   hso=hb.eeo if hoh else None,
                   enim=hb.enim if hoh else None)
    mk = MSKubo(eng, v_a, v_b, vo_a, vo_b)
    mu_ms = mk.moments(psi0, n_moments, a_s, b_s)
    scale = np.abs(mu_ref).max()
    np.testing.assert_allclose(mu_ms, mu_ref, atol=1e-10 * scale)


def test_kubo_ms_random_phase_start():
    """Random-phase trace-sampling start blocks (the
    cond_calctype='random_vec' path) go through the same engine."""
    n_moments = 5
    a_s, b_s = 1.9, -0.2
    sys_, cl, hb, lsham, (v_a, v_b, vo_a, vo_b) = _setup(False)
    rng = np.random.default_rng(7)
    ph = np.exp(2j * np.pi * rng.random(cl.kk)) / np.sqrt(float(cl.kk))
    psi0 = np.zeros((cl.kk, 18, 18), np.complex128)
    idx = np.arange(18)
    psi0[:, idx, idx] = ph[:, None]

    mu_ref = np.asarray(kubo_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(v_a), jnp.asarray(v_b),
        jnp.asarray(psi0), n_moments=n_moments, block_size=5,
        a=a_s, b=b_s))
    eng = MSEngine(build_ms_stencil(cl), hb.ee, lsham)
    mk = MSKubo(eng, v_a, v_b, vo_a, vo_b)
    mu_ms = mk.moments(psi0, n_moments, a_s, b_s)
    scale = np.abs(mu_ref).max()
    np.testing.assert_allclose(mu_ms, mu_ref, atol=1e-10 * scale)
