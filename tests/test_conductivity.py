"""Kubo-Bastin conductivity: device moment engine vs dense reference.

Validates ops/kubo.kubo_moments (blocked lax.scan double-Chebyshev
chains) against a brute-force dense-matrix evaluation of
mu_nm = <r| T_m(H~) v_a T_n(H~) v_b |r> on a small synthetic bcc
cluster, and smoke-tests the full ConductivityCalculation output files.
"""

import os

import jax.numpy as jnp
import numpy as np

from rslmtoasa.models.conductivity import (
    ConductivityCalculation,
    build_velocity_operators,
    spin_current,
)
from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.ops.kubo import kubo_moments


def _dense_from_ell(blocks, iz, cols, kk):
    n = kk * 18
    H = np.zeros((n, n), dtype=np.complex128)
    for i in range(kk):
        for m in range(cols.shape[1]):
            j = int(cols[i, m])
            if j >= kk:
                continue
            H[i * 18 : (i + 1) * 18, j * 18 : (j + 1) * 18] += \
                blocks[int(iz[i]), m]
    return H


def test_kubo_moments_match_dense():
    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    cl = sys_.cluster
    hb = sys_.ham
    kk = cl.kk
    v_a, v_b, _, _ = build_velocity_operators(
        sys_, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0])
    )
    iz = np.asarray(hb.iz)
    cols = np.asarray(hb.cols)
    lsh = (hb.lsham if hb.lsham is not None
           else np.zeros((hb.ee.shape[0], 18, 18), np.complex128))
    a, b = 1.9, -0.2
    nmom = 6

    mu_dev = np.asarray(kubo_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsh), jnp.asarray(iz),
        jnp.asarray(cols), jnp.asarray(v_a), jnp.asarray(v_b),
        jnp.asarray(_start(kk)), n_moments=nmom, block_size=4,
        a=a, b=b,
    ))

    # dense reference
    H = _dense_from_ell(hb.ee, iz, cols, kk)
    for i in range(kk):
        H[i * 18 : (i + 1) * 18, i * 18 : (i + 1) * 18] += lsh[int(iz[i])]
    Va = _dense_from_ell(v_a, iz, cols, kk)
    Vb = _dense_from_ell(v_b, iz, cols, kk)
    Ht = (H - b * np.eye(kk * 18)) / a
    r = np.zeros((kk * 18, 18), np.complex128)
    r[:18] = np.eye(18)
    # left vectors T_m|r>, right vectors T_n Vb|r>
    lefts, rights = [], []
    w0, w1 = None, r
    v0, v1 = None, Vb @ r
    for m in range(nmom):
        if m == 1:
            w0, w1 = w1, Ht @ w1
            v0, v1 = v1, Ht @ v1
        elif m > 1:
            w0, w1 = w1, 2.0 * (Ht @ w1) - w0
            v0, v1 = v1, 2.0 * (Ht @ v1) - v0
        lefts.append(w1.copy())
        rights.append(Va @ v1)
    mu_ref = np.zeros((nmom, nmom, 18, 18), np.complex128)
    for n in range(nmom):
        for m in range(nmom):
            mu_ref[n, m] = lefts[m].conj().T @ rights[n]
    np.testing.assert_allclose(mu_dev, mu_ref, atol=1e-10)


def _start(kk):
    psi = np.zeros((kk, 18, 18), np.complex128)
    psi[0] = np.eye(18)
    return psi


def test_kubo_moments_hoh_match_dense():
    """HoH Kubo chains vs brute-force dense evaluation of the
    reference's operators: H_hoh = h - eeo.h + enim + ls (inner h
    excludes lsham; ham_hoh_vec_matmul :892-912) and
    v_eff = v - vo.h (velo_hoh_vec_matmul :656-784)."""
    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2, hoh=True)
    cl = sys_.cluster
    hb = sys_.ham
    kk = cl.kk
    assert hb.eeo is not None and hb.enim is not None
    v_a, v_b, vo_a, vo_b = build_velocity_operators(
        sys_, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0])
    )
    iz = np.asarray(hb.iz)
    cols = np.asarray(hb.cols)
    lsh = hb.lsham
    a, b = 1.9, -0.2
    nmom = 6

    mu_dev = np.asarray(kubo_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsh), jnp.asarray(iz),
        jnp.asarray(cols), jnp.asarray(v_a), jnp.asarray(v_b),
        jnp.asarray(_start(kk)), n_moments=nmom, block_size=4,
        a=a, b=b, hoh=True, vo_a=jnp.asarray(vo_a),
        vo_b=jnp.asarray(vo_b), blocks_o=jnp.asarray(hb.eeo),
        enim=jnp.asarray(hb.enim),
    ))

    # dense reference operators
    n18 = kk * 18
    Hd = _dense_from_ell(hb.ee, iz, cols, kk)   # ee only (no lsham)
    EEO = _dense_from_ell(hb.eeo, iz, cols, kk)
    LS = np.zeros((n18, n18), np.complex128)
    EN = np.zeros((n18, n18), np.complex128)
    for i in range(kk):
        sl = slice(i * 18, (i + 1) * 18)
        LS[sl, sl] = lsh[int(iz[i])]
        EN[sl, sl] = hb.enim[int(iz[i])]
    Hhoh = Hd - EEO @ Hd + EN + LS
    Ht = (Hhoh - b * np.eye(n18)) / a
    Va = _dense_from_ell(v_a, iz, cols, kk) \
        - _dense_from_ell(vo_a, iz, cols, kk) @ Hd
    Vb = _dense_from_ell(v_b, iz, cols, kk) \
        - _dense_from_ell(vo_b, iz, cols, kk) @ Hd
    r = np.zeros((n18, 18), np.complex128)
    r[:18] = np.eye(18)
    lefts, rights = [], []
    w1 = r
    v1 = Vb @ r
    w0 = v0 = None
    for m in range(nmom):
        if m == 1:
            w0, w1 = w1, Ht @ w1
            v0, v1 = v1, Ht @ v1
        elif m > 1:
            w0, w1 = w1, 2.0 * (Ht @ w1) - w0
            v0, v1 = v1, 2.0 * (Ht @ v1) - v0
        lefts.append(w1.copy())
        rights.append(Va @ v1)
    mu_ref = np.zeros((nmom, nmom, 18, 18), np.complex128)
    for n in range(nmom):
        for m in range(nmom):
            mu_ref[n, m] = lefts[m].conj().T @ rights[n]
    np.testing.assert_allclose(mu_dev, mu_ref, atol=1e-10)


def test_spin_current_hermitian_blocks():
    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    v_a, _, _, _ = build_velocity_operators(
        sys_, np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0])
    )
    js = spin_current(v_a, "z")
    # {S_z, v}/2 with S_z block-diagonal halves: spin-diagonal blocks of
    # v survive with +-1/2 weights, spin-off-diagonal blocks vanish
    np.testing.assert_allclose(js[:, :, :9, :9], 0.5 * v_a[:, :, :9, :9])
    np.testing.assert_allclose(js[:, :, 9:, 9:], -0.5 * v_a[:, :, 9:, 9:])
    np.testing.assert_allclose(js[:, :, :9, 9:], 0.0, atol=1e-15)


def test_conductivity_pipeline_outputs(tmp_path):
    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    sys_.cfg.control.cond_ll = 8
    sys_.cfg.energy.channels_ldos = 200
    calc = ConductivityCalculation(sys_, str(tmp_path))
    mu = calc.run()
    assert mu.shape[2] == 8 and np.all(np.isfinite(mu))
    out = os.path.join(str(tmp_path), "cond_total.out")
    assert os.path.exists(out)
    for extra in ("cond_total_orb_real.out", "cond_total_orb_im.out",
                  "X_cond_orb_real.out"):
        dat_o = np.loadtxt(os.path.join(str(tmp_path), extra))
        assert dat_o.shape[1] == 19 and np.all(np.isfinite(dat_o))
    dat = np.loadtxt(out)
    assert dat.shape[1] == 3 and np.all(np.isfinite(dat))
    # cumulative integral: flat before the band, monotone build-up region
    assert abs(dat[0, 1]) <= abs(dat[:, 1]).max()


def test_kubo_realified_parity():
    """The Kubo engine on realified 36x36 real blocks reproduces the
    complex moments exactly."""
    from rslmtoasa.ops.block_lanczos import (
        realify_blocks,
        unrealify_blocks,
    )

    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    hb = sys_.ham
    kk = sys_.cluster.kk
    v_a, v_b, _, _ = build_velocity_operators(
        sys_, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0])
    )
    m1 = np.asarray(kubo_moments(
        jnp.asarray(hb.ee), jnp.asarray(hb.lsham), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(v_a), jnp.asarray(v_b),
        jnp.asarray(_start(kk)), n_moments=5, block_size=3,
        a=1.9, b=-0.2,
    ))
    psir = np.zeros((kk, 36, 36))
    psir[0] = np.eye(36)
    m2 = unrealify_blocks(np.asarray(kubo_moments(
        jnp.asarray(realify_blocks(hb.ee)),
        jnp.asarray(realify_blocks(hb.lsham)), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(realify_blocks(v_a)),
        jnp.asarray(realify_blocks(v_b)), jnp.asarray(psir),
        n_moments=5, block_size=3, a=1.9, b=-0.2,
    )))
    np.testing.assert_allclose(m2, m1, atol=1e-10)


def test_kubo_f32_production_cond_ll():
    """The Kubo engine is dtype-generic: on realified float32 blocks at
    the production moment count (cond_ll = lld = 100, the fccPt
    reference case patch) it stays inside the reference 1e-6 parity
    gate relative to the moment scale."""
    from rslmtoasa.ops.block_lanczos import (
        realify_blocks,
        unrealify_blocks,
    )

    sys_ = build_synthetic_bcc(rc=12.0, lld=4, nsp=2)
    hb = sys_.ham
    kk = sys_.cluster.kk
    v_a, v_b, _, _ = build_velocity_operators(
        sys_, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    ntype = hb.ee.shape[0]
    lsh = hb.lsham if hb.lsham is not None else np.zeros(
        (ntype, 18, 18), np.complex128)
    psi0 = np.zeros((kk, 18, 18), np.complex128)
    psi0[0] = np.eye(18)
    a_s = (1.0 - (-1.5)) / (2.0 - 0.3)
    b_s = (1.0 + (-1.5)) / 2.0
    cond_ll = 100
    mu64 = np.asarray(kubo_moments(
        jnp.asarray(hb.ee), jnp.asarray(lsh), jnp.asarray(hb.iz),
        jnp.asarray(hb.cols), jnp.asarray(v_a), jnp.asarray(v_b),
        jnp.asarray(psi0), n_moments=cond_ll, block_size=cond_ll,
        a=a_s, b=b_s))
    psir = np.zeros((kk, 36, 36))
    psir[0] = np.eye(36)
    mu32 = unrealify_blocks(np.asarray(kubo_moments(
        jnp.asarray(realify_blocks(hb.ee), jnp.float32),
        jnp.asarray(realify_blocks(lsh), jnp.float32),
        jnp.asarray(hb.iz), jnp.asarray(hb.cols),
        jnp.asarray(realify_blocks(v_a), jnp.float32),
        jnp.asarray(realify_blocks(v_b), jnp.float32),
        jnp.asarray(psir, jnp.float32),
        n_moments=cond_ll, block_size=cond_ll, a=a_s, b=b_s)))
    scale = np.abs(mu64).max()
    err = np.abs(mu32 - mu64).max()
    assert err / scale < 5e-6, f"f32 Kubo rel error {err/scale:.2e}"


def test_kubo_random_vec_moments_match_dense():
    """Stochastic (random-phase) Kubo start vectors
    (cond_calctype='random_vec', recursion.f90:1120-1143): the sampled
    moment block matches a brute-force dense evaluation with the same
    seeded phases, and the runner writes totals but no per-type files."""
    from rslmtoasa.models.conductivity import ConductivityCalculation

    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    sys_.cfg.control.cond_calctype = "random_vec"
    sys_.cfg.control.random_vec_num = 1
    cl, hb = sys_.cluster, sys_.ham
    kk = cl.kk
    v_a, v_b, _, _ = build_velocity_operators(
        sys_, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
    calc = ConductivityCalculation(sys_)
    a_s, b_s = 1.9, -0.2
    nmom = 5
    mu = calc.compute_moments(v_a, v_b, a_s, b_s, nmom)
    assert mu.shape[4] == 1

    # dense reference with the identical seeded phases
    rng = np.random.default_rng(20260821)
    ph = np.exp(2j * np.pi * rng.random(kk)) / np.sqrt(float(kk))
    iz, cols = np.asarray(hb.iz), np.asarray(hb.cols)
    H = _dense_from_ell(hb.ee, iz, cols, kk)
    for i in range(kk):
        H[i * 18:(i + 1) * 18, i * 18:(i + 1) * 18] += hb.lsham[int(iz[i])]
    Va = _dense_from_ell(v_a, iz, cols, kk)
    Vb = _dense_from_ell(v_b, iz, cols, kk)
    Ht = (H - b_s * np.eye(kk * 18)) / a_s
    r = np.zeros((kk * 18, 18), np.complex128)
    for k in range(kk):
        r[k * 18:(k + 1) * 18] = np.eye(18) * ph[k]
    lefts, rights = [], []
    w0 = v0 = None
    w1 = r
    v1 = Vb @ r
    for m in range(nmom):
        if m == 1:
            w0, w1 = w1, Ht @ w1
            v0, v1 = v1, Ht @ v1
        elif m > 1:
            w0, w1 = w1, 2.0 * (Ht @ w1) - w0
            v0, v1 = v1, 2.0 * (Ht @ v1) - v0
        lefts.append(w1.copy())
        rights.append(Va @ v1)
    for n in range(nmom):
        for m in range(nmom):
            ref = lefts[m].conj().T @ rights[n]
            np.testing.assert_allclose(mu[:, :, n, m, 0], ref, atol=1e-10)


def test_conductivity_random_vec_outputs(tmp_path):
    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    sys_.cfg.control.cond_ll = 6
    sys_.cfg.energy.channels_ldos = 150
    sys_.cfg.control.cond_calctype = "random_vec"
    sys_.cfg.control.random_vec_num = 2
    calc = ConductivityCalculation(sys_, str(tmp_path))
    mu = calc.run()
    assert mu.shape[4] == 2 and np.all(np.isfinite(mu))
    assert os.path.exists(os.path.join(str(tmp_path), "cond_total.out"))
    # per-type files exist only for cond_calctype='per_type'
    assert not os.path.exists(os.path.join(str(tmp_path), "X_cond.out"))


def test_kubo_operator_types():
    """All Kubo slot operator types build finite, correctly-structured
    tables; anticommutator/commutator identities hold block-wise."""
    from rslmtoasa.models.conductivity import (
        S_Z,
        _l_op18,
        build_kubo_operator,
    )

    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    hb = sys_.ham
    d = np.array([0.0, 0.0, 1.0])
    for op_type in ("charge", "spin", "orbital", "spin_accumulation",
                    "orbital_accumulation", "spin_torque",
                    "spin_soc_torque", "orbital_torque"):
        tab, tab_o = build_kubo_operator(sys_, op_type, "z", d)
        assert tab.shape == hb.ee.shape
        assert np.all(np.isfinite(tab)) and np.all(np.isfinite(tab_o))
    # spin current with S_z: block-diagonal halves of v survive
    v, _ = build_kubo_operator(sys_, "charge", "z", d)
    js, _ = build_kubo_operator(sys_, "spin", "z", d)
    np.testing.assert_allclose(js[:, :, :9, :9], 0.5 * v[:, :, :9, :9])
    # accumulation operators live on the onsite slot only
    acc, _ = build_kubo_operator(sys_, "spin_accumulation", "z", d)
    np.testing.assert_allclose(acc[:, 0], S_Z[None])
    assert np.all(acc[:, 1:] == 0)
    # torque operators are anti-Hermitian times i => Hermitian blocks
    st, _ = build_kubo_operator(sys_, "spin_soc_torque", "z", d)
    np.testing.assert_allclose(
        st[:, 0], np.conj(st[:, 0]).transpose(0, 2, 1), atol=1e-12
    )
