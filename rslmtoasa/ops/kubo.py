"""Device (XLA) path for the two-sided Kubo-Bastin Chebyshev moments.

Computes mu_nm = <r| T_m(H~) v_a T_n(H~) v_b |r> (the moment matrix of
``recursion.f90 compute_moments_stochastic`` :979-1234) with bounded
memory: instead of materialising all N left vectors T_m|r> (O(N kk 18^2),
tens of GB at production cond_ll), the left chain is generated in blocks
of ``block_size`` (with v_a folded in — v_a is Hermitian) and a full
right chain is replayed per block inside a ``lax.scan``.
Work: 2N + (N/Mb) N block SpMVs; memory: Mb kk 18^2.

Every inner step is two batched 18x18 block matmuls (SpMV + the
left-block contraction).  Dtype follows the inputs; production runs it
in complex128.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

def _spmv(blocks, iz, cols, psi):
    """y[i] = sum_m blocks[iz[i], m] @ psi[cols[i, m]]; psi (kk, 18, W).

    Sentinel column index kk selects the appended zero row.
    """
    pad = jnp.concatenate(
        [psi, jnp.zeros((1,) + psi.shape[1:], psi.dtype)], axis=0
    )
    return jnp.einsum("imab,imbc->iac", blocks[iz], pad[cols])


def _apply_h(blocks, lsham, iz, iz_onsite, cols, a, b, psi):
    out = _spmv(blocks, iz, cols, psi)
    out = out + jnp.einsum("iab,ibc->iac", lsham[iz_onsite], psi)
    return (out - b * psi) / a


def _apply_h_hoh(blocks, blocks_o, enim, lsham, iz, iz_onsite, cols, a, b,
                 psi):
    """HoH-corrected scaled H application (``ham_hoh_vec_matmul``,
    recursion.f90:892-912): out = (h - eeo.(h psi) + enim psi
    + ls psi - b psi)/a, where the inner h EXCLUDES lsham."""
    hpsi = _spmv(blocks, iz, cols, psi)
    hohpsi = _spmv(blocks_o, iz, cols, hpsi)
    out = (hpsi - hohpsi
           + jnp.einsum("iab,ibc->iac", enim[iz_onsite], psi)
           + jnp.einsum("iab,ibc->iac", lsham[iz_onsite], psi))
    return (out - b * psi) / a


def _apply_v_hoh(v_op, vo_op, blocks, iz, cols, psi):
    """HoH velocity application (``velo_hoh_vec_matmul``,
    recursion.f90:656-784): out = v psi - vo.(h psi).  The enim/ls
    onsite terms are disabled in the reference's bulk loop (:710-713
    commented out) and the vo onsite slot is zero by construction
    (build_realspace_velocity_operators loops m>=2)."""
    vpsi = _spmv(v_op, iz, cols, psi)
    hpsi = _spmv(blocks, iz, cols, psi)
    return vpsi - _spmv(vo_op, iz, cols, hpsi)


@partial(jax.jit, static_argnames=("n_moments", "block_size", "hoh"))
def kubo_moments(blocks, lsham, iz, cols, va, vb, psi0, *,
                 n_moments: int, block_size: int, a: float, b: float,
                 iz_onsite=None, hoh: bool = False, vo_a=None, vo_b=None,
                 blocks_o=None, enim=None):
    """Two-sided Chebyshev moment matrix for one start block.

    blocks/va/vb: (ntype, nslots, 18, 18) ELL tables; psi0: (kk, 18, 18)
    unit start block.  Returns mu (n_moments, n_moments, 18, 18) with
    mu[n, m] = sum_k T_m(H~)|r>[k]^H  (v_a T_n(H~) v_b |r>)[k].

    ``hoh=True`` switches every H application to the HoH-corrected
    operator and every velocity application to v - vo.(h .) — the
    reference's ``ham_hoh_vec_matmul``/``velo_hoh_vec_matmul`` pair.
    The HoH velocity operator is NOT Hermitian (v_eff^H = v - h.vo),
    so the left chain stores RAW T_m blocks and v_a is applied on the
    right each step, exactly as the reference does
    (``compute_moments_stochastic`` :1220-1228).  Without HoH, v_a IS
    Hermitian and is folded into the stored left vectors, saving one
    SpMV per right-chain step.
    """
    if iz_onsite is None:
        iz_onsite = iz
    if hoh:
        apply_h = partial(_apply_h_hoh, blocks, blocks_o, enim, lsham,
                          iz, iz_onsite, cols, a, b)
        apply_va = partial(_apply_v_hoh, va, vo_a, blocks, iz, cols)
        apply_vb = partial(_apply_v_hoh, vb, vo_b, blocks, iz, cols)
    else:
        apply_h = partial(_apply_h, blocks, lsham, iz, iz_onsite, cols,
                          a, b)
        apply_va = lambda p: _spmv(va, iz, cols, p)
        apply_vb = lambda p: _spmv(vb, iz, cols, p)

    nblocks = (n_moments + block_size - 1) // block_size

    def left_block(carry, _):
        # emit the next block_size left vectors, carrying (m, w0, w1).
        # Non-HoH: v_a T_m|r> (v_a Hermitian — the fold is exact).
        # HoH: raw T_m|r> (v_a applied on the right chain instead).
        m, w0, w1 = carry

        def one(c, _):
            m, w0, w1 = c
            w2 = jnp.where(m == 0, w1,
                           jnp.where(m == 1, apply_h(w1),
                                     2.0 * apply_h(w1) - w0))
            out = w2 if hoh else apply_va(w2)
            return (m + 1, jnp.where(m == 0, w0, w1), w2), out

        (m, w0, w1), blk = jax.lax.scan(one, (m, w0, w1), None,
                                        length=block_size)
        return (m, w0, w1), blk

    def right_over_block(lblk):
        # full right chain, contracting each step against lblk.
        # Non-HoH: contract T_n v_b|r> against the stored v_a T_m|r>.
        # HoH: contract v_a T_n v_b|r> against the stored T_m|r>.
        v0 = apply_vb(psi0)

        def one(c, _):
            n, vprev, v1 = c
            v2 = jnp.where(n == 0, v1,
                           jnp.where(n == 1, apply_h(v1),
                                     2.0 * apply_h(v1) - vprev))
            rvec = apply_va(v2) if hoh else v2
            mu_n = jnp.einsum("mkba,kbc->mac", lblk.conj(), rvec)
            return (n + 1, jnp.where(n == 0, vprev, v1), v2), mu_n

        _, mu = jax.lax.scan(
            one, (0, jnp.zeros_like(v0), v0), None, length=n_moments
        )
        return mu  # (n_moments, block_size, 18, 18)

    def outer(carry, _):
        carry, lblk = left_block(carry, None)
        return carry, right_over_block(lblk)

    init = (0, jnp.zeros_like(psi0), psi0)
    _, mu = jax.lax.scan(outer, init, None, length=nblocks)
    # (nblocks, n, Mb, d, d) -> (n, nblocks*Mb, d, d)
    d = psi0.shape[-1]
    mu = jnp.moveaxis(mu, 0, 1).reshape(
        n_moments, nblocks * block_size, d, d
    )
    return mu[:, :n_moments]
