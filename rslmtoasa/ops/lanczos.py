"""Batched scalar (Haydock) Lanczos recursion on the block-ELL Hamiltonian.

Batched re-design of the reference scalar recursion
(``source/recursion.f90`` ``recur`` :3485, ``crecal`` :3423, ``hop`` :3310):

* the per-(atom, orbital) chain loop becomes a *batch axis* — all 9 orbitals
  x 2 spins x nrec atoms recur simultaneously;
* the recursion-depth loop is a single ``lax.scan``;
* the masked neighbor-map SpMV is a gather + batched 9x9 block matmul over
  canonical slots.  The reference's ``izero`` active-set masking is purely a
  CPU work-saving device: vectors are exactly zero outside the active set, so
  the unmasked dense-batch SpMV produces identical numbers.

Missing neighbors use the sentinel column ``kk``; ``psi`` carries one extra
zero row so gathers need no masking.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp


def block_spmv(hs: jnp.ndarray, iz: jnp.ndarray, cols: jnp.ndarray,
               psi: jnp.ndarray, slot_chunk: int = None) -> jnp.ndarray:
    """y[i] = sum_m H[iz[i], m] @ psi[cols[i, m]].

    Parameters
    ----------
    hs :   (ntype, nslots, B, B) complex block table
    iz :   (kk,) type index per atom
    cols : (kk, nslots) neighbor columns (sentinel kk = missing)
    psi :  (kk+1, B, C) wavefront block vectors, row kk all-zero

    Returns (kk, B, C).

    One-shot gather + einsum over all slots (a slot loop fuses less).
    For small type counts the per-type formulation turns the whole SpMV
    into one large (B x nslots*B) @ (nslots*B x kk*C) matmul per type —
    the batched per-atom (B x B) form runs tiny matmuls.
    """
    ntype = hs.shape[0]
    if slot_chunk is not None and ntype == 1:
        # chunked gather: peak gather memory drops by nslots/slot_chunk
        ns = hs.shape[1]
        out = None
        for s0 in range(0, ns, slot_chunk):
            pg = psi[cols[:, s0:s0 + slot_chunk]]
            yt = jnp.einsum("mab,imbc->iac", hs[0, s0:s0 + slot_chunk], pg)
            out = yt if out is None else out + yt
        return out
    pg = psi[cols]  # (kk, nslots, B, C)
    if ntype == 1:
        return jnp.einsum("mab,imbc->iac", hs[0], pg)
    if ntype <= 4:
        out = None
        for t in range(ntype):
            yt = jnp.einsum("mab,imbc->iac", hs[t], pg)
            yt = jnp.where((iz == t)[:, None, None], yt, 0.0)
            out = yt if out is None else out + yt
        return out
    hi = hs[iz]  # (kk, nslots, B, B)
    return jnp.einsum("imab,imbc->iac", hi, pg)


@partial(jax.jit, static_argnames=("lld",))
def lanczos_coefficients(
    hs: jnp.ndarray,
    iz: jnp.ndarray,
    cols: jnp.ndarray,
    psi0: jnp.ndarray,
    lld: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run ``lld`` Haydock recursion steps for a batch of start vectors.

    ``psi0`` is (kk+1, B, C) with unit start vectors in the chain columns
    (row kk must be zero).  Returns ``(a, b2)`` of shape (lld, C): the
    tridiagonal coefficients per chain, with the reference's conventions
    ``b2[0] = 1``, ``a[lld-1] = 0`` and ``b2[lld-1] = |r|^2`` of the last
    residual (``crecal`` :3423-3483).
    """
    kk1, b, c = psi0.shape

    def step(carry, _):
        psi, pmn, summ_prev = carry
        v = block_spmv(hs, iz, cols, psi)
        a_ll = jnp.sum(v.real * psi[:-1].real + v.imag * psi[:-1].imag,
                       axis=(0, 1))
        b2_ll = summ_prev
        pmn = pmn + v - a_ll[None, None, :] * psi[:-1]
        summ = jnp.sum(pmn.real**2 + pmn.imag**2, axis=(0, 1))
        s = jnp.sqrt(summ)
        psi_new = jnp.concatenate(
            [pmn / s[None, None, :], jnp.zeros((1, b, c), pmn.dtype)], axis=0
        )
        pmn_new = -psi[:-1] * s[None, None, :]
        return (psi_new, pmn_new, summ), (a_ll, b2_ll)

    pmn0 = jnp.zeros((kk1 - 1, b, c), dtype=psi0.dtype)
    summ0 = jnp.ones((c,), dtype=jnp.real(psi0).dtype)
    (psi, pmn, summ), (a, b2) = jax.lax.scan(
        step, (psi0, pmn0, summ0), None, length=lld - 1
    )
    a = jnp.concatenate([a, jnp.zeros((1, c), a.dtype)], axis=0)
    b2 = jnp.concatenate([b2, summ[None, :]], axis=0)
    return a, b2


def split_complex(x) -> jnp.ndarray:
    """Realify complex Hamiltonian blocks: (..., B, B) complex ->
    (..., 2B, 2B) real via M -> [[Re, -Im], [Im, Re]].

    For backends without complex dtypes (no production path selects
    it): all math runs on this embedding with f64 real arithmetic (a
    complex MAC is exactly 4 real MACs, so results are bit-compatible
    with complex128 up to summation grouping).  The embedding is built
    host-side.
    """
    import numpy as np

    x = np.asarray(x)
    b = x.shape[-1]
    out = np.zeros(x.shape[:-2] + (2 * b, 2 * b))
    out[..., :b, :b] = x.real
    out[..., :b, b:] = -x.imag
    out[..., b:, :b] = x.imag
    out[..., b:, b:] = x.real
    return jnp.asarray(out)


def split_vector(x) -> jnp.ndarray:
    """Realify block vectors: (..., B, C) complex -> (..., 2B, C) real
    ([Re; Im] stacking, compatible with :func:`split_complex`)."""
    import numpy as np

    x = np.asarray(x)
    return jnp.asarray(np.concatenate([x.real, x.imag], axis=-2))


def merge_vector(x) -> "np.ndarray":
    import numpy as np

    x = np.asarray(x)
    b = x.shape[-2] // 2
    return x[..., :b, :] + 1j * x[..., b:, :]


@partial(jax.jit, static_argnames=("lld", "slot_chunk"))
def lanczos_coefficients_split(
    hs: jnp.ndarray,
    iz: jnp.ndarray,
    cols: jnp.ndarray,
    psi0: jnp.ndarray,
    lld: int,
    slot_chunk: int = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Haydock recursion in the realified representation.

    hs: (ntype, nslots, 2B, 2B) real (from :func:`split_complex`);
    psi0: (kk+1, 2B, C) real (from :func:`split_vector`) with zero pad
    row.  Returns (a, b2) of shape (lld, C) — identical to
    :func:`lanczos_coefficients` up to f64 rounding.  The real inner
    products over the stacked [Re; Im] axis equal the real parts of the
    complex inner products, which is exactly what the recursion needs
    (``crecal`` accumulates Re<.|.> only).
    """
    kk1, b2dim, c = psi0.shape

    def step(carry, _):
        psi, pmn, summ_prev = carry
        v = block_spmv(hs, iz, cols, psi, slot_chunk=slot_chunk)
        a_ll = jnp.sum(v * psi[:-1], axis=(0, 1))
        b2_ll = summ_prev
        pmn = pmn + v - a_ll[None, None, :] * psi[:-1]
        summ = jnp.sum(pmn * pmn, axis=(0, 1))
        s = jnp.sqrt(summ)
        psi_new = jnp.concatenate(
            [pmn / s[None, None, :], jnp.zeros((1, b2dim, c), pmn.dtype)],
            axis=0,
        )
        pmn_new = -psi[:-1] * s[None, None, :]
        return (psi_new, pmn_new, summ), (a_ll, b2_ll)

    pmn0 = jnp.zeros((kk1 - 1, b2dim, c), dtype=psi0.dtype)
    summ0 = jnp.ones((c,), dtype=psi0.dtype)
    (psi, pmn, summ), (a, b2) = jax.lax.scan(
        step, (psi0, pmn0, summ0), None, length=lld - 1
    )
    a = jnp.concatenate([a, jnp.zeros((1, c), a.dtype)], axis=0)
    b2 = jnp.concatenate([b2, summ[None, :]], axis=0)
    return a, b2


def scalar_start_vectors(kk: int, atom_indices, dtype=jnp.complex128
                         ) -> jnp.ndarray:
    """Unit start vectors for the scalar recursion: one chain per
    (atom, orbital) pair; orbital runs fastest (matches ``recur``'s l-loop).

    Returns (kk+1, 9, C) with C = 9 * len(atom_indices) laid out as
    chain ``c = a * 9 + l`` for atom ``a``, orbital ``l``.
    """
    import numpy as np

    n = len(atom_indices)
    psi0 = np.zeros((kk + 1, 9, 9 * n), dtype=np.complex128)
    for a, j in enumerate(atom_indices):
        for l in range(9):
            psi0[j, l, a * 9 + l] = 1.0
    return psi0  # host array; callers move it to the device
