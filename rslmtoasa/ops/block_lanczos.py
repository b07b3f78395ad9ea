"""Block-Lanczos recursion with 18x18 block coefficients.

Batched re-design of the reference block recursion
(``source/recursion.f90`` ``recur_b`` :1807, ``crecal_b`` :1873,
``hop_b`` :1560, ``hop_b_hoh`` :1411):

* per recursion level: block SpMV over the cluster, block coefficient
  A_n = sum_i psi_i^H (H psi)_i, residual update, B_{n+1} = sqrt(B^2)
  via an eigendecomposition, psi update with B^{-1};
* the per-atom loop becomes a leading batch axis (R start blocks recur
  simultaneously, batched ``eigh``);
* the HoH overlap correction H = h - h*obar*h + enim + l.s follows
  ``hop_b_hoh``: a second SpMV with the ``eeo`` blocks applied to
  ``h|psi>`` plus onsite ``enim``/``lsham`` terms.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _spmv18(hs: jnp.ndarray, iz: jnp.ndarray, cols: jnp.ndarray,
            psi: jnp.ndarray, slot_chunk: int = None) -> jnp.ndarray:
    """y[r, i] = sum_m H[iz[i], m] @ psi[r, cols[i, m]].

    hs: (nrows, nslots, d, d); psi: (R, kk+1, d, d) zero-padded row.
    For small row counts the per-row einsum + mask avoids materialising
    hs[iz] (kk x nslots x d x d -- the dominant device-memory cost at
    production sizes).
    """
    nrows, m, d = hs.shape[0], hs.shape[1], hs.shape[2]
    if slot_chunk is not None and nrows <= 4:
        out = None
        for s0 in range(0, m, slot_chunk):
            y = _spmv18(hs[:, s0:s0 + slot_chunk], iz,
                        cols[:, s0:s0 + slot_chunk], psi)
            out = y if out is None else out + y
        return out
    pg = psi[:, cols]  # (R, kk, nslots, d, d)
    r, kk = pg.shape[0], pg.shape[1]
    c = pg.shape[-1]
    if nrows <= 4:
        # flatten (slot, b) into ONE contraction so XLA emits a single
        # (d x m*d) @ (m*d x c) dot per atom instead of materialising a
        # broadcast of the block table over all atoms (the einsum with a
        # slot batch axis lowers to broadcast-multiply-reduce and OOMs
        # at production sizes under the f64 emulation)
        pgf = pg.reshape(r, kk, m * d, c)
        out = None
        for t in range(nrows):
            hflat = hs[t].transpose(1, 0, 2).reshape(d, m * d)
            yt = jnp.einsum("aB,riBc->riac", hflat, pgf)
            if nrows > 1:
                yt = jnp.where((iz == t)[None, :, None, None], yt, 0.0)
            out = yt if out is None else out + yt
        return out
    hi = hs[iz]  # (kk, nslots, d, d)
    return jnp.einsum("imab,rimbc->riac", hi, pg)


def _onsite18(mat: jnp.ndarray, iz: jnp.ndarray, psi: jnp.ndarray
              ) -> jnp.ndarray:
    """y[r, i] = mat[iz[i]] @ psi[r, i] (onsite block application)."""
    mi = mat[iz]  # (kk, 18, 18)
    return jnp.einsum("iab,ribc->riac", mi, psi[:, :-1])


def gram_sum(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Chain Gram blocks out[r, a, c] = sum_{i,b} x[r,i,b,a] y[r,i,b,c]
    (one fused contraction).  Callers pass x already conjugated where
    complex."""
    return jnp.einsum("riba,ribc->rac", x, y)


def _eig_sqrt(b2: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """B = U sqrt(ev) U^H and B^-1 from the Hermitian eigendecomposition
    (crecal_b :1977-1999, zheev-based square root).

    The eigendecomposition is refined as an INITIAL GUESS: one Newton
    step on the inverse (X <- X(2I - B X), quadratic) and one Babylonian
    step on the root (B <- (B + b2 X)/2) push both to f64 roundoff even
    where eigh is less accurate than the matmuls.  Where eigh is exact
    (CPU) the refinement is an exact-point no-op; whether it is needed
    on the GPU's eigh is open (ROADMAP S4)."""
    ev, u = jnp.linalg.eigh(b2)
    # clamp against (near-)Lanczos breakdown: a ~zero eigenvalue makes
    # 1/lam huge and the refinement matmuls can overflow to Inf/NaN
    # where plain eigh would have stayed finite
    ev = jnp.maximum(ev, 1e-300 + 1e-14 * ev[..., -1:])
    lam = jnp.sqrt(ev.astype(b2.dtype))
    b = jnp.einsum("...ab,...b,...cb->...ac", u, lam, u.conj())
    b_i = jnp.einsum("...ab,...b,...cb->...ac", u, 1.0 / lam, u.conj())
    eye = jnp.eye(b2.shape[-1], dtype=b2.dtype)
    mm = lambda x, y: jnp.einsum("...ab,...bc->...ac", x, y)
    herm = lambda x: 0.5 * (x + jnp.swapaxes(x.conj(), -1, -2))
    b_i = mm(b_i, 2.0 * eye - mm(b, b_i))  # Newton: X ~= B^-1 to E^2
    b = herm(0.5 * (b + mm(b2, b_i)))  # Babylonian: B ~= sqrt(b2) to E^2
    b_i = herm(mm(b_i, 2.0 * eye - mm(b, b_i)))  # re-pair X with new B
    return b, b_i


@partial(jax.jit, static_argnames=("lld", "hoh", "slot_chunk"))
def block_lanczos(
    hs: jnp.ndarray,  # (nrows, nslots, 18, 18) block-row table
    lsham: jnp.ndarray,  # (ntype, 18, 18) SOC (zeros if disabled)
    iz: jnp.ndarray,  # per-atom row index into hs
    cols: jnp.ndarray,
    psi0: jnp.ndarray,  # (R, kk+1, 18, 18) start blocks, zero pad row
    lld: int,
    hoh: bool = False,
    hso: Optional[jnp.ndarray] = None,  # (nrows, nslots, 18, 18) eeo blocks
    enim: Optional[jnp.ndarray] = None,  # (ntype, 18, 18)
    iz_onsite: Optional[jnp.ndarray] = None,  # species index for onsite ops
    slot_chunk: int = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run the block recursion; returns (a_b, b2_b) of shape
    (lld, R, 18, 18) with the reference conventions: b2_b[0] = I,
    a_b[lld-1] = 0, b2_b[lld-1] = last residual Gram matrix."""
    r, kk1 = psi0.shape[0], psi0.shape[1]
    d = psi0.shape[-1]  # 18 complex, 36 realified
    eye = jnp.eye(d, dtype=psi0.dtype)
    izo = iz if iz_onsite is None else iz_onsite

    def apply_h(psi):
        if hoh:
            hpsi = _spmv18(hs, iz, cols, psi, slot_chunk)
            hpsi_pad = jnp.concatenate(
                [hpsi, jnp.zeros((r, 1, d, d), psi.dtype)], axis=1
            )
            hohpsi = _spmv18(hso, iz, cols, hpsi_pad, slot_chunk)
            enupsi = _onsite18(enim, izo, psi)
            socpsi = _onsite18(lsham, izo, psi)
            return hpsi - hohpsi + enupsi + socpsi
        # non-HoH: lsham folds into the onsite slot
        hpsi = _spmv18(hs, iz, cols, psi, slot_chunk)
        return hpsi + _onsite18(lsham, izo, psi)

    def step(carry, _):
        psi, pmn, sum_b_prev = carry
        hpsi = apply_h(psi)
        a_ll = gram_sum(psi[:, :-1].conj(), hpsi)
        pmn = hpsi - pmn
        pmn = pmn - jnp.einsum("riab,rbc->riac", psi[:, :-1], a_ll)
        b2 = gram_sum(pmn.conj(), pmn)
        b, b_i = _eig_sqrt(b2)
        psi_new = jnp.einsum("riab,rbc->riac", pmn, b_i)
        pmn_new = jnp.einsum("riab,rbc->riac", psi[:, :-1], b)
        psi_new = jnp.concatenate(
            [psi_new, jnp.zeros((r, 1, d, d), psi.dtype)], axis=1
        )
        return (psi_new, pmn_new, b2), (a_ll, sum_b_prev)

    pmn0 = jnp.zeros((r, kk1 - 1, d, d), dtype=psi0.dtype)
    sum_b0 = jnp.broadcast_to(eye, (r, d, d))
    (psi, pmn, sum_b), (a_b, b2_b) = jax.lax.scan(
        step, (psi0, pmn0, sum_b0), None, length=lld - 1
    )
    a_b = jnp.concatenate([a_b, jnp.zeros((1, r, d, d), a_b.dtype)], axis=0)
    b2_b = jnp.concatenate([b2_b, sum_b[None]], axis=0)
    return a_b, b2_b


def block_start_vectors(kk: int, atom_indices) -> np.ndarray:
    """Identity start blocks per atom: psi0 (R, kk+1, 18, 18)."""
    r = len(atom_indices)
    psi0 = np.zeros((r, kk + 1, 18, 18), dtype=np.complex128)
    for a, j in enumerate(atom_indices):
        psi0[a, j] = np.eye(18)
    return psi0


def zsqr(b2_b: np.ndarray) -> np.ndarray:
    """Replace every B^2 block by its Hermitian square root
    (``zsqr`` :1980-2028).  b2_b: (lld, R, 18, 18)."""
    ev, u = np.linalg.eigh(b2_b)
    lam = np.sqrt(ev)
    return np.einsum("...ab,...b,...cb->...ac", u, lam, u.conj())


# ------------------------------------------------------------------
# Realified (split-complex) path for backends with no complex dtypes (no
# production path selects it).
# realify is a *-algebra homomorphism: M -> [[Re, -Im], [Im, Re]] commutes
# with products, adjoints (transpose of the real image), and analytic
# matrix functions (sqrt/inv via eigh of the symmetric image).  The block
# recursion therefore runs UNCHANGED on 36x36 real blocks; only the
# embedding/extraction below is new.  2x memory/flops redundancy vs an
# optimal split.
# ------------------------------------------------------------------

def realify_blocks(x: np.ndarray) -> np.ndarray:
    """(..., B, B) complex -> (..., 2B, 2B) real embedding."""
    x = np.asarray(x)
    b = x.shape[-1]
    out = np.zeros(x.shape[:-2] + (2 * b, 2 * b))
    out[..., :b, :b] = x.real
    out[..., :b, b:] = -x.imag
    out[..., b:, :b] = x.imag
    out[..., b:, b:] = x.real
    return out


def unrealify_blocks(x: np.ndarray) -> np.ndarray:
    """(..., 2B, 2B) real embedding -> (..., B, B) complex."""
    x = np.asarray(x)
    b = x.shape[-1] // 2
    return x[..., :b, :b] + 1j * x[..., b:, :b]


def block_lanczos_split(hs, lsham, iz, cols, psi0, lld, hoh=False,
                        hso=None, enim=None, iz_onsite=None,
                        slot_chunk=3):
    """Realified block recursion: complex inputs, complex outputs, all
    device math real f64.  Drop-in for :func:`block_lanczos` on
    backends without complex support."""
    import jax.numpy as jnp

    args = dict(
        hs=jnp.asarray(realify_blocks(hs)),
        lsham=jnp.asarray(realify_blocks(lsham)),
        iz=jnp.asarray(iz), cols=jnp.asarray(cols),
        psi0=jnp.asarray(realify_blocks(psi0)),
        lld=lld, hoh=hoh,
        hso=jnp.asarray(realify_blocks(hso)) if hso is not None else None,
        enim=jnp.asarray(realify_blocks(enim)) if enim is not None else None,
        iz_onsite=jnp.asarray(iz_onsite) if iz_onsite is not None else None,
        slot_chunk=slot_chunk,
    )
    a_b, b2_b = block_lanczos(**args)
    return unrealify_blocks(np.asarray(a_b)), \
        unrealify_blocks(np.asarray(b2_b))
