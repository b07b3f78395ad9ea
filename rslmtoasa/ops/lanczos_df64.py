"""Haydock (scalar Lanczos) recursion in df64 arithmetic.

No production path selects this engine since the recursion runs in
native complex128 (ROADMAP D2: delete next, with replacement tests).

Same recurrence as :mod:`.lanczos` (reference ``source/recursion.f90``
``recur``:3485 / ``crecal``:3423 / ``hop``:3310), but every array lives as
a double-float (hi, lo) f32 pair and the block-ELL SpMV runs as exact-chunk
bf16 GEMMs (see :mod:`.df64`), at ~1e-13 accuracy — far inside the
1e-6 parity tolerance of the reference regression suite.

Single-type clusters hit the fully-fused path (one (2B x nslots*2B) GEMM
family per chunk pair); general type counts fall back to per-type masking
like :func:`.lanczos.block_spmv`.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp

from . import df64
from .df64 import (
    ds_add,
    ds_add_f32,
    ds_dot,
    ds_mul,
    ds_recip,
    ds_sqrt,
    extract_chunks,
    fast_two_sum,
    two_prod,
    two_sum,
)


def pack_ham_df64(ee_complex: np.ndarray, nchunks: int = df64.DF64_CHUNKS):
    """Host-side prep: realify + chunk the per-type Hamiltonian blocks.

    ``ee_complex``: (ntype, nslots, B, B) complex128 -> returns
    ``(h_chunks, h_scale)`` with ``h_chunks`` (nchunks, ntype, nslots,
    2B, 2B) bf16.
    """
    from .lanczos import split_complex

    hs = np.asarray(split_complex(ee_complex))  # (ntype, nslots, 2B, 2B)
    return df64.pack_chunks_host(hs, nchunks)


def spmv_df64(h_chunks, h_scale, cols, psi_ds, nchunks: int):
    """y[i] = sum_m H[m] @ psi[cols[i, m]] in df64 (single-type).

    h_chunks: (nchunks, nslots, 2B, 2B) bf16; psi_ds: (hi, lo) each
    (kk+1, 2B, C) f32 with |psi| <= 1 and zero pad row.  Returns the df64
    pair (kk, 2B, C).

    The gather runs once per psi chunk (bf16 — 4x less HBM traffic than
    the f64-emulated gather); each chunk-pair contraction is ONE bf16
    einsum whose (slot, orbital) axes fold to a K=nslots*2B contraction
    that accumulates exactly in f32 (K <= 4096).
    """
    xch = extract_chunks(psi_ds, nchunks)  # (nchunks, kk+1, 2B, C)
    acc_hi = None
    acc_lo = None
    # largest buckets last so the running compensation tracks the head
    for q in reversed(range(nchunks)):
        g = xch[q][cols]  # (kk, nslots, 2B, C) bf16
        for p in reversed(range(nchunks - q)):
            o = jnp.einsum("mab,imbc->iac", h_chunks[p], g,
                           preferred_element_type=jnp.float32)
            if acc_hi is None:
                acc_hi, acc_lo = o, jnp.zeros_like(o)
            else:
                acc_hi, acc_lo = ds_add_f32((acc_hi, acc_lo), o)
    scale = jnp.float32(h_scale * 2.0)  # undo extract's 1/2 pre-scale
    return (acc_hi * scale, acc_lo * scale)


@partial(jax.jit, static_argnames=("lld", "nchunks"))
def _lanczos_df64_jit(h_chunks, cols, psi0_hi, psi0_lo, h_scale_arr,
                      lld: int, nchunks: int):
    kk1, b2dim, c = psi0_hi.shape
    h_scale = h_scale_arr  # traced f32 scalar (pow2, exact)

    def spmv(psi_ds):
        xch = extract_chunks(psi_ds, nchunks)
        acc_hi = None
        acc_lo = None
        for q in reversed(range(nchunks)):
            g = xch[q][cols]
            for p in reversed(range(nchunks - q)):
                o = jnp.einsum("mab,imbc->iac", h_chunks[p], g,
                               preferred_element_type=jnp.float32)
                if acc_hi is None:
                    acc_hi, acc_lo = o, jnp.zeros_like(o)
                else:
                    acc_hi, acc_lo = ds_add_f32((acc_hi, acc_lo), o)
        s = h_scale * 2.0
        return (acc_hi * s, acc_lo * s)

    def step(carry, _):
        psi_hi, psi_lo, pmn_hi, pmn_lo, sp_hi, sp_lo = carry
        psi = (psi_hi, psi_lo)
        v = spmv(psi)
        psin = (psi_hi[:-1], psi_lo[:-1])  # drop zero pad row
        a_ll = ds_dot(v, psin, (0, 1))  # (C,) df64
        b2_ll = (sp_hi, sp_lo)
        # pmn += v - a_ll * psi
        t = ds_mul((a_ll[0][None, None, :], a_ll[1][None, None, :]), psin)
        pmn = ds_add(ds_add((pmn_hi, pmn_lo), v), (-t[0], -t[1]))
        summ = ds_dot(pmn, pmn, (0, 1))  # (C,)
        s = ds_sqrt(summ)
        rinv = ds_recip(s)
        psi_new = ds_mul((rinv[0][None, None, :], rinv[1][None, None, :]),
                         pmn)
        # pmn_new = -psi * s
        pm = ds_mul((s[0][None, None, :], s[1][None, None, :]), psin)
        zrow_hi = jnp.zeros((1, b2dim, c), jnp.float32)
        carry_out = (
            jnp.concatenate([psi_new[0], zrow_hi], axis=0),
            jnp.concatenate([psi_new[1], zrow_hi], axis=0),
            -pm[0], -pm[1], summ[0], summ[1],
        )
        return carry_out, (a_ll[0], a_ll[1], b2_ll[0], b2_ll[1])

    pmn0 = jnp.zeros((kk1 - 1, b2dim, c), jnp.float32)
    ones = jnp.ones((c,), jnp.float32)
    zer = jnp.zeros((c,), jnp.float32)
    carry0 = (psi0_hi, psi0_lo, pmn0, pmn0, ones, zer)
    carry, (ahi, alo, bhi, blo) = jax.lax.scan(step, carry0, None,
                                               length=lld - 1)
    return ahi, alo, bhi, blo, carry[4], carry[5]


def lanczos_coefficients_df64(
    h_chunks, h_scale: float, cols, psi0_ds, lld: int,
    nchunks: int = df64.DF64_CHUNKS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run ``lld`` Haydock steps in df64; returns host f64 ``(a, b2)``
    of shape (lld, C) with the reference conventions (``b2[0]=1``,
    ``a[lld-1]=0``, ``b2[lld-1]=|r|^2`` — ``crecal``:3423-3483).

    ``h_chunks`` must be the single-type (nchunks, nslots, 2B, 2B) table
    from :func:`pack_ham_df64` (squeeze the type axis); ``psi0_ds`` the
    df64 pair of (kk+1, 2B, C) start vectors.
    """
    ahi, alo, bhi, blo, shi, slo = _lanczos_df64_jit(
        h_chunks, cols, psi0_ds[0], psi0_ds[1],
        jnp.float32(h_scale), lld, nchunks)
    a = np.asarray(ahi, np.float64) + np.asarray(alo, np.float64)
    b2 = np.asarray(bhi, np.float64) + np.asarray(blo, np.float64)
    last = (np.asarray(shi, np.float64) + np.asarray(slo, np.float64))
    c = a.shape[1]
    a = np.concatenate([a, np.zeros((1, c))], axis=0)
    b2 = np.concatenate([b2, last[None, :]], axis=0)
    return a, b2
