"""Gather-free stencil SpMV as a 3-D convolution + df64 Lanczos.

No production path selects this engine since the recursion runs in
native complex128 (ROADMAP D2: delete next, with replacement tests).

On a crystal cluster every canonical neighbor slot is a constant integer
offset in primitive-cell coordinates, so the block-ELL SpMV

    y[i] = sum_m H_m @ x[i + d_m]

is exactly a 3-D convolution over the cell grid with taps ``d_m`` (the
reference's neighbor-map ``hop``/``chebyshev_recur_ll`` SpMV,
``source/recursion.f90:3310,2495``, re-expressed as a convolution).
This removes the per-element gathers of the ELL engine and lowers to
XLA's native conv.

df64 composition (see :mod:`.df64`): both the Hamiltonian blocks and the
wavefront are split into 7 bf16 chunks on shared power-of-two grids.  All
49 chunk-pair products are computed by ONE conv per SpMV by folding the
chunk index into the channel axes with a *bucket* kernel:

    W[(s, a), (q, b), tap(d_m)] = chunk_{s-q}(H_m)[a, b]   (0 <= s-q < 7)

so output channel group ``s`` accumulates every product of total order
``s``.  Products in one bucket share the same power-of-two quantum, and
the contraction length 27 * 126 * 64 * 64 quanta stays below 2^24, so the
f32 accumulation is EXACT; the df64 result is recombined from the 7
bucket outputs with compensated adds.  Accuracy ~1e-13 relative — far
inside the reference's 1e-6 parity gate.

Single-bravais-site clusters only for now (bcc/fcc primitive cells); the
basis index folds into the channel axis for multi-site lattices later.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import df64
from .df64 import (
    ds_add,
    ds_add_f32,
    ds_mul,
    ds_recip,
    ds_sqrt,
    ds_sum_tree,
    fast_two_sum,
    two_prod,
    two_sum,
)


@dataclass
class ConvStencil:
    """3-D box embedding of a single-site cluster for the conv SpMV."""

    dims: Tuple[int, int, int]  # (nx, ny, nz) cell-grid shape
    coords: np.ndarray  # (kk, 3) 0-based cell coords per cluster atom
    dcells: np.ndarray  # (nslots, 3) per-slot integer cell offsets (slot 0 = 0)
    mask: np.ndarray  # (nx, ny, nz) f32, 1 where a cluster atom sits
    kk: int


def build_conv_stencil(cl) -> ConvStencil:
    """Cell-grid embedding (cluster analogue of ``geometry.cluster
    box_embedding``, structured 3-D instead of linearised)."""
    assert cl.nn is not None and cl.dirs is not None
    if cl.cell.ntot != 1:
        raise ValueError("conv stencil supports single-site cells only")
    a = cl.cell.a * cl.alat
    ainv = np.linalg.inv(a)
    m = (ainv @ cl.cr_ang.T).T  # (kk, 3) fractional cell coords
    cells = np.round(m).astype(np.int64)
    if not np.allclose(m, cells, atol=1e-6):
        raise RuntimeError("atom not on the lattice grid")
    lo = cells.min(axis=0)
    coords = cells - lo
    dims = tuple(int(d) for d in coords.max(axis=0) + 1)

    la = int(cl.iu[0]) - 1
    nslots = cl.nn.shape[1] + 1
    dcells = np.zeros((nslots, 3), dtype=np.int64)
    for s in range(1, nslots):
        j = int(cl.nn[la, s - 1])
        if j < 0:
            raise RuntimeError("representative misses a canonical neighbor")
        dcells[s] = cells[j] - cells[la]

    # consistency: every present neighbor must sit at the constant offset
    for s in range(1, nslots):
        has = cl.nn[:, s - 1] >= 0
        jj = cl.nn[has, s - 1]
        if not np.array_equal(cells[jj], cells[has] + dcells[s][None, :]):
            raise RuntimeError(f"slot {s} is not a constant stencil offset")

    mask = np.zeros(dims, dtype=np.float32)
    mask[coords[:, 0], coords[:, 1], coords[:, 2]] = 1.0
    return ConvStencil(dims=dims, coords=coords, dcells=dcells, mask=mask,
                       kk=cl.kk)


def pack_conv_kernel_df64(hs_split: np.ndarray, dcells: np.ndarray,
                          nchunks: int = df64.DF64_CHUNKS):
    """Host-side bucket-conv kernel from realified slot blocks.

    hs_split: (nslots, D, D) f64 (slot 0 = onsite); dcells (nslots, 3).
    Returns (W bf16 (nchunks*D, nchunks*D, KD, KH, KW), h_scale, radius).
    """
    hs = np.asarray(hs_split, np.float64)
    nslots, d = hs.shape[0], hs.shape[1]
    r = np.abs(dcells).max(axis=0)  # per-dim tap radius
    kd, kh, kw = (int(2 * x + 1) for x in r)

    amax = float(np.max(np.abs(hs))) if hs.size else 1.0
    scale = df64._pow2ceil(amax) * 2.0
    y = hs / scale
    chunks = []
    res = y.copy()
    for k in range(nchunks):
        u = 2.0 ** (-df64.CHUNK_BITS * (k + 1))
        c = np.round(res / u) * u
        chunks.append(c)
        res = res - c
    ch = np.stack(chunks, 0)  # (nchunks, nslots, D, D) exact 7-bit values

    w = np.zeros((nchunks * d, nchunks * d, kd, kh, kw), np.float32)
    for s in range(nchunks):  # output bucket
        for q in range(nchunks):  # input chunk
            p = s - q
            if p < 0 or p >= nchunks:
                continue
            for m in range(nslots):
                tx, ty, tz = (int(v) for v in dcells[m] + r)
                w[s * d:(s + 1) * d, q * d:(q + 1) * d, tx, ty, tz] += \
                    ch[p, m]
    return jnp.asarray(w, jnp.bfloat16), scale, tuple(int(x) for x in r)


def _extract_chunks_chan(y, nchunks: int):
    """Device chunk extraction stacked into the channel axis.

    y: (hi, lo) of (C, D, nx, ny, nz) -> bf16 (C, nchunks*D, nx, ny, nz).
    Same chunk values as :func:`df64.extract_chunks`, but the fixed-point
    rounding uses ``rint`` on the pre-scaled value instead of the
    Veltkamp +bmag/-bmag trick: bit-identical results (verified), no
    algebraic identity for XLA's excess-precision rewrites to destroy,
    so NO optimization barriers — the whole extraction fuses into a
    handful of kernels.
    """
    hi, lo = y
    r = hi * jnp.float32(0.5)
    w_lo = lo * jnp.float32(0.5)
    outs = []
    for k in range(nchunks):
        q = jnp.float32(2.0 ** (-df64.CHUNK_BITS * (k + 1)))
        iq = jnp.float32(2.0 ** (df64.CHUNK_BITS * (k + 1)))
        c = jnp.rint(r * iq) * q
        outs.append(c.astype(jnp.bfloat16))
        r = r - c
        if k == 2:
            r, w_lo = two_sum(r, w_lo)
        elif k == 3:
            r = r + w_lo
    return jnp.concatenate(outs, axis=1)  # channel groups = chunk index


def conv_spmv_df64(w, h_scale, mask, psi_ds, nchunks: int, radius):
    """One df64 SpMV: y = H psi as a single 3-D bucket convolution.

    w: (nchunks*D, nchunks*D, KD, KH, KW) bf16; psi_ds: (hi, lo) each
    (C, D, nx, ny, nz) f32; mask (nx, ny, nz).  Returns a df64 pair.
    """
    x = _extract_chunks_chan(psi_ds, nchunks)
    pad = [(int(r), int(r)) for r in radius]
    o = lax.conv_general_dilated(
        x, w, window_strides=(1, 1, 1), padding=pad,
        dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        preferred_element_type=jnp.float32,
    )  # (C, nchunks*D, nx, ny, nz): channel group s = bucket s
    d = psi_ds[0].shape[1]
    # bucket recombination: |o_s| ~ 2^-7s of o_0, so compensated adds are
    # only needed for the head buckets; the tail (s >= 3, total magnitude
    # <= 2^-21 of the head) sums in plain f32 — its rounding error
    # (~2^-45 relative) is far below the df64 target, and the whole
    # recombination fuses into ~two passes instead of 6 sequential
    # two_sum chains
    tail = None
    for s in range(3, nchunks):
        part = o[:, s * d:(s + 1) * d]
        tail = part if tail is None else tail + part
    acc_hi, acc_lo = two_sum(o[:, :d], o[:, d:2 * d])
    if nchunks > 2:
        s2, e2 = two_sum(acc_hi, o[:, 2 * d:3 * d])
        acc_hi, acc_lo = s2, acc_lo + e2
    if tail is not None:
        acc_lo = acc_lo + tail
    acc_hi, acc_lo = fast_two_sum(acc_hi, acc_lo)
    sc = jnp.float32(h_scale * 2.0)  # undo extract's 1/2 pre-scale
    m = mask[None, None]
    return (acc_hi * sc * m, acc_lo * sc * m)


def _fold_halves(hi, lo):
    """Compensated reduction of the LAST axis by repeated halving —
    contiguous slices only (no reshape/transpose relayouts).  Odd sizes are padded
    once to the next power of two with exact zeros."""
    n = hi.shape[-1]
    n2 = 1 << (n - 1).bit_length()
    if n2 != n:
        pad = [(0, 0)] * (hi.ndim - 1) + [(0, n2 - n)]
        hi = jnp.pad(hi, pad)
        lo = jnp.pad(lo, pad)
        n = n2
    while n > 1:
        half = n // 2
        s, e = two_sum(hi[..., :half], hi[..., half:n])
        e = e + (lo[..., :half] + lo[..., half:n])
        hi, lo = fast_two_sum(s, e)
        n = half
    return hi[..., 0], lo[..., 0]


def ds_dot_chain(x, y):
    """Per-chain df64 dot sum over all non-leading axes.

    Optimised for the conv layout: exact per-element products WITHOUT
    the final pair renormalisation (the cross terms are already below
    2^-48 of the head), then innermost-axis-first compensated folding —
    only contiguous slicing, no reshapes (a (C, D, x, y, z) -> (C, -1)
    reshape is a full relayout copy)."""
    ph, pe = two_prod(x[0], y[0])
    pe = pe + (x[0] * y[1] + x[1] * y[0])
    hi, lo = ph, pe
    while hi.ndim > 1:
        hi, lo = _fold_halves(hi, lo)
    return hi, lo


@partial(jax.jit, static_argnames=("lld", "nchunks", "radius"))
def _lanczos_conv_df64_jit(w, mask, psi0_hi, psi0_lo, h_scale,
                           lld: int, nchunks: int, radius):

    def step(carry, _):
        psi_hi, psi_lo, pmn_hi, pmn_lo, sp_hi, sp_lo = carry
        psi = (psi_hi, psi_lo)
        v = conv_spmv_df64(w, h_scale, mask, psi, nchunks, radius)
        a_ll = ds_dot_chain(v, psi)
        t = ds_mul((a_ll[0][:, None, None, None, None],
                    a_ll[1][:, None, None, None, None]), psi)
        pmn = ds_add(ds_add((pmn_hi, pmn_lo), v), (-t[0], -t[1]))
        summ = ds_dot_chain(pmn, pmn)
        s = ds_sqrt(summ)
        rinv = ds_recip(s)
        psi_new = ds_mul((rinv[0][:, None, None, None, None],
                          rinv[1][:, None, None, None, None]), pmn)
        pm = ds_mul((s[0][:, None, None, None, None],
                     s[1][:, None, None, None, None]), psi)
        carry_out = (psi_new[0], psi_new[1], -pm[0], -pm[1],
                     summ[0], summ[1])
        return carry_out, (a_ll[0], a_ll[1], sp_hi, sp_lo)

    c = psi0_hi.shape[0]
    pmn0 = jnp.zeros_like(psi0_hi)
    ones = jnp.ones((c,), jnp.float32)
    zer = jnp.zeros((c,), jnp.float32)
    carry0 = (psi0_hi, psi0_lo, pmn0, pmn0, ones, zer)
    carry, (ahi, alo, bhi, blo) = jax.lax.scan(step, carry0, None,
                                               length=lld - 1)
    return ahi, alo, bhi, blo, carry[4], carry[5]


def lanczos_coefficients_conv_df64(w, h_scale: float, mask, psi0_ds,
                                   lld: int,
                                   nchunks: int = df64.DF64_CHUNKS,
                                   radius=(1, 1, 1)):
    """Haydock recursion on the conv-stencil layout in df64.

    psi0_ds: df64 pair of (C, D, nx, ny, nz) start vectors.  Returns host
    f64 (a, b2) of shape (lld, C) with the reference conventions
    (``b2[0]=1``, ``a[lld-1]=0``, ``b2[lld-1]=|r|^2``; ``crecal``
    recursion.f90:3423-3483).
    """
    ahi, alo, bhi, blo, shi, slo = _lanczos_conv_df64_jit(
        w, jnp.asarray(mask), psi0_ds[0], psi0_ds[1],
        jnp.float32(h_scale), lld, nchunks, tuple(radius))
    a = np.asarray(ahi, np.float64) + np.asarray(alo, np.float64)
    b2 = np.asarray(bhi, np.float64) + np.asarray(blo, np.float64)
    last = np.asarray(shi, np.float64) + np.asarray(slo, np.float64)
    c = a.shape[1]
    a = np.concatenate([a, np.zeros((1, c))], axis=0)
    b2 = np.concatenate([b2, last[None, :]], axis=0)
    return a, b2


@partial(jax.jit, static_argnames=("lld", "nchunks", "radius"))
def _chebyshev_conv_df64_jit(w, mask, psi0_hi, psi0_lo, h_scale,
                             ainv_hi, ainv_lo, b_hi, b_lo,
                             lld: int, nchunks: int, radius):
    """Chebyshev block moments on the conv layout in df64.

    The scaled Hamiltonian H~ = (H - b)/a is applied as the conv SpMV
    plus a df64 axpy; moments mu_n = <psi0| T_n(H~) |psi0> come from the
    doubling identities mu_2n = 2<T_n|T_n> - mu_0, mu_2n+1 =
    2<T_n+1|T_n> - mu_1 (``chebyshev_recur_ll`` recursion.f90:2495-2596),
    giving 2*lld+2 moments from lld applications.  psi0 is (C, D, nx, ny,
    nz); moments are per chain: mu (2*lld+2, C).
    """
    def apply_ht(psi):
        # (H psi - b psi) / a in df64; b and 1/a arrive as df64 pairs
        # (a single-f32 1/a is 6e-8 off and poisons every moment)
        v = conv_spmv_df64(w, h_scale, mask, psi, nchunks, radius)
        t = ds_mul((b_hi, b_lo), psi)
        num = ds_add(v, (-t[0], -t[1]))
        return ds_mul((ainv_hi, ainv_lo), num)

    psi0 = (psi0_hi, psi0_lo)
    mu0 = ds_dot_chain(psi0, psi0)
    w1 = apply_ht(psi0)
    mu1 = ds_dot_chain(w1, psi0)

    def step(carry, _):
        # carry = (T_{k-1}, T_k); emits <T_k|T_k> and <T_{k+1}|T_k>
        # (doubling pairs of chebyshev_recur :3057-3135)
        w0_, w1_ = carry
        v = apply_ht(w1_)
        two = (jnp.float32(2.0), jnp.float32(0.0))
        w2 = ds_add(ds_mul(two, v), (-w0_[0], -w0_[1]))
        d1 = ds_dot_chain(w1_, w1_)
        d2 = ds_dot_chain(w2, w1_)
        return (w1_, w2), (d1[0], d1[1], d2[0], d2[1])

    (_, _), (d1h, d1l, d2h, d2l) = jax.lax.scan(
        step, (psi0, w1), None, length=lld)
    return mu0[0], mu0[1], mu1[0], mu1[1], d1h, d1l, d2h, d2l


def chebyshev_moments_conv_df64(w, h_scale: float, mask, psi0_ds,
                                lld: int, a: float, b: float,
                                nchunks: int = df64.DF64_CHUNKS,
                                radius=(1, 1, 1)) -> np.ndarray:
    """Scalar-chain Chebyshev moments mu (2*lld+2, C) in f64 on the host,
    from the conv-stencil df64 recursion (doubling identities of
    ``chebyshev_recur_ll``)."""
    ainv = 1.0 / float(a)
    ainv_hi = np.float32(ainv)
    ainv_lo = np.float32(ainv - np.float64(ainv_hi))
    b_hi = np.float32(b)
    b_lo = np.float32(float(b) - np.float64(b_hi))
    out = _chebyshev_conv_df64_jit(
        w, jnp.asarray(mask), psi0_ds[0], psi0_ds[1],
        jnp.float32(h_scale), jnp.float32(ainv_hi), jnp.float32(ainv_lo),
        jnp.float32(b_hi), jnp.float32(b_lo), lld, nchunks,
        tuple(radius))
    mu0h, mu0l, mu1h, mu1l, d1h, d1l, d2h, d2l = out
    f64 = lambda h, l: np.asarray(h, np.float64) + np.asarray(l, np.float64)
    mu0 = f64(mu0h, mu0l)
    mu1 = f64(mu1h, mu1l)
    d1 = f64(d1h, d1l)  # (lld, C): <T_n|T_n>, n = 1..lld
    d2 = f64(d2h, d2l)  # (lld, C): <T_{n+1}|T_n>, n = 1..lld
    c = mu0.shape[0]
    mu = np.zeros((2 * lld + 2, c))
    mu[0] = mu0
    mu[1] = mu1
    mu[2::2] = 2.0 * d1 - mu0[None]
    mu[3::2] = 2.0 * d2 - mu1[None]
    return mu


def conv_start_vectors(st: ConvStencil, atom_indices, d: int,
                       orbitals=None):
    """df64 start vectors on the cell grid: one chain per (atom, orbital).

    Returns (hi, lo) of (C, d, nx, ny, nz) with C = len(atom_indices) *
    len(orbitals); chain c = a * norb + l (orbital fastest, matching
    ``recur``'s l-loop).
    """
    orbitals = list(range(d // 2)) if orbitals is None else list(orbitals)
    norb = len(orbitals)
    c = len(atom_indices) * norb
    hi = np.zeros((c,) + (d,) + st.dims, np.float32)
    for a_i, j in enumerate(atom_indices):
        ix, iy, iz = st.coords[j]
        for li, l in enumerate(orbitals):
            hi[a_i * norb + li, l, ix, iy, iz] = 1.0
    return (jnp.asarray(hi), jnp.zeros_like(jnp.asarray(hi)))
