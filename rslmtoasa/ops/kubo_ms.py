"""df64 device Kubo-Bastin two-sided moments on the ms-conv engine.

No production path selects this engine since the recursion runs in
native complex128 (ROADMAP D2: delete next, with replacement tests).

The two-sided Chebyshev moment matrix mu_nm =
<r| T_m(H~) v_a T_n(H~) v_b |r> (``recursion.f90
compute_moments_stochastic`` :979-1234) computed entirely in the df64
pair representation of :mod:`.msconv` — every H and velocity
application is an exact bf16 bucket conv, and every mu block is the
same segmented exact Gram contraction the recursion engines use
(:func:`.msconv.gram_chunks`).  Moments land ~1e-12 relative to the
complex128 engine (``tests/test_kubo_ms.py``).

Memory model follows :func:`.kubo.kubo_moments`: the left chain is
generated in blocks of ``block_size`` states (stored as their chunk
extractions — bf16, so cheaper than the pair itself) and a full right
chain is replayed per block inside ``lax.scan``.  Work:
N + (N/Mb) N conv applications; left-block memory: Mb * d * 7*nd *
ncells bf16 bytes.

Operator conventions (identical to the gather engine):

* non-HoH: v_a is Hermitian, so the stored left states carry v_a
  folded in (saving one application per right step);
* HoH: v_eff = v - vo.(h .) is NOT Hermitian
  (``velo_hoh_vec_matmul`` :656-784, h = bare blocks EXCLUDING lsham,
  which is exactly the unfolded ``w`` kernel the ms engine packs in
  HoH mode), so left states are raw T_m and v_a applies on the right.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import df64
from .df64 import ds_add, ds_mul
from .msconv import (
    MSEngine,
    _apply_h_chunks,
    _ds_neg,
    _fold_first,
    conv_chunks,
    extract_scaled,
    grid_embed,
    pack_ms_kernel_df64,
)


def _ds_where(c, a, b):
    return (jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1]))


def _kubo_contract(lq, flv, rq, fr, mb: int, d: int, nd: int,
                   nchunks: int = df64.DF64_CHUNKS):
    """mu[m] = realified (left_m)^H (right) for a whole left block.

    lq: (mb, d, nchunks*nd, ncells) bf16 chunks with per-state factors
    flv (mb,); rq: (d, nchunks*nd, ncells) with factor fr.  Exactness
    as :func:`.msconv.gram_chunks`: cell segmentation keeps every
    partial inside the f32 integer window, one compensated fold over
    (chunk-pair x segment).  Returns a df64 pair (mb, d, d).
    """
    ncell = lq.shape[-1]
    lseg = max(1, 4096 // nd)
    nseg = -(-ncell // lseg)
    pad = nseg * lseg - ncell

    def _shape(q, lead):
        z = q.reshape(lead + (d, nchunks, nd, ncell))
        if pad:
            z = jnp.pad(z, [(0, 0)] * (len(lead) + 3) + [(0, pad)])
        return z.reshape(lead + (d, nchunks, nd, nseg, lseg))

    x = _shape(lq, (mb,))
    y = _shape(rq, ())
    part = jnp.einsum("mapdsl,cqdsl->pqmsac", x, y,
                      preferred_element_type=jnp.float32)
    sel = [part[pp, b - pp] for b in range(nchunks)
           for pp in range(nchunks) if 0 <= b - pp < nchunks]
    stack = jnp.concatenate(sel, axis=1)  # (mb, Npq*nseg, a, c)
    stack = jnp.moveaxis(stack, 1, 0)
    hi, lo = _fold_first(stack, jnp.zeros_like(stack))
    sc = (flv * fr)[:, None, None]
    return hi * sc, lo * sc


@partial(jax.jit, static_argnames=(
    "n_moments", "block_size", "hoh", "radius", "dims", "d", "groups",
    "gva", "gvb", "gvoa", "gvob", "unroll"))
def _kubo_ms_jit(w, w_o, w_ons, mask_chan, wva, wvb, wvoa, wvob, psi0,
                 scale, scale_o, scale_ons, sva, svb, svoa, svob,
                 ainv_p, b_p, n_moments: int, block_size: int,
                 hoh: bool, radius, dims, d: int, groups, gva, gvb,
                 gvoa, gvob, unroll: bool = False):
    """Blocked two-sided moment engine -> (hi, lo) f32
    (nblocks, n_moments, block_size, d, d)."""
    nd = psi0[0].shape[1]
    apply_h = partial(_apply_h_chunks, w, w_o, w_ons, None, None,
                      mask_chan, scale, scale_o, scale_ons, radius,
                      groups, dims, hoh)

    def apply_ht(pair):
        xq, fx = extract_scaled(pair)
        hx = apply_h(xq, fx, x_pair=pair)
        num = ds_add(hx, _ds_neg(ds_mul(b_p, pair)))
        return ds_mul(ainv_p, num)

    def apply_v(wop, sop, gop, wo_op, so_op, go_op, pair):
        xq, fx = extract_scaled(pair)
        vx = conv_chunks(wop, xq, fx, sop, mask_chan, radius, gop, dims)
        if not hoh:
            return vx
        h1 = conv_chunks(w, xq, fx, scale, mask_chan, radius, groups,
                         dims)
        hq, fh = extract_scaled(h1)
        vo = conv_chunks(wo_op, hq, fh, so_op, mask_chan, radius, go_op,
                         dims)
        return ds_add(vx, _ds_neg(vo))

    apply_va = partial(apply_v, wva, sva, gva, wvoa, svoa, gvoa)
    apply_vb = partial(apply_v, wvb, svb, gvb, wvob, svob, gvob)

    psi0p = psi0  # df64 pair (random-phase starts are not f32-exact)
    nblocks = -(-n_moments // block_size)

    def left_block(carry):
        # emit block_size left states as chunk extractions; carry
        # (m, T_{m-1}, T_m) pairs.  Non-HoH stores v_a T_m (fold).
        def one(c, _):
            m, w0, w1 = c
            ht = apply_ht(w1)
            w2 = _ds_where(m == 0, w1,
                           _ds_where(m == 1, ht,
                                     ds_add(ds_add(ht, ht),
                                            _ds_neg(w0))))
            out = w2 if hoh else apply_va(w2)
            oq, fo = extract_scaled(out)
            return (m + 1, _ds_where(m == 0, w0, w1), w2), (oq, fo)

        return lax.scan(one, carry, None, length=block_size,
                        unroll=block_size if unroll else 1)

    def right_over_block(lq, flv):
        v0 = apply_vb(psi0p)

        def one(c, _):
            n, vprev, v1 = c
            ht = apply_ht(v1)
            v2 = _ds_where(n == 0, v1,
                           _ds_where(n == 1, ht,
                                     ds_add(ds_add(ht, ht),
                                            _ds_neg(vprev))))
            rpair = apply_va(v2) if hoh else v2
            rq, fr = extract_scaled(rpair)
            g = _kubo_contract(lq, flv, rq, fr, block_size, d, nd)
            return (n + 1, _ds_where(n == 0, vprev, v1), v2), g

        zero = (jnp.zeros_like(v0[0]), jnp.zeros_like(v0[1]))
        _, mus = lax.scan(one, (0, zero, v0), None, length=n_moments,
                          unroll=n_moments if unroll else 1)
        return mus  # pair of (n_moments, block_size, d, d)

    def outer(carry, _):
        carry, (lq, flv) = left_block(carry)
        return carry, right_over_block(lq, flv)

    init = (0, (jnp.zeros_like(psi0[0]), jnp.zeros_like(psi0[1])),
            psi0p)
    _, mu = lax.scan(outer, init, None, length=nblocks,
                     unroll=nblocks if unroll else 1)
    return mu


class MSKubo:
    """Packed df64 Kubo engine for one (cluster, Hamiltonian, v_a, v_b).

    ``eng`` must be a correction-free :class:`~.msconv.MSEngine`
    (bulk crystals — the reference conductivity cases are bulk; layered
    or impurity clusters keep the gather path).  Velocity tables are
    (ntype, nslots, 18, 18) complex, packed once; ``moments`` runs per
    start block.
    """

    def __init__(self, eng: MSEngine, va, vb, vo_a, vo_b):
        from .block_lanczos import realify_blocks

        if eng.gcorr is not None or eng.local is not None:
            raise ValueError("ms Kubo engine needs a correction-free "
                             "stencil")
        self.eng = eng
        st = eng.st
        self.wva, self.sva, rva, self.gva = pack_ms_kernel_df64(
            realify_blocks(np.asarray(va)), st)
        self.wvb, self.svb, rvb, self.gvb = pack_ms_kernel_df64(
            realify_blocks(np.asarray(vb)), st)
        if rva != eng.radius or rvb != eng.radius:
            raise ValueError("velocity kernel radius mismatch")
        if eng.hoh:
            self.wvoa, self.svoa, _, self.gvoa = pack_ms_kernel_df64(
                realify_blocks(np.asarray(vo_a)), st)
            self.wvob, self.svob, _, self.gvob = pack_ms_kernel_df64(
                realify_blocks(np.asarray(vo_b)), st)
        else:  # unused placeholders (traced but dead)
            self.wvoa = self.wvob = self.wva
            self.svoa = self.svob = self.sva
            self.gvoa = self.gvob = self.gva
        self.mask = jnp.asarray(eng.mask_np)

    def block_size(self, n_moments: int) -> int:
        """Largest left block whose chunk storage fits the budget
        (override: RSLMTO_MS_HBM_BYTES, shared with the recursion
        engines)."""
        import os as _os

        budget = int(_os.environ.get("RSLMTO_MS_HBM_BYTES", 9 << 30))
        st, d = self.eng.st, self.eng.d
        per = d * df64.DF64_CHUNKS * st.ntot * d * self.eng.ncells * 2
        return int(min(n_moments, max(4, (budget // 3) // max(per, 1))))

    def moments(self, psi0_complex: np.ndarray, n_moments: int,
                a: float, b: float) -> np.ndarray:
        """mu (n_moments, n_moments, 18, 18) complex128 with
        mu[n, m] = sum_k <left_m | right_n> — index order of
        :func:`.kubo.kubo_moments`."""
        from .block_lanczos import realify_blocks, unrealify_blocks

        eng = self.eng
        d = eng.d
        g64 = grid_embed(eng.st, realify_blocks(
            np.asarray(psi0_complex)[None]), d)[0]
        g_hi = g64.astype(np.float32)
        g_lo = (g64 - g_hi.astype(np.float64)).astype(np.float32)
        ainv = 1.0 / float(a)
        ainv_p = (jnp.asarray(np.float32(ainv)),
                  jnp.asarray(np.float32(
                      ainv - np.float64(np.float32(ainv)))))
        b_p = (jnp.asarray(np.float32(b)),
               jnp.asarray(np.float32(
                   float(b) - np.float64(np.float32(b)))))
        mb = self.block_size(n_moments)
        unroll = jax.default_backend() == "cpu"  # conv-in-scan is
        # pathological on XLA-CPU (see msconv engines)
        hi, lo = _kubo_ms_jit(
            eng.w, eng.w_o, eng.w_ons, self.mask, self.wva, self.wvb,
            self.wvoa, self.wvob, (jnp.asarray(g_hi), jnp.asarray(g_lo)),
            jnp.float32(eng.scale), jnp.float32(eng.scale_o),
            jnp.float32(eng.scale_ons), jnp.float32(self.sva),
            jnp.float32(self.svb), jnp.float32(self.svoa),
            jnp.float32(self.svob), ainv_p, b_p, n_moments, mb,
            eng.hoh, eng.radius, eng.dims, d, eng.groups, self.gva,
            self.gvb, self.gvoa, self.gvob, unroll=unroll)
        mu = (np.asarray(hi, np.float64) + np.asarray(lo, np.float64))
        # (nblocks, n, mb, d, d) -> (n, nblocks*mb, d, d)
        mu = np.moveaxis(mu, 0, 1).reshape(n_moments, -1, d, d)
        return unrealify_blocks(mu[:, :n_moments])
