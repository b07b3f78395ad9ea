"""Grid-sharded ms-conv engines: x-slab sharding + ppermute halo.

The beyond-HBM route for the block/Chebyshev conv engines (SURVEY §2.2
"ppermute halo exchange ... when the cluster exceeds per-chip HBM"):
the flat cell axis — x-major, so contiguous ranges are x-slabs of the
cell grid — is sharded over the device mesh with ``shard_map``, and
each H application exchanges one kernel-radius of boundary planes with
the neighbor shards via ``lax.ppermute`` (edge shards receive the
zeros ppermute naturally delivers to un-sourced destinations, matching
the dense engine's zero padding).  The reference has no analogue: every
MPI rank replicates the full cluster (``mpi.f90:32-58``); a device's
memory is a hard ceiling, so spatial sharding is what makes a cluster
whose *single-chain* state exceeds one device runnable at all.

Corrected stencils (surface per-layer types, impurity ``hall`` local
rows — ``hamiltonian.f90 build_locham`` :1618) are supported: each
correction atom is owned by the x-slab holding its cell, its neighbor
gathers read from the halo-EXTENDED df64 pair (every neighbor is
within one tap radius, so the exchanged halo always contains it), and
its row scatter-adds into the owner's local slab.  Atoms are grouped
per shard host-side, padded to a common count, with out-of-bounds
sentinel indices for the pads (JAX scatters drop them).

Numerics are IDENTICAL to the dense engines (tests/test_sharding.py,
dryrun gate 1e-10):

* conv: the halo-padded slab conv computes exactly the rows of the
  dense conv that land in the slab (x VALID after the halo concat,
  y/z padded as usual) — including the dense engine's truncated
  per-bucket mode for large slabs (the flop/bytes switch lives in
  ``msconv.conv_chunks``, shared);
* chunk extraction: the dynamic power-of-two pre-scale uses a global
  ``lax.pmax`` so every shard extracts against the same factor;
* Gram blocks: per-shard segmented exact partials, then an exact
  cross-device combine — ``all_gather`` of the per-shard df64 pairs and
  one compensated fold — instead of a plain f32 psum (which would
  break the 1e-10 whole-recursion parity);
* column transforms and the 36x36 eigensolve are cell-local /
  replicated and run unchanged.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from . import df64
from .df64 import ds_add, two_sum
from .msconv import (
    MSEngine,
    _ds_neg,
    _ds_pair,
    _fold_first,
    _group_corr,
    _local_corr,
    _pair_f64,
    _ravel_cells,
    colmul_chunks,
    conv_chunks,
    extract_small,
    gram_chunks,
)
from .stencil_conv import _extract_chunks_chan


def _extract_scaled_sh(pair, axis: str,
                       nchunks: int = df64.DF64_CHUNKS):
    """Shard-aware :func:`.msconv.extract_scaled`: the power-of-two
    pre-scale is the GLOBAL max (lax.pmax), so all shards share one
    exact factor."""
    m = jnp.max(jnp.abs(pair[0]))
    m = lax.pmax(m, axis)
    m = jnp.maximum(m, jnp.float32(1e-20))
    _, e = jnp.frexp(m)
    s = jnp.exp2(e.astype(jnp.float32))
    inv = 1.0 / s
    return (_extract_chunks_chan((pair[0] * inv, pair[1] * inv),
                                 nchunks), 2.0 * s)


def _halo_x(g, rx: int, ndev: int, axis: str):
    """Exchange ``rx`` boundary x-planes with the neighbor slabs.

    g: (..., nxl, m) with x the second-to-last axis.  ppermute
    delivers zeros to un-sourced chain ends (the dense zero pad).
    Returns (..., nxl + 2*rx, m)."""
    if rx == 0:
        return g
    nxl = g.shape[-2]
    if ndev > 1:
        fwd = [(i, i + 1) for i in range(ndev - 1)]
        bwd = [(i + 1, i) for i in range(ndev - 1)]
        from_left = lax.ppermute(g[..., nxl - rx:, :], axis, fwd)
        from_right = lax.ppermute(g[..., :rx, :], axis, bwd)
    else:
        from_left = jnp.zeros_like(g[..., :rx, :])
        from_right = jnp.zeros_like(g[..., :rx, :])
    return jnp.concatenate([from_left, g, from_right], axis=-2)


def _halo_pair(pair, rx: int, ldims, ndev: int, axis: str):
    """Halo-extend a flat df64 pair (C, nd, ncells_loc) -> flat
    (C, nd, ncells_ext) over the extended x extent."""
    nxl, ny, nz = ldims
    c, nd = pair[0].shape[0], pair[0].shape[1]

    def ext(x):
        g = x.reshape(c, nd, nxl, ny * nz)
        g = _halo_x(g, rx, ndev, axis)
        return g.reshape(c, nd, (nxl + 2 * rx) * ny * nz)

    return (ext(pair[0]), ext(pair[1]))


def _conv_halo(w, xq, fx, scale_w, mask_loc, radius, groups, ldims,
               ndev: int, axis: str,
               nchunks: int = df64.DF64_CHUNKS):
    """Bucket-conv SpMV on one x-slab with halo exchange.

    xq: (C, K, ncells_loc) chunks of the local slab; ldims the LOCAL
    (nxl, ny, nz).  The rx boundary planes travel to the x-neighbors;
    the conv itself (incl. the truncated per-bucket large-slab mode)
    is :func:`.msconv.conv_chunks` with ``halo_x``.
    """
    c, k = xq.shape[0], xq.shape[1]
    nxl, ny, nz = ldims
    rx = int(radius[0])
    g = xq.reshape(c, k, nxl, ny * nz)
    g = _halo_x(g, rx, ndev, axis)
    xe = g.reshape(c, k, (nxl + 2 * rx) * ny * nz)
    return conv_chunks(w, xe, fx, scale_w, mask_loc, radius, groups,
                       (nxl + 2 * rx, ny, nz), nchunks=nchunks,
                       halo_x=rx)


def _gram_sh(xq, fx, yq, fy, r: int, d: int, nd: int, axis: str):
    """Sharded exact block Gram: per-shard segmented partials, then an
    all_gather of the df64 pairs + one compensated fold (NOT an f32
    psum — that would lose the compensation across shards)."""
    hi, lo = gram_chunks(xq, fx, yq, fy, r, d, nd)
    hi_all = lax.all_gather(hi, axis)  # (ndev, r, d, d)
    lo_all = lax.all_gather(lo, axis)
    return _fold_first(hi_all, lo_all)


def _shard_tab(t):
    """Shard-local view of a per-shard correction table: drop the
    leading (size-1 after shard_map) device axis."""
    return None if t is None else t[0]


def _corr_sh(y, src_ext, loc, gco, key_l: str, key_g: str):
    """Apply the typed-layer and impurity-local row corrections on one
    slab (the dense ``_apply_h_chunks.corrected`` with shard-local
    tables; gathers read the halo-extended pair, scatters land in the
    local slab, pad rows carry out-of-bounds sentinels that JAX
    scatters drop)."""
    if gco is not None:
        y = _group_corr(y, src_ext, gco[key_g], _shard_tab(gco["sel"]),
                        _shard_tab(gco["chan"]), _shard_tab(gco["cell"]),
                        _shard_tab(gco["out"]), _shard_tab(gco["vmask"]))
    if loc is not None and key_l in loc:
        y = _local_corr(y, src_ext, _shard_tab(loc[key_l]),
                        _shard_tab(loc["chan"]), _shard_tab(loc["cell"]),
                        _shard_tab(loc["out"]), _shard_tab(loc["vmask"]))
    return y


def _apply_h_sh(w, w_o, w_ons, mask_loc, scale, scale_o, scale_ons,
                radius, groups, ldims, hoh: bool, ndev: int, axis: str,
                xq, fx, x_pair=None, loc=None, gco=None):
    rx = int(radius[0])
    corr = loc is not None or gco is not None
    h1 = _conv_halo(w, xq, fx, scale, mask_loc, radius, groups, ldims,
                    ndev, axis)
    if corr:
        xe = _halo_pair(x_pair, rx, ldims, ndev, axis)
        h1 = _corr_sh(h1, xe, loc, gco, "delta", "delta")
    if not hoh:
        return h1
    hq, fh = _extract_scaled_sh(h1, axis)
    h2 = _conv_halo(w_o, hq, fh, scale_o, mask_loc, radius, groups,
                    ldims, ndev, axis)
    if corr:
        h1e = _halo_pair(h1, rx, ldims, ndev, axis)
        h2 = _corr_sh(h2, h1e, loc, gco, "delta_o", "delta_o")
    # onsite (enim + lsham) term is cell-local: the dense onsite path
    ons = conv_chunks(w_ons, xq, fx, scale_ons, mask_loc, (0, 0, 0),
                      ((0, int(w_ons.shape[0])),), ldims)
    if gco is not None:
        ons = _group_corr(
            ons, xe, gco["delta_ons"], _shard_tab(gco["sel"]),
            _shard_tab(gco["chan"])[:, :1],
            _shard_tab(gco["cell"])[:, :1], _shard_tab(gco["out"]),
            _shard_tab(gco["vmask"])[:, :1])
    return ds_add(ds_add(h1, _ds_neg(h2)), ons)


def _block_stage_sh(w, w_o, w_ons, mask_loc, psi, pmn, sum_b, scale,
                    scale_o, scale_ons, loc, gco, nsteps: int, hoh: bool,
                    radius, groups, ldims, d: int, ndev: int, axis: str,
                    unroll: int):
    from .block_lanczos import _eig_sqrt

    r = sum_b.shape[0]
    nd = psi[0].shape[1]
    apply_h = partial(_apply_h_sh, w, w_o, w_ons, mask_loc, scale,
                      scale_o, scale_ons, radius, groups, ldims, hoh,
                      ndev, axis, loc=loc, gco=gco)

    def step(carry, _):
        psi, pmn, sum_b_prev = carry
        xq, fx = _extract_scaled_sh(psi, axis)
        hpsi = apply_h(xq, fx, x_pair=psi)
        hq, fh = _extract_scaled_sh(hpsi, axis)
        a_ll = _gram_sh(xq, fx, hq, fh, r, d, nd, axis)
        aq, fa = extract_small(a_ll)
        t = colmul_chunks(xq, fx, aq, fa, r, d)
        pmn = ds_add(ds_add(hpsi, _ds_neg(pmn)), _ds_neg(t))
        pq, fp = _extract_scaled_sh(pmn, axis)
        b2 = _gram_sh(pq, fp, pq, fp, r, d, nd, axis)
        b2_64 = _pair_f64(b2)
        b, b_i = _eig_sqrt(b2_64)  # replicated small blocks
        biq, fbi = extract_small(_ds_pair(b_i))
        bq, fb = extract_small(_ds_pair(b))
        psi_new = colmul_chunks(pq, fp, biq, fbi, r, d)
        pmn_new = colmul_chunks(xq, fx, bq, fb, r, d)
        return (psi_new, pmn_new, b2_64), (_pair_f64(a_ll), sum_b_prev)

    (psi, pmn, sum_b), (a_b, b2_b) = lax.scan(
        step, (psi, pmn, sum_b), None, length=nsteps, unroll=unroll)
    return psi, pmn, sum_b, a_b, b2_b


def _cheb_stage_sh(w, w_o, w_ons, mask_loc, p0, p1, mu0, mu1, scale,
                   scale_o, scale_ons, ainv_p, b_p, loc, gco,
                   nsteps: int, hoh: bool, radius, groups, ldims,
                   d: int, ndev: int, axis: str, unroll: int):
    from .df64 import ds_mul

    r = mu0.shape[0]
    nd = p0[0].shape[1]
    apply_h = partial(_apply_h_sh, w, w_o, w_ons, mask_loc, scale,
                      scale_o, scale_ons, radius, groups, ldims, hoh,
                      ndev, axis, loc=loc, gco=gco)

    def apply_ht(xq, fx, pair):
        hx = apply_h(xq, fx, x_pair=pair)
        num = ds_add(hx, _ds_neg(ds_mul(b_p, pair)))
        return ds_mul(ainv_p, num)

    def step(carry, _):
        p0_, p1_ = carry
        x1q, f1 = _extract_scaled_sh(p1_, axis)
        ht = apply_ht(x1q, f1, p1_)
        p2 = ds_add(ds_add(ht, ht), _ds_neg(p0_))
        x2q, f2 = _extract_scaled_sh(p2, axis)
        d1 = _pair_f64(_gram_sh(x1q, f1, x1q, f1, r, d, nd, axis))
        d2 = _pair_f64(_gram_sh(x2q, f2, x1q, f1, r, d, nd, axis))
        return (p1_, p2), (2.0 * d1 - mu0, 2.0 * d2 - mu1)

    (p0, p1), (mu_odd, mu_even) = lax.scan(
        step, (p0, p1), None, length=nsteps, unroll=unroll)
    return p0, p1, mu_odd, mu_even


# ----------------------------------------------------------------------
# host wrappers


def _per_shard_corr(eng: MSEngine, ndev: int, nxl: int):
    """Host-side per-shard correction tables.

    Groups correction atoms by their owning x-slab, pads every shard to
    the same atom count, remaps neighbor cells into the halo-EXTENDED
    local flat index and atom rows into the local slab flat index; pads
    scatter to an out-of-bounds sentinel (dropped) and gather (masked)
    zeros.  Returns (loc_tables, gco_tables), each a dict of
    (ndev, ...) arrays to shard on the leading axis, or None.
    """
    st = eng.st
    d = eng.d
    rx = int(eng.radius[0])
    nx, ny, nz = st.dims
    ldims = (nxl, ny, nz)
    ncl = int(nxl * ny * nz)
    exdims = (nxl + 2 * rx, ny, nz)
    oob = np.int64(st.ntot * d) * ncl  # scatter-dropped sentinel

    def build(cells_i, cells_j, ok, b_rows, nb_j, extra):
        """Common per-shard packing.  cells_i (na, 3) atom cells;
        cells_j (na, nslots, 3) neighbor cells; ok (na, nslots) valid;
        b_rows (na,) out-row basis; nb_j (na, nslots) neighbor basis;
        extra: dict name -> (na, ...) arrays regrouped alongside."""
        na = cells_i.shape[0]
        nslots = cells_j.shape[1]
        owner = cells_i[:, 0] // nxl
        namax = max(1, int(np.bincount(owner, minlength=ndev).max()))
        chan = np.zeros((ndev, namax, nslots, d), np.int32)
        cell = np.zeros((ndev, namax, nslots), np.int32)
        out = np.full((ndev, namax, d), oob, np.int64)
        vmask = np.zeros((ndev, namax, nslots), np.float32)
        packed = {k: np.zeros((ndev, namax) + v.shape[1:], v.dtype)
                  for k, v in extra.items()}
        for k in range(ndev):
            sel = np.nonzero(owner == k)[0]
            n = sel.size
            if n == 0:
                continue
            ci = cells_i[sel].copy()
            ci[:, 0] -= k * nxl
            cj = cells_j[sel].copy()
            cj[:, :, 0] -= (k * nxl - rx)  # into the extended slab
            okk = ok[sel]
            # every valid neighbor is within rx of an owned plane, so
            # it lies inside the extended slab by construction
            cjc = np.clip(cj, 0, np.asarray(exdims) - 1)
            cl_ = _ravel_cells(cjc, exdims).astype(np.int32)
            cl_[~okk] = 0
            cell[k, :n] = cl_
            chan[k, :n] = (nb_j[sel][..., None] * d
                           + np.arange(d)[None, None, :])
            out[k, :n] = ((b_rows[sel][:, None] * d
                           + np.arange(d)[None, :]) * ncl
                          + _ravel_cells(ci, ldims)[:, None])
            vmask[k, :n] = okk.astype(np.float32)
            for kk_, v in extra.items():
                packed[kk_][k, :n] = v[sel]
        tabs = {"chan": jnp.asarray(chan), "cell": jnp.asarray(cell),
                "out": jnp.asarray(
                    out.reshape(ndev, -1).astype(np.int32)),
                "vmask": jnp.asarray(vmask)}
        for k, v in packed.items():
            tabs[k] = jnp.asarray(v)
        return tabs

    loc_t = gco_t = None
    geom = eng._geom()
    if eng.local is not None:
        lg = geom["loc"]
        nmax = lg["nmax"]
        # neighbor basis per (atom, slot): chan stores nb*d + arange(d)
        nb_j = (np.asarray(lg["chan"])[:, :, 0] // d).astype(np.int64)
        extra = {"delta": np.asarray(eng.local["delta"])}
        if "delta_o" in eng.local:
            extra["delta_o"] = np.asarray(eng.local["delta_o"])
        loc_t = build(lg["cells_i"], lg["cells_j"], ~lg["absent"],
                      st.basis[:nmax], nb_j, extra)
    if eng.gcorr is not None:
        gc = geom["gc"]
        nb_j = st.nbasis[gc["b_a"]]
        extra = {"sel": np.asarray(eng.gcorr["sel"])}
        gco_t = build(gc["cells_a"], gc["nc"], gc["ok"], gc["b_a"],
                      nb_j, extra)
        for k in ("delta", "delta_o", "delta_ons"):
            if k in eng.gcorr:
                gco_t[k] = eng.gcorr[k]  # replicated group deltas
    return loc_t, gco_t


_jit_cache: dict = {}


def _cached(key, make):
    fn = _jit_cache.get(key)
    if fn is None:
        fn = make()
        if len(_jit_cache) > 16:
            _jit_cache.pop(next(iter(_jit_cache)))
        _jit_cache[key] = fn
    return fn


def _shard_setup(eng: MSEngine, mesh):
    axis = list(mesh.shape)[0]
    ndev = int(np.prod(list(mesh.shape.values())))
    nx, ny, nz = eng.dims
    nxl = -(-nx // ndev)
    pad = nxl * ndev - nx
    ncp = nxl * ndev * ny * nz
    mask = np.zeros((eng.mask_np.shape[0], ncp), np.float32)
    mask[:, :eng.ncells] = eng.mask_np
    loc_t, gco_t = _per_shard_corr(eng, ndev, nxl)
    return (axis, ndev, (nxl, ny, nz), pad, ncp, jnp.asarray(mask),
            loc_t, gco_t)


def _pad_cells(x, ncp: int):
    return np.pad(np.asarray(x),
                  [(0, 0)] * (x.ndim - 1) + [(0, ncp - x.shape[-1])])


def _corr_specs(tabs, axis, kind: str):
    """shard_map in_specs pytree for a correction-table dict.

    Per-shard tables (leading device axis) split on ``axis``; the
    impurity (``loc``) deltas are per-ATOM hence per-shard, the
    typed-layer (``gco``) deltas are per-GROUP hence replicated."""
    if tabs is None:
        return None
    shard_keys = {"chan", "cell", "out", "vmask", "sel"}
    if kind == "loc":
        shard_keys |= {"delta", "delta_o"}
    return {k: (P(axis) if k in shard_keys else P())
            for k in tabs}


def block_lanczos_ms_sharded(eng: MSEngine, mesh, psi0_grid, lld: int):
    """Grid-sharded block recursion -> host (a_b, b2_b) complex
    (lld, R, 18, 18); bit-path-identical to ``eng.block_lanczos`` dense
    execution up to the exact cross-device Gram combine."""
    from .block_lanczos import unrealify_blocks

    (axis, ndev, ldims, _, ncp, mask, loc_t, gco_t) = \
        _shard_setup(eng, mesh)
    d = eng.d
    r = psi0_grid.shape[0]
    flat = _pad_cells(np.asarray(psi0_grid).reshape(
        (r * d,) + psi0_grid.shape[2:]), ncp)
    unroll = (lld - 1) if jax.default_backend() == "cpu" else 1

    key = ("block", ndev, eng.hoh, eng.radius, eng.groups, ldims, d,
           r, lld, flat.shape, loc_t is None, gco_t is None,
           None if loc_t is None else loc_t["chan"].shape,
           None if gco_t is None else gco_t["chan"].shape)

    def make():
        spec_s = P(None, None, axis)
        spec_r = P()
        inner = partial(_block_stage_sh, nsteps=lld - 1, hoh=eng.hoh,
                        radius=eng.radius, groups=eng.groups,
                        ldims=ldims, d=d, ndev=ndev, axis=axis,
                        unroll=unroll)

        def run(w, w_o, w_ons, mask_j, psi_hi, scale, scale_o,
                scale_ons, sum_b, loc, gco):
            psi = (psi_hi, jnp.zeros_like(psi_hi))
            pmn = (jnp.zeros_like(psi_hi), jnp.zeros_like(psi_hi))
            _, _, sum_b_f, a_b, b2_b = inner(
                w, w_o, w_ons, mask_j, psi, pmn, sum_b, scale,
                scale_o, scale_ons, loc, gco)
            return a_b, b2_b, sum_b_f

        sm = shard_map(
            run, mesh=mesh,
            in_specs=(spec_r, spec_r, spec_r, P(None, axis), spec_s,
                      spec_r, spec_r, spec_r, spec_r,
                      _corr_specs(loc_t, axis, "loc"),
                      _corr_specs(gco_t, axis, "gco")),
            out_specs=(spec_r, spec_r, spec_r),
            # the Gram outputs are replicated BY CONSTRUCTION (identical
            # all_gather + deterministic fold on every shard) — the vma
            # checker cannot prove it
            check_vma=False)
        return jax.jit(sm)

    fn = _cached(key, make)
    sum_b0 = jnp.broadcast_to(jnp.eye(d, dtype=jnp.float64), (r, d, d))
    a_b, b2_b, sum_b_f = fn(
        eng.w, eng.w_o, eng.w_ons, mask, jnp.asarray(flat, jnp.float32),
        jnp.float32(eng.scale), jnp.float32(eng.scale_o),
        jnp.float32(eng.scale_ons), sum_b0, loc_t, gco_t)
    a_b = np.concatenate([np.asarray(a_b),
                          np.zeros((1, r, d, d))], axis=0)
    b2_b = np.concatenate([np.asarray(b2_b),
                           np.asarray(sum_b_f)[None]], axis=0)
    return unrealify_blocks(a_b), unrealify_blocks(b2_b)


def chebyshev_moments_ms_sharded(eng: MSEngine, mesh, psi0_grid,
                                 lld: int, a: float, b: float):
    """Grid-sharded Chebyshev doubling moments -> host mu complex
    (2*lld+2, R, 18, 18)."""
    from .block_lanczos import unrealify_blocks
    from .df64 import ds_mul

    (axis, ndev, ldims, _, ncp, mask, loc_t, gco_t) = \
        _shard_setup(eng, mesh)
    d = eng.d
    r = psi0_grid.shape[0]
    flat = _pad_cells(np.asarray(psi0_grid).reshape(
        (r * d,) + psi0_grid.shape[2:]), ncp)
    unroll_n = lld if jax.default_backend() == "cpu" else 1
    ainv = 1.0 / float(a)
    ainv_p = (jnp.asarray(np.float32(ainv)),
              jnp.asarray(np.float32(ainv - np.float64(np.float32(ainv)))))
    b_p = (jnp.asarray(np.float32(b)),
           jnp.asarray(np.float32(float(b) - np.float64(np.float32(b)))))

    key = ("cheb", ndev, eng.hoh, eng.radius, eng.groups, ldims, d, r,
           lld, flat.shape, loc_t is None, gco_t is None,
           None if loc_t is None else loc_t["chan"].shape,
           None if gco_t is None else gco_t["chan"].shape)

    def make():
        spec_s = P(None, None, axis)
        spec_r = P()

        def run(w, w_o, w_ons, mask_j, psi_hi, scale, scale_o,
                scale_ons, ainv_p, b_p, loc, gco):
            nd = psi_hi.shape[1]
            p0 = (psi_hi, jnp.zeros_like(psi_hi))
            x0q, f0 = _extract_scaled_sh(p0, axis)
            mu0 = _pair_f64(_gram_sh(x0q, f0, x0q, f0, r, d, nd, axis))
            hx = _apply_h_sh(w, w_o, w_ons, mask_j, scale, scale_o,
                             scale_ons, eng.radius, eng.groups, ldims,
                             eng.hoh, ndev, axis, x0q, f0, x_pair=p0,
                             loc=loc, gco=gco)
            num = ds_add(hx, _ds_neg(ds_mul(b_p, p0)))
            p1 = ds_mul(ainv_p, num)
            x1q, f1 = _extract_scaled_sh(p1, axis)
            mu1 = _pair_f64(_gram_sh(x1q, f1, x0q, f0, r, d, nd, axis))
            _, _, mu_odd, mu_even = _cheb_stage_sh(
                w, w_o, w_ons, mask_j, p0, p1, mu0, mu1, scale,
                scale_o, scale_ons, ainv_p, b_p, loc, gco, lld,
                eng.hoh, eng.radius, eng.groups, ldims, d, ndev, axis,
                unroll_n)
            return mu0, mu1, mu_odd, mu_even

        sm = shard_map(
            run, mesh=mesh,
            in_specs=(spec_r, spec_r, spec_r, P(None, axis), spec_s,
                      spec_r, spec_r, spec_r, spec_r, spec_r,
                      _corr_specs(loc_t, axis, "loc"),
                      _corr_specs(gco_t, axis, "gco")),
            out_specs=(spec_r,) * 4,
            check_vma=False)
        return jax.jit(sm)

    fn = _cached(key, make)
    mu0, mu1, mu_odd, mu_even = fn(
        eng.w, eng.w_o, eng.w_ons, mask, jnp.asarray(flat, jnp.float32),
        jnp.float32(eng.scale), jnp.float32(eng.scale_o),
        jnp.float32(eng.scale_ons), ainv_p, b_p, loc_t, gco_t)
    mu = np.zeros((2 * lld + 2, r, d, d))
    mu[0] = np.asarray(mu0)
    mu[1] = np.asarray(mu1)
    mu[2::2] = np.asarray(mu_odd)
    mu[3::2] = np.asarray(mu_even)
    return unrealify_blocks(mu)
