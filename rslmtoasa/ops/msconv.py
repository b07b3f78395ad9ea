"""Multi-site df64 flat-state conv engines for block-Lanczos and Chebyshev.

No production path selects this engine since the recursion runs in
native complex128 (ROADMAP D2: delete next, with replacement tests).

A df64 (bf16 exact-chunk) formulation of the recursion engines every
reference SCF case uses (``recur='block'|'chebyshev'``, all 18 cases in
``/root/reference/tests/scf/cases.json``): the masked block SpMV of
``recursion.f90`` ``hop_b`` :1560, ``hop_b_hoh`` :1411 and
``chebyshev_recur_ll`` :2495 re-expressed as a 3-D bucket convolution
over the crystal's cell grid, with basis sites folded into the conv
channel axis.

Design points (round-4 revision):

* **flat persistent state** — every array that lives across a scan step
  (the df64 pair wavefront, its chunk extraction) is shaped
  ``(C, nd, ncells)`` with the flattened cell grid minor.  Arrays tiled
  (8, 128) on their two minor dims pad a 5-D ``(.., nx, ny, nz)``
  layout pads a 17^3 impurity grid ~10x (measured: the round-3 B2FeCo
  HBM crash).  The flat layout pads <2%%.  Only the conv transients are
  5-D, in channel-minor NDHWC (~1.4-1.9x padding), reshaped back to
  flat immediately — XLA conv speed measured identical in NDHWC/NCDHW
  (138-155 TF/s bf16 at the production sizes).
* **18x18 spinor blocks, df64-pair state** — the engine state is the
  realified (36x36-real) block wavefront as a PAIR of f32 arrays; the
  SpMV runs in exact df64 bucket convolutions (bf16), and the block
  algebra that scales with the grid — Gram blocks (:func:`gram_chunks`)
  and column transforms (:func:`colmul_chunks`) — is built from the
  same exact chunk products with compensated accumulation.  Nothing
  large ever touches emulated f64; only the per-step 36x36 eigensolve
  runs in f64.
* **gather corrections, not correction convs** — per-layer surface
  types (one Hamiltonian row type per slab layer) and the impurity
  ``hall`` local rows (``hamiltonian.f90 build_locham`` :1618) are
  row corrections ``(H_special - H_bulk) @ x[neighbors]`` on a small
  atom subset; they run as per-atom gathers + tiny emulated-f64
  einsums with cost proportional to the special-atom count, instead of
  the round-3 full-grid masked delta convs (which cost a full extra
  conv per (family x layer-type) — the surface case's 278 s).
* **grouped exact accumulation** — one fused bucket conv is only exact
  while (taps x in-channels) x 2^12 fits in the f32 integer window
  (2^24).  Multi-site channel counts exceed it, so the input channels
  are split into groups at pack time and the group partials are
  compensated-summed (two_sum cascade) — error-free for any cell size.

Accuracy: the SpMV is ~1e-13 relative (exact bucket sums + compensated
recombination); whole-recursion parity vs the complex128 engines is
tested at 1e-10 (``tests/test_msconv.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from . import df64
from .df64 import ds_add, fast_two_sum, two_sum
from .stencil_conv import _extract_chunks_chan


@dataclass
class MSStencil:
    """Multi-site box embedding: atoms live at (basis, cell) grid sites."""

    dims: Tuple[int, int, int]  # (nx, ny, nz) cell-grid shape
    ntot: int  # basis sites per cell
    cells: np.ndarray  # (kk, 3) 0-based cell coords per atom
    basis: np.ndarray  # (kk,) 0-based basis index per atom
    basis_type: np.ndarray  # (ntot,) 0-based Hamiltonian row (type) per basis
    dcells: np.ndarray  # (ntot, nslots, 3) per-basis per-slot cell offsets
    nbasis: np.ndarray  # (ntot, nslots) neighbor basis per slot
    slot_ok: np.ndarray  # (ntot, nslots) slot exists for this basis
    mask: np.ndarray  # (ntot, nx, ny, nz) f32 occupancy
    kk: int
    #: per-atom 0-based types when some basis carries MULTIPLE types
    #: (surface slabs: types per layer); None for type-pure bases
    atom_type: Optional[np.ndarray] = None


def build_ms_stencil(cl) -> MSStencil:
    """Multi-site cell-grid embedding of a crystal cluster.

    Raises ValueError for clusters without a constant-offset stencil
    (wrapped PBC, atoms off the lattice grid) — callers fall back to
    the gather engine.
    """
    if cl.nn is None or cl.dirs is None:
        raise ValueError("cluster has no neighbor map")
    # impurity local zones keep the lattice geometry (newclu re-types
    # atoms in place); their per-atom hall rows become small gather
    # corrections in MSEngine, so they are NOT a stencil obstruction
    if any(getattr(cl, "pbc_wrap", (False,) * 3)):
        raise ValueError("wrapped PBC aliases conv taps")
    nb = cl.cell.ntot
    a = cl.cell.a * cl.alat
    ainv = np.linalg.inv(a)
    basis = (np.asarray(cl.num) - 1).astype(np.int64)
    if basis.min() < 0 or basis.max() >= nb:
        raise ValueError("basis bookkeeping out of range")
    rel = cl.cr_ang - (cl.cell.crd[:, basis] * cl.alat).T
    m = (ainv @ rel.T).T
    cells = np.round(m).astype(np.int64)
    if not np.allclose(m, cells, atol=1e-6):
        raise ValueError("atom not on the lattice grid")
    lo = cells.min(axis=0)
    cells = cells - lo
    dims = tuple(int(d) for d in cells.max(axis=0) + 1)

    nslots = cl.nn.shape[1] + 1
    dcells = np.zeros((nb, nslots, 3), np.int64)
    nbas = np.zeros((nb, nslots), np.int64)
    slot_ok = np.zeros((nb, nslots), bool)
    slot_ok[:, 0] = True
    nbas[:, 0] = np.arange(nb)
    # per-basis types: type-pure bases (bulk crystals) use the plain
    # kernel; bases carrying multiple types (surface slabs: one type
    # per layer; impurity re-typed zones) get gather-corrected rows —
    # the geometry must still be a constant-offset sublattice, but the
    # type distribution over it is arbitrary
    basis_type = np.full(nb, -1, np.int64)
    iz0 = (np.asarray(cl.iz) - 1).astype(np.int64)
    layered = False
    for b in range(nb):
        sel = basis == b
        if not sel.any():
            raise ValueError(f"basis {b} has no atoms")
        tt = np.unique(iz0[sel])
        if tt.size != 1:
            layered = True
            # dominant (bulk) type carries the main kernel
            basis_type[b] = np.bincount(iz0[sel]).argmax()
        else:
            basis_type[b] = tt[0]
        # representative: an atom of this basis with the full slot set
        cand = np.nonzero(sel & (cl.nn >= 0).all(axis=1))[0]
        la = int(cand[0]) if cand.size else int(np.nonzero(sel)[0][0])
        for s in range(1, nslots):
            j = int(cl.nn[la, s - 1])
            if j < 0:
                continue
            dcells[b, s] = cells[j] - cells[la]
            nbas[b, s] = basis[j]
            slot_ok[b, s] = True
    atom_type = iz0 if layered else None
    # every slot of every basis must be represented (otherwise an interior
    # atom's hop would be silently dropped)
    for b in range(nb):
        sel = np.nonzero(basis == b)[0]
        for s in range(1, nslots):
            has = sel[cl.nn[sel, s - 1] >= 0]
            if has.size == 0:
                continue
            if not slot_ok[b, s]:
                raise ValueError(f"slot {s} of basis {b} unrepresented")
            jj = cl.nn[has, s - 1]
            ok = (cells[jj] == cells[has] + dcells[b, s][None]).all() \
                and (basis[jj] == nbas[b, s]).all()
            if not ok:
                raise ValueError(f"slot {s} of basis {b} is not constant")

    mask = np.zeros((nb,) + dims, np.float32)
    mask[basis, cells[:, 0], cells[:, 1], cells[:, 2]] = 1.0
    return MSStencil(dims=dims, ntot=nb, cells=cells, basis=basis,
                     basis_type=basis_type, dcells=dcells, nbasis=nbas,
                     slot_ok=slot_ok, mask=mask, kk=cl.kk,
                     atom_type=atom_type)


# ----------------------------------------------------------------------
# kernel packing


def _chunk_host(y, nchunks):
    chunks = []
    res = y.copy()
    for k in range(nchunks):
        u = 2.0 ** (-df64.CHUNK_BITS * (k + 1))
        c = np.round(res / u) * u
        chunks.append(c)
        res = res - c
    return np.stack(chunks, 0)


def _pack_geometry(st: MSStencil, ntype: int, nslots: int, d: int,
                   nchunks: int = df64.DF64_CHUNKS):
    """Hamiltonian-independent kernel-assembly tables, cached on the
    stencil: device scatter/gather indices mapping the small chunk
    table ch (nchunks, ntype, nslots, D, D) into the expanded DHWIO
    conv kernel, plus the STRUCTURAL exactness groups.

    Device-side assembly is the fix for round-3 weak #3 (per-iteration
    host packing): the per-iteration upload shrinks from the expanded
    kernel (27-55 MB bf16) to the ~2 MB chunk
    table; the index tables upload once per case.  Structural groups
    (every existing (basis, slot) block counted dense) are slightly
    more conservative than value-based counts — still exact, and
    stable across SCF iterations (value-based groups could flip a
    boundary between iterations and retrigger jit compilation).
    """
    key = ("_pack_geom", ntype, nslots, d, nchunks)
    cache = getattr(st, "_pack_geom_cache", None)
    if cache is None:
        cache = {}
        st._pack_geom_cache = cache
    if key in cache:
        return cache[key]
    nb = st.ntot
    r = np.abs(st.dcells.reshape(-1, 3)).max(axis=0)
    kd, kh, kw = (int(2 * x + 1) for x in r)
    nd = nb * d
    kch = nchunks * nd
    if kd * kh * kw * kch * kch >= 2 ** 31:
        raise ValueError("conv kernel too large for i32 assembly "
                         "indices")

    # block-level enumeration: every valid (b_out, slot) x (p, q) with
    # p + q < nchunks places ch[p, t, m] at tap (dcell + r), in-block
    # (q, b_in), out-block (p + q, b_out).  Each destination block has
    # at most ONE source (neighbor slots are distinct (offset, basis)
    # pairs), so assembly is a dense block GATHER — an element
    # scatter-add serializes on the device and its expanded index upload
    # was ~70-150 MB per process.
    nblk = nchunks * nb
    zidx = nchunks * ntype * nslots  # appended zero block
    gidx = np.full((kd * kh * kw, nblk, nblk), zidx, np.int64)
    taps_np, in0_np, out0_np = [], [], []
    for b_out in range(nb):
        t = int(st.basis_type[b_out])
        for m in range(nslots):
            if not st.slot_ok[b_out, m]:
                continue
            b_in = int(st.nbasis[b_out, m])
            tx, ty, tz = (int(v) for v in st.dcells[b_out, m] + r)
            tap = (tx * kh + ty) * kw + tz
            for p in range(nchunks):
                for q in range(nchunks - p):
                    ib = q * nb + b_in
                    ob = (p + q) * nb + b_out
                    if gidx[tap, ib, ob] != zidx:
                        raise ValueError(
                            "duplicate kernel block in stencil")
                    gidx[tap, ib, ob] = (p * ntype + t) * nslots + m
                    taps_np.append(tap)
                    in0_np.append(ib * d)
                    out0_np.append(ob * d)
    taps = np.asarray(taps_np, np.int64)
    in0 = np.asarray(in0_np, np.int64)
    out0 = np.asarray(out0_np, np.int64)

    # structural exactness groups (same greedy split as the value-based
    # round-3 code, with every existing block counted fully dense)
    nzb = np.zeros((kch, nchunks * nb), np.int64)
    for k in range(len(taps)):
        ob = out0[k]
        ib = in0[k] // d
        nzb[ob:ob + d, ib] += d
    LIMIT = 4000
    groups = []
    start = 0
    acc = np.zeros(kch, np.int64)
    for bi in range(nchunks * nb):
        t = nzb[:, bi]
        if (acc + t).max() > LIMIT and bi > start:
            groups.append((start * d, bi * d))
            start = bi
            acc = t.copy()
        else:
            acc += t
    groups.append((start * d, nchunks * nb * d))

    ent = {
        "gidx": jnp.asarray(gidx.astype(np.int32)),
        "shape": (kd, kh, kw, kch, kch),
        "d": d,
        "radius": tuple(int(x) for x in r),
        "groups": tuple(groups),
    }
    cache[key] = ent
    return ent


@partial(jax.jit, static_argnames=("shape", "d"))
def _assemble_kernel_jit(ch_f32, gidx, shape, d):
    """Dense block-gather kernel assembly: ch_f32 is the small chunk
    table (nchunks, ntype, nslots, d, d); gidx maps every (tap,
    in-block, out-block) to its source chunk block (or the appended
    zero block).  DHWIO element (i=row/out, j=col/in): kernel[tap,
    ib*d+j, ob*d+i] = ch[gidx[tap, ib, ob]][i, j]."""
    chz = jnp.concatenate(
        [ch_f32.reshape(-1, d, d),
         jnp.zeros((1, d, d), jnp.float32)], axis=0)
    blocks = chz[gidx]  # (T, IB, OB, i, j)
    t_, ib, ob = gidx.shape
    w = blocks.transpose(0, 1, 4, 2, 3).reshape(t_, ib * d, ob * d)
    return w.reshape(shape).astype(jnp.bfloat16)


def pack_ms_kernel_df64(hs: np.ndarray, st: MSStencil,
                        nchunks: int = df64.DF64_CHUNKS):
    """Bucket-conv kernel from realified per-type slot blocks.

    hs: (ntype, nslots, D, D) f64 REAL (realified) slot blocks, slot 0 =
    onsite.  Returns (W bf16 DHWIO (KD, KH, KW, 7*ntot*D, 7*ntot*D),
    scale, radius, groups) where ``groups`` are input-channel split
    points that keep every partial conv's accumulation exact (see
    module docstring).  Host work per call is only the chunking of the
    small per-type table; the expanded kernel is assembled ON DEVICE
    from cached geometry indices (:func:`_pack_geometry`).
    """
    hs = np.asarray(hs, np.float64)
    ntype, nslots, d = hs.shape[0], hs.shape[1], hs.shape[2]
    geo = _pack_geometry(st, ntype, nslots, d, nchunks)
    amax = float(np.max(np.abs(hs))) if hs.size else 1.0
    scale = df64._pow2ceil(amax) * 2.0
    ch = _chunk_host(hs / scale, nchunks)  # (nchunks, ntype, nslots, D, D)
    w = _assemble_kernel_jit(jnp.asarray(ch.astype(np.float32)),
                             geo["gidx"], geo["shape"], geo["d"])
    return w, scale, geo["radius"], geo["groups"]


def pack_ms_onsite_df64(mat: np.ndarray, st: MSStencil,
                        nchunks: int = df64.DF64_CHUNKS):
    """(I, O) bucket matmul kernel for a per-type onsite block operator
    (the HoH enim + lsham correction applied per basis).  mat:
    (ntype, D, D) realified f64.  Returns (W bf16 (7*ntot*D, 7*ntot*D),
    scale)."""
    mat = np.asarray(mat, np.float64)
    d = mat.shape[-1]
    nb = st.ntot
    amax = float(np.max(np.abs(mat))) if mat.size else 1.0
    scale = df64._pow2ceil(max(amax, 1e-300)) * 2.0
    ch = _chunk_host(mat / scale, nchunks)
    nd = nb * d
    w = np.zeros((nchunks * nd, nchunks * nd), np.float32)
    for b_out in range(nb):
        t = int(st.basis_type[b_out])
        for s in range(nchunks):
            for q in range(nchunks):
                p = s - q
                if p < 0 or p >= nchunks:
                    continue
                w[s * nd + b_out * d:s * nd + (b_out + 1) * d,
                  q * nd + b_out * d:q * nd + (b_out + 1) * d] += ch[p, t]
    return jnp.asarray(w.T, jnp.bfloat16), scale


def mask_channels(st: MSStencil, d: int) -> np.ndarray:
    """Per-channel occupancy mask, flat (ntot*D, ncells)."""
    return np.repeat(st.mask, d, axis=0).reshape(st.ntot * d, -1)


# ----------------------------------------------------------------------
# df64 pair-state primitives (all heavy math f32/bf16)
#
# The engine state is a df64 PAIR of f32 arrays, never emulated f64:
# every large-array operation here is built from exact bf16 chunk
# products with compensated f32 accumulation (the same bucket algebra as
# the conv).


def _pow2_bound(hi):
    """Smallest power of two >= max|hi| (device scalar, exact)."""
    m = jnp.max(jnp.abs(hi))
    m = jnp.maximum(m, jnp.float32(1e-20))
    _, e = jnp.frexp(m)
    return jnp.exp2(e.astype(jnp.float32))


def extract_scaled(x_ds, nchunks: int = df64.DF64_CHUNKS):
    """Chunk-extract a df64 pair under a dynamic power-of-two pre-scale.

    Returns (chunks, factor): chunks bf16 (C, nchunks*nd, ncells) with
    x = factor * sum_k chunks_k to ~2^-49 relative; factor a power of
    two, so every scale propagation below is exact.  The dynamic scale
    keeps the leading chunk inside 6 bits for ANY operand magnitude
    (the recursion's pre-normalisation residuals exceed 1), preserving
    the exact-accumulation window.
    """
    s = _pow2_bound(x_ds[0])
    inv = 1.0 / s
    xs = (x_ds[0] * inv, x_ds[1] * inv)
    return _extract_chunks_chan(xs, nchunks), 2.0 * s


def conv_chunks(w, xq, fx, scale_w, mask_chan, radius, groups, dims,
                nchunks: int = df64.DF64_CHUNKS, halo_x: int = 0):
    """Bucket-conv SpMV from pre-extracted chunks -> df64 pair.

    xq: bf16 (C, K, ncells) chunks with factor fx; w bf16 DHWIO (or
    (I, O) for the onsite 1-tap kernel); mask_chan (nd, ncells_out)
    f32; dims the static (nx, ny, nz) of the flattened cell axis.

    ``halo_x > 0``: the x axis of ``xq``/``dims`` is pre-extended by
    ``halo_x`` boundary planes on each side (the grid-sharded slab
    engines concatenate ppermute halos) — the conv then runs VALID
    along x, producing ``nx - 2*halo_x`` output planes.

    Two execution modes, chosen by a flop/bytes model:

    * small problems: ONE fused conv over all output buckets (exactness
      via the packed channel ``groups``) — kernel-launch overhead
      dominates at these sizes;
    * large problems: per-bucket truncated convs — output bucket s only
      convolves input chunks q <= s (sum_s (s+1) = 28 channel-block
      products instead of 49), the NDHWC transients stay nd wide
      instead of 7*nd, and buckets s >= 4 skip the exactness grouping
      (their 2^-28 weight puts plain-f32 accumulation error below the
      df64 target).
    """
    c = xq.shape[0]
    onsite = w.ndim == 2
    kout = w.shape[-1]
    nd = kout // nchunks
    out_dims = (dims[0] - 2 * halo_x,) + tuple(dims[1:]) if halo_x \
        else dims
    ncells = int(np.prod(out_dims))

    def run(cin0, cin1, out0, out1):
        xs = xq[:, cin0:cin1]
        if onsite:
            return jnp.einsum("cin,io->cno", xs, w[cin0:cin1, out0:out1],
                              preferred_element_type=jnp.float32)
        xg = jnp.moveaxis(xs, 1, -1).reshape((c,) + tuple(dims)
                                             + (cin1 - cin0,))
        pad = [(int(r), int(r)) for r in radius]
        if halo_x:
            pad[0] = (0, 0)  # x pre-padded by the exchanged halo
        o = lax.conv_general_dilated(
            xg, w[..., cin0:cin1, out0:out1], window_strides=(1, 1, 1),
            padding=pad, dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            preferred_element_type=jnp.float32)
        return o.reshape(c, ncells, out1 - out0)

    def accumulate(gs, out0, out1):
        acc_hi = acc_lo = None
        for (c0, c1) in gs:
            o = run(c0, c1, out0, out1)
            if acc_hi is None:
                acc_hi, acc_lo = o, jnp.zeros_like(o)
            else:
                acc_hi, e = two_sum(acc_hi, o)
                acc_lo = acc_lo + e
        return acc_hi, acc_lo

    window = 1 if onsite else int(np.prod([2 * int(r) + 1 for r in radius]))
    fused_flops = 2.0 * c * ncells * window * xq.shape[1] * kout
    fused_bytes = 12.0 * c * ncells * kout  # 3 live f32 NDHWC transients
    if onsite or (fused_flops < 5e12 and fused_bytes < 2e9):
        acc_hi, acc_lo = accumulate(groups, 0, kout)
        outs = [(acc_hi[..., t * nd:(t + 1) * nd],
                 acc_lo[..., t * nd:(t + 1) * nd]) for t in range(nchunks)]
    else:
        outs = []
        for t in range(nchunks):
            cmax = (t + 1) * nd
            if t >= 4:
                gs = [(0, cmax)]
            else:
                gs = []
                for (c0, c1) in groups:
                    if c0 >= cmax:
                        break
                    gs.append((c0, min(c1, cmax)))
            outs.append(accumulate(gs, t * nd, (t + 1) * nd))
    hi, lo = _combine_buckets(outs)  # (C, ncells, nd)
    sc = jnp.asarray(scale_w, jnp.float32) * fx
    m = jnp.swapaxes(mask_chan, 0, 1)[None]
    return (jnp.moveaxis(hi * sc * m, -1, 1),
            jnp.moveaxis(lo * sc * m, -1, 1))


def _fold_first(hi, lo):
    """Compensated reduction of the LEADING axis by repeated halving
    (sibling of stencil_conv._fold_halves; leading-axis slices are
    contiguous blocks, no relayout)."""
    n = hi.shape[0]
    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        padw = [(0, n2 - n)] + [(0, 0)] * (hi.ndim - 1)
        hi = jnp.pad(hi, padw)
        lo = jnp.pad(lo, padw)
        n = n2
    while n > 1:
        half = n // 2
        s, e = two_sum(hi[:half], hi[half:n])
        e = e + (lo[:half] + lo[half:n])
        hi, lo = fast_two_sum(s, e)
        n = half
    return hi[0], lo[0]


def _combine_buckets(parts):
    """Combine per-bucket (hi, lo) pairs [b = 0..6] into one df64 pair:
    compensated adds for the head buckets, plain f32 for the tail
    (<= 2^-21 of the head) — the conv recombination pattern."""
    h, l = parts[0]
    hi, e = two_sum(h, parts[1][0])
    lo = l + e + parts[1][1]
    hi2, e2 = two_sum(hi, parts[2][0])
    hi, lo = hi2, lo + e2 + parts[2][1]
    for b in range(3, len(parts)):
        lo = lo + parts[b][0] + parts[b][1]
    return fast_two_sum(hi, lo)


def gram_chunks(xq, fx, yq, fy, r: int, d: int, nd: int,
                nchunks: int = df64.DF64_CHUNKS):
    """df64 block Gram from chunked operands.

    G[r, a, c] = sum_{Q, cell} x[(r, a), Q, cell] y[(r, c), Q, cell]
    with x = fx * sum(xq) etc.  All products are exact bf16 pairs; the
    cell axis is segmented so every partial accumulation stays
    inside the f32 integer window (terms <= 2^24 quanta), and segments /
    chunk-pairs reduce with compensated folds — error-free for any grid.
    Returns a df64 pair of (r, d, d).
    """
    ncell = int(np.prod(xq.shape[2:]))
    # exactness: (nd * L) products of <= 2^12 quanta must stay <= 2^24
    lseg = max(1, 4096 // nd)
    nseg = -(-ncell // lseg)
    pad = nseg * lseg - ncell

    def _shape(q):
        z = q.reshape(r, d, nchunks, nd, ncell)
        if pad:
            z = jnp.pad(z, [(0, 0)] * 4 + [(0, pad)])
        return z.reshape(r, d, nchunks, nd, nseg, lseg)

    x = _shape(xq)
    y = _shape(yq)
    # all chunk-pair partials in one contraction: (p, q, r, seg, a, c)
    partial = jnp.einsum("rapdsl,rcqdsl->pqrsac", x, y,
                         preferred_element_type=jnp.float32)
    # every partial is exact f32, so ONE compensated fold over the
    # whole (chunk-pair x segment) axis is error-free — two_sum needs
    # no same-quantum assumption; chunk pairs beyond p+q > 6 are below
    # 2^-49 and dropped (matching the conv kernel)
    sel = [partial[pp, b - pp] for b in range(nchunks)
           for pp in range(nchunks) if 0 <= b - pp < nchunks]
    stack = jnp.concatenate(sel, axis=1)  # (r, Npq*seg, a, c)
    stack = jnp.moveaxis(stack, 1, 0)
    hi, lo = _fold_first(stack, jnp.zeros_like(stack))
    sc = fx * fy
    return (hi * sc, lo * sc)


def extract_small(m_ds, nchunks: int = df64.DF64_CHUNKS):
    """Chunk-extract a small df64 block pair (r, d, d) -> (chunks bf16
    (r, nchunks, d, d), factor)."""
    s = _pow2_bound(m_ds[0])
    inv = 1.0 / s
    ms = (m_ds[0] * inv, m_ds[1] * inv)
    q = _extract_chunks_chan(ms, nchunks)  # (r, nchunks*d, d)
    r, _, d = q.shape
    return q.reshape(r, nchunks, d, d), 2.0 * s


def colmul_chunks(xq, fx, mq, fm, r: int, d: int,
                  nchunks: int = df64.DF64_CHUNKS):
    """df64 column transform from chunked operands.

    out[(r, c), Q, cell] = sum_b x[(r, b), Q, cell] M[r, b, c], with
    x = fx * sum(xq), M = fm * sum(mq).  One einsum computes every
    output bucket at once (contraction (q, b) = nchunks*d <= 2^20
    quanta — exact), then a compensated fold over the bucket axis.
    Returns a df64 pair shaped like the state.
    """
    grid = xq.shape[2:]
    x = xq.reshape(r, d, nchunks, -1)  # (r, b, q, nd*cells)
    zero = jnp.zeros_like(mq[:, 0])
    ms = jnp.stack([
        jnp.stack([mq[:, b - q] if 0 <= b - q < nchunks else zero
                   for q in range(nchunks)], axis=1)
        for b in range(nchunks)], axis=1)  # (r, s, q, b, c)
    o = jnp.einsum("rbqx,rsqbc->rscx", x, ms,
                   preferred_element_type=jnp.float32)  # (r, s, c, X)
    stack = jnp.moveaxis(o, 1, 0)  # (s, r, c, X)
    hi, lo = _fold_first(stack, jnp.zeros_like(stack))
    sc = fx * fm
    hi = (hi * sc).reshape((r * d, xq.shape[1] // nchunks) + grid)
    lo = (lo * sc).reshape((r * d, xq.shape[1] // nchunks) + grid)
    return hi, lo


def _ds_pair(x64):
    """Exact f64 -> df64 pair split (small arrays only)."""
    hi = x64.astype(jnp.float32)
    lo = (x64 - hi.astype(jnp.float64)).astype(jnp.float32)
    return hi, lo


def _pair_f64(p):
    return p[0].astype(jnp.float64) + p[1].astype(jnp.float64)


def _ds_neg(p):
    return (-p[0], -p[1])


# ----------------------------------------------------------------------
# gather corrections (impurity hall rows; surface per-layer types)


def _scatter_corr(y, corr, out_idx):
    """Compensated scatter-add of an emulated-f64 correction (C, na, D)
    into the flat df64 pair y at flattened (row, cell) indices."""
    c = y[0].shape[0]
    ch = corr.astype(jnp.float32)
    cl_ = (corr - ch.astype(jnp.float64)).astype(jnp.float32)
    yh = y[0].reshape(c, -1)
    yl = y[1].reshape(c, -1)
    old = yh[:, out_idx]
    snew, e = two_sum(old, ch.reshape(c, -1))
    yh = yh.at[:, out_idx].set(snew)
    yl = yl.at[:, out_idx].add(e + cl_.reshape(c, -1))
    return (yh.reshape(y[0].shape), yl.reshape(y[1].shape))


def _gather_x(x_pair, chan_idx, cell_idx, vmask):
    """Gather neighbor blocks from the flat pair -> emulated f64
    (C, na, nslots, D), with invalid (out-of-stage) slots zeroed."""
    xg = (x_pair[0][:, chan_idx, cell_idx[..., None]]
          .astype(jnp.float64)
          + x_pair[1][:, chan_idx, cell_idx[..., None]]
          .astype(jnp.float64))
    return xg * vmask[None, :, :, None]


def _local_corr(y, x_pair, delta64, chan_idx, cell_idx, out_idx, vmask):
    """Per-atom impurity correction (the ``hall`` local rows,
    hamiltonian.f90 build_locham :1618): y[local atom i] += sum_m
    (hall[i,m] - ee[type_i,m]) x[neighbor].  nmax is small, so the
    gather + einsum runs in emulated f64 on tiny arrays and the result
    scatter-adds into the pair with a compensated update."""
    xg = _gather_x(x_pair, chan_idx, cell_idx, vmask)
    corr = jnp.einsum("rimq,impq->rip", xg, delta64)
    return _scatter_corr(y, corr, out_idx)


def _group_corr(y, x_pair, delta_g64, sel, chan_idx, cell_idx, out_idx,
                vmask):
    """Typed-layer correction (surface slabs, impurity re-typed zones):
    atoms whose type t differs from their basis's dominant type get
    (H_t - H_dominant) row corrections — Hamiltonian row blocks depend
    only on the ROW atom's type (build_bulkham/ham0m_nc,
    hamiltonian.f90:2225,1553), so one delta table per (basis, type)
    group serves every atom of that group.

    Contraction order matters for HBM here: contracting sel with the
    group deltas first materialises a PER-ATOM delta table in emulated
    f64 — f32[8, na, nslots, d, d], several GiB padded on real slabs
    (fccCu001: na=1257, measured 3x3.64 GiB live) — while the
    (c, na, ngroups, d) intermediate below stays ~100x smaller for
    the small group counts real clusters have."""
    xg = _gather_x(x_pair, chan_idx, cell_idx, vmask)
    t = jnp.einsum("rimq,gmpq->rigp", xg, delta_g64)
    corr = jnp.einsum("rigp,ig->rip", t, sel)
    return _scatter_corr(y, corr, out_idx)


def _apply_h_chunks(w, w_o, w_ons, local, gcorr, mask_chan, scale,
                    scale_o, scale_ons, radius, groups, dims, hoh, xq, fx,
                    x_pair=None):
    def corrected(y, src_pair, key_l, key_g):
        if gcorr is not None:
            g = gcorr
            y = _group_corr(y, src_pair, g[key_g], g["sel"], g["chan"],
                            g["cell"], g["out"], g["vmask"])
        if local is not None and key_l in local:
            y = _local_corr(y, src_pair, local[key_l], local["chan"],
                            local["cell"], local["out"], local["vmask"])
        return y

    h1 = conv_chunks(w, xq, fx, scale, mask_chan, radius, groups, dims)
    h1 = corrected(h1, x_pair, "delta", "delta")
    if not hoh:
        return h1
    # H = h - eeo.(h psi) + (enim + ls) psi (hop_b_hoh :1411)
    hq, fh = extract_scaled(h1)
    h2 = conv_chunks(w_o, hq, fh, scale_o, mask_chan, radius, groups,
                     dims)
    h2 = corrected(h2, h1, "delta_o", "delta_o")
    ons = conv_chunks(w_ons, xq, fx, scale_ons, mask_chan, (0, 0, 0),
                      ((0, int(w_ons.shape[0])),), dims)
    if gcorr is not None:
        g = gcorr
        ons = _group_corr(ons, x_pair, g["delta_ons"], g["sel"],
                          g["chan"][:, :1], g["cell"][:, :1], g["out"],
                          g["vmask"][:, :1])
    return ds_add(ds_add(h1, _ds_neg(h2)), ons)


# ----------------------------------------------------------------------
# engines (df64 pair state; scan over recursion depth)
#
# Both engines are exposed as STAGE functions carrying their full state,
# so the host driver can run the recursion on a growing subgrid — the
# active-set wavefront device (create_ll_map, recursion.f90:3277-3303)
# composed with the conv engines: after k steps the wavefront has
# reached at most k tap-radii from the start cells, so early steps run
# on a small box and the full grid is only touched by the last stage.


@partial(jax.jit, static_argnames=("nsteps", "hoh", "radius", "groups",
                                   "dims", "d", "unroll"))
def _block_stage_ms_jit(w, w_o, w_ons, local, gcorr, mask_chan, psi, pmn,
                        sum_b, scale, scale_o, scale_ons, nsteps: int,
                        hoh: bool, radius, groups, dims, d: int,
                        unroll: int = 1):
    """nsteps of the block recursion from a full carry.  psi/pmn are
    flat df64 pairs (r*d, nd, ncells); sum_b is f64 (r, d, d).  Returns
    the advanced carry plus the emitted (a_ll, b2) blocks."""
    from .block_lanczos import _eig_sqrt

    r = sum_b.shape[0]
    nd = psi[0].shape[1]
    apply_h = partial(_apply_h_chunks, w, w_o, w_ons, local, gcorr,
                      mask_chan, scale, scale_o, scale_ons, radius,
                      groups, dims, hoh)

    def step(carry, _):
        psi, pmn, sum_b_prev = carry
        xq, fx = extract_scaled(psi)
        hpsi = apply_h(xq, fx, x_pair=psi)
        hq, fh = extract_scaled(hpsi)
        a_ll = gram_chunks(xq, fx, hq, fh, r, d, nd)
        aq, fa = extract_small(a_ll)
        t = colmul_chunks(xq, fx, aq, fa, r, d)
        pmn = ds_add(ds_add(hpsi, _ds_neg(pmn)), _ds_neg(t))
        pq, fp = extract_scaled(pmn)
        b2 = gram_chunks(pq, fp, pq, fp, r, d, nd)
        b2_64 = _pair_f64(b2)
        # NOTE: an f32-seeded eigh + Newton refinement is ~50 ms/step
        # cheaper but loses the small eigenvalues of ill-conditioned
        # late-recursion B^2 blocks beyond what the refinement can
        # recover — measured parity failures at lld >= 6.  Emulated-f64
        # eigh it is (grid-independent cost).
        b, b_i = _eig_sqrt(b2_64)  # small (r, d, d) emulated f64
        biq, fbi = extract_small(_ds_pair(b_i))
        bq, fb = extract_small(_ds_pair(b))
        psi_new = colmul_chunks(pq, fp, biq, fbi, r, d)
        pmn_new = colmul_chunks(xq, fx, bq, fb, r, d)
        a_ll64 = _pair_f64(a_ll)
        return (psi_new, pmn_new, b2_64), (a_ll64, sum_b_prev)

    (psi, pmn, sum_b), (a_b, b2_b) = jax.lax.scan(
        step, (psi, pmn, sum_b), None, length=nsteps, unroll=unroll)
    return psi, pmn, sum_b, a_b, b2_b


@partial(jax.jit, static_argnames=("hoh", "radius", "groups", "dims",
                                   "d"))
def _cheb_init_ms_jit(w, w_o, w_ons, local, gcorr, mask_chan, psi0,
                      scale, scale_o, scale_ons, ainv_p, b_p, hoh: bool,
                      radius, groups, dims, d: int):
    """First Chebyshev application + mu0/mu1 (T_0, T_1 seeds)."""
    r = psi0.shape[0]
    psi0 = psi0.reshape((r * d,) + psi0.shape[2:])
    nd = psi0.shape[1]
    from .df64 import ds_mul

    apply_h = partial(_apply_h_chunks, w, w_o, w_ons, local, gcorr,
                      mask_chan, scale, scale_o, scale_ons, radius,
                      groups, dims, hoh)
    psi0p = (psi0, jnp.zeros_like(psi0))
    x0q, f0 = extract_scaled(psi0p)
    mu0 = _pair_f64(gram_chunks(x0q, f0, x0q, f0, r, d, nd))
    hpsi = apply_h(x0q, f0, x_pair=psi0p)
    num = ds_add(hpsi, _ds_neg(ds_mul(b_p, psi0p)))
    psi1 = ds_mul(ainv_p, num)
    x1q, f1 = extract_scaled(psi1)
    mu1 = _pair_f64(gram_chunks(x1q, f1, x0q, f0, r, d, nd))
    return psi0p, psi1, mu0, mu1


@partial(jax.jit, static_argnames=("nsteps", "hoh", "radius", "groups",
                                   "dims", "d", "unroll"))
def _cheb_stage_ms_jit(w, w_o, w_ons, local, gcorr, mask_chan, p0, p1,
                       mu0, mu1, scale, scale_o, scale_ons, ainv_p, b_p,
                       nsteps: int, hoh: bool, radius, groups, dims,
                       d: int, unroll: int = 1):
    """nsteps of the Chebyshev doubling recursion from (T_{k-1}, T_k)."""
    r = mu0.shape[0]
    nd = p0[0].shape[1]
    from .df64 import ds_mul

    apply_h = partial(_apply_h_chunks, w, w_o, w_ons, local, gcorr,
                      mask_chan, scale, scale_o, scale_ons, radius,
                      groups, dims, hoh)

    def apply_ht(xq, fx, psi):
        hpsi = apply_h(xq, fx, x_pair=psi)
        num = ds_add(hpsi, _ds_neg(ds_mul(b_p, psi)))
        return ds_mul(ainv_p, num)

    def step(carry, _):
        p0_, p1_ = carry
        x1q, f1 = extract_scaled(p1_)
        ht = apply_ht(x1q, f1, p1_)
        p2 = ds_add(ds_add(ht, ht), _ds_neg(p0_))
        x2q, f2 = extract_scaled(p2)
        d1 = _pair_f64(gram_chunks(x1q, f1, x1q, f1, r, d, nd))
        d2 = _pair_f64(gram_chunks(x2q, f2, x1q, f1, r, d, nd))
        return (p1_, p2), (2.0 * d1 - mu0, 2.0 * d2 - mu1)

    (p0, p1), (mu_odd, mu_even) = jax.lax.scan(
        step, (p0, p1), None, length=nsteps, unroll=unroll)
    return p0, p1, mu_odd, mu_even


# ----------------------------------------------------------------------
# host-side wrappers


def _ravel_cells(cells: np.ndarray, dims) -> np.ndarray:
    return ((cells[..., 0] * dims[1] + cells[..., 1]) * dims[2]
            + cells[..., 2])


def grid_embed(st: MSStencil, psi0: np.ndarray, d: int) -> np.ndarray:
    """Embed (R, kk[+1], D, D) start blocks into the flat conv layout
    (R, D, ntot*D, ncells); column axis leads (conv batch)."""
    psi0 = np.asarray(psi0)
    r = psi0.shape[0]
    ncells = int(np.prod(st.dims))
    out = np.zeros((r, d, st.ntot * d, ncells), psi0.dtype)
    rows = (st.basis[:, None] * d + np.arange(d)[None, :])  # (kk, D)
    cell_lin = _ravel_cells(st.cells, st.dims)
    # out[r, c, row, cell] = psi0[r, i, q, c]
    out[:, :, rows, cell_lin[:, None]] = \
        psi0[:, :st.kk].transpose(0, 3, 1, 2)
    return out


class MSEngine:
    """Packed multi-site engine for one (cluster, Hamiltonian) pair.

    Build once per SCF iteration (the kernel depends on the Hamiltonian);
    the stencil geometry — including the per-stage index tables — is
    cached on the stencil by the caller, so the per-iteration host cost
    is only the kernel chunking itself (timed under ``ms-pack``).
    """

    def __init__(self, st: MSStencil, hs, lsham, *, hoh=False, hso=None,
                 enim=None, local=None):
        from .block_lanczos import realify_blocks
        from ..utils.timer import g_timer

        self.st = st
        self.d = 2 * hs.shape[-1]  # realified block dim
        self.dims = tuple(int(x) for x in st.dims)
        self.ncells = int(np.prod(st.dims))
        self.hoh = bool(hoh)
        with g_timer.section("ms-pack"):
            hs_r = realify_blocks(np.asarray(hs))
            ls_r = realify_blocks(np.asarray(lsham))
            with g_timer.section("kernel"):
                if self.hoh:
                    en_r = realify_blocks(np.asarray(enim))
                    hso_r = realify_blocks(np.asarray(hso))
                    self.w, self.scale, self.radius, self.groups = \
                        pack_ms_kernel_df64(hs_r, st)
                    self.w_o, self.scale_o, rad_o, grp_o = \
                        pack_ms_kernel_df64(hso_r, st)
                    if rad_o != self.radius:
                        raise ValueError("hoh kernel radius mismatch")
                    # refine both partitions so each partial conv is
                    # exact for BOTH kernels
                    bounds = sorted({p for g in self.groups for p in g}
                                    | {p for g in grp_o for p in g})
                    self.groups = tuple(zip(bounds[:-1], bounds[1:]))
                    self.w_ons, self.scale_ons = pack_ms_onsite_df64(
                        en_r + ls_r, st)
                    fam = (hs_r, hso_r, en_r + ls_r)
                else:
                    hs_fold = hs_r.copy()
                    hs_fold[:, 0] += ls_r  # lsham -> onsite slot
                    self.w, self.scale, self.radius, self.groups = \
                        pack_ms_kernel_df64(hs_fold, st)
                    self.w_o = self.w  # placeholder (same shape, unused)
                    self.scale_o = self.scale
                    nchunks = df64.DF64_CHUNKS
                    nd = nchunks * st.ntot * self.d
                    self.w_ons = jnp.zeros((nd, nd), jnp.bfloat16)
                    self.scale_ons = 1.0
                    fam = (hs_fold, None, None)
            self.mask_np = mask_channels(st, self.d)
            self.local = None
            if local is not None and int(local.get("nmax", 0)) > 0:
                # hall deltas are relative to the UNfolded ee rows in
                # both branches: the non-hoh kernel folds lsham into its
                # onsite slot, and the reference applies lsham to hall
                # rows too (block SpMV adds lsham[iz_onsite] for every
                # row, recursion.f90 hop_b :1560)
                with g_timer.section("local"):
                    self.local = self._build_local(local, hs_r, hso, st)
            # per-layer-type row corrections (surface slabs; impurity
            # re-typed zones): gather tables, one delta per (basis,type)
            self.gcorr = None
            if st.atom_type is not None:
                with g_timer.section("gcorr"):
                    self.gcorr = self._build_gcorr(st, fam)

    # -- geometry index tables (Hamiltonian-independent, cached on st) --
    def _geom(self):
        """Gather/stage geometry for this stencil+block size, cached on
        the stencil object (constant across SCF iterations)."""
        key = ("_ms_geom", self.d)
        g = getattr(self.st, "_ms_geom_cache", None)
        if g is None:
            g = {}
            self.st._ms_geom_cache = g
        if key not in g:
            g[key] = {"stage": {}}
        return g[key]

    def _gcorr_geom(self, st):
        """Full-grid gather indices for the typed-layer corrections."""
        geom = self._geom()
        if "gc" in geom:
            return geom["gc"]
        d = self.d
        at = st.atom_type
        bs = st.basis
        specs = []
        for b in range(st.ntot):
            tm = int(st.basis_type[b])
            for t in sorted(set(int(x) for x in at[bs == b]) - {tm}):
                specs.append((b, t))
        if not specs:
            geom["gc"] = None
            return None
        atoms = []
        grp = []
        for gidx, (b, t) in enumerate(specs):
            sel_i = np.nonzero((bs == b) & (at == t))[0]
            atoms.append(sel_i)
            grp.append(np.full(sel_i.size, gidx))
        atoms = np.concatenate(atoms)
        grp = np.concatenate(grp)
        na = atoms.size
        cells_a = st.cells[atoms]  # (na, 3)
        b_a = bs[atoms]
        nc = cells_a[:, None, :] + st.dcells[b_a]  # (na, nslots, 3)
        nb_s = st.nbasis[b_a]  # (na, nslots)
        dims = np.asarray(st.dims)
        inb = ((nc >= 0) & (nc < dims[None, None])).all(axis=2)
        ok = st.slot_ok[b_a] & inb
        ncl = np.clip(nc, 0, dims[None, None] - 1)
        cell = _ravel_cells(ncl, st.dims).astype(np.int32)
        cell[~ok] = 0
        chan = (nb_s[..., None] * d
                + np.arange(d)[None, None, :]).astype(np.int32)
        out_rows = b_a[:, None] * d + np.arange(d)[None, :]
        out_idx = (out_rows * self.ncells
                   + _ravel_cells(cells_a, st.dims)[:, None])
        sel = np.zeros((na, len(specs)))
        sel[np.arange(na), grp] = 1.0
        geom["gc"] = {
            "specs": specs, "atoms": atoms, "cells_a": cells_a,
            "nc": nc, "ok": ok, "b_a": b_a,
            "chan": jnp.asarray(chan),
            "cell": jnp.asarray(cell),
            "out": jnp.asarray(out_idx.ravel().astype(np.int32)),
            "vmask": jnp.asarray(ok.astype(np.float32)),
            "sel": jnp.asarray(sel),
        }
        return geom["gc"]

    def _build_gcorr(self, st, fam):
        gc = self._gcorr_geom(st)
        if gc is None:
            return None
        specs = gc["specs"]
        nslots = st.dcells.shape[1]
        d = self.d

        def deltas(tab, onsite=False):
            if tab is None:
                return None
            out = np.zeros((len(specs), 1 if onsite else nslots, d, d))
            for g, (b, t) in enumerate(specs):
                tm = int(st.basis_type[b])
                if onsite:
                    out[g, 0] = tab[t] - tab[tm]
                else:
                    m = st.slot_ok[b]
                    out[g, m] = tab[t, m] - tab[tm, m]
            return jnp.asarray(out)

        tabs = {"delta": deltas(fam[0])}
        if self.hoh:
            tabs["delta_o"] = deltas(fam[1])
            tabs["delta_ons"] = deltas(fam[2], onsite=True)
        return dict(tabs, chan=gc["chan"], cell=gc["cell"], out=gc["out"],
                    vmask=gc["vmask"], sel=gc["sel"])

    # -- impurity local zone -------------------------------------------
    def _local_geom(self, local, st):
        """Full-grid gather indices for the per-atom hall rows."""
        geom = self._geom()
        if "loc" in geom:
            return geom["loc"]
        nmax = int(local["nmax"])
        d = self.d
        cols = np.asarray(local["cols"])[:nmax]
        absent = cols >= st.kk
        j = np.where(absent, 0, cols)
        cells_j = st.cells[j]
        cells_i = st.cells[:nmax]
        # the hall neighbors come from the same neighbor map as the
        # stencil slots, so their reach never exceeds the tap radius —
        # required for the stage plan's ball bound to cover them.
        # Absent slots gather (masked) zeros from the clamped index 0
        # and must not enter the bound (their cells_j is meaningless).
        diff = np.abs(cells_j - cells_i[:, None])
        diff[absent] = 0
        reach = diff.max(axis=(0, 1))
        if (reach > np.asarray(self.radius)).any():
            raise ValueError("hall neighbor outside stencil radius")
        cellj = _ravel_cells(cells_j, st.dims).astype(np.int32)
        cellj[absent] = 0
        bj = st.basis[j]
        chan = (bj[..., None] * d
                + np.arange(d)[None, None, :]).astype(np.int32)
        out_idx = ((st.basis[:nmax, None] * d + np.arange(d)[None, :])
                   * self.ncells
                   + _ravel_cells(cells_i, st.dims)[:, None])
        geom["loc"] = {
            "nmax": nmax, "absent": absent, "cells_j": cells_j,
            "cells_i": cells_i,
            "chan": jnp.asarray(chan),
            "cell": jnp.asarray(cellj),
            "out": jnp.asarray(out_idx.ravel().astype(np.int32)),
            "vmask": jnp.asarray((~absent).astype(np.float32)),
        }
        return geom["loc"]

    def _build_local(self, local, hs_main, hso, st):
        """Per-atom gather-correction tables for the impurity-local
        ``hall`` rows (hamiltonian.f90 ``build_locham`` :1618): the conv
        assigns ``ee[type_i]`` to every atom (via the typed-layer
        corrections when the zone is re-typed); nmax small deltas
        (hall[i] - ee[type_i]) restore the exact per-atom rows."""
        from .block_lanczos import realify_blocks

        lg = self._local_geom(local, st)
        nmax = lg["nmax"]
        hall_r = realify_blocks(np.asarray(local["hall"]))
        at = (st.atom_type if st.atom_type is not None
              else st.basis_type[st.basis])
        tloc = np.asarray(at)[:nmax]
        delta = hall_r - hs_main[tloc]
        delta[lg["absent"]] = 0.0
        tabs = {"delta": jnp.asarray(delta)}
        if self.hoh:
            hallo_r = realify_blocks(np.asarray(local["hallo"]))
            eeo_r = realify_blocks(np.asarray(hso))
            delta_o = hallo_r - eeo_r[tloc]
            delta_o[lg["absent"]] = 0.0
            tabs["delta_o"] = jnp.asarray(delta_o)
        return dict(tabs, chan=lg["chan"], cell=lg["cell"],
                    out=lg["out"], vmask=lg["vmask"])

    # -- per-stage tables ----------------------------------------------
    def _stage_geom(self, bbox):
        """(mask_dev, idx_cells, sub_dims, loc_remap, gc_remap) for one
        stage box, cached on the stencil (geometry only)."""
        stages = self._geom()["stage"]
        hit = stages.get(bbox)
        if hit is not None:
            return hit
        st = self.st
        (lo, hi) = (np.asarray(bbox[0]), np.asarray(bbox[1]))
        sdims = tuple(int(x) for x in hi - lo)
        full = sdims == self.dims
        # flat linear indices of the subgrid cells within the full grid
        gx, gy, gz = np.meshgrid(*[np.arange(lo[k], hi[k])
                                   for k in range(3)], indexing="ij")
        sub_cells = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
        idx = _ravel_cells(sub_cells, st.dims).astype(np.int32)
        mask3 = self.mask_np.reshape((-1,) + self.dims)
        mask_sub = jnp.asarray(
            mask3[:, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            .reshape(mask3.shape[0], -1))

        def remap(cells_i, cells_j, ok0):
            """Remap (atom cells, neighbor cells) into the stage box.
            Neighbor cells outside the box gather (masked) zeros; atom
            rows outside scatter to an out-of-bounds sentinel, which
            JAX scatters DROP — never a collision with a valid row."""
            in_i = ((cells_i >= lo) & (cells_i < hi)).all(axis=-1)
            in_j = ((cells_j >= lo) & (cells_j < hi)).all(axis=-1)
            v = ok0 & in_j & in_i[:, None]
            cj = np.clip(cells_j - lo, 0, np.asarray(sdims) - 1)
            cell = _ravel_cells(cj, sdims).astype(np.int32)
            cell[~v] = 0
            ci = np.clip(cells_i - lo, 0, np.asarray(sdims) - 1)
            return v, cell, _ravel_cells(ci, sdims), in_i

        ent = {"sdims": sdims, "full": full,
               "idx": jnp.asarray(idx), "idx_np": idx,
               "mask": mask_sub, "loc": None, "gc": None}
        geom = self._geom()
        d = self.d
        ncs = int(np.prod(sdims))
        oob = np.int64(ncs) * (self.st.ntot * d)  # dropped by scatter
        if geom.get("loc") is not None:
            lg = geom["loc"]
            nmax = lg["nmax"]
            v, cell, ci_lin, in_i = remap(lg["cells_i"], lg["cells_j"],
                                          ~lg["absent"])
            out_idx = ((self.st.basis[:nmax, None] * d
                        + np.arange(d)[None, :]) * ncs
                       + ci_lin[:, None])
            out_idx[~in_i] = oob
            ent["loc"] = {"chan": lg["chan"],
                          "cell": jnp.asarray(cell),
                          "out": jnp.asarray(
                              out_idx.ravel().astype(np.int32)),
                          "vmask": jnp.asarray(v.astype(np.float32))}
        if geom.get("gc") is not None:
            gc = geom["gc"]
            v, cell, ci_lin, in_i = remap(gc["cells_a"], gc["nc"],
                                          gc["ok"])
            out_rows = gc["b_a"][:, None] * d + np.arange(d)[None, :]
            out_idx = out_rows * ncs + ci_lin[:, None]
            out_idx[~in_i] = oob
            ent["gc"] = {"chan": gc["chan"],
                         "cell": jnp.asarray(cell),
                         "out": jnp.asarray(
                             out_idx.ravel().astype(np.int32)),
                         "vmask": jnp.asarray(v.astype(np.float32)),
                         "sel": gc["sel"]}
        stages[bbox] = ent
        return ent

    def _stage_tables(self, bbox):
        """(mask, local, gcorr, sdims, entry) with the Hamiltonian
        deltas composed onto the cached stage geometry."""
        ent = self._stage_geom(bbox)
        if not ent["full"] and (
                (self.local is not None and ent["loc"] is None)
                or (self.gcorr is not None and ent["gc"] is None)):
            # stage entry cached before the correction geometry existed
            self._geom()["stage"].pop(bbox, None)
            ent = self._stage_geom(bbox)
        loc = None
        if self.local is not None:
            if ent["full"]:
                loc = self.local
            else:
                loc = dict(ent["loc"])
                for k in ("delta", "delta_o"):
                    if k in self.local:
                        loc[k] = self.local[k]
        gco = None
        if self.gcorr is not None:
            if ent["full"]:
                gco = self.gcorr
            else:
                gco = dict(ent["gc"])
                for k in ("delta", "delta_o", "delta_ons"):
                    if k in self.gcorr:
                        gco[k] = self.gcorr[k]
        return ent["mask"], loc, gco, ent["sdims"], ent

    @property
    def full_bbox(self):
        return ((0, 0, 0), self.dims)

    # -- start blocks --------------------------------------------------
    def embed(self, psi0_complex: np.ndarray) -> jnp.ndarray:
        from .block_lanczos import realify_blocks

        st = self.st
        p = np.asarray(psi0_complex)[:, :st.kk]
        occ = np.nonzero(np.abs(p).sum(axis=(0, 2, 3)))[0]
        if occ.size <= 4096:
            # sparse device-side embed: production start blocks occupy
            # only the rec atoms (SCF) or 2 sites per pair chain
            # (exchange), so uploading the dense (r, d, nd, ncells)
            # grid (hundreds of MB) for a handful of nonzero site
            # blocks dominated the dispatch
            # wall; instead ship just the occupied blocks and scatter
            # on device
            r = p.shape[0]
            vals = realify_blocks(np.ascontiguousarray(p[:, occ]))
            rows = (st.basis[occ, None] * self.d
                    + np.arange(self.d)[None, :])  # (ns, D)
            cell = _ravel_cells(st.cells[occ], st.dims)  # (ns,)
            out = jnp.zeros((r, self.d, st.ntot * self.d, self.ncells),
                            jnp.float32)
            v = jnp.asarray(vals.transpose(0, 3, 1, 2)
                            .astype(np.float32))  # (r, D, ns, D)
            return out.at[:, :, rows, cell[:, None]].set(v)
        return jnp.asarray(grid_embed(
            self.st, realify_blocks(np.asarray(psi0_complex)),
            self.d).astype(np.float32))

    # -- wavefront stage plan ------------------------------------------
    def start_bbox(self, psi0):
        """Cell bounding box of the nonzero start blocks (host psi0,
        (R, kk[+1], D, D))."""
        p = np.abs(np.asarray(psi0))[:, :self.st.kk]
        rows = np.nonzero(p.sum(axis=(0, 2, 3)))[0]
        cc = self.st.cells[rows]
        return tuple(cc.min(axis=0)), tuple(cc.max(axis=0))

    def stage_plan(self, bbox0, nsteps: int, first_ball: int = 1,
                   force: bool = False):
        """Greedy wavefront staging (the create_ll_map device,
        recursion.f90:3277-3303, composed with the conv engine): step i
        needs the box reached after (first_ball + i - 1 + 1) hop-radii.
        Box dims are quantised to multiples of 4 so distinct cases and
        SCF iterations share compiled stage shapes.  Returns
        [(nsteps_k, (lo, hi))] or None when dense is cheaper.
        ``force`` skips the work-threshold collapse (tests of the
        staged execution path).
        """
        hops = 2 if self.hoh else 1
        rad = np.asarray(self.radius)
        dims = np.asarray(self.st.dims)
        lo0 = np.asarray(bbox0[0])
        hi0 = np.asarray(bbox0[1])
        boxes, vols = [], []
        for i in range(nsteps):
            m = (first_ball + i) * hops
            lo = np.maximum(0, lo0 - m * rad)
            hi = np.minimum(dims, hi0 + 1 + m * rad)
            lo = (lo // 4) * 4
            hi = np.minimum(dims, -(-hi // 4) * 4)
            boxes.append((tuple(int(x) for x in lo),
                          tuple(int(x) for x in hi)))
            vols.append(int(np.prod(hi - lo)))
        full = int(np.prod(dims))
        plan = []
        i = 0
        while i < nsteps:
            j = i
            while j + 1 < nsteps and vols[j + 1] <= 2.5 * vols[i] \
                    and (j + 1 - i) < 48:
                j += 1
            plan.append((j - i + 1, boxes[j]))
            i = j + 1
        def vol(b):
            return int(np.prod(np.asarray(b[1]) - np.asarray(b[0])))

        work = sum(n * vol(b) for n, b in plan)
        # compile-aware staging: every stage is a distinct (nsteps, box)
        # jit signature costing a separate trace+compile, so marginal
        # work savings lose to the extra compiles — require a >=40% cut
        # (the dense single-shape plan is shared by every case and SCF
        # iteration on the same grid), and cap the plan at 3 stages by
        # merging the cheapest adjacent pair
        if work >= 0.6 * nsteps * full and not force:
            return None
        while len(plan) > 3:
            costs = [plan[i][0] * (vol(plan[i + 1][1]) - vol(plan[i][1]))
                     for i in range(len(plan) - 1)]
            i = int(np.argmin(costs))
            plan[i:i + 2] = [(plan[i][0] + plan[i + 1][0],
                              plan[i + 1][1])]
        return plan

    def _transfer_pair(self, pair, old_ent, new_ent):
        """Move a flat stage pair from one box to a larger one via a
        host-precomputed scatter (no padded 5-D transients)."""
        pos = np.searchsorted(new_ent["idx_np"], old_ent["idx_np"])
        pos = jnp.asarray(pos.astype(np.int32))
        shape = pair[0].shape[:-1] + (int(np.prod(new_ent["sdims"])),)

        def put(x):
            return jnp.zeros(shape, x.dtype).at[..., pos].set(x)

        return put(pair[0]), put(pair[1])

    # -- engines -------------------------------------------------------
    def _chain_batch(self, r: int) -> int:
        """Largest chain batch the engine state fits in HBM.

        Mode-aware (a flat 150 B/elem model assumed
        the FUSED conv's 7*nd-wide transients, forcing the exchange
        pair driver into 3x smaller batches than the truncated
        per-bucket mode — which large problems actually run — needs):
        flat-state bytes per chain are ~8 live df64 pairs + 2 chunk
        extractions, plus 3 live conv transients whose channel width
        depends on the mode :func:`conv_chunks` will pick for the
        candidate batch.  Override budget: RSLMTO_MS_HBM_BYTES
        (default 9 GiB)."""
        import os as _os

        budget = int(_os.environ.get("RSLMTO_MS_HBM_BYTES", 9 << 30))
        nd = self.st.ntot * self.d
        elems = self.ncells * nd * self.d
        # HoH (two convs + onsite per application) and gather-corrected
        # engines hold roughly twice the transients of the plain
        # engine, and XLA's while-loop liveness roughly doubles the
        # hand count again — 150 B/elem is the empirically proven
        # bound for them (every r4 device case).  Clean non-HoH bulk
        # engines (the exchange pair driver's regime) measured safe at
        # the leaner 120 B/elem (truncated-mode transients).
        heavy = self.hoh or self.local is not None \
            or self.gcorr is not None
        per = elems * (150 if heavy else 120)
        return max(1, min(r, budget // max(per, 1)))

    def block_lanczos(self, psi0_grid, lld: int, start_bbox=None,
                      plan=None):
        r = psi0_grid.shape[0]
        rb = self._chain_batch(r)
        if rb < r:
            # fixed batch size: pad R up to a multiple of rb with copies
            # of chain 0 so every batch compiles to the SAME shape
            # (round-3 weak #7: per-batch-size jit churn)
            pads = (-r) % rb
            if pads:
                psi0_grid = jnp.concatenate(
                    [psi0_grid] + [psi0_grid[:1]] * pads, axis=0)
            parts = [self._block_lanczos_one(psi0_grid[i:i + rb], lld,
                                             start_bbox, plan)
                     for i in range(0, r + pads, rb)]
            return (np.concatenate([p[0] for p in parts], axis=1)[:, :r],
                    np.concatenate([p[1] for p in parts], axis=1)[:, :r])
        return self._block_lanczos_one(psi0_grid, lld, start_bbox, plan)

    def _block_lanczos_one(self, psi0_grid, lld: int, start_bbox=None,
                           plan=None):
        """Block recursion -> (a_b, b2_b) complex (lld, R, 18, 18).

        With ``start_bbox`` the recursion runs wavefront-staged on
        growing subgrids when the plan predicts a win; otherwise dense.
        An explicit ``plan`` overrides the stage_plan heuristic.
        """
        from .block_lanczos import unrealify_blocks

        unroll_all = jax.default_backend() == "cpu"
        r, d = psi0_grid.shape[0], self.d
        flat = psi0_grid.reshape((r * d,) + psi0_grid.shape[2:])
        if plan is None and start_bbox is not None and lld > 2:
            plan = self.stage_plan(start_bbox, lld - 1, first_ball=1)
        if plan is None:
            plan = [(lld - 1, self.full_bbox)]
        args = (jnp.float32(self.scale), jnp.float32(self.scale_o),
                jnp.float32(self.scale_ons))
        psi = pmn = None
        sum_b = jnp.broadcast_to(jnp.eye(d, dtype=jnp.float64), (r, d, d))
        prev_ent = None
        a_parts, b_parts = [], []
        for nsteps, bbox in plan:
            mask_sub, loc, gco, sdims, ent = self._stage_tables(bbox)
            if psi is None:
                sub = flat[..., ent["idx"]]
                psi = (sub, jnp.zeros_like(sub))
                pmn = (jnp.zeros_like(sub), jnp.zeros_like(sub))
            else:
                psi = self._transfer_pair(psi, prev_ent, ent)
                pmn = self._transfer_pair(pmn, prev_ent, ent)
            unroll = nsteps if unroll_all else 1
            psi, pmn, sum_b, a_b, b2_b = _block_stage_ms_jit(
                self.w, self.w_o, self.w_ons, loc, gco, mask_sub,
                psi, pmn, sum_b, *args, nsteps, self.hoh, self.radius,
                self.groups, sdims, d, unroll)
            a_parts.append(np.asarray(a_b))
            b_parts.append(np.asarray(b2_b))
            prev_ent = ent
        a_b = np.concatenate(a_parts + [np.zeros((1, r, d, d))], axis=0)
        b2_b = np.concatenate(b_parts + [np.asarray(sum_b)[None]], axis=0)
        return unrealify_blocks(a_b), unrealify_blocks(b2_b)

    def chebyshev_moments(self, psi0_grid, lld: int, a: float, b: float,
                          start_bbox=None, plan=None):
        r = psi0_grid.shape[0]
        rb = self._chain_batch(r)
        if rb < r:
            pads = (-r) % rb
            if pads:
                psi0_grid = jnp.concatenate(
                    [psi0_grid] + [psi0_grid[:1]] * pads, axis=0)
            parts = [self._chebyshev_moments_one(
                psi0_grid[i:i + rb], lld, a, b, start_bbox, plan)
                for i in range(0, r + pads, rb)]
            return np.concatenate(parts, axis=1)[:, :r]
        return self._chebyshev_moments_one(psi0_grid, lld, a, b,
                                           start_bbox, plan)

    def _chebyshev_moments_one(self, psi0_grid, lld: int, a: float,
                               b: float, start_bbox=None, plan=None):
        """Chebyshev doubling moments -> mu complex (2*lld+2, R, 18, 18),
        optionally wavefront-staged."""
        from .block_lanczos import unrealify_blocks

        unroll_all = jax.default_backend() == "cpu"
        r, d = psi0_grid.shape[0], self.d
        ainv = 1.0 / float(a)
        ainv_p = (jnp.asarray(np.float32(ainv)),
                  jnp.asarray(np.float32(
                      ainv - np.float64(np.float32(ainv)))))
        b_p = (jnp.asarray(np.float32(b)),
               jnp.asarray(np.float32(
                   float(b) - np.float64(np.float32(b)))))
        args = (jnp.float32(self.scale), jnp.float32(self.scale_o),
                jnp.float32(self.scale_ons), ainv_p, b_p)
        if plan is None and start_bbox is not None and lld > 2:
            # scan step j emits T_{j+1}: ball (j+1) applications deep
            plan = self.stage_plan(start_bbox, lld, first_ball=2)
        if plan is None:
            init_bbox = self.full_bbox
            plan = [(lld, self.full_bbox)]
        else:
            # the init (T_1 = H~ T_0) needs one application's reach
            ip = self.stage_plan(start_bbox, 1, first_ball=1)
            init_bbox = ip[0][1] if ip else self.full_bbox
        mask_sub, loc, gco, sdims, ent = self._stage_tables(init_bbox)
        flat = psi0_grid[..., ent["idx"]]
        p0, p1, mu0, mu1 = _cheb_init_ms_jit(
            self.w, self.w_o, self.w_ons, loc, gco, mask_sub, flat,
            *args, self.hoh, self.radius, self.groups, sdims, d)
        odd_parts, even_parts = [], []
        prev_ent = ent
        for nsteps, bbox in plan:
            mask_sub, loc, gco, sdims, ent = self._stage_tables(bbox)
            if ent is not prev_ent:
                p0 = self._transfer_pair(p0, prev_ent, ent)
                p1 = self._transfer_pair(p1, prev_ent, ent)
            unroll = nsteps if unroll_all else 1
            p0, p1, mu_odd, mu_even = _cheb_stage_ms_jit(
                self.w, self.w_o, self.w_ons, loc, gco, mask_sub,
                p0, p1, mu0, mu1, *args, nsteps, self.hoh, self.radius,
                self.groups, sdims, d, unroll)
            odd_parts.append(np.asarray(mu_odd))
            even_parts.append(np.asarray(mu_even))
            prev_ent = ent
        mu_odd = np.concatenate(odd_parts, axis=0)
        mu_even = np.concatenate(even_parts, axis=0)
        mu = np.zeros((2 * lld + 2, r, d, d))
        mu[0] = np.asarray(mu0)
        mu[1] = np.asarray(mu1)
        mu[2::2] = mu_odd
        mu[3::2] = mu_even
        return unrealify_blocks(mu)


def ms_engine_for(cluster, hs, lsham, hoh, hso, enim, local=None):
    """Multi-site df64 conv engine for a crystal cluster, or ``None``
    when the cluster has no constant-offset stencil (wrapped PBC) or
    one chain's state exceeds the ``RSLMTO_MS_HBM_BYTES`` budget
    (default 9 GiB) and no mesh can grid-shard it.

    No production path selects this engine: the native complex128
    engines in ``parallel/dispatch.py`` serve every backend.  The
    stencil geometry is cached on the cluster; the packed kernel depends
    on the Hamiltonian and is rebuilt per call."""
    import os

    from ..parallel.dispatch import get_mesh
    from ..utils.logger import g_logger

    if cluster is None:
        return None
    st = getattr(cluster, "_ms_stencil", None)
    if st is None:
        if getattr(cluster, "_ms_stencil_failed", False):
            return None
        try:
            st = build_ms_stencil(cluster)
        except ValueError as e:
            g_logger.info(f"multi-site conv engine unavailable ({e})")
            cluster._ms_stencil_failed = True
            return None
        cluster._ms_stencil = st
    # bytes model: a single chain column-batch must fit the per-device
    # budget.  d-aware: spin-sector (9x9) problems need 4x less than
    # the full 18x18 block state.
    d2 = 2 * int(np.asarray(hs).shape[-1])
    nd = st.ntot * d2
    per_chain = int(np.prod(st.dims)) * nd * d2 * 150
    budget = int(os.environ.get("RSLMTO_MS_HBM_BYTES", 9 << 30))
    grid_shard = False
    if per_chain > budget:
        # shard the cell grid over the mesh with ppermute halo exchange
        # (ops/msconv_shard.py)
        mesh = get_mesh()
        ndev = (int(np.prod(list(mesh.shape.values())))
                if mesh is not None else 1)
        if mesh is None or per_chain // ndev > budget:
            g_logger.info(
                f"multi-site conv engine needs ~{per_chain/2**30:.1f} "
                f"GiB per chain (> {budget/2**30:.1f} GiB budget)")
            return None
        grid_shard = True
    try:
        eng = MSEngine(st, hs, lsham, hoh=hoh, hso=hso, enim=enim,
                       local=local)
    except ValueError:
        return None
    eng._grid_shard = grid_shard
    return eng
