"""Double-float (df64) arithmetic + exact-chunk bf16 GEMM.

Emulated double precision for matrix units without f64 hardware, where
XLA's own f64 emulation expands every value into 8 f32 slices.  No production path selects this engine since the recursion runs in
native complex128 (ROADMAP D2: delete next, with replacement tests).

* **df64 values** are unevaluated pairs ``(hi, lo)`` of f32 arrays with
  ``|lo| <= ulp(hi)/2`` — classic double-single (Dekker/Knuth error-free
  transforms).  All elementwise recursion updates (axpy, normalisation,
  dots) run at f32 speed with ~2^-48 relative accuracy.
* **Exact-chunk GEMM** (Ozaki-style splitting): each df64 operand is split
  into ``S`` bf16 chunks of 7 mantissa bits on a shared power-of-two
  grid.  Products of chunks are exact in f32 and — because chunk magnitudes
  are bounded by 64 grid quanta — f32 accumulation over K <= 4096 is
  *exact* (every partial sum is an integer number of grid quanta below
  2^24).  The df64 result is recombined from the S(S+1)/2 bucket GEMMs
  with error-free adds.  Net effect: near-f64 matmuls at bf16
  throughput / ~28 passes.

This replaces the reference's BLAS zgemm/zaxpy calls (e.g.
``source/recursion.f90:3310-3520`` hop/crecal); results match the
complex128 computation to ~1e-12, far inside the 1e-6 parity tolerance of
the reference test suite (``tests/scf/README.md:151-156``).

The split-complex embedding (see ``ops.lanczos.split_complex``) composes
with this module: complex arrays become 2Bx2B real blocks first, then each
real array becomes a df64 pair.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


# ----------------------------------------------------------------------
# error-free transforms (branch-free, f32)
# ----------------------------------------------------------------------

def two_sum(a, b):
    """s + e == a + b exactly (Knuth, 6 flops, no magnitude assumption).

    FMA-safe: contains no multiplies, and LLVM's FP contraction (which
    XLA's CPU backend applies even across ``optimization_barrier``) can
    only fuse mul+add pairs."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """s + e == a + b exactly, REQUIRES |a| >= |b| (Dekker, 3 flops).

    When ``a`` is an upstream product the backend may contract ``a + b``
    into fma(x, y, b); the returned pair then deviates from a + b by
    O(ulp(b)) — second order in the df64 budget, harmless."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split12(x):
    """Exact 12-bit mantissa split via bit masking: x == xh + xl with both
    halves having <= 12 significant bits, so every cross product is exact
    in f32.

    Bit masking (not the Veltkamp multiply trick) because XLA's CPU
    backend FMA-contracts ``x * 4097 - y`` chains — below HLO, where
    ``optimization_barrier`` cannot reach — which silently destroys the
    split and cost 2.5e-8 on Lanczos coefficients (vs 1e-13 now).
    Integer ops are immune to FP contraction."""
    xi = jax.lax.bitcast_convert_type(x, jnp.uint32)
    xh = jax.lax.bitcast_convert_type(
        xi & jnp.uint32(0xFFFFF000), jnp.float32)
    return xh, x - xh


def two_prod(a, b):
    """p + e == a * b exactly, fully FMA-immune.

    The classic ``e = ah*bh - p + ...`` form is UNSAFE here: LLVM may
    contract ``x - p`` with ``p = a*b`` into fma(-a, b, x), which uses the
    UNROUNDED product and collapses the error term to ~0 (observed: the
    entire lo word vanished, 2.5e-8 Lanczos-coefficient error).  Instead
    the product is assembled from the four exact partials with two_sum
    chains: every multiply below is exactly representable in f32, so any
    fma the backend forms is bit-identical to the two-op sequence, and
    the adds cannot contract at all."""
    ah, al = _split12(a)
    bh, bl = _split12(b)
    q_hh = ah * bh  # all four partials exact: 12-bit x 12-bit mantissas
    q_hl = ah * bl
    q_lh = al * bh
    q_ll = al * bl
    s, e1 = two_sum(q_hl, q_lh)
    p, e2 = fast_two_sum(q_hh, s)
    e = (e1 + e2) + q_ll
    return fast_two_sum(p, e)


# ----------------------------------------------------------------------
# df64 = (hi, lo) pair arithmetic
# ----------------------------------------------------------------------

def ds_add(a, b):
    """(hi,lo) + (hi,lo), ~2^-48 relative error."""
    s, e = two_sum(a[0], b[0])
    e = e + (a[1] + b[1])
    return fast_two_sum(s, e)


def ds_add_f32(a, b):
    """(hi,lo) + plain f32."""
    s, e = two_sum(a[0], b)
    e = e + a[1]
    return fast_two_sum(s, e)


def ds_neg(a):
    return (-a[0], -a[1])


def ds_sub(a, b):
    return ds_add(a, ds_neg(b))


def ds_mul(a, b):
    """(hi,lo) * (hi,lo)."""
    p, e = two_prod(a[0], b[0])
    e = e + (a[0] * b[1] + a[1] * b[0])
    return fast_two_sum(p, e)


def ds_sqr(a):
    p, e = two_prod(a[0], a[0])
    e = e + 2.0 * (a[0] * a[1])
    return fast_two_sum(p, e)


def ds_zeros(shape, dtype=jnp.float32):
    z = jnp.zeros(shape, dtype)
    return (z, z)


def ds_sqrt(a):
    """df64 sqrt via one Newton correction of the f32 estimate."""
    r = jax.lax.rsqrt(jnp.maximum(a[0], 1e-37))
    y0 = a[0] * r  # ~sqrt to f32 accuracy
    # e = a - y0^2 computed exactly, then y = y0 + e / (2 y0)
    p, pe = two_prod(y0, y0)
    e = ((a[0] - p) - pe) + a[1]
    return fast_two_sum(y0, e * (0.5 * r))


def ds_recip(a):
    """df64 reciprocal via one Newton correction of the f32 estimate."""
    r0 = 1.0 / a[0]
    # e = 1 - a * r0 exactly
    p, pe = two_prod(a[0], r0)
    e = ((1.0 - p) - pe) - a[1] * r0
    return fast_two_sum(r0, r0 * e)


def ds_from_f64(x) -> tuple:
    """Host-side f64 -> df64 split (exact)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return (jnp.asarray(hi), jnp.asarray(lo))


def ds_to_f64(a) -> np.ndarray:
    """Host-side df64 -> f64 merge."""
    return np.asarray(a[0], np.float64) + np.asarray(a[1], np.float64)


def ds_sum_tree(a, axis: int, fold: int = 64):
    """Compensated reduction of a df64 array along ``axis``.

    Fully vectorised folding (no fori_loops): repeatedly reshape the axis
    to ``(n', fold)`` and collapse the fold dimension with a fixed 6-step
    halving of vectorised compensated adds.  Each pass is a handful of
    whole-array VPU ops, so the first (largest) pass dominates the HBM
    traffic and the sequential depth is ~log_64(n) * 6 vector ops — the
    earlier per-element ``fori_loop`` version serialised ~n/64 tiny adds
    and dominated the whole recursion step at production sizes.
    Error ~2^-48 * log(n), better than the sequential scheme.
    """
    hi = jnp.moveaxis(a[0], axis, 0)
    lo = jnp.moveaxis(a[1], axis, 0)
    rest = hi.shape[1:]

    def _ds_add_vec(x, y):
        s, e = two_sum(x[0], y[0])
        e = e + (x[1] + y[1])
        return fast_two_sum(s, e)

    while hi.shape[0] > 1:
        n = hi.shape[0]
        f = min(fold, 1 << (max(1, n - 1)).bit_length())
        nseg = -(-n // f)
        padn = nseg * f - n
        if padn:
            pad = [(0, padn)] + [(0, 0)] * (hi.ndim - 1)
            hi = jnp.pad(hi, pad)
            lo = jnp.pad(lo, pad)
        hi = hi.reshape((nseg, f) + rest)
        lo = lo.reshape((nseg, f) + rest)
        # halve the fold axis: f -> f/2 -> ... -> 1 (log2(f) vector steps)
        cur = (hi, lo)
        width = f
        while width > 1:
            half = width // 2
            left = (cur[0][:, :half], cur[1][:, :half])
            right = (cur[0][:, half:width], cur[1][:, half:width])
            cur = _ds_add_vec(left, right)
            cur = (cur[0], cur[1])
            width = half
        hi, lo = cur[0][:, 0], cur[1][:, 0]
    return hi[0], lo[0]


def ds_dot(x, y, axes):
    """Compensated inner product sum(x*y) over ``axes`` (tuple of ints).

    x, y are df64 pairs of identical shape; returns a df64 pair of the
    remaining shape.  Exact products (two_prod) + tree reduction.
    """
    p = ds_mul(x, y)
    # flatten the contracted axes to one leading axis
    nd = p[0].ndim
    axes = tuple(ax % nd for ax in axes)
    keep = tuple(i for i in range(nd) if i not in axes)
    perm = axes + keep
    hi = jnp.transpose(p[0], perm)
    lo = jnp.transpose(p[1], perm)
    kshape = hi.shape[len(axes):]
    hi = hi.reshape((-1,) + kshape)
    lo = lo.reshape((-1,) + kshape)
    return ds_sum_tree((hi, lo), 0)


# ----------------------------------------------------------------------
# exact-chunk (Ozaki-style) splitting for bf16 GEMMs
# ----------------------------------------------------------------------

def _pow2ceil(x: float) -> float:
    return float(2.0 ** np.ceil(np.log2(x))) if x > 0 else 1.0


#: mantissa bits per chunk.  7 (not 8) so that every chunk magnitude stays
#: <= 64 grid quanta even after the low word is folded in — 64 quanta fit
#: bf16's 8 significant bits exactly, and chunk-product partial sums stay
#: exact in f32 up to K = 4096 contraction terms.
CHUNK_BITS = 7

#: chunks for full df64 (~2^-49) accuracy: ceil(49 / 7)
DF64_CHUNKS = 7


def pack_chunks_host(x, nchunks: int = DF64_CHUNKS):
    """Split a host f64 array into bf16 chunks on a shared pow2 grid.

    Returns ``(chunks, scale)`` with ``chunks[k]`` bf16 of x.shape and
    ``sum_k chunks[k] * scale ~= x`` to 7*nchunks mantissa bits.  All
    chunk values are multiples of ``2^-7(k+1)`` with at most 64 quanta
    magnitude, so products of two such chunk families accumulate EXACTLY
    in f32 for K <= 4096 terms.
    """
    x = np.asarray(x, np.float64)
    amax = float(np.max(np.abs(x))) if x.size else 1.0
    scale = _pow2ceil(amax) * 2.0  # margin so |y| <= 0.5
    y = x / scale
    chunks = []
    r = y.copy()
    for k in range(nchunks):
        u = 2.0 ** (-CHUNK_BITS * (k + 1))
        c = np.round(r / u) * u
        chunks.append(c.astype(np.float32))  # exact: <= 7-bit mantissa
        r = r - c
    ch = np.stack(chunks, axis=0)
    return jnp.asarray(ch, jnp.bfloat16), scale


def extract_chunks(y, nchunks: int = DF64_CHUNKS):
    """Device-side chunk extraction of a df64 array with |y| <= 1.

    Returns bf16 ``(nchunks, *y.shape)``; ``sum_k out[k] == (y_hi+y_lo)/2``
    to ~7*nchunks bits (the caller accounts for the fixed 1/2 pre-scale).
    Branch-free grid rounding via the add-magic trick: adding
    ``B_k = 1.5 * 2^(23-7(k+1))`` forces RN to the chunk grid, whose ulp
    inside that binade is exactly ``2^-7(k+1)``.
    """
    # barrier the pair: if the producer fuses into this graph, XLA's
    # excess-precision rewrites can distribute the *0.5/+magic across the
    # producer's arithmetic and break the grid rounding (see
    # stencil_conv._extract_chunks_chan)
    hi, lo = jax.lax.optimization_barrier(y)
    r = hi * jnp.float32(0.5)  # exact pow2 scale; |r| <= 0.5
    w_lo = lo * jnp.float32(0.5)
    outs = []
    for k in range(nchunks):
        bmag = jnp.float32(1.5 * 2.0 ** (23 - CHUNK_BITS * (k + 1)))
        # r rounded to grid 2^-7(k+1).  The optimization_barrier is
        # REQUIRED: XLA's algebraic simplifier constant-reassociates
        # (r + B) - B -> r under jit, silently destroying the rounding.
        c = jax.lax.optimization_barrier(r + bmag) - bmag
        outs.append(c.astype(jnp.bfloat16))
        r = r - c  # exact (nested grids)
        if k == 2:
            # w_hi is 24 bits = ~3.5 chunks; chunk 3's range contains the
            # low word's leading bits (|w_lo| <= 2^-26) — fold it in now,
            # error-free via two_sum (the residual re-enters below, where
            # the add is exact relative to the remaining chunk range)
            r, w_lo = two_sum(r, w_lo)
        elif k == 3:
            r = r + w_lo
    return jnp.stack(outs, axis=0)


def gemm_df64(h_chunks, h_scale: float, x_chunks, x_scale: float,
              contract, nchunks: int):
    """df64-accurate contraction from pre-chunked bf16 operands.

    ``contract(hc, xc)`` must contract ONE h-chunk array against ONE
    x-chunk array in bf16 with f32 accumulation (an einsum with
    ``preferred_element_type=jnp.float32``) and total contraction length
    K <= 1024.  Buckets p+q > nchunks-1 are truncated (below the df64
    noise floor).  Returns the df64 result pair.
    """
    parts = {}  # bucket s -> list of exact f32 partials
    for q in range(nchunks):
        for p in range(nchunks - q):
            o = contract(h_chunks[p], x_chunks[q])
            parts.setdefault(p + q, []).append(o)
    # combine smallest buckets first; every add is compensated
    acc = None
    for s in sorted(parts.keys(), reverse=True):
        for o in parts[s]:
            acc = (o, jnp.zeros_like(o)) if acc is None else ds_add_f32(acc, o)
    scale = jnp.float32(h_scale * x_scale * 2.0)  # undo extract's 1/2
    return (acc[0] * scale, acc[1] * scale)
