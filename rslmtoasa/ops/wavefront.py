"""Active-set wavefront recursion: O(|ball|) work for large clusters.

The reference bounds recursion work with per-step active-set maps
(``create_ll_map``/``izeroll``/``irlist``, ``source/recursion.f90
:3277-3303,2570-2577``): after ``ll`` applications of H the wavefront
only reaches atoms within ``ll`` hops of the start atom, so the SpMV
needs only those rows.  A data-dependent row list is hostile to XLA
(dynamic shapes retrace), so this re-design makes the active
set a *static prefix*:

1. host BFS over the neighbor graph gives each atom its hop distance to
   the nearest start atom (the union ball covers every chain in the
   batch);
2. atoms are permuted by distance, so the step-``ll`` active set is the
   prefix ``rows[: n_{ll+1}]``;
3. the recursion-depth scan is split into a handful of *stages*, each
   jitted at a fixed power-of-two prefix length — every step inside a
   stage runs on static shapes, carries grow by exact zero padding at
   stage boundaries.

Work drops from ``lld * kk`` to ``sum_ll n_ll`` ~ ``lld^4`` (ball
volume), a >10x saving whenever the cluster radius exceeds the
recursion depth — the regime the reference targets at 1e5-1e6 atoms.
Results are exactly the dense-engine numbers (the skipped rows are
exact zeros), verified in ``tests/test_wavefront.py``.
"""

from __future__ import annotations

from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .block_lanczos import _eig_sqrt, gram_sum


# ------------------------------------------------------------------
# Host-side preprocessing (create_ll_map analogue, one BFS per batch)
# ------------------------------------------------------------------

def hop_distances(cols: np.ndarray, kk: int, starts: Sequence[int]
                  ) -> np.ndarray:
    """Hop distance of every atom to the nearest start atom.

    ``cols`` is the (kk, nslots) ELL neighbor table with sentinel ``kk``
    for missing neighbors (slot 0 = onsite).  Level-synchronous BFS on
    the host; unreachable atoms get ``kk + 1``.
    """
    cols = np.asarray(cols)
    dist = np.full(kk, kk + 1, dtype=np.int64)
    frontier = np.unique(np.asarray(list(starts), dtype=np.int64))
    dist[frontier] = 0
    level = 0
    while frontier.size:
        nxt = np.unique(cols[frontier].ravel())
        nxt = nxt[nxt < kk]
        nxt = nxt[dist[nxt] > level + 1]
        dist[nxt] = level + 1
        frontier = nxt
        level += 1
    return dist


class WavefrontPlan:
    """Distance ordering + staged prefix sizes for one start-atom batch.

    ``reach`` is the per-step hop reach of the SpMV *output* rows: the
    step-``i`` SpMV only needs the rows within ``reach[i]`` hops of a
    start atom.  Steps are grouped into stages of identical
    power-of-two-ish prefix length."""

    def __init__(self, cols: np.ndarray, kk: int, starts: Sequence[int],
                 reach: Sequence[int], granularity: int = 512):
        dist = hop_distances(cols, kk, starts)
        self.perm = np.argsort(dist, kind="stable")
        self.inv = np.empty(kk, dtype=np.int64)
        self.inv[self.perm] = np.arange(kk)
        dist_sorted = dist[self.perm]
        self.n_read = np.minimum(
            np.searchsorted(dist_sorted, np.asarray(reach), side="right"),
            kk)

        # power-of-two-ish buckets, multiples of `granularity`
        def _bucket(n):
            n = max(int(n), granularity)
            b = granularity
            while b < n:
                b *= 2
            return min(b, kk)

        self.stages: List[Tuple[int, int]] = []  # (prefix N, step count)
        for n in self.n_read:
            nb = _bucket(n)
            if self.stages and self.stages[-1][0] == nb:
                self.stages[-1] = (nb, self.stages[-1][1] + 1)
            else:
                self.stages.append((nb, 1))
        self.work = sum(n * s for n, s in self.stages)
        self.dense_work = kk * len(list(reach))
        self.kk = kk

    def permute_tables(self, iz: np.ndarray, cols: np.ndarray,
                       iz_onsite: Optional[np.ndarray] = None):
        """Row-permuted, column-remapped ELL tables (sentinel kept)."""
        kk = self.kk
        cols = np.asarray(cols)
        cols_w = np.where(cols < kk, self.inv[np.minimum(cols, kk - 1)], kk)
        cols_w = cols_w[self.perm]
        iz_w = np.asarray(iz)[self.perm]
        izo_w = (np.asarray(iz_onsite)[self.perm]
                 if iz_onsite is not None else None)
        return iz_w, cols_w, izo_w


# ------------------------------------------------------------------
# Staged scalar (Haydock) recursion
# ------------------------------------------------------------------

def _clamp_cols(cols: jnp.ndarray, n: int) -> jnp.ndarray:
    """Redirect columns outside the prefix to the zero pad row ``n`` —
    those rows are exact zeros at this depth (izeroll semantics)."""
    return jnp.where(cols < n, cols, n)


@partial(jax.jit, static_argnames=("steps", "n"))
def _scalar_stage(hs, iz_n, cols_n, psi, pmn, summ, steps: int, n: int):
    """``steps`` Haydock iterations on the static prefix ``n``.

    psi: (n+1, B, C) real or complex with zero pad row; pmn: (n, B, C).
    Emits (a, b2) of shape (steps, C).
    """
    from .lanczos import block_spmv

    b, c = psi.shape[1], psi.shape[2]
    is_complex = jnp.iscomplexobj(psi)

    def step(carry, _):
        psi, pmn, summ_prev = carry
        v = block_spmv(hs, iz_n, cols_n, psi)
        if is_complex:
            a_ll = jnp.sum(v.real * psi[:-1].real + v.imag * psi[:-1].imag,
                           axis=(0, 1))
        else:
            a_ll = jnp.sum(v * psi[:-1], axis=(0, 1))
        pmn = pmn + v - a_ll[None, None, :] * psi[:-1]
        if is_complex:
            summ = jnp.sum(pmn.real ** 2 + pmn.imag ** 2, axis=(0, 1))
        else:
            summ = jnp.sum(pmn * pmn, axis=(0, 1))
        s = jnp.sqrt(summ)
        psi_new = jnp.concatenate(
            [pmn / s[None, None, :], jnp.zeros((1, b, c), pmn.dtype)], 0)
        pmn_new = -psi[:-1] * s[None, None, :]
        return (psi_new, pmn_new, summ), (a_ll, summ_prev)

    (psi, pmn, summ), (a, b2) = jax.lax.scan(
        step, (psi, pmn, summ), None, length=steps)
    return psi, pmn, summ, a, b2


def _grow(x: jnp.ndarray, n_new: int, axis: int) -> jnp.ndarray:
    pad = n_new - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def lanczos_coefficients_wavefront(
        hs, iz, cols, psi0, lld: int, plan: WavefrontPlan
) -> Tuple[np.ndarray, np.ndarray]:
    """Scalar recursion with active-set staging.  Same contract as
    :func:`.lanczos.lanczos_coefficients`; ``psi0`` in ORIGINAL atom
    order (permutation handled here).  Host in, host out."""
    kk = plan.kk
    iz_w, cols_w, _ = plan.permute_tables(iz, cols)
    psi0 = np.asarray(psi0)
    psi_w = np.concatenate([psi0[:kk][plan.perm], psi0[kk:kk + 1]], axis=0)

    b, c = psi0.shape[1], psi0.shape[2]
    n0 = plan.stages[0][0]
    psi = jnp.asarray(psi_w[:n0 + 1])
    pmn = jnp.zeros((n0, b, c), dtype=psi.dtype)
    summ = jnp.ones((c,), dtype=np.asarray(psi0).real.dtype)
    hs_j = jnp.asarray(hs)
    a_parts, b_parts = [], []
    for n, steps in plan.stages:
        psi = _grow(psi[:-1], n, 0)
        psi = jnp.concatenate([psi, jnp.zeros((1, b, c), psi.dtype)], 0)
        pmn = _grow(pmn, n, 0)
        cols_n = _clamp_cols(jnp.asarray(cols_w[:n]), n)
        iz_n = jnp.asarray(iz_w[:n])
        psi, pmn, summ, a, b2 = _scalar_stage(
            hs_j, iz_n, cols_n, psi, pmn, summ, steps, n)
        a_parts.append(np.asarray(a))
        b_parts.append(np.asarray(b2))
    a = np.concatenate(a_parts + [np.zeros((1, c))], axis=0)
    b2 = np.concatenate(b_parts + [np.asarray(summ)[None]], axis=0)
    return a, b2


# ------------------------------------------------------------------
# Staged block recursion (production SCF engine)
# ------------------------------------------------------------------

@partial(jax.jit, static_argnames=("steps", "n", "hoh"))
def _block_stage(hs, lsham, iz_n, cols_n, psi, pmn, sum_b,
                 steps: int, n: int, hoh: bool, hso, enim, izo_n):
    """``steps`` block-Lanczos iterations on the static prefix ``n``.

    psi: (R, n+1, d, d) with zero pad row; pmn: (R, n, d, d)."""
    from .block_lanczos import _onsite18, _spmv18

    r, d = psi.shape[0], psi.shape[-1]

    def apply_h(psi):
        if hoh:
            hpsi = _spmv18(hs, iz_n, cols_n, psi)
            hpsi_pad = jnp.concatenate(
                [hpsi, jnp.zeros((r, 1, d, d), psi.dtype)], axis=1)
            hohpsi = _spmv18(hso, iz_n, cols_n, hpsi_pad)
            enupsi = _onsite18(enim, izo_n, psi)
            socpsi = _onsite18(lsham, izo_n, psi)
            return hpsi - hohpsi + enupsi + socpsi
        hpsi = _spmv18(hs, iz_n, cols_n, psi)
        return hpsi + _onsite18(lsham, izo_n, psi)

    def step(carry, _):
        psi, pmn, sum_b_prev = carry
        hpsi = apply_h(psi)
        a_ll = gram_sum(psi[:, :-1].conj(), hpsi)
        pmn = hpsi - pmn
        pmn = pmn - jnp.einsum("riab,rbc->riac", psi[:, :-1], a_ll)
        b2 = gram_sum(pmn.conj(), pmn)
        bm, b_i = _eig_sqrt(b2)
        psi_new = jnp.einsum("riab,rbc->riac", pmn, b_i)
        pmn_new = jnp.einsum("riab,rbc->riac", psi[:, :-1], bm)
        psi_new = jnp.concatenate(
            [psi_new, jnp.zeros((r, 1, d, d), psi.dtype)], axis=1)
        return (psi_new, pmn_new, b2), (a_ll, sum_b_prev)

    (psi, pmn, sum_b), (a_b, b2_b) = jax.lax.scan(
        step, (psi, pmn, sum_b), None, length=steps)
    return psi, pmn, sum_b, a_b, b2_b


def block_lanczos_wavefront(
        hs, lsham, iz, cols, psi0, lld: int, plan: WavefrontPlan, *,
        hoh: bool = False, hso=None, enim=None, iz_onsite=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Block recursion with active-set staging.  Same contract as
    :func:`.block_lanczos.block_lanczos` (psi0 in ORIGINAL atom order,
    (R, kk+1, d, d)); host in, host out.

    HoH note: H = h - h*obar*h reaches 2 hops per application, so the
    HoH caller must build the plan with ``hop=2`` — handled by passing
    the per-step read sizes for 2-hop growth (see
    :func:`make_plan_for_engine`).
    """
    kk = plan.kk
    iz_w, cols_w, izo_w = plan.permute_tables(iz, cols, iz_onsite)
    psi0 = np.asarray(psi0)
    psi_w = np.concatenate(
        [psi0[:, :kk][:, plan.perm], psi0[:, kk:kk + 1]], axis=1)

    r, d = psi0.shape[0], psi0.shape[-1]
    eye = np.eye(d, dtype=psi0.dtype)
    n0 = plan.stages[0][0]
    psi = jnp.asarray(psi_w[:, :n0 + 1])
    pmn = jnp.zeros((r, n0, d, d), dtype=psi.dtype)
    sum_b = jnp.asarray(np.broadcast_to(eye, (r, d, d)))
    hs_j = jnp.asarray(hs)
    ls_j = jnp.asarray(lsham)
    hso_j = jnp.asarray(hso) if hso is not None else hs_j
    enim_j = jnp.asarray(enim) if enim is not None else ls_j
    a_parts, b_parts = [], []
    for n, steps in plan.stages:
        psi = _grow(psi[:, :-1], n, 1)
        psi = jnp.concatenate(
            [psi, jnp.zeros((r, 1, d, d), psi.dtype)], axis=1)
        pmn = _grow(pmn, n, 1)
        cols_n = _clamp_cols(jnp.asarray(cols_w[:n]), n)
        iz_n = jnp.asarray(iz_w[:n])
        izo_n = jnp.asarray(izo_w[:n]) if izo_w is not None else iz_n
        psi, pmn, sum_b, a_b, b2_b = _block_stage(
            hs_j, ls_j, iz_n, cols_n, psi, pmn, sum_b, steps, n, hoh,
            hso_j, enim_j, izo_n)
        a_parts.append(np.asarray(a_b))
        b_parts.append(np.asarray(b2_b))
    a_b = np.concatenate(a_parts + [np.zeros((1, r, d, d), psi0.dtype)], 0)
    b2_b = np.concatenate(b_parts + [np.asarray(sum_b)[None]], 0)
    return a_b, b2_b


@partial(jax.jit, static_argnames=("steps", "n", "hoh", "first"))
def _cheb_stage(hs, lsham, iz_n, cols_n, p0, p1, mu0, mu1, a, b,
                steps: int, n: int, hoh: bool, first: bool,
                hso, enim, izo_n):
    """Chebyshev moment recursion on the static prefix ``n``.

    p0/p1: (R, n+1, d, d) with zero pad row.  When ``first``, p1 is
    ignored and recomputed as H~ p0 (the pre-step), and mu0/mu1 are
    computed here.  Emits (mu_odd, mu_even) of shape (steps, R, d, d).
    """
    from .block_lanczos import _onsite18, _spmv18

    r, d = p0.shape[0], p0.shape[-1]

    def apply_h(psi):
        if hoh:
            hpsi = _spmv18(hs, iz_n, cols_n, psi)
            hpsi_pad = jnp.concatenate(
                [hpsi, jnp.zeros((r, 1, d, d), psi.dtype)], axis=1)
            hpsi = hpsi - _spmv18(hso, iz_n, cols_n, hpsi_pad) \
                + _onsite18(enim, izo_n, psi) \
                + _onsite18(lsham, izo_n, psi)
        else:
            hpsi = _spmv18(hs, iz_n, cols_n, psi) \
                + _onsite18(lsham, izo_n, psi)
        return (hpsi - b * psi[:, :-1]) / a

    def pad(x):
        return jnp.concatenate(
            [x, jnp.zeros((r, 1, d, d), x.dtype)], axis=1)

    if first:
        mu0 = gram_sum(p0[:, :-1].conj(), p0[:, :-1])
        p1 = pad(apply_h(p0))
        mu1 = gram_sum(p0[:, :-1].conj(), p1[:, :-1])

    def step(carry, _):
        q0, q1 = carry
        q2 = 2.0 * apply_h(q1) - q0[:, :-1]
        d1 = gram_sum(q1[:, :-1].conj(), q1[:, :-1])
        d2 = gram_sum(q2.conj(), q1[:, :-1])
        return (q1, pad(q2)), (2.0 * d1 - mu0, 2.0 * d2 - mu1)

    (p0, p1), (mu_odd, mu_even) = jax.lax.scan(
        step, (p0, p1), None, length=steps)
    return p0, p1, mu0, mu1, mu_odd, mu_even


def chebyshev_moments_wavefront(
        hs, lsham, iz, cols, psi0, lld: int, a: float, b: float,
        plan: WavefrontPlan, *, hoh: bool = False, hso=None, enim=None,
        iz_onsite=None) -> np.ndarray:
    """Chebyshev block moments with active-set staging (``izeroll`` of
    ``chebyshev_recur_ll``, recursion.f90:2570-2577).  Same contract as
    :func:`.chebyshev.chebyshev_moments` (psi0 in ORIGINAL atom order);
    the plan must come from :func:`make_plan_chebyshev` — its step 0 is
    the ``psi1 = H~ psi0`` pre-step, folded into the first stage."""
    kk = plan.kk
    iz_w, cols_w, izo_w = plan.permute_tables(iz, cols, iz_onsite)
    psi0 = np.asarray(psi0)
    psi_w = np.concatenate(
        [psi0[:, :kk][:, plan.perm], psi0[:, kk:kk + 1]], axis=1)

    r, d = psi0.shape[0], psi0.shape[-1]
    n0 = plan.stages[0][0]
    p0 = jnp.asarray(psi_w[:, :n0 + 1])
    p1 = jnp.zeros_like(p0)
    mu0 = jnp.zeros((r, d, d), dtype=psi0.dtype)
    mu1 = jnp.zeros((r, d, d), dtype=psi0.dtype)
    hs_j = jnp.asarray(hs)
    ls_j = jnp.asarray(lsham)
    hso_j = jnp.asarray(hso) if hso is not None else hs_j
    enim_j = jnp.asarray(enim) if enim is not None else ls_j
    odd_parts, even_parts = [], []
    first = True
    for n, steps in plan.stages:
        def grow2(x):
            x = _grow(x[:, :-1], n, 1)
            return jnp.concatenate(
                [x, jnp.zeros((r, 1, d, d), x.dtype)], axis=1)
        p0, p1 = grow2(p0), grow2(p1)
        cols_n = _clamp_cols(jnp.asarray(cols_w[:n]), n)
        iz_n = jnp.asarray(iz_w[:n])
        izo_n = jnp.asarray(izo_w[:n]) if izo_w is not None else iz_n
        scan_steps = steps - 1 if first else steps
        p0, p1, mu0, mu1, mo, me = _cheb_stage(
            hs_j, ls_j, iz_n, cols_n, p0, p1, mu0, mu1, a, b,
            scan_steps, n, hoh, first, hso_j, enim_j, izo_n)
        first = False
        if scan_steps:
            odd_parts.append(np.asarray(mo))
            even_parts.append(np.asarray(me))
    mu_odd = np.concatenate(odd_parts, axis=0)
    mu_even = np.concatenate(even_parts, axis=0)
    mu = np.zeros((2 * lld + 2, r, d, d), dtype=psi0.dtype)
    mu[0] = np.asarray(mu0)
    mu[1] = np.asarray(mu1)
    mu[2::2] = mu_odd
    mu[3::2] = mu_even
    return mu


def make_plan(cols, kk: int, starts, lld: int, *, hops_per_step: int = 1,
              granularity: int = 512) -> WavefrontPlan:
    """Staged plan for the ``lld - 1``-step Lanczos recursions; the
    step-``i`` SpMV reaches ``hops_per_step * (i + 2)`` hops
    (``hops_per_step=2`` for HoH: H = h - h*obar*h spreads two hops
    per application)."""
    reach = hops_per_step * (np.arange(1, lld) + 1)
    return WavefrontPlan(cols, kk, starts, reach, granularity=granularity)


def make_plan_chebyshev(cols, kk: int, starts, lld: int, *,
                        hops_per_step: int = 1,
                        granularity: int = 512) -> WavefrontPlan:
    """Staged plan for the Chebyshev moment recursion: one pre-step
    (psi1 = H~ psi0, reach 1 application) plus ``lld`` scan steps
    producing p_{i+2} (reach i+2 applications)."""
    reach = hops_per_step * np.concatenate(
        [[1], np.arange(lld) + 2])
    return WavefrontPlan(cols, kk, starts, reach, granularity=granularity)
