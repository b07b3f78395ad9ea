"""Automatic engine dispatch: single-device vs mesh-sharded execution.

The reference partitions every phase's independent work over MPI ranks
(atoms for SCF, ij-pairs for exchange, types for conductivity;
``source/mpi.f90:32-58``, re-initialised per phase at
``calculation.f90:252,863,1002``) and allreduces the results.  Here the
same axis — the batch of independent recursion chains — is sharded over
a ``jax.sharding.Mesh`` whenever more than one device is visible, and
gathered back to the host (the allreduce-sum analogue; chain results are
disjoint, so the gather is exact and rank-count independent).

Every production driver (SCF bulk/surface/impurity, exchange,
conductivity) calls these entry points, so ``dryrun_multichip`` and the
CPU-mesh parity test exercise the real pipeline.  All engines run in
native complex128 (see :func:`native_complex128`).

Multi-host: call :func:`init_distributed` once at process start (the CLI
does); it wires ``jax.distributed.initialize`` from the standard
coordinator environment variables when present.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

#: backends whose XLA lowering computes float64/complex128 natively
NATIVE_C128_PLATFORMS = frozenset({"cpu", "gpu", "cuda", "rocm"})

#: recursion-state budget on the host backend, where device memory is
#: host RAM and reports no limit
HOST_BUDGET_BYTES = 8 << 30

_mesh_cache = {"mesh": None, "checked": False}


def native_complex128(platform: Optional[str] = None) -> bool:
    """True when ``platform`` (default: JAX's default backend) has native
    float64/complex128 arithmetic.  Every engine in this package runs
    the recursion in complex128; a backend without it is refused at
    start-up (:func:`require_native_complex128`) instead of being routed
    to an emulation."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    return platform in NATIVE_C128_PLATFORMS


def require_native_complex128() -> None:
    """Fail fast on a backend without native complex128."""
    import jax

    if not native_complex128():
        from ..utils.logger import g_logger

        g_logger.fatal(
            f"backend {jax.default_backend()!r} has no native complex128; "
            "run on CPU or GPU")


def memory_budget(fraction: float, host_bytes: int) -> int:
    """Bytes a recursion state may take on the default device:
    ``fraction`` of the device's reported ``bytes_limit`` on an
    accelerator, ``host_bytes`` on the host backend (or when the device
    reports no limit)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return int(host_bytes)
    limit = (dev.memory_stats() or {}).get("bytes_limit")
    return int(fraction * limit) if limit else int(host_bytes)


def init_distributed() -> None:
    """Multi-host bring-up (reference MPI_INIT analogue, main.f90:26-49).

    No-op unless the standard JAX coordinator variables are set
    (``JAX_COORDINATOR_ADDRESS`` + ``JAX_NUM_PROCESSES`` +
    ``JAX_PROCESS_ID``), so single-host runs never pay for it.
    """
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return
    import jax

    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
        process_id=int(os.environ["JAX_PROCESS_ID"]),
    )


def get_mesh():
    """The chain-sharding mesh over all visible devices, or ``None`` on a
    single device (or when ``RSLMTO_NO_MESH`` is set)."""
    if _mesh_cache["checked"]:
        return _mesh_cache["mesh"]
    _mesh_cache["checked"] = True
    if os.environ.get("RSLMTO_NO_MESH"):
        return None
    import jax

    if len(jax.devices()) < 2:
        return None
    from .mesh import make_mesh

    _mesh_cache["mesh"] = make_mesh()
    return _mesh_cache["mesh"]


def _pad_axis(x: np.ndarray, axis: int, mult: int) -> Tuple[np.ndarray, int]:
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths), n


def _mesh_for(n_chains: int):
    """The mesh, or None when there are fewer chains than devices (the
    reference leaves surplus MPI ranks idle in that regime — running
    single-device avoids pure padding overhead)."""
    mesh = get_mesh()
    if mesh is None:
        return None
    d = int(np.prod(list(mesh.shape.values())))
    return mesh if n_chains >= d else None


def _wavefront_plan(cols, kk: int, psi0, lld: int, hoh: bool,
                    starts=None, kind: str = "lanczos"):
    """Active-set plan for large clusters (create_ll_map analogue,
    recursion.f90:3277-3303), or ``None`` when dense is better.

    Engages above ``RSLMTO_WAVEFRONT_KK`` atoms (default 30000) when the
    recursion ball is genuinely smaller than the cluster.  ``starts``
    defaults to the nonzero rows of ``psi0``.
    """
    thr = int(os.environ.get("RSLMTO_WAVEFRONT_KK", "30000"))
    if kk < thr:
        return None
    if starts is None:
        p = np.abs(np.asarray(psi0))
        axes = tuple(i for i in range(p.ndim)
                     if i != (1 if p.ndim == 4 else 0))
        rows = p.sum(axis=axes)[:kk]
        starts = np.nonzero(rows)[0]
        if starts.size == 0 or starts.size > 4096:
            return None
    from ..ops.wavefront import make_plan, make_plan_chebyshev

    mk = make_plan_chebyshev if kind == "chebyshev" else make_plan
    plan = mk(np.asarray(cols), kk, starts, lld,
              hops_per_step=2 if hoh else 1)
    if plan.work >= 0.7 * plan.dense_work:
        return None
    return plan


def _spin_diag(m) -> bool:
    """True when every 18x18 block of ``m`` has exactly zero
    spin-off-diagonal (up-down / down-up) 9x9 blocks."""
    if m is None:
        return True
    m = np.asarray(m)
    return (not np.count_nonzero(m[..., :9, 9:])
            and not np.count_nonzero(m[..., 9:, :9]))


def _spin_sectors(hs, lsham, hso, enim, psi0):
    """Collinear spin-sector decoupling (nsp<=2, no SOC).

    When H, eeo, enim, the SOC table and the start-block columns are all
    spin-block-diagonal, the 18-wide block recursion decouples EXACTLY
    into two independent 9-wide recursions: a_ll = psi^H H psi, B^2, B,
    B^-1 and psi stay spin-block-diagonal at every step (the up columns
    never acquire down rows and vice versa), so running the 9x9 sectors
    separately reproduces the 18x18 recursion to roundoff.  The
    reference always processes the full 18x18 blocks
    (``recursion.f90`` ``hop_b`` :1560); the zero spin-off-diagonal
    blocks are real work there, so the split is a 4x flop cut on every
    collinear case, and both sector calls share one compiled executable
    (identical shapes, the tables are runtime operands).

    Returns [(hs, lsham, hso, enim, psi0)] per sector, or ``None`` when
    the problem does not decouple.
    """
    if (np.asarray(psi0).shape[-1] != 18
            or os.environ.get("RSLMTO_NO_SPIN_SPLIT")):
        return None
    if not (_spin_diag(hs) and _spin_diag(lsham) and _spin_diag(hso)
            and _spin_diag(enim) and _spin_diag(psi0)):
        return None

    def cut(m, sl):
        return None if m is None else np.ascontiguousarray(
            np.asarray(m)[..., sl, sl])

    return [tuple(cut(m, slice(9 * s, 9 * s + 9))
                  for m in (hs, lsham, hso, enim, psi0))
            for s in range(2)]


def _spin_assemble(xu, xd):
    """Reassemble per-sector (..., 9, 9) results into spin-block-diagonal
    (..., 18, 18) arrays (the off-diagonal blocks are exactly zero)."""
    xu = np.asarray(xu)
    out = np.zeros(xu.shape[:-2] + (18, 18), xu.dtype)
    out[..., :9, :9] = xu
    out[..., 9:, 9:] = np.asarray(xd)
    return out


def _opt(x):
    import jax.numpy as jnp

    return None if x is None else jnp.asarray(x)


def _mesh_run(mesh, engine, hs, lsham, iz, cols, psi0, hso, enim,
              iz_onsite, n_out):
    """Run ``engine(hs, lsham, iz, cols, psi0, hso, enim, iz_onsite)``
    with the chain axis (0) of ``psi0`` sharded over ``mesh`` and the
    tables replicated.  Chains are independent, so padding R to a
    multiple of the mesh size with copies of chain 0 and dropping the
    pads afterwards is exact.  Returns host arrays with the pads cut."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    d = int(np.prod(list(mesh.shape.values())))
    psi0_p, r0 = _pad_axis(np.asarray(psi0), 0, d)
    psi0_p[r0:] = psi0_p[0] if r0 else 0.0
    rep = NamedSharding(mesh, P())
    hs_j = jnp.asarray(hs)
    lsham_j = jnp.asarray(lsham)
    iz_j = jnp.asarray(iz)
    hso_j = jnp.asarray(hso) if hso is not None else jnp.zeros_like(hs_j)
    enim_j = (jnp.asarray(enim) if enim is not None
              else jnp.zeros_like(lsham_j))
    izo_j = jnp.asarray(iz_onsite) if iz_onsite is not None else iz_j
    out_sh = NamedSharding(mesh, P(None, "chains"))
    fn = jax.jit(
        engine,
        in_shardings=(rep, rep, rep, rep, NamedSharding(mesh, P("chains")),
                      rep, rep, rep),
        out_shardings=(out_sh,) * n_out if n_out > 1 else out_sh,
    )
    out = fn(hs_j, lsham_j, iz_j, jnp.asarray(cols), jnp.asarray(psi0_p),
             hso_j, enim_j, izo_j)
    if n_out == 1:
        return np.asarray(out)[:, :r0]
    return tuple(np.asarray(o)[:, :r0] for o in out)


def block_lanczos_auto(hs, lsham, iz, cols, psi0, lld, *, hoh=False,
                       hso=None, enim=None, iz_onsite=None, starts=None):
    """Block recursion over R chains, sharded over the mesh when present.

    All inputs host arrays (complex128); returns host (a_b, b2_b) of
    shape (lld, R, 18, 18).  Collinear problems run as two 9-wide spin
    sectors; large clusters route through the active-set wavefront
    engine (``ops/wavefront.py``) — O(recursion ball) work instead of
    O(kk) per step, the reference's ``create_ll_map`` device.
    """
    import jax.numpy as jnp

    from ..ops.block_lanczos import block_lanczos

    sec = _spin_sectors(hs, lsham, hso, enim, psi0)
    if sec is not None:
        outs = [
            block_lanczos_auto(h_, l_, iz, cols, p_, lld, hoh=hoh,
                               hso=o_, enim=e_, iz_onsite=iz_onsite,
                               starts=starts)
            for (h_, l_, o_, e_, p_) in sec
        ]
        return (_spin_assemble(outs[0][0], outs[1][0]),
                _spin_assemble(outs[0][1], outs[1][1]))
    mesh = _mesh_for(np.asarray(psi0).shape[0])
    if mesh is not None:
        def _bl(hs_, lsham_, iz_, cols_, psi0_, hso_, enim_, izo_):
            return block_lanczos(hs_, lsham_, iz_, cols_, psi0_, lld,
                                 hoh=hoh, hso=hso_, enim=enim_,
                                 iz_onsite=izo_)

        return _mesh_run(mesh, _bl, hs, lsham, iz, cols, psi0, hso, enim,
                         iz_onsite, 2)
    plan = _wavefront_plan(cols, np.asarray(psi0).shape[1] - 1,
                           psi0, lld, hoh, starts=starts)
    if plan is not None:
        from ..ops.wavefront import block_lanczos_wavefront

        return block_lanczos_wavefront(
            np.asarray(hs), np.asarray(lsham), np.asarray(iz),
            np.asarray(cols), np.asarray(psi0), lld, plan, hoh=hoh,
            hso=np.asarray(hso) if hso is not None else None,
            enim=np.asarray(enim) if enim is not None else None,
            iz_onsite=(np.asarray(iz_onsite)
                       if iz_onsite is not None else None))
    a_b, b2_b = block_lanczos(
        jnp.asarray(hs), jnp.asarray(lsham), jnp.asarray(iz),
        jnp.asarray(cols), jnp.asarray(psi0), lld, hoh=hoh,
        hso=_opt(hso), enim=_opt(enim), iz_onsite=_opt(iz_onsite))
    return np.asarray(a_b), np.asarray(b2_b)


def _chebyshev_fatal():
    from ..utils.logger import g_logger

    g_logger.fatal("Chebyshev moments did not converge. Check energy "
                   "limits energy_min and energy_max")


def chebyshev_moments_auto(hs, lsham, iz, cols, psi0, lld, a, b, *,
                           hoh=False, hso=None, enim=None, iz_onsite=None,
                           starts=None, guard=True):
    """Chebyshev block moments over R chains, mesh-sharded when present.

    Returns host mu (2*lld+2, R, 18, 18).  Large clusters route through
    the active-set wavefront engine (izeroll, recursion.f90:2570-2577).
    ``guard=False`` for ij-pair chains: the reference's divergence check
    exists only in the per-atom ``chebyshev_recur_ll`` (:2594-2596), not
    in ``chebyshev_recur_ij`` — pair start blocks are superpositions
    whose signed block sums legitimately exceed the per-atom bound.
    """
    import jax.numpy as jnp

    from ..ops.chebyshev import chebyshev_moments

    def _guard(mu):
        """Divergence guard (recursion.f90:2594-2596): the reference
        checks the SIGNED real sum of the newest even-moment block per
        rec atom against 1000 — moments blowing up mean the spectrum
        leaks outside the scaled energy window.  Pair chains get only
        the finite check."""
        if not np.isfinite(mu).all():
            _chebyshev_fatal()
        if guard:
            last = mu[-1].real.reshape(mu.shape[1], -1).sum(axis=1)
            if (last > 1.0e3).any():
                _chebyshev_fatal()
        return mu

    # collinear spin-sector split: the mu_n = psi0^H T_n(H) psi0 blocks
    # decouple exactly like the block recursion.  The divergence guard
    # must see the ASSEMBLED 18x18 block sums (the reference sums the
    # full block, recursion.f90:2594), so the sector calls run with only
    # the finite check.
    sec = _spin_sectors(hs, lsham, hso, enim, psi0)
    if sec is not None:
        outs = [
            chebyshev_moments_auto(h_, l_, iz, cols, p_, lld, a, b,
                                   hoh=hoh, hso=o_, enim=e_,
                                   iz_onsite=iz_onsite, starts=starts,
                                   guard=False)
            for (h_, l_, o_, e_, p_) in sec
        ]
        return _guard(_spin_assemble(outs[0], outs[1]))
    mesh = _mesh_for(np.asarray(psi0).shape[0])
    if mesh is not None:
        def _ch(hs_, lsham_, iz_, cols_, psi0_, hso_, enim_, izo_):
            return chebyshev_moments(hs_, lsham_, iz_, cols_, psi0_, lld,
                                     a, b, hoh=hoh, hso=hso_, enim=enim_,
                                     iz_onsite=izo_)

        return _guard(_mesh_run(mesh, _ch, hs, lsham, iz, cols, psi0, hso,
                                enim, iz_onsite, 1))
    plan = _wavefront_plan(cols, np.asarray(psi0).shape[1] - 1,
                           psi0, lld, hoh, starts=starts,
                           kind="chebyshev")
    if plan is not None:
        from ..ops.wavefront import chebyshev_moments_wavefront

        return _guard(chebyshev_moments_wavefront(
            np.asarray(hs), np.asarray(lsham), np.asarray(iz),
            np.asarray(cols), np.asarray(psi0), lld, a, b, plan,
            hoh=hoh,
            hso=np.asarray(hso) if hso is not None else None,
            enim=np.asarray(enim) if enim is not None else None,
            iz_onsite=(np.asarray(iz_onsite)
                       if iz_onsite is not None else None)))
    mu = chebyshev_moments(
        jnp.asarray(hs), jnp.asarray(lsham), jnp.asarray(iz),
        jnp.asarray(cols), jnp.asarray(psi0), lld, a, b, hoh=hoh,
        hso=_opt(hso), enim=_opt(enim), iz_onsite=_opt(iz_onsite))
    return _guard(np.asarray(mu))


def _rowshard_wanted(mesh, kk: int, b: int, c: int,
                     itemsize: int = 16) -> bool:
    """Memory threshold for the row-sharded layout: when the recursion
    state (a handful of (kk, B, C) wavefront buffers) would exceed half
    of one device's memory, the cluster rows are sharded instead of
    replicated (the reference replicates the full cluster on every MPI
    rank — mpi.f90 keeps no halo).  Budget override:
    ``RSLMTO_ROWSHARD_BYTES``."""
    if mesh is None:
        return False
    env = os.environ.get("RSLMTO_ROWSHARD_BYTES")
    budget = (int(env) if env
              else memory_budget(0.5, HOST_BUDGET_BYTES))
    state = 6 * kk * b * c * itemsize  # psi/pmn/hpsi + headroom
    return state > budget


def lanczos_auto(hs, iz, cols, psi0, lld, starts=None):
    """Scalar Haydock recursion over C chains (last axis), mesh-sharded
    when present.  Host in, host out: (a, b2) of shape (lld, C).

    Large clusters route through the active-set wavefront engine, or —
    when the recursion state exceeds one device's memory — through the
    row-sharded ppermute-halo engine (``parallel/mesh.py
    lanczos_rowsharded``)."""
    import jax.numpy as jnp

    from ..ops.lanczos import lanczos_coefficients

    p0 = np.asarray(psi0)
    kk = p0.shape[0] - 1
    mesh = _mesh_for(p0.shape[2])
    if mesh is None:
        plan = _wavefront_plan(cols, kk, psi0, lld, False, starts=starts)
        if plan is not None:
            from ..ops.wavefront import lanczos_coefficients_wavefront

            return lanczos_coefficients_wavefront(
                np.asarray(hs), np.asarray(iz), np.asarray(cols), p0, lld,
                plan)
        a, b2 = lanczos_coefficients(
            jnp.asarray(hs), jnp.asarray(iz), jnp.asarray(cols),
            jnp.asarray(p0), lld)
        return np.asarray(a), np.asarray(b2)
    d = int(np.prod(list(mesh.shape.values())))
    if _rowshard_wanted(mesh, kk, p0.shape[1], p0.shape[2],
                        p0.dtype.itemsize):
        # cluster rows sharded, ppermute halo SpMV, psum reductions
        # (mesh.py lanczos_rowsharded)
        from .mesh import lanczos_rowsharded

        kk_pad = -(-kk // d) * d
        iz_p = np.zeros(kk_pad, np.int32)
        iz_p[:kk] = np.asarray(iz)
        cols_np = np.asarray(cols)
        cols_p = np.full((kk_pad, cols_np.shape[1]), kk_pad, np.int32)
        cols_p[:kk] = np.where(cols_np >= kk, kk_pad, cols_np)
        psi_rows = np.zeros((kk_pad,) + p0.shape[1:], p0.dtype)
        psi_rows[:kk] = p0[:kk]
        a, b2 = lanczos_rowsharded(
            mesh, jnp.asarray(hs), jnp.asarray(iz_p),
            jnp.asarray(cols_p), jnp.asarray(psi_rows), lld)
        return np.asarray(a), np.asarray(b2)
    from .mesh import lanczos_sharded

    psi0_p, c0 = _pad_axis(p0, 2, d)
    a, b2 = lanczos_sharded(mesh, jnp.asarray(hs), jnp.asarray(iz),
                            jnp.asarray(cols), jnp.asarray(psi0_p), lld)
    return np.asarray(a)[:, :c0], np.asarray(b2)[:, :c0]
