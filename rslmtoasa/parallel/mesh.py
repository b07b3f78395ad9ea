"""Multi-device distribution of the recursion workload.

The reference's only distribution axis is atoms/chains (MPI block partition,
``source/mpi.f90:32-58``) with allreduce-sum collectives.  The JAX
equivalents implemented here:

* **chain sharding** — the batch of independent recursion chains
  (atoms x orbitals x start vectors) is sharded across the mesh; every
  device holds the full cluster Hamiltonian (exactly the reference's
  replicated-Hamiltonian + atom-partition model).  DOS/moment reductions
  become ``psum`` over the chain axis.
* **row sharding** — for clusters exceeding one device's memory, the block-ELL
  rows are sharded over the mesh; two SpMV formulations:
  ``rowsharded_spmv_step`` all-gathers the wavefront vector (small-D
  meshes, low-diameter clusters where halo = everything), and
  ``rowsharded_spmv_halo`` / ``lanczos_rowsharded`` pipeline the vector
  chunks around a logical ring of devices with ``ppermute``, overlapping
  each hop with the partial block contraction — per-device memory stays
  O(kk/D) and no device ever materialises the full wavefront.  The mesh
  is topology-free: the cards of one host are joined all to all by
  NVLink, so the ring order costs nothing.

Both are expressed with ``jax.sharding`` + ``shard_map`` so XLA inserts the
collectives.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "chains") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_chains(mesh: Mesh, psi0: jnp.ndarray) -> jnp.ndarray:
    """Place the chain batch axis (last) of psi0 on the mesh."""
    sharding = NamedSharding(mesh, P(None, None, "chains"))
    return jax.device_put(psi0, sharding)


def lanczos_sharded(
    mesh: Mesh,
    hs: jnp.ndarray,
    iz: jnp.ndarray,
    cols: jnp.ndarray,
    psi0: jnp.ndarray,
    lld: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Chain-sharded Haydock recursion.

    Chains are embarrassingly parallel: with psi0's chain axis sharded,
    the per-chain reductions (a_ll, b2_ll) stay local to each shard and
    XLA keeps everything communication-free; outputs come back sharded
    over chains.  This is the pjit formulation — no shard_map needed.
    """
    from ..ops.lanczos import lanczos_coefficients

    hs_s = jax.device_put(hs, NamedSharding(mesh, P()))
    iz_s = jax.device_put(iz, NamedSharding(mesh, P()))
    cols_s = jax.device_put(cols, NamedSharding(mesh, P()))
    psi0_s = shard_chains(mesh, psi0)
    fn = jax.jit(
        partial(lanczos_coefficients, lld=lld),
        in_shardings=(
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P()),
            NamedSharding(mesh, P(None, None, "chains")),
        ),
        out_shardings=NamedSharding(mesh, P(None, "chains")),
    )
    return fn(hs_s, iz_s, cols_s, psi0_s)


def total_dos_psum(mesh: Mesh, dens_chains: jnp.ndarray) -> jnp.ndarray:
    """Reference-ALLREDUCE analogue: sum per-chain DOS over the sharded
    chain axis with a psum (``bands.f90:271-274``).

    dens_chains: (NE, C) with C sharded -> (NE,) replicated total.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=P(None, "chains"),
        out_specs=P(),
    )
    def _reduce(local):
        return jax.lax.psum(jnp.sum(local, axis=1), axis_name="chains")

    return _reduce(dens_chains)


def rowsharded_spmv_step(
    mesh: Mesh,
    hs: jnp.ndarray,
    iz: jnp.ndarray,
    cols: jnp.ndarray,
    psi: jnp.ndarray,
    rows_axis: str = "chains",
) -> jnp.ndarray:
    """One block-SpMV with the cluster rows sharded across the mesh.

    Each shard owns a contiguous block of atom rows (iz/cols sharded on
    axis 0) and all-gathers the wavefront vector for the column gathers —
    the large-cluster layout where the Hamiltonian no longer fits one device.
    psi is (kk+1, B, C); rows of the output stay sharded.
    """
    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(rows_axis), P(rows_axis), P(rows_axis)),
        out_specs=P(rows_axis),
    )
    def _step_repl_h(hs_all, iz_loc, cols_loc, psi_loc):
        psi_full = jax.lax.all_gather(
            psi_loc, axis_name=rows_axis, axis=0, tiled=True
        )
        pad = jnp.zeros((1,) + psi_full.shape[1:], psi_full.dtype)
        psi_pad = jnp.concatenate([psi_full, pad], axis=0)
        hi = hs_all[iz_loc]

        def body(m, acc):
            pg = psi_pad[cols_loc[:, m]]
            return acc + jnp.einsum("iab,ibc->iac", hi[:, m], pg)

        acc0 = jnp.zeros((cols_loc.shape[0],) + psi_loc.shape[1:],
                         dtype=psi_loc.dtype)
        acc0 = jax.lax.pcast(acc0, (rows_axis,), to="varying")
        return jax.lax.fori_loop(0, cols_loc.shape[1], body, acc0)

    return _step_repl_h(hs, iz, cols, psi)


def _ring_spmv(hs_all, iz_loc, cols_loc, psi_loc, rows_axis: str,
               n_shards: int):
    """Ring-pipelined partial SpMV against a row-sharded wavefront.

    ``psi_loc`` is this shard's (kk_loc, B, C) chunk of the wavefront
    (global rows [r*kk_loc, (r+1)*kk_loc)); ``cols_loc`` holds GLOBAL
    column indices (sentinel >= kk masks a missing neighbor).  The chunk
    circulates the ring with ``ppermute`` while each shard contracts the
    slots whose columns live in the currently-resident chunk — XLA
    overlaps the hop with the contraction, so the device-to-device
    transfer (NVLink, all to all between the cards of one host) hides
    behind the per-chunk block GEMMs.  Runs inside ``shard_map``.
    """
    r = jax.lax.axis_index(rows_axis)
    kk_loc = psi_loc.shape[0]
    hi = hs_all[iz_loc]  # (kk_loc, nslots, B, B)
    nslots = cols_loc.shape[1]
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]

    acc = jnp.zeros((kk_loc,) + psi_loc.shape[1:], dtype=psi_loc.dtype)
    acc = jax.lax.pcast(acc, (rows_axis,), to="varying")
    buf = psi_loc
    for t in range(n_shards):
        src = jax.lax.rem(r + t, jnp.int32(n_shards))
        base = src * kk_loc
        lc = cols_loc - base
        valid = (lc >= 0) & (lc < kk_loc)
        lc_cl = jnp.clip(lc, 0, kk_loc - 1)
        # next hop issued before the contraction so it can overlap
        buf_next = (
            jax.lax.ppermute(buf, rows_axis, perm)
            if t + 1 < n_shards else buf
        )

        def body(m, a):
            pg = buf[lc_cl[:, m]]  # (kk_loc, B, C)
            pg = jnp.where(valid[:, m, None, None], pg, 0)
            return a + jnp.einsum("iab,ibc->iac", hi[:, m], pg)

        acc = jax.lax.fori_loop(0, nslots, body, acc)
        buf = buf_next
    return acc


def rowsharded_spmv_halo(
    mesh: Mesh,
    hs: jnp.ndarray,
    iz: jnp.ndarray,
    cols: jnp.ndarray,
    psi: jnp.ndarray,
    rows_axis: str = "chains",
) -> jnp.ndarray:
    """One block-SpMV with rows AND the wavefront sharded (halo ring).

    Unlike :func:`rowsharded_spmv_step` no device ever holds the full
    wavefront: ``psi`` is (kk, B, C) row-sharded (kk divisible by the
    mesh size, NO sentinel pad row — sentinel columns >= kk are masked),
    and chunks ride the logical device ring via ``ppermute``.  This is the
    large-cluster production layout (SURVEY §2.2): per-device memory is
    O(kk/D) for every recursion buffer.
    """
    n_shards = int(mesh.shape[rows_axis])

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(rows_axis), P(rows_axis), P(rows_axis)),
        out_specs=P(rows_axis),
    )
    def _run(hs_all, iz_loc, cols_loc, psi_loc):
        return _ring_spmv(hs_all, iz_loc, cols_loc, psi_loc, rows_axis,
                          n_shards)

    return _run(hs, iz, cols, psi)


def lanczos_rowsharded(
    mesh: Mesh,
    hs: jnp.ndarray,
    iz: jnp.ndarray,
    cols: jnp.ndarray,
    psi0: jnp.ndarray,
    lld: int,
    rows_axis: str = "chains",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Haydock recursion with the CLUSTER ROWS sharded across the mesh.

    The large-cluster mode: every recursion buffer (psi, pmn) is
    row-sharded, the SpMV is the ``ppermute`` halo ring of
    :func:`rowsharded_spmv_halo`, and the Lanczos reductions (a_ll, |r|²)
    are ``psum`` over the row shards — for a cluster that no longer fits
    one device.  ``psi0`` is (kk, B, C) with kk
    divisible by the mesh size; sentinel columns must be >= kk.  Returns
    replicated ``(a, b2)`` of shape (lld, C) with the reference
    conventions of :func:`..ops.lanczos.lanczos_coefficients`.
    """
    n_shards = int(mesh.shape[rows_axis])

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(rows_axis), P(rows_axis), P(rows_axis)),
        out_specs=(P(), P()),
    )
    def _run(hs_all, iz_loc, cols_loc, psi0_loc):
        kk_loc, b, c = psi0_loc.shape

        def step(carry, _):
            psi, pmn, summ_prev = carry
            v = _ring_spmv(hs_all, iz_loc, cols_loc, psi, rows_axis,
                           n_shards)
            a_loc = jnp.sum(v.real * psi.real + v.imag * psi.imag,
                            axis=(0, 1))
            a_ll = jax.lax.psum(a_loc, rows_axis)
            b2_ll = summ_prev
            pmn = pmn + v - a_ll[None, None, :] * psi
            summ = jax.lax.psum(
                jnp.sum(pmn.real**2 + pmn.imag**2, axis=(0, 1)), rows_axis
            )
            s = jnp.sqrt(summ)
            psi_new = pmn / s[None, None, :]
            pmn_new = -psi * s[None, None, :]
            return (psi_new, pmn_new, summ), (a_ll, b2_ll)

        pmn0 = jax.lax.pcast(
            jnp.zeros((kk_loc, b, c), dtype=psi0_loc.dtype), (rows_axis,),
            to="varying",
        )
        summ0 = jnp.ones((c,), dtype=jnp.real(psi0_loc).dtype)
        (_, _, summ), (a, b2) = jax.lax.scan(
            step, (psi0_loc, pmn0, summ0), None, length=lld - 1
        )
        a = jnp.concatenate([a, jnp.zeros((1, c), a.dtype)], axis=0)
        b2 = jnp.concatenate([b2, summ[None, :]], axis=0)
        return a, b2

    return _run(hs, iz, cols, psi0)


def block_lanczos_sharded(
    mesh: Mesh,
    hs: jnp.ndarray,
    lsham: jnp.ndarray,
    iz: jnp.ndarray,
    cols: jnp.ndarray,
    psi0: jnp.ndarray,
    lld: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Chain-sharded BLOCK recursion: the R axis (one 18-wide chain per
    rec atom / exchange pair) is the distribution axis; Hamiltonian
    tables replicate.  This is the production nsp>=2 layout — the MPI
    nrec/njij partitions of ``recursion.f90 recur_b``/``recur_b_ij``
    as a pjit sharding."""
    from ..ops.block_lanczos import block_lanczos

    rep = NamedSharding(mesh, P())
    r_shard = NamedSharding(mesh, P("chains"))
    fn = jax.jit(
        partial(block_lanczos, lld=lld),
        in_shardings=(rep, rep, rep, rep, r_shard),
        out_shardings=(
            NamedSharding(mesh, P(None, "chains")),
            NamedSharding(mesh, P(None, "chains")),
        ),
    )
    return fn(
        jax.device_put(hs, rep), jax.device_put(lsham, rep),
        jax.device_put(iz, rep), jax.device_put(cols, rep),
        jax.device_put(psi0, r_shard),
    )
