"""LDOS reconstruction from Haydock chain coefficients.

The Beer-Pettifor continued fraction with square-root terminator
(``density_of_states.f90`` ``bprldos`` :377-419) evaluated for all energies
and all chains at once on device, plus the orchestration of
``dos%density`` (:248-370): per-orbital terminator fits (``bpopt``), the
empirical 1.01 beta_inf scaling for s-orbitals, per-orbital band
renormalisation ``e/dw_l - cshi`` and the final ``/dw_l``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .terminator import bpopt


@jax.jit
def bprldos(
    e: jnp.ndarray,  # (..., ) energies, broadcastable against chains
    a: jnp.ndarray,  # (lld, C)
    b2: jnp.ndarray,  # (lld, C)
    ebot: jnp.ndarray,  # (C,)
    etop: jnp.ndarray,  # (C,)
) -> jnp.ndarray:
    """Continued-fraction LDOS density for each (energy, chain).

    ``e`` has shape (NE,); returns (NE, C).  The terminator is the
    square-root branch with Im(Q) <= 0 (reference :1268-1298 analogue in
    bprldos).
    """
    lld = a.shape[0]
    ec = e[:, None].astype(jnp.complex128)  # (NE, 1)
    ebot_c = ebot[None, :].astype(jnp.complex128)
    etop_c = etop[None, :].astype(jnp.complex128)
    emid = 0.5 * (etop_c + ebot_c)
    det = (ec - etop_c) * (ec - ebot_c)
    zoff = jnp.sqrt(det)
    qt = (ec - emid - zoff) * 0.5
    qt = jnp.where(qt.imag > 0.0, (ec - emid + zoff) * 0.5, qt)

    def body(l, qt):
        idx = lld - 2 - l
        return b2[idx][None, :] / (ec - a[idx][None, :] - qt)

    qt = jax.lax.fori_loop(0, lld - 1, body, qt)
    return -qt.imag / jnp.pi


def orbital_density(
    a: np.ndarray,  # (lld, 18) chain diagonals for one atom (sph basis)
    b2: np.ndarray,  # (lld, 18)
    ene: np.ndarray,  # (NE,) energy mesh
    dw_l: np.ndarray,  # (18,)
    cshi: np.ndarray,  # (18,)
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-orbital LDOS for one atom (``dos%density``).

    Returns (tdens (18, NE), a_inf (18,), b_inf (18,)).
    """
    lld = a.shape[0]
    a_inf = np.zeros(18)
    b_inf = np.zeros(18)
    for nl in range(18):
        sqb = np.sqrt(b2[:, nl])
        ainf, binf, _ = bpopt(a[:, nl], sqb, lld - 1)
        if nl in (0, 9):  # s-orbitals: empirical band-edge widening
            binf *= 1.01
        a_inf[nl] = ainf
        b_inf[nl] = binf
    ebot = a_inf - 2.0 * b_inf
    etop = a_inf + 2.0 * b_inf

    # e_shift per orbital: ene/dw_l - cshi  (density :355-360)
    e_shift = ene[:, None] / dw_l[None, :] - cshi[None, :]  # (NE, 18)
    dens = _bprldos_shifted(
        jnp.asarray(e_shift),
        jnp.asarray(a),
        jnp.asarray(b2),
        jnp.asarray(ebot),
        jnp.asarray(etop),
    )
    tdens = np.asarray(dens) / dw_l[None, :]  # (NE, 18)
    return tdens.T, a_inf, b_inf


@jax.jit
def _bprldos_shifted(
    e: jnp.ndarray,  # (NE, C) per-chain shifted energies
    a: jnp.ndarray,
    b2: jnp.ndarray,
    ebot: jnp.ndarray,
    etop: jnp.ndarray,
) -> jnp.ndarray:
    lld = a.shape[0]
    ec = e.astype(jnp.complex128)
    ebot_c = ebot[None, :].astype(jnp.complex128)
    etop_c = etop[None, :].astype(jnp.complex128)
    emid = 0.5 * (etop_c + ebot_c)
    det = (ec - etop_c) * (ec - ebot_c)
    zoff = jnp.sqrt(det)
    qt = (ec - emid - zoff) * 0.5
    qt = jnp.where(qt.imag > 0.0, (ec - emid + zoff) * 0.5, qt)

    def body(l, qt):
        idx = lld - 2 - l
        return b2[idx][None, :] / (ec - a[idx][None, :] - qt)

    qt = jax.lax.fori_loop(0, lld - 1, body, qt)
    return -qt.imag / jnp.pi
