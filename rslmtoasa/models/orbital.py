"""Modern-theory orbital magnetization via Chebyshev moments.

Implements ``post_processing='orbital_modern'`` (``calculation.f90``
:1158-1290 and ``recursion.f90 chebyshev_orbital_mod`` :2834-3049):
the z orbital-moment operator is generated from the Hamiltonian and the
position operators, A = i alat^2 (X H~ Y - Y H~ X) (the r x v commutator
projected on z), and its KPM trace

    mu_n = sum_sites <A e_s | T_n(H~) e_s>

is Jackson-damped and reconstructed to the energy-resolved orbital
moment Lz(E); the cumulative Fermi integral is written to ``fort.50``
(the reference's unit-50 output).

Batched: the reference loops every cluster site serially
(O(kk) chains each restarted from scratch); here sites are batched into
wide unit-block start vectors and the chain is one ``lax.scan``.
Site subsampling (``n_sites``) turns the exact trace into the standard
stochastic-trace estimate for large clusters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.chebyshev import jackson_kernel
from ..ops.kubo import _apply_h, _spmv
from ..physics.energy_mesh import EnergyMesh
from ..utils.logger import g_logger
from ..utils.timer import g_timer


@partial(jax.jit, static_argnames=("n_mom",))
def _orbital_chunk(blocks, lsham, iz, cols, xs, ys, psi0, *, n_mom,
                   a, b):
    """mu_n (n_mom, 18, 18) contribution of one chunk of start sites.

    xs/ys: (kk,) scaled site coordinates (alat units x alat); psi0:
    (kk, 18, W) unit blocks on the chunk sites.
    """
    apply_h = partial(_apply_h, blocks, lsham, iz, iz, cols, a, b)

    def xy(coef, psi):
        return coef[:, None, None] * psi

    # left vector A|ref> = i (X H Y' - Y H X') with the reference's
    # ordering: lv1 = Y . H . (X psi), lv2 = X . H . (Y psi)
    lv1 = xy(ys, apply_h(xy(xs, psi0)))
    lv2 = xy(xs, apply_h(xy(ys, psi0)))
    left = 1j * (lv1 - lv2)

    def one(carry, _):
        n, vprev, v1 = carry
        v2 = jnp.where(n == 0, v1,
                       jnp.where(n == 1, apply_h(v1),
                                 2.0 * apply_h(v1) - vprev))
        # (W, W) cross-site matrix; the caller keeps the per-site
        # diagonal 18x18 blocks
        mu = jnp.einsum("kba,kbc->ac", left.conj(), v2)
        return (n + 1, jnp.where(n == 0, vprev, v1), v2), mu

    init = (0, jnp.zeros_like(psi0), psi0)
    _, mu = jax.lax.scan(one, init, None, length=n_mom)
    return mu


class OrbitalMoment:
    def __init__(self, sys, workdir: str = "."):
        self.sys = sys
        self.cfg = sys.cfg
        self.workdir = workdir

    def run(self, n_sites: int = None, chunk: int = 4):
        import os

        cfg = self.cfg
        sys = self.sys
        cl = sys.cluster
        sys.build_hamiltonian()
        hb = sys.ham
        emesh = EnergyMesh.build(cfg.energy)
        lld = cfg.control.lld
        a = (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3)
        b = (emesh.energy_max + emesh.energy_min) / 2.0
        ntype = hb.ee.shape[0]
        lsh = hb.lsham if hb.lsham is not None else np.zeros(
            (ntype, 18, 18), np.complex128)
        xs = jnp.asarray(cl.cr[:, 0] * cl.alat)
        ys = jnp.asarray(cl.cr[:, 1] * cl.alat)
        jb = jnp.asarray(hb.ee)
        jlsh = jnp.asarray(lsh)
        jiz = jnp.asarray(hb.iz)
        jcols = jnp.asarray(hb.cols)

        sites = (np.arange(cl.kk) if n_sites is None
                 else np.linspace(0, cl.kk - 1, n_sites).astype(int))
        mu = np.zeros((lld, 18, 18), np.complex128)
        with g_timer.section("orbital-moments-kpm"):
            for c0 in range(0, len(sites), chunk):
                sub = sites[c0:c0 + chunk]
                psi0 = np.zeros((cl.kk, 18, 18 * len(sub)),
                                np.complex128)
                for n, s in enumerate(sub):
                    psi0[s, :, 18 * n:18 * (n + 1)] = np.eye(18)
                mu_c = np.asarray(_orbital_chunk(
                    jb, jlsh, jiz, jcols, xs, ys, jnp.asarray(psi0),
                    n_mom=lld, a=float(a), b=float(b),
                ))
                # per-site diagonal 18x18 blocks of the (W, W) result
                for n in range(len(sub)):
                    sl = slice(18 * n, 18 * (n + 1))
                    mu += mu_c[:, sl, sl]
        mu /= float(len(sites))
        kern = jackson_kernel(lld)
        mu *= kern[:, None, None]
        mu[1:] *= 2.0

        # KPM reconstruction (chebyshev_orbital_mod :2995-3030)
        w = (emesh.ene - b) / a
        acx = np.arccos(np.clip(w, -1.0, 1.0))
        n_idx = np.arange(lld)
        expf = -1j * np.exp(-1j * n_idx[None, :] * acx[:, None])
        # reference accumulates mu * Im(exp_factor)
        g0 = np.einsum("en,nab->abe", expf.imag, mu)
        g0 /= np.sqrt(np.maximum(a**2 - (emesh.ene - b) ** 2, 1e-300))
        lzi = np.trace(g0, axis1=0, axis2=1).real

        from ..physics.quadrature import simpson_f_cumulative

        cum = simpson_f_cumulative(lzi, emesh.ene, emesh.nv1)
        path = os.path.join(self.workdir, "fort.50")
        with open(path, "w") as fh:
            for ie in range(emesh.npts):
                fh.write(f"{emesh.ene[ie] - emesh.fermi:16.6e}"
                         f"{-cum[ie] / np.pi:16.6e}"
                         f"{-lzi[ie] / np.pi:16.6e}\n")
        g_logger.info(f"orbital_modern: wrote {path}")
        return lzi
