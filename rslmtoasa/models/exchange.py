"""Exchange-coupling post-processing: Jij, DMI vector Dij, anisotropy Aij.

Implements the reference ``post_processing='exchange'`` pipeline
(``calculation.f90 post_processing_exchange`` :816-951):

* per ij-pair block recursion with the 4-start-vector trick
  (``recur_b_ij`` :1655-1745: (i+j), (i-j), (i+ij), (i-ij) superpositions),
* intersite Green functions Gij/Gji from the 4 chains and their spin
  decomposition (``green.f90 calculate_intersite_gf`` :425-470),
* LKAG formula: energy traces of d_i Gij d_j Gji combinations
  (``exchange.f90 calculate_exchange`` :1437-1560 with ``dGdG_Jnc``/
  ``dGdG_Dnc``/``dGdG_Anc`` :933-1030), Fermi-weighted Simpson integration,
* outputs ``jij.out``, ``dij.out``, ``aij.out`` in the reference's column
  layout (values in mRy: x 1e3 / 4 pi).

The pair batch (4 x njij chains) is the natural device fan-out axis.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import JobConfig
from ..ops.block_lanczos import block_lanczos, zsqr
from ..physics.greens import bgreen, get_terminf
from ..physics.energy_mesh import EnergyMesh
from ..physics.quadrature import simpson_f_cumulative, simpson_f_fermi
from ..utils.logger import g_logger
from ..utils.timer import g_timer
from .bulk import BulkSystem
from .scf import ANG2AU


def pair_start_vectors(kk: int, pairs: np.ndarray) -> np.ndarray:
    """4 start blocks per (i, j) pair (``recur_b_ij`` :1655-1712).

    pairs: (njij, 2) 0-based cluster indices.  Returns
    psi0 (4*njij, kk+1, 18, 18).
    """
    c = 1.0 / np.sqrt(2.0)
    signs = [(c, c), (c, -c), (c, 1j * c), (c, -1j * c)]
    r = 4 * len(pairs)
    psi0 = np.zeros((r, kk + 1, 18, 18), dtype=np.complex128)
    for p, (i, j) in enumerate(pairs):
        for reci, (asign, bsign) in enumerate(signs):
            if i == j:
                if reci == 0:
                    asign = bsign = 1.0
                else:
                    continue  # reference cycles (chains stay zero)
            idx = p * 4 + reci
            # layout (R, kk+1, 18, 18) = (chain, site, orb, orb);
            # assignment (not +=) matches the reference's overwrite when i==j
            psi0[idx, i, :, :] = asign * np.eye(18)
            psi0[idx, j, :, :] = bsign * np.eye(18)
    return psi0




class ExchangeCalculation:
    def __init__(self, sys: BulkSystem, pairs_1based: np.ndarray,
                 workdir: str = "."):
        self.sys = sys
        self.cfg = sys.cfg
        self.workdir = workdir
        self.pairs = np.asarray(pairs_1based, dtype=np.int64) - 1  # 0-based

    # ------------------------------------------------------------------
    def run(self):
        cfg = self.cfg
        sys = self.sys
        cl = sys.cluster
        lld = cfg.control.lld
        emesh = EnergyMesh.build(cfg.energy)

        # build_pot -> Hamiltonian from file parameters; predls afterwards
        # feeds d_matrix (post_processing_exchange ordering)
        sys.build_hamiltonian()
        for at in sys.atoms:
            at.potential.predls(cl.wav * ANG2AU)

        hb = sys.ham
        ntype = hb.ee.shape[0]
        lsham = hb.lsham if hb.lsham is not None else np.zeros(
            (ntype, 18, 18), dtype=np.complex128
        )
        psi0 = pair_start_vectors(cl.kk, self.pairs)
        # pair chains are the distribution axis (the reference's njij MPI
        # partition, calculation.f90:863); the dispatch layer shards them
        # over the device mesh when more than one chip is visible
        from ..parallel.dispatch import (
            block_lanczos_auto,
            chebyshev_moments_auto,
        )

        if cfg.control.recur == "chebyshev":
            # pair-resolved Chebyshev moments (chebyshev_recur_ij
            # :2376-2494) reconstructed per chain with the Jackson
            # kernel (chebyshev_green_ij :892-943)
            with g_timer.section("pair-recursion"):
                mu = chebyshev_moments_auto(
                    hb.ee, lsham, hb.iz, hb.cols, psi0, lld,
                    (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3),
                    (emesh.energy_max + emesh.energy_min) / 2.0,
                    hoh=cfg.hamiltonian.hoh,
                    hso=hb.eeo if cfg.hamiltonian.hoh else None,
                    enim=hb.enim if cfg.hamiltonian.hoh else None,
                    guard=False,  # chebyshev_recur_ij has no guard
                )
            self.mu = mu
            with g_timer.section("intersite-gf"):
                gi, gj = self._intersite_gf(None, None, emesh, mu=mu)
        else:
            with g_timer.section("pair-recursion"):
                a_b, b2_b = block_lanczos_auto(
                    hb.ee, lsham, hb.iz, hb.cols, psi0, lld,
                    hoh=cfg.hamiltonian.hoh,
                    hso=hb.eeo if cfg.hamiltonian.hoh else None,
                    enim=hb.enim if cfg.hamiltonian.hoh else None,
                )
            a_b = np.asarray(a_b)
            b_b = zsqr(np.asarray(b2_b))
            self.a_b = a_b
            self.b_b = b_b

            with g_timer.section("intersite-gf"):
                gi, gj = self._intersite_gf(a_b, b_b, emesh)

        with g_timer.section("jij-integrals"):
            results = self._lkag(gi, gj, emesh)
        self._write_outputs(results)
        return results

    # ------------------------------------------------------------------
    def _intersite_gf(self, a_b, b_b, emesh, mu=None):
        """Gij/Gji spin components per pair: returns two dicts of
        (njij, 9, 9, NE) arrays keyed by ('n','x','y','z').  With
        ``mu`` given, chains are reconstructed by KPM instead of the
        matrix continued fraction."""
        cfg = self.cfg
        njij = len(self.pairs)
        ne = emesh.npts
        comps_i = {k: np.zeros((njij, 9, 9, ne), np.complex128)
                   for k in "nxyz"}
        comps_j = {k: np.zeros((njij, 9, 9, ne), np.complex128)
                   for k in "nxyz"}
        # full 18x18 intersite blocks, kept for damping / inertia
        self.gij_full = np.zeros((njij, 18, 18, ne), np.complex128)
        self.gji_full = np.zeros((njij, 18, 18, ne), np.complex128)
        for p, (i, j) in enumerate(self.pairs):
            sl = slice(4 * p, 4 * p + 4)
            if mu is not None:
                from ..ops.chebyshev import chebyshev_green

                g4 = np.stack([
                    chebyshev_green(mu[:, 4 * p + n], emesh.ene,
                                    emesh.energy_min, emesh.energy_max)
                    for n in range(4)
                ])
            else:
                a4 = a_b[:, sl]
                b4 = b_b[:, sl]
                a_inf, b_inf = get_terminf(a4, b4)
                g4 = np.stack([
                    bgreen(a4[:, n], b4[:, n], a_inf[n], b_inf[n],
                           emesh.ene, sym_term=cfg.control.sym_term)
                    for n in range(4)
                ])  # (4, 18, 18, NE)
            if i == j:
                gij = g4[0]
                gji = g4[0]
            else:
                diff = (1.0 / 1j) * (g4[2] - g4[3])
                gij = 0.5 * (g4[0] - g4[1] + diff)
                gji = 0.5 * (g4[0] - g4[1] - diff)
            self.gij_full[p] = gij
            self.gji_full[p] = gji
            for (comps, g) in ((comps_i, gij), (comps_j, gji)):
                uu = g[0:9, 0:9]
                dd = g[9:18, 9:18]
                ud = g[0:9, 9:18]
                du = g[9:18, 0:9]
                comps["n"][p] = 0.5 * (uu + dd)
                comps["z"][p] = 0.5 * (uu - dd)
                comps["y"][p] = 0.5 * (1j * ud - 1j * du)
                comps["x"][p] = 0.5 * (ud + du)
        self.comps_i = comps_i
        self.comps_j = comps_j
        return comps_i, comps_j

    # ------------------------------------------------------------------
    def _lkag(self, gi, gj, emesh) -> List[dict]:
        cl = self.sys.cluster
        ne = emesh.npts
        results = []
        for p, (i, j) in enumerate(self.pairs):
            it = int(cl.iz[i]) - 1
            jt = int(cl.iz[j]) - 1
            pot_i = self.sys.atoms[it].potential
            pot_j = self.sys.atoms[jt].potential
            # d matrices for all energies: diagonal 9-vector per energy
            di = np.stack([np.diag(pot_i.d_matrix(e)) for e in emesh.ene])
            dj = np.stack([np.diag(pot_j.d_matrix(e)) for e in emesh.ene])
            # work in (NE, 9, 9)
            gjx = {k: gj[k][p].transpose(2, 0, 1) for k in "nxyz"}
            gix = {k: gi[k][p].transpose(2, 0, 1) for k in "nxyz"}

            def dg(d, g):  # (NE,9) diag @ (NE,9,9)
                return d[:, :, None] * g

            # Jij: tr[ d_i G^n_ij d_j G^n_ji - sum_k d_i G^k_ij d_j G^k_ji ]
            jmat = np.matmul(dg(di, gix["n"]), dg(dj, gjx["n"]))
            for k in "xyz":
                jmat = jmat - np.matmul(dg(di, gix[k]), dg(dj, gjx[k]))
            jtot = np.imag(np.trace(jmat, axis1=1, axis2=2))
            jij = simpson_f_fermi(jtot, emesh.ene, emesh.fermi, emesh.nv1)
            jij *= 1.0e3 / 4.0 / np.pi

            # DMI
            dmi = np.zeros(3)
            for kidx, k in enumerate("xyz"):
                t3 = np.matmul(dg(di, gix["n"]), dg(dj, gjx[k]))
                t4 = np.matmul(dg(dj, gjx["n"]), dg(di, gix[k]))
                y = np.real(np.trace(t3 - t4, axis1=1, axis2=2))
                dmi[kidx] = simpson_f_fermi(y, emesh.ene, emesh.fermi,
                                            emesh.nv1)
            dmi *= 1.0e3 / 4.0 / np.pi

            # anisotropy tensor
            aij = np.zeros((3, 3))
            for kidx, k in enumerate("xyz"):
                for lidx, l in enumerate("xyz"):
                    t3 = np.matmul(dg(di, gix[k]), dg(dj, gjx[l]))
                    t4 = np.matmul(dg(dj, gjx[k]), dg(di, gix[l]))
                    y = np.imag(np.trace(0.5 * (t3 + t4), axis1=1, axis2=2))
                    aij[kidx, lidx] = simpson_f_fermi(
                        y, emesh.ene, emesh.fermi, emesh.nv1
                    )
            aij *= 1.0e3 / 4.0 / np.pi

            results.append({
                "i": int(i), "j": int(j),
                "iz_i": int(cl.iz[i]), "iz_j": int(cl.iz[j]),
                "rij": cl.cr[j] - cl.cr[i],
                "dist": float(np.linalg.norm(cl.cr[i] - cl.cr[j])),
                "jij": jij, "dmi": dmi, "aij": aij,
            })
            g_logger.info(f"Jij pair ({i+1},{j+1}): {jij:.6f} mRy")
        return results

    # ------------------------------------------------------------------
    def _write_outputs(self, results: List[dict]):
        # jtens.out: J on the diagonal, DMI skew, Aij full tensor
        # (calculate_exchange :1581-1599; the reference prints the
        # tensor to stdout and leaves the opened jtens.out empty --
        # here the documented tensor goes into the file)
        with open(os.path.join(self.workdir, "jtens.out"), "w") as f60:
            for r in results:
                jt = np.eye(3) * r["jij"]
                d = r["dmi"]
                jt += np.array([[0, d[2], -d[1]],
                                [-d[2], 0, d[0]],
                                [d[1], -d[0], 0]])
                jt += r["aij"]
                f60.write(f"{r['iz_i']:8d}{r['iz_j']:8d}  " + "".join(
                    f"{x:12.6f}" for x in r["rij"]) + "  " + "".join(
                    f"{v:12.6f}" for v in jt.ravel())
                    + f" {r['dist']:12.6f}\n")
        with open(os.path.join(self.workdir, "jij.out"), "w") as f20, \
                open(os.path.join(self.workdir, "dij.out"), "w") as f30, \
                open(os.path.join(self.workdir, "aij.out"), "w") as f40:
            for r in results:
                head = (f"{r['iz_i']:8d}{r['iz_j']:8d}  "
                        + "".join(f"{x:12.6f}" for x in r["rij"]) + "  ")
                f20.write(head + f"{r['jij']:12.6f} {r['dist']:12.6f}\n")
                f30.write(head + "".join(f"{x:12.6f}" for x in r["dmi"])
                          + f" {r['dist']:12.6f}\n")
                # Fortran writes aij in column-major order
                f40.write(head
                          + "".join(f"{x:12.6f}" for x in r["aij"].T.ravel())
                          + f" {r['dist']:12.6f}\n")

    # ------------------------------------------------------------------
    def calculate_jijk(self, trios):
        """Spin-lattice three-site coupling Jijk (``exchange.f90
        calculate_jijk`` :338-612, real-space torque-correlation of
        Sci. Rep. 7, 931 (2017)).

        trios: (njijk, 6) rows [i, j, k, dx, dy, dz] (1-based atoms,
        displacement direction of atom k).  Requires construction with
        pairs [(i,j), (i,k), (j,k)] per trio (3*njijk pairs) and run().
        Returns the (njijk, 9) tensor in meV/a.u.; writes jijk.out
        (the reference only prints to stdout).
        """
        import os

        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ene = emesh.ene
        ne = len(ene)
        lmax = 2
        K = (lmax + 1) ** 2
        wav = cl.wav  # Angstrom (mRy/Angstrom scaling, :437)
        # component angle table (theta, theta', phi, phi') for xx..zz
        hp = 0.5 * np.pi
        ang = np.array([
            [hp, hp, 0, 0], [hp, hp, 0, hp], [hp, 0, 0, 0],
            [hp, hp, hp, 0], [hp, hp, hp, hp], [hp, 0, hp, 0],
            [0, hp, 0, 0], [0, hp, 0, hp], [0, 0, 0, 0],
        ])
        out_rows = []
        results = np.zeros((len(trios), 9))
        for nt, trio in enumerate(trios):
            i, j, k = (int(trio[0]) - 1, int(trio[1]) - 1,
                       int(trio[2]) - 1)
            disp = np.asarray(trio[3:6], float)
            u = disp / np.linalg.norm(disp)
            pots = {a: self.sys.atoms[int(cl.iz[a]) - 1].potential
                    for a in (i, j, k)}
            scr = {a: pots[a].qpar for a in (i, j, k)}
            zero_scr = np.zeros((lmax + 1, 2))
            pm = {a: p_matrix(pots[a], lmax, ene) for a in (i, j, k)}
            pm0 = {a: transform_pmatrix(pm[a], scr[a], zero_scr, lmax)
                   for a in (i, j, k)}
            umat_d = disp_matrix(lmax, wav, u)  # (2K, 2K)
            # U_k(E) = D P0_k + P0_k D^T per energy (udisp_matrix)
            umk = (umat_d[None] * pm0[k][:, None, :]
                   + pm0[k][:, :, None] * umat_d.T[None])

            def aux(g, a, b):
                """delta_a G_ab delta_b, then orthogonal->canonical
                (auxiliary_gij + transform_auxiliary_gij)."""
                da = np.concatenate([np.repeat(pots[a].dele[:, s],
                                               [1, 3, 5]) for s in (0, 1)])
                db = np.concatenate([np.repeat(pots[b].dele[:, s],
                                               [1, 3, 5]) for s in (0, 1)])
                gax = g.transpose(2, 0, 1) * da[None, :, None] \
                    * db[None, None, :]
                r1 = pm[a] / pm0[a]  # (NE, 2K) diagonal rescale
                r2 = pm[b] / pm0[b]
                out = r1[:, :, None] * gax * r2[:, None, :]
                if a == b:
                    scr_d = np.concatenate([
                        np.repeat(-scr[a][:, s], [1, 3, 5])
                        for s in (0, 1)
                    ])  # (beta - alpha) with beta = 0
                    diag = scr_d[None, :] * (pm[a] / pm0[a])
                    out[:, np.arange(2 * K), np.arange(2 * K)] += diag
                return out

            base = 3 * nt
            g_ij = aux(self.gij_full[base + 0], i, j)
            g_ji = aux(self.gji_full[base + 0], j, i)
            g_ik = aux(self.gij_full[base + 1], i, k)
            g_ki = aux(self.gji_full[base + 1], k, i)
            g_jk = aux(self.gij_full[base + 2], j, k)
            g_kj = aux(self.gji_full[base + 2], k, j)
            dp_i = (pm0[i][:, :K] - pm0[i][:, K:])  # (NE, K) diagonal
            dp_j = (pm0[j][:, :K] - pm0[j][:, K:])
            uu = slice(0, K)
            dd = slice(K, 2 * K)
            t1 = np.matmul(umk[:, dd, dd], g_ki[:, dd, dd])
            t2 = np.matmul(umk[:, uu, uu], g_ki[:, uu, uu])
            t3 = dp_i[:, :, None] * g_ij[:, uu, uu]
            t4 = dp_j[:, :, None] * g_jk[:, uu, uu]
            t5 = np.matmul(umk[:, uu, uu], g_kj[:, uu, uu])
            t6 = np.matmul(umk[:, dd, dd], g_kj[:, dd, dd])
            t7 = dp_j[:, :, None] * g_ji[:, uu, uu]
            t8 = dp_i[:, :, None] * g_ij[:, dd, dd]
            t9 = dp_j[:, :, None] * g_jk[:, dd, dd]
            t10 = dp_j[:, :, None] * g_ji[:, dd, dd]
            m342 = np.matmul(t3, np.matmul(t4, t2))
            m842 = np.matmul(t8, np.matmul(t4, t2))
            m391 = np.matmul(t3, np.matmul(t9, t1))
            m891 = np.matmul(t8, np.matmul(t9, t1))
            m3510 = np.matmul(t3, np.matmul(t5, t10))
            m8610 = np.matmul(t8, np.matmul(t6, t10))
            m357 = np.matmul(t3, np.matmul(t5, t7))
            m867 = np.matmul(t8, np.matmul(t6, t7))
            for p in range(9):
                th, thp, ph, php = ang[p]
                cc = np.cos(th) * np.cos(thp)
                ssp = np.sin(th) * np.sin(thp) * np.exp(
                    1j * (php - ph))
                ssm = np.sin(th) * np.sin(thp) * np.exp(
                    1j * (ph - php))
                tot = (cc * m342 + ssp * m842 + ssm * m391 + cc * m891
                       + ssm * m3510 + cc * m8610 + cc * m357
                       + ssp * m867)
                y = 0.5 * np.trace(tot, axis1=1, axis2=2).imag
                results[nt, p] = simpson_f_fermi(
                    y, ene, emesh.fermi, emesh.nv1
                )
            results[nt] *= (1.0e3 / 8.0 / np.pi) \
                * (13.605693122994 / 1.8897261246)
            out_rows.append(
                f"{i + 1:6d}{j + 1:6d}{k + 1:6d}  "
                + "".join(f"{v:10.6f}" for v in u) + "  "
                + "".join(f"{v:14.9f}" for v in results[nt]) + "\n"
            )
            g_logger.info(
                f"Jijk trio ({i+1},{j+1},{k+1}): "
                + " ".join(f"{v:.6f}" for v in results[nt][:3])
            )
        with open(os.path.join(self.workdir, "jijk.out"), "w") as fh:
            fh.writelines(out_rows)
        return results

    # ------------------------------------------------------------------
    def calculate_jij_auxgreen(self):
        """Jij tensor from auxiliary Green functions (``exchange.f90
        calculate_jij_auxgreen`` :140-336): aux G = delta_i G delta_j,
        DeltaP = P_up - P_dw from the LMTO potential functions; the
        9-component angle tensor for i != j, and the on-site J0 sum rule
        for i == j.  Writes jij_aux.out; returns (njij, 9) in mRy
        (column 0 holds J0 for i == j rows).  Requires run()."""
        import os

        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ene = emesh.ene
        hp = 0.5 * np.pi
        ang = np.array([
            [hp, hp, 0, 0], [hp, hp, 0, hp], [hp, 0, 0, 0],
            [hp, hp, hp, 0], [hp, hp, hp, hp], [hp, 0, hp, 0],
            [0, hp, 0, 0], [0, hp, 0, hp], [0, 0, 0, 0],
        ])
        K = 9
        out = np.zeros((len(self.pairs), 9))
        rows = []
        for p, (i, j) in enumerate(self.pairs):
            it = int(cl.iz[i]) - 1
            jt = int(cl.iz[j]) - 1
            pot_i = self.sys.atoms[it].potential
            pot_j = self.sys.atoms[jt].potential
            pm_i = p_matrix(pot_i, 2, ene)  # (NE, 18) diagonal
            pm_j = p_matrix(pot_j, 2, ene)
            dp_i = pm_i[:, :K] - pm_i[:, K:]  # (NE, 9)
            dp_j = pm_j[:, :K] - pm_j[:, K:]

            def aux(g, pa, pb):
                da = np.concatenate([np.repeat(pa.dele[:, s], [1, 3, 5])
                                     for s in (0, 1)])
                db = np.concatenate([np.repeat(pb.dele[:, s], [1, 3, 5])
                                     for s in (0, 1)])
                return (g.transpose(2, 0, 1) * da[None, :, None]
                        * db[None, None, :])

            gij = aux(self.gij_full[p], pot_i, pot_j)  # (NE, 18, 18)
            gji = aux(self.gji_full[p], pot_j, pot_i)
            uu = slice(0, K)
            dd = slice(K, 2 * K)
            t1 = dp_i[:, :, None] * gij[:, uu, uu]
            t2 = dp_j[:, :, None] * gji[:, dd, dd]
            t4 = dp_j[:, :, None] * gji[:, uu, uu]
            if i != j:
                t3 = dp_i[:, :, None] * gij[:, dd, dd]
                m14 = np.matmul(t1, t4)
                m34 = np.matmul(t3, t4)
                m12 = np.matmul(t1, t2)
                m32 = np.matmul(t3, t2)
                for k in range(9):
                    th, thp, ph, php = ang[k]
                    cc = np.cos(th) * np.cos(thp)
                    ssp = np.sin(th) * np.sin(thp) * np.exp(
                        1j * (php - ph))
                    ssm = np.sin(th) * np.sin(thp) * np.exp(
                        1j * (ph - php))
                    tot = cc * m14 + ssp * m34 + ssm * m12 + cc * m32
                    y = 0.5 * np.trace(tot, axis1=1, axis2=2).imag
                    out[p, k] = simpson_f_fermi(y, ene, emesh.fermi,
                                                emesh.nv1)
            else:
                t3 = dp_i[:, :, None] * (gij[:, uu, uu] - gji[:, dd, dd])
                y = -np.trace(np.matmul(t1, t2) + t3,
                              axis1=1, axis2=2).imag
                out[p, 0] = simpson_f_fermi(y, ene, emesh.fermi,
                                            emesh.nv1)
            out[p] *= 1.0e3 / 4.0 / np.pi
            rij = cl.cr[j] - cl.cr[i]
            rows.append(f"{it + 1:8d}{jt + 1:8d}  "
                        + "".join(f"{v:12.6f}" for v in rij) + "  "
                        + "".join(f"{v:14.9f}" for v in out[p]) + "\n")
            if i != j:
                g_logger.info(
                    f"Jij_aux pair ({i+1},{j+1}) zz: {out[p, 8]:.6f} mRy,"
                    f" Dij_zz_aux: {0.5 * (out[p, 1] - out[p, 3]):.6f}"
                )
            else:
                g_logger.info(f"J0_aux atom {i+1}: {out[p, 0]:.6f} mRy")
        with open(os.path.join(self.workdir, "jij_aux.out"), "w") as fh:
            fh.writelines(rows)
        return out

    # ------------------------------------------------------------------
    def run_gauss_legendre(self):
        """Fermi-sea exchange via imaginary-axis Gauss-Legendre
        quadrature (``calculate_exchange_gauss_legendre`` :1756-1900 and
        ``green.f90 calculate_intersite_gf_eta`` :471-540).

        The intersite GF is evaluated at z = E_F + i eta for 64 GL nodes
        eta = (1-x)/x on (0, inf); Jij = -sum_n w_n/x_n^2 Re tr[d G d G]
        with d = Re(ee_onsite_up - ee_onsite_dn) (the onsite exchange
        splitting, not the energy-dependent d_matrix).  Writes jij.out /
        dij.out / aij.out in the GL layout.  Requires run() (chains).
        """
        import os

        cl = self.sys.cluster
        hb = self.sys.ham
        cfg = self.cfg
        emesh = EnergyMesh.build(cfg.energy)
        # fermi_point: last mesh index with ene <= fermi + 1e-6
        fermi_point = int(np.max(np.nonzero(
            emesh.ene - emesh.fermi <= 1.0e-6
        )[0]))
        ef = np.array([emesh.ene[fermi_point]])
        t, w = np.polynomial.legendre.leggauss(64)
        x = 0.5 * (t + 1.0)
        w = 0.5 * w

        rows_j, rows_d, rows_a = [], [], []
        for p, (i, j) in enumerate(self.pairs):
            sl = slice(4 * p, 4 * p + 4)
            a4 = self.a_b[:, sl]
            b4 = self.b_b[:, sl]
            a_inf, b_inf = get_terminf(a4, b4)
            gi = {k: np.zeros((64, 9, 9), np.complex128) for k in "nxyz"}
            gj = {k: np.zeros((64, 9, 9), np.complex128) for k in "nxyz"}
            for nv in range(64):
                eta = 1j * (1.0 - x[nv]) / x[nv]
                g4 = np.stack([
                    bgreen(a4[:, n], b4[:, n], a_inf[n], b_inf[n], ef,
                           sym_term=cfg.control.sym_term, eta=eta)[:, :, 0]
                    for n in range(4)
                ])  # (4, 18, 18)
                if i == j:
                    gij = gji = g4[0]
                else:
                    diff = (1.0 / 1j) * (g4[2] - g4[3])
                    gij = 0.5 * (g4[0] - g4[1] + diff)
                    gji = 0.5 * (g4[0] - g4[1] - diff)
                for (comp, g) in ((gi, gij), (gj, gji)):
                    uu, dd = g[:9, :9], g[9:, 9:]
                    ud, du = g[:9, 9:], g[9:, :9]
                    comp["n"][nv] = 0.5 * (uu + dd)
                    comp["z"][nv] = 0.5 * (uu - dd)
                    comp["y"][nv] = 0.5 * (1j * ud - 1j * du)
                    comp["x"][nv] = 0.5 * (ud + du)
            it = int(cl.iz[i]) - 1
            jt = int(cl.iz[j]) - 1
            d1 = np.real(hb.ee[it, 0][:9, :9] - hb.ee[it, 0][9:, 9:])
            d2 = np.real(hb.ee[jt, 0][:9, :9] - hb.ee[jt, 0][9:, 9:])
            quad = (w / x**2)[:, None, None]

            def dgdg(da, ga, db, gb):
                return np.matmul(da[None] @ ga, db[None] @ gb)

            jmat = dgdg(d1, gi["n"], d2, gj["n"])
            for k in "xyz":
                jmat = jmat - dgdg(d1, gi[k], d2, gj[k])
            jij = -np.sum(np.trace(quad * jmat, axis1=1, axis2=2).real)
            jij *= 1.0e3 / 4.0 / np.pi
            dmi = np.zeros(3)
            for kidx, k in enumerate("xyz"):
                dm = (dgdg(d1, gi["n"], d2, gj[k])
                      - dgdg(d2, gj["n"], d1, gi[k]))
                dmi[kidx] = np.sum(
                    np.trace(quad * dm, axis1=1, axis2=2).imag
                )
            dmi *= 1.0e3 / 4.0 / np.pi
            aij = np.zeros((3, 3))
            for kidx, k in enumerate("xyz"):
                for lidx, l in enumerate("xyz"):
                    am = 0.5 * (dgdg(d1, gi[k], d2, gj[l])
                                + dgdg(d2, gj[k], d1, gi[l]))
                    aij[kidx, lidx] = -np.sum(
                        np.trace(quad * am, axis1=1, axis2=2).real
                    )
            aij *= 1.0e3 / 4.0 / np.pi

            rij = cl.cr[j] - cl.cr[i]
            dist = float(np.linalg.norm(rij))
            head = (f"{it + 1:8d}{jt + 1:8d}  "
                    + "".join(f"{v:12.6f}" for v in rij) + "  ")
            rows_j.append(head + f"{jij:12.6f} {dist:12.6f}\n")
            rows_d.append(head + "".join(f"{v:12.6f}" for v in dmi)
                          + f" {dist:12.6f}\n")
            rows_a.append(head + "".join(f"{v:12.6f}"
                                         for v in aij.T.ravel())
                          + f" {dist:12.6f}\n")
            g_logger.info(f"GL Jij pair ({i+1},{j+1}): {jij:.6f} mRy")
        for name, rows in (("jij", rows_j), ("dij", rows_d),
                           ("aij", rows_a)):
            with open(os.path.join(self.workdir, name + ".out"),
                      "w") as fh:
                fh.writelines(rows)
        return rows_j

    # ------------------------------------------------------------------
    def calculate_exchange_twoindex(self):
        """Density/current-decomposed exchange (``exchange.f90
        calculate_exchange_twoindex`` :84-337 and ``green.f90
        calculate_intersite_gf_twoindex`` :386-423).

        Each spin channel of the intersite GF is split into a density
        (0) and a current (1) part via the m -> -m reflection
        G^{c,0/1}_ij = (G^c_ij +/- refl(G^c_ji))/2 with
        refl(G)[k, j] = (-1)^{k+j} G[2j0-j, 2k0-k]; second-order (so) and
        first-order (fo) Jij/Dij/Aij combinations are integrated to E_F
        and written to jijso/jijfo/jijparts/dijso/dijfo/dijparts/
        aijso/aijfo/aijparts (+ the reference's empty jtens files and
        its unit-150 cumulative Jij curve, fort.150).  Requires run().
        """
        import os

        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ne = emesh.npts

        # m -> -m reflection table (1-based 2*k0-k) and sign matrix
        q = np.arange(1, 10)
        l1 = np.sqrt(q - 0.9).astype(int)
        k0 = l1 * (l1 + 1) + 1
        refl = 2 * k0 - q - 1  # 0-based reflected index
        sign = (-1.0) ** (np.add.outer(np.arange(9), np.arange(9)))

        def reflect(g):
            # g: (9, 9, NE); returns (-1)^{k+j} g[R(j), R(k)]
            return sign[:, :, None] * g[refl][:, refl].transpose(1, 0, 2)

        def integrate(y):
            return simpson_f_fermi(y, emesh.ene, emesh.fermi, emesh.nv1) \
                * 1.0e3 / 4.0 / np.pi

        files = {name: open(os.path.join(self.workdir, name + ".out"), "w")
                 for name in ("jijso", "jijfo", "jijparts", "dijso",
                              "dijfo", "dijparts", "aijso", "aijfo",
                              "aijparts", "jtensso", "jtensfo")}
        f150 = open(os.path.join(self.workdir, "fort.150"), "w")
        try:
            for p, (i, j) in enumerate(self.pairs):
                it = int(cl.iz[i]) - 1
                jt = int(cl.iz[j]) - 1
                pot_i = self.sys.atoms[it].potential
                pot_j = self.sys.atoms[jt].potential
                di = np.stack([np.diag(pot_i.d_matrix(e))
                               for e in emesh.ene])
                dj = np.stack([np.diag(pot_j.d_matrix(e))
                               for e in emesh.ene])

                # two-index channel blocks, (NE, 9, 9)
                ch = {}
                for c in "nxyz":
                    gi = self.comps_i[c][p]  # (9, 9, NE)
                    gj = self.comps_j[c][p]
                    rgj = reflect(gj)
                    rgi = reflect(gi)
                    ch[c + "0ij"] = (0.5 * (gi + rgj)).transpose(2, 0, 1)
                    ch[c + "1ij"] = (0.5 * (gi - rgj)).transpose(2, 0, 1)
                    ch[c + "0ji"] = (0.5 * (gj + rgi)).transpose(2, 0, 1)
                    ch[c + "1ji"] = (0.5 * (gj - rgi)).transpose(2, 0, 1)

                def dgdg(gij, gji):
                    return np.matmul(di[:, :, None] * gij,
                                     dj[:, :, None] * gji)

                def tr(m):
                    return np.trace(m, axis1=1, axis2=2)

                jcd = tr(dgdg(ch["n0ij"], ch["n0ji"])).imag
                jcc = tr(dgdg(ch["n1ij"], ch["n1ji"])).imag
                jsd = sum(tr(dgdg(ch[c + "0ij"], ch[c + "0ji"])).imag
                          for c in "xyz")
                jsc = sum(tr(dgdg(ch[c + "1ij"], ch[c + "1ji"])).imag
                          for c in "xyz")
                jso = jcd - jsd + jcc - jsc
                jfo = jcd + jsd - jcc - jsc

                dsc = np.stack([tr(dgdg(ch["n0ij"], ch[c + "1ji"])).real
                                for c in "xyz"], 1)
                dcc = np.stack([tr(dgdg(ch["n1ij"], ch[c + "0ji"])).real
                                for c in "xyz"], 1)
                dso = 2.0 * (dsc + dcc)
                dfo = 2.0 * (dsc - dcc)

                isd = np.stack([np.stack([
                    tr(dgdg(ch[a + "0ij"], ch[b + "0ji"])).imag
                    for b in "xyz"], 1) for a in "xyz"], 1)  # (NE, 3, 3)
                isc = np.stack([np.stack([
                    tr(dgdg(ch[a + "1ij"], ch[b + "1ji"])).imag
                    for b in "xyz"], 1) for a in "xyz"], 1)

                rij = cl.cr[j] - cl.cr[i]
                dist = float(np.linalg.norm(rij))
                head = (f"{it + 1:8d}{jt + 1:8d}  "
                        + "".join(f"{x:20.11e}" for x in rij) + "  ")

                def row(f, vals):
                    files[f].write(head + "".join(
                        f"{v:16.6e}" for v in np.atleast_1d(vals)
                    ) + f" {dist:12.6f}\n")

                row("jijso", integrate(jso))
                row("jijfo", integrate(jfo))
                row("jijparts", [integrate(jcd), integrate(jsd),
                                 integrate(jcc), integrate(jsc)])
                row("dijso", [integrate(dso[:, k]) for k in range(3)])
                row("dijfo", [integrate(dfo[:, k]) for k in range(3)])
                row("dijparts",
                    [2.0 * integrate(dcc[:, k]) for k in range(3)]
                    + [2.0 * integrate(dsc[:, k]) for k in range(3)])
                aso = np.array([[integrate((isd + isc)[:, k, l])
                                 for l in range(3)] for k in range(3)])
                afo = np.array([[integrate((-isd + isc)[:, k, l])
                                 for l in range(3)] for k in range(3)])
                row("aijso", aso.T.ravel())
                row("aijfo", afo.T.ravel())
                asd = np.array([[integrate(isd[:, k, l])
                                 for l in range(3)] for k in range(3)])
                asc = np.array([[integrate(isc[:, k, l])
                                 for l in range(3)] for k in range(3)])
                row("aijparts", np.concatenate([asd.T.ravel(),
                                                asc.T.ravel()]))
                cum = simpson_f_cumulative(jso, emesh.ene, emesh.nv1) \
                    * 1.0e3 / 4.0 / np.pi
                for nv in range(ne):
                    f150.write(f" {emesh.ene[nv] - emesh.fermi:18.10e}"
                               f" {cum[nv]:18.10e}\n")
        finally:
            for fh in files.values():
                fh.close()
            f150.close()

    # ------------------------------------------------------------------
    def calculate_gilbert_damping(self):
        """Torque-correlation Gilbert damping per ij pair
        (``exchange.f90 calculate_gilbert_damping`` :613-744).

        alpha^{kl}_ij = -0.5/(pi m_i) Re tr[T^k_i A_ij T^l_j^dag A_ji]
        with A_ij = g_ij - g_ji^dag the anti-Hermitian intersite GF and
        T^k the collinear SOC torque operators.  Writes
        ``damping-energy.out`` (accumulated over pairs vs energy) and
        ``alldampings.out`` (per-pair tensor at E_F).  Requires run().
        """
        import os

        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ne = emesh.npts
        tmat = torque_operator_collinear(self.sys.atoms)
        total = np.zeros((9, ne))
        ief = int(np.argmin(np.abs(emesh.ene - emesh.fermi)))
        rows = []
        factor = 1.0
        for p, (i, j) in enumerate(self.pairs):
            it = int(cl.iz[i]) - 1
            jt = int(cl.iz[j]) - 1
            gij = self.gij_full[p].transpose(2, 0, 1)  # (NE, 18, 18)
            gji = self.gji_full[p].transpose(2, 0, 1)
            aij = gij - np.conj(gji).transpose(0, 2, 1)
            aji = gji - np.conj(gij).transpose(0, 2, 1)
            pot_i = self.sys.atoms[it].potential
            spin_i = float(
                (pot_i.ql[0, :, 0] - pot_i.ql[0, :, 1]).sum()
            )
            factor = -0.25 * 2.0 / (np.pi * spin_i)
            dt = np.zeros((9, ne))
            m = 0
            for k in range(3):
                tk_aij = np.matmul(tmat[it, k][None], aij)
                for l in range(3):
                    tl_aji = np.matmul(
                        np.conj(tmat[jt, l]).T[None], aji
                    )
                    dt[m] = np.real(np.einsum(
                        "nab,nba->n", tk_aij, tl_aji
                    ))
                    m += 1
            total += dt
            rij = cl.cr[i] - cl.cr[j]
            dist = float(np.linalg.norm(rij))
            rows.append(
                f"{i + 1:7d}{j + 1:7d}"
                + "".join(f"{factor * v:14.9f}" for v in dt[:, ief])
                + f"{0.5 * factor * (dt[0, ief] + dt[4, ief]):14.9f}"
                + f"{dist:10.6f}"
                + "".join(f"{v:10.6f}" for v in rij) + "\n"
            )
        with open(os.path.join(self.workdir, "alldampings.out"), "w") as fh:
            fh.write("    #i     #j   #xx #xy #xz #yx #yy #yz #zx #zy #zz"
                     " #0.5*(xx+yy) #Dist #rij\n")
            fh.writelines(rows)
        with open(os.path.join(self.workdir, "damping-energy.out"),
                  "w") as fh:
            fh.write("#Energy (E-Ef) #xx #xy #xz #yx #yy #yz #zx #zy #zz\n")
            for nv in range(ne):
                fh.write(f"{emesh.ene[nv] - emesh.fermi:14.9f}" + "".join(
                    f"{factor * total[m, nv]:14.9f}" for m in range(9)
                ) + "\n")
        return factor * total[:, ief]

    # ------------------------------------------------------------------
    def calculate_moment_of_inertia(self):
        """Torque-correlation moment of inertia (``exchange.f90``
        :755-912, Sci. Rep. 7, 931 (2017)).

        I^{kl}_ij ~ Re tr[T^k A_ij T^l^dag B''_ji + T^k B''_ij T^l^dag
        A_ji] with B the Hermitian GF part and B'' its second energy
        derivative.  Deviation: the reference evaluates the tensor with
        an out-of-range energy index after its loop (:873-886, Fortran
        UB) and never writes it; here the tensor is evaluated at E_F.
        Writes ``example-real.out``/``example-imag.out`` (B(1,1) traces)
        as the reference does.  Returns the (9,) tensor at E_F per pair
        summed.
        """
        import os

        cl = self.sys.cluster
        emesh = EnergyMesh.build(self.cfg.energy)
        ne = emesh.npts
        h = emesh.ene[1] - emesh.ene[0]
        tmat = torque_operator_collinear(self.sys.atoms)
        ief = int(np.argmin(np.abs(emesh.ene - emesh.fermi)))
        total = np.zeros(9)
        fre = open(os.path.join(self.workdir, "example-real.out"), "w")
        fim = open(os.path.join(self.workdir, "example-imag.out"), "w")
        for p, (i, j) in enumerate(self.pairs):
            it = int(cl.iz[i]) - 1
            jt = int(cl.iz[j]) - 1
            gij = self.gij_full[p].transpose(2, 0, 1)
            gji = self.gji_full[p].transpose(2, 0, 1)
            aij = gij - np.conj(gji).transpose(0, 2, 1)
            aji = gji - np.conj(gij).transpose(0, 2, 1)
            bij = gij + np.conj(gji).transpose(0, 2, 1)
            bji = gji + np.conj(gij).transpose(0, 2, 1)

            def d2(b):
                out = np.zeros_like(b)
                out[1:-1] = (b[2:] - 2.0 * b[1:-1] + b[:-2]) / h**2
                return out

            sbij = d2(bij)
            sbji = d2(bji)
            for nv in range(ne):
                fre.write(f"{emesh.ene[nv]:18.10e}"
                          f"{bij[nv, 0, 0].real:18.10e}"
                          f"{sbij[nv, 0, 0].real:18.10e}\n")
                fim.write(f"{emesh.ene[nv]:18.10e}"
                          f"{bij[nv, 0, 0].imag:18.10e}"
                          f"{sbij[nv, 0, 0].imag:18.10e}\n")
            m = 0
            for k in range(3):
                for l in range(3):
                    t5 = (tmat[it, k] @ aij[ief]) \
                        @ (np.conj(tmat[jt, l]).T @ sbji[ief])
                    t6 = (tmat[it, k] @ sbij[ief]) \
                        @ (np.conj(tmat[jt, l]).T @ aji[ief])
                    total[m] += np.trace(t5 + t6).real
                    m += 1
        fre.close()
        fim.close()
        return total


def _real_sph(l, m, theta, phi):
    """Real spherical harmonics, standard convention (math.f90
    ``real_spharm`` :516-615): S_{l,m>0} = sqrt2 (-1)^m Re Y_l^m,
    S_{l,0} = Y_l^0, S_{l,m<0} = sqrt2 (-1)^m Im Y_l^|m|."""
    try:
        from scipy.special import sph_harm_y
        y = sph_harm_y(l, abs(m), theta, phi)
    except ImportError:  # older scipy
        from scipy.special import sph_harm
        y = sph_harm(abs(m), l, phi, theta)
    if m > 0:
        return np.sqrt(2.0) * (-1.0) ** m * y.real
    if m < 0:
        return np.sqrt(2.0) * (-1.0) ** m * y.imag
    return y.real


_GAUNT_CACHE = {}


def real_gaunt(l1, l2, l3, m1, m2, m3):
    """Real Gaunt coefficient int S_{l1 m1} S_{l2 m2} S_{l3 m3} dOmega
    by exact spherical quadrature (replaces the reference's
    ``realgaunt`` case analysis, math.f90 :330-484; both use the same
    standard real-harmonic convention so the coefficients agree)."""
    key = (l1, l2, l3, m1, m2, m3)
    if key in _GAUNT_CACHE:
        return _GAUNT_CACHE[key]
    xs, ws = np.polynomial.legendre.leggauss(24)
    theta = np.arccos(xs)[:, None]
    nphi = 64
    phi = (2.0 * np.pi * np.arange(nphi) / nphi)[None, :]
    f = (_real_sph(l1, m1, theta, phi) * _real_sph(l2, m2, theta, phi)
         * _real_sph(l3, m3, theta, phi))
    val = float(np.sum(ws[:, None] * f) * 2.0 * np.pi / nphi)
    _GAUNT_CACHE[key] = val
    return val


def _orb_order(l_max):
    """(l, m)-slot -> cubic orbital index table (``disp_matrix``
    :order block: p ordered (3,4,2), d ordered (5,6,9,7,8))."""
    order = np.zeros((l_max + 1, 2 * l_max + 1), dtype=int)
    for l in range(l_max + 1):
        if l == 0:
            order[0, 0] = 1
        elif l == 1:
            order[1, :3] = [3, 4, 2]
        elif l == 2:
            order[2, :5] = [5, 6, 9, 7, 8]
        else:
            for j in range(-l, l + 1):
                order[l, l + j] = l * l + l + j + 1
    return order


def disp_matrix(lmax, ws_radius, disp_vec):
    """Displacement (Laplace-expansion) matrix of the structure-constant
    gradient (``symbolic_atom.f90 disp_matrix``).  Returns (2K, 2K)
    with K = (lmax+1)^2, spin-block-diagonal."""
    from scipy.special import factorial2

    k = (lmax + 1) ** 2
    nrm = np.linalg.norm(disp_vec)
    u = np.zeros(3) if nrm == 0 else np.asarray(disp_vec, float) / nrm
    # direction angles for real_spharm(unit_disp, 1, m)
    theta = np.arccos(np.clip(u[2], -1, 1)) if nrm else 0.0
    phi = np.arctan2(u[1], u[0]) if nrm else 0.0
    order = _orb_order(lmax)
    mat_b = np.zeros((k, k), dtype=np.complex128)
    for li in range(lmax + 1):  # l'
        for lj in range(lmax + 1):  # l
            if li > lj:
                continue
            fac = (factorial2(max(2 * lj - 1, 0))
                   / factorial2(max(2 * li - 1, 0)))
            for mi in range(-li, li + 1):
                for mj in range(-lj, lj + 1):
                    acc = 0.0
                    for mm in (-1, 0, 1):
                        acc += (real_gaunt(lj, li, 1, mj, mi, mm)
                                * float(_real_sph(1, mm, theta, phi)))
                    mat_b[order[li, mi + li] - 1,
                          order[lj, mj + lj] - 1] += fac * acc
    mat_b *= -4.0 * np.pi / (3.0 * ws_radius)
    out = np.zeros((2 * k, 2 * k), dtype=np.complex128)
    out[:k, :k] = mat_b
    out[k:, k:] = mat_b
    return out


def p_matrix(pot, lmax, ene):
    """Diagonal LMTO potential function P(E) = (E - C - vmad)/Delta^2
    per (l, m, s) (``symbolic_atom.f90 p_matrix``).  (NE, 2K) diag."""
    k = (lmax + 1) ** 2
    ne = len(ene)
    p = np.zeros((ne, 2 * k), dtype=np.complex128)
    for s in range(2):
        for l in range(lmax + 1):
            c = pot.c[l, s] + pot.vmad
            d2 = pot.dele[l, s] ** 2
            for m in range(2 * l + 1):
                mls = l * l + m + k * s
                p[:, mls] = (ene - c) / d2
    return p


def transform_pmatrix(p, scr_in, scr_out, lmax):
    """P^beta = P^alpha / (1 + (alpha - beta) P^alpha) per diagonal
    entry (``transform_pmatrix``); scr arrays (lmax+1, 2)."""
    k = (lmax + 1) ** 2
    out = np.zeros_like(p)
    for s in range(2):
        for l in range(lmax + 1):
            d = scr_in[l, s] - scr_out[l, s]
            for m in range(2 * l + 1):
                mls = l * l + m + k * s
                out[:, mls] = p[:, mls] / (1.0 + d * p[:, mls])
    return out


def torque_operator_collinear(atoms) -> np.ndarray:
    """Collinear SOC torque operators T^x/T^y/T^z per type
    (``hamiltonian.f90 torque_operator_collinear`` :1429-1475).

    Returns (ntype, 3, 18, 18).  The prefactor is 0.5 sqrt(xi_p1 xi_p2)
    on the p block and 0.5 sqrt(xi_d1 xi_d2) on the d block; mixed-l
    blocks are irrelevant because L is block-diagonal in l (the
    reference's stale-prefactor carry-over multiplies exact zeros).
    """
    from ..physics.harmonics import L_X, L_Y, L_Z, cart2sph

    lx = cart2sph(L_X)
    ly = cart2sph(L_Y)
    lz = cart2sph(L_Z)
    ntype = len(atoms)
    tmat = np.zeros((ntype, 3, 18, 18), np.complex128)
    for t, at in enumerate(atoms):
        pot = at.potential
        soc_p = 0.5 * np.sqrt(pot.xi_p[0] * pot.xi_p[1])
        soc_d = 0.5 * np.sqrt(pot.xi_d[0] * pot.xi_d[1])
        pref = np.zeros((9, 9))
        pref[1:4, 1:4] = soc_p
        pref[4:9, 4:9] = soc_d
        plx = pref * lx
        ply = pref * ly
        plz = pref * lz
        # T^x
        tmat[t, 0, :9, :9] = 2j * ply
        tmat[t, 0, :9, 9:] = -2.0 * plz
        tmat[t, 0, 9:, :9] = 2.0 * plz
        tmat[t, 0, 9:, 9:] = -2j * ply
        # T^y
        tmat[t, 1, :9, :9] = -2j * plx
        tmat[t, 1, :9, 9:] = 2j * plz
        tmat[t, 1, 9:, :9] = 2j * plz
        tmat[t, 1, 9:, 9:] = 2j * plx
        # T^z
        tmat[t, 2, :9, 9:] = 2.0 * (plx - 1j * ply)
        tmat[t, 2, 9:, :9] = -2.0 * (plx + 1j * ply)
    return tmat
