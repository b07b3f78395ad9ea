"""Kubo-Bastin conductivity from 2-D Chebyshev moments.

Implements the reference ``post_processing='conductivity'`` pipeline:

* real-space velocity operators v = -i (d.r_ij) H_ij per neighbor slot
  (``hamiltonian.f90 build_realspace_velocity_operators`` :1308-1368),
  optional spin-current symmetrisation j^S = 1/2 {S_pol, v},
* two-sided Chebyshev moment matrix mu_nm = <r| T_m(H~) v_a T_n(H~) v_b |r>
  per type (``recursion.f90 compute_moments_stochastic`` :979-1234:
  all left vectors T_m|r> are stored; the right chain applies
  v_b then T_n then v_a),
* Gamma_nm(E) per PRL 114, 116602 (2015) with the Lorentz kernel
  (lambda = 6) and the (1 - w^2)^-2 factor
  (``conductivity.f90 calculate_gamma_nm`` :158-224),
* sigma(E): cumulative Fermi-weighted Simpson integral of
  sum_nm Gamma_nm mu_nm with factor 16/(pi dE^2), written to
  ``cond_total.out`` and per-type ``<El>_cond.out``
  (``calculate_conductivity_tensor`` :226-376).
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import JobConfig
from ..physics.energy_mesh import EnergyMesh
from ..physics.harmonics import cart2sph, L_X, L_Y, L_Z
from ..ops.chebyshev import lorentz_kernel
from ..utils.logger import g_logger
from ..utils.timer import g_timer
from .bulk import BulkSystem

#: spin operators in the 18x18 spinor basis (math.f90 S_x/S_y/S_z :200-280)
S_Z = np.zeros((18, 18), dtype=np.complex128)
S_Z[:9, :9] = np.eye(9) * 0.5
S_Z[9:, 9:] = -np.eye(9) * 0.5
S_X = np.zeros((18, 18), dtype=np.complex128)
S_X[:9, 9:] = np.eye(9) * 0.5
S_X[9:, :9] = np.eye(9) * 0.5
S_Y = np.zeros((18, 18), dtype=np.complex128)
S_Y[:9, 9:] = -0.5j * np.eye(9)
S_Y[9:, :9] = 0.5j * np.eye(9)


def build_velocity_operators(sys: BulkSystem, v_alpha, v_beta,
                             velocity_scale=None):
    """Velocity-operator ELL blocks (v_a, v_b) per type/slot, plus the
    HoH overlap tables vo = v @ obarm[type(j)] per neighbor slot
    (``build_realspace_velocity_operators`` :1355-1360) when the
    Hamiltonian carries HoH data (zeros otherwise)."""
    cl = sys.cluster
    hb = sys.ham
    ntype, nslots = hb.ee.shape[0], hb.ee.shape[1]
    v_a = np.zeros_like(hb.ee)
    v_b = np.zeros_like(hb.ee)
    vo_a = np.zeros_like(hb.ee)
    vo_b = np.zeros_like(hb.ee)
    dir_a = np.asarray(v_alpha, float)
    dir_a /= np.linalg.norm(dir_a)
    dir_b = np.asarray(v_beta, float)
    dir_b /= np.linalg.norm(dir_b)
    if velocity_scale is None:
        velocity_scale = np.ones(ntype)
    hoh = hb.obarm is not None
    for t in range(ntype):
        ia = int(cl.atlist[t]) - 1
        nd = cl.dirs[int(cl.num[ia]) - 1].shape[0]
        for m in range(1, nd + 1):
            jj = int(cl.nn[ia, m - 1])
            if jj < 0:
                continue
            rij = cl.wrap_diff((cl.cr_ang[ia] - cl.cr_ang[jj]))
            dot_a = float(dir_a @ rij)
            dot_b = float(dir_b @ rij)
            v_a[t, m] = (1.0 / 1j) * dot_a * hb.ee[t, m]
            jt = int(cl.iz[jj]) - 1
            vsc = max(velocity_scale[t], velocity_scale[jt])
            v_b[t, m] = (1.0 / 1j) * dot_b * hb.ee[t, m] * vsc
            if hoh:
                vo_a[t, m] = v_a[t, m] @ hb.obarm[jt]
                vo_b[t, m] = v_b[t, m] @ hb.obarm[jt]
    return v_a, v_b, vo_a, vo_b


def spin_current(v: np.ndarray, pol: str = "z") -> np.ndarray:
    """j^S = 1/2 {S_pol, v} applied per slot block."""
    s_op = {"x": S_X, "y": S_Y, "z": S_Z}[pol]
    return 0.5 * (np.einsum("ab,tmbc->tmac", s_op, v)
                  + np.einsum("tmab,bc->tmac", v, s_op))


def _l_op18(pol: str) -> np.ndarray:
    """L_pol in spherical harmonics, spin-block-diagonal 18x18
    (``select_orbital_operator``)."""
    l9 = cart2sph({"x": L_X, "y": L_Y, "z": L_Z}[pol])
    out = np.zeros((18, 18), np.complex128)
    out[:9, :9] = l9
    out[9:, 9:] = l9
    return out


def orbital_current(v: np.ndarray, pol: str = "z") -> np.ndarray:
    """j^L = 1/2 {L_pol, v} per slot
    (``build_realspace_orbital_velocity_operators`` :568-654)."""
    l_op = _l_op18(pol)
    return 0.5 * (np.einsum("ab,tmbc->tmac", l_op, v)
                  + np.einsum("tmab,bc->tmac", v, l_op))


def _onsite_table(op: np.ndarray, like: np.ndarray) -> np.ndarray:
    out = np.zeros_like(like)
    out[:, 0] = op[None]
    return out


def build_kubo_operator(sys: BulkSystem, op_type: str, pol: str,
                        v_dir, velocity_scale=None):
    """ELL operator tables ``(op, op_o)`` for one Kubo slot
    (``recursion.f90 set_kubo_operator_slot`` :242-585 + the
    hamiltonian builders :490-840).  ``op_o`` is the HoH overlap
    companion used by ``velo_hoh_vec_matmul`` (zeros when HoH is off
    or the operator has no overlap image).

    op_type: charge | spin | orbital | spin_accumulation |
    orbital_accumulation | spin_torque | spin_soc_torque |
    orbital_torque.
    """
    hb = sys.ham
    v, _, vo, _ = build_velocity_operators(sys, v_dir, v_dir,
                                           velocity_scale)
    s_op = {"x": S_X, "y": S_Y, "z": S_Z}.get(pol, S_Z)
    ntype = hb.ee.shape[0]
    lsh = hb.lsham if hb.lsham is not None else np.zeros(
        (ntype, 18, 18), np.complex128)
    zeros = np.zeros_like(hb.ee)
    if op_type == "charge":
        return v, vo
    if op_type == "spin":
        # jso = 1/2 {S, vo} (build_realspace_spin_operators :532-549)
        return spin_current(v, pol), spin_current(vo, pol)
    if op_type == "orbital":
        return orbital_current(v, pol), orbital_current(vo, pol)
    if op_type == "spin_accumulation":
        # bare S_pol on the onsite slot; no overlap image (vo_a zeroed,
        # compute_moments_stochastic :1046-1051)
        return _onsite_table(s_op, hb.ee), zeros
    if op_type == "orbital_accumulation":
        return _onsite_table(_l_op18(pol), hb.ee), zeros
    if op_type in ("spin_soc_torque", "soc_spin_torque"):
        # (1/i)[S_pol, H_soc] on the onsite slot (:658-703); in HoH the
        # reference reuses the same operator as its overlap container
        out = np.zeros_like(hb.ee)
        out[:, 0] = (1.0 / 1j) * (np.einsum("ab,tbc->tac", s_op, lsh)
                                  - np.einsum("tab,bc->tac", lsh, s_op))
        return out, (out.copy() if hb.obarm is not None else zeros)
    if op_type == "spin_torque":
        # (1/i)[S_pol, hxc] per slot, hxc = spin-odd (exchange-field)
        # part of each block: ee - I2 (x) (uu + dd)/2 (:711-763;
        # hxc assembly build_bulkham :1573-1576).  The HoH o-table is
        # disabled in the reference (:745-756 commented out).
        hxc = hb.ee.copy()
        h0 = 0.5 * (hb.ee[:, :, :9, :9] + hb.ee[:, :, 9:, 9:])
        hxc[:, :, :9, :9] -= h0
        hxc[:, :, 9:, 9:] -= h0
        return (1.0 / 1j) * (np.einsum("ab,tmbc->tmac", s_op, hxc)
                             - np.einsum("tmab,bc->tmac", hxc, s_op)), zeros
    if op_type == "orbital_torque":
        # (1/i)[L_pol, H] with lsham added on the onsite slot (:773-825);
        # HoH o-table is the same commutator over eeo (:807-818)
        l_op = _l_op18(pol)
        h = hb.ee.copy()
        h[:, 0] += lsh
        out = (1.0 / 1j) * (np.einsum("ab,tmbc->tmac", l_op, h)
                            - np.einsum("tmab,bc->tmac", h, l_op))
        if hb.obarm is not None and hb.eeo is not None:
            ho = hb.eeo.copy()
            ho[:, 0] += lsh
            out_o = (1.0 / 1j) * (np.einsum("ab,tmbc->tmac", l_op, ho)
                                  - np.einsum("tmab,bc->tmac", ho, l_op))
        else:
            out_o = zeros
        return out, out_o
    raise ValueError(f"unknown Kubo operator type {op_type!r}")


class ConductivityCalculation:
    def __init__(self, sys: BulkSystem, workdir: str = "."):
        self.sys = sys
        self.cfg = sys.cfg
        self.workdir = workdir

    # ------------------------------------------------------------------
    def run(self, cond_type: str = "charge", pol_alpha: str = "z"):
        cfg = self.cfg
        sys = self.sys
        cl = sys.cluster
        emesh = EnergyMesh.build(cfg.energy)
        sys.build_hamiltonian()
        hb = sys.ham

        nml = cfg.namelists.get("hamiltonian")
        v_alpha = np.array([0.0, 1.0, 0.0])
        v_beta = np.array([1.0, 0.0, 0.0])
        pol_beta = "z"
        if nml is not None:
            va = np.zeros(3)
            vb = np.zeros(3)
            if nml.has("v_alpha"):
                nml.fill_array("v_alpha", va)
                v_alpha = va
            if nml.has("v_beta"):
                nml.fill_array("v_beta", vb)
                v_beta = vb
            if nml.has("pol_alpha"):
                pol_alpha = str(nml.get_scalar("pol_alpha", pol_alpha))
            if nml.has("pol_beta"):
                pol_beta = str(nml.get_scalar("pol_beta", pol_beta))
        # slot b carries linear_in, slot a linear_out
        # (setup_kubo_operators :242-260); legacy cond_type='spin'
        # shorthand maps to a spin-current output slot
        linear_out = cfg.control.linear_out
        linear_in = cfg.control.linear_in
        if cond_type == "spin" and linear_out == "charge":
            linear_out = "spin"
        v_a, vo_a = build_kubo_operator(sys, linear_out, pol_alpha, v_alpha)
        v_b, vo_b = build_kubo_operator(sys, linear_in, pol_beta, v_beta)

        cond_ll = cfg.control.cond_ll
        a = (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3)
        b = (emesh.energy_max + emesh.energy_min) / 2.0

        with g_timer.section("kubo-moments"):
            mu_nm = self.compute_moments(v_a, v_b, a, b, cond_ll,
                                         vo_a=vo_a, vo_b=vo_b)

        with g_timer.section("gamma-and-integrals"):
            self.conductivity_tensor(mu_nm, emesh, a, b, cond_ll)
        return mu_nm

    # ------------------------------------------------------------------
    def compute_moments(self, v_a, v_b, a, b, cond_ll, *,
                        vo_a=None, vo_b=None):
        """mu_nm (18, 18, n, m, ntype): two-sided Chebyshev moments.

        Per-type unit-block start vectors (``cond_calctype='per_type'``),
        complex128 throughout (``ops/kubo.py``); the scaled-H application
        is the same block SpMV as the recursion engines.  When the Hamiltonian carries HoH data the
        whole chain switches to the HoH-corrected H and v - vo.(h .)
        velocity applications (ham_hoh_vec_matmul /
        velo_hoh_vec_matmul, recursion.f90:656-912).
        """
        sys = self.sys
        cl = sys.cluster
        hb = sys.ham
        ntype = hb.ee.shape[0]
        iz = np.asarray(hb.iz)
        cols = np.asarray(hb.cols)
        lsh = hb.lsham if hb.lsham is not None else np.zeros(
            (ntype, 18, 18), np.complex128)
        hoh = bool(self.cfg.hamiltonian.hoh) and hb.eeo is not None
        enim = hb.enim if hb.enim is not None else np.zeros_like(lsh)
        eeo = hb.eeo if hb.eeo is not None else np.zeros_like(hb.ee)
        if vo_a is None:
            vo_a = np.zeros_like(v_a)
        if vo_b is None:
            vo_b = np.zeros_like(v_b)

        from ..ops.kubo import kubo_moments
        from ..parallel.dispatch import get_mesh, memory_budget

        jb = jnp.asarray(hb.ee)
        jlsh = jnp.asarray(lsh)
        jva = jnp.asarray(v_a)
        jvb = jnp.asarray(v_b)
        jvoa = jnp.asarray(vo_a)
        jvob = jnp.asarray(vo_b)
        jeeo = jnp.asarray(eeo)
        jenim = jnp.asarray(enim)
        # bound the stored left block: each right-chain replay costs a
        # full cond_ll of H SpMVs, so make the block as large as memory
        # allows (a quarter of the device, a fixed share of host RAM on
        # the CPU backend)
        budget = memory_budget(0.25, 24 << 30)
        per_vec = cl.kk * 18 * 18 * 16
        block_size = int(min(cond_ll, max(8, budget // per_vec)))
        jiz = jnp.asarray(iz)
        jcols = jnp.asarray(cols)
        # start-vector mode: per-type unit blocks, or random-phase trace
        # sampling (cond_calctype='random_vec',
        # compute_moments_stochastic :1120-1143: one phase per atom on
        # all 18 diagonal orbitals, normalised by sqrt(kk)).  The RNG is
        # seeded for self-reproducibility (the reference reseeds from
        # the OS per run).
        calctype = getattr(self.cfg.control, "cond_calctype", "per_type")
        nvec = int(getattr(self.cfg.control, "random_vec_num", 1))
        loop_over = ntype if calctype == "per_type" else nvec
        rng = np.random.default_rng(20260821)
        mu = np.zeros((18, 18, cond_ll, cond_ll, loop_over), np.complex128)

        def _psiref(t):
            """Start block, complex (kk, 18, 18)."""
            if calctype == "per_type":
                j = int(cl.atlist[t]) - 1
                p = np.zeros((cl.kk, 18, 18), np.complex128)
                p[j] = np.eye(18)
                return p
            ph = np.exp(2j * np.pi * rng.random(cl.kk)) \
                / np.sqrt(float(cl.kk))
            pc = np.zeros((cl.kk, 18, 18), np.complex128)
            idx = np.arange(18)
            pc[:, idx, idx] = ph[:, None]
            return pc

        def _one(psiref_dev):
            return kubo_moments(
                jb, jlsh, jiz, jcols, jva, jvb, psiref_dev,
                n_moments=cond_ll, block_size=block_size,
                a=float(a), b=float(b),
                hoh=hoh, vo_a=jvoa, vo_b=jvob, blocks_o=jeeo,
                enim=jenim,
            )

        mesh = get_mesh()
        if mesh is not None and loop_over > 1:
            # type / random-vector partition over the device mesh (the
            # reference's get_mpi_variables(rank, ntype),
            # calculation.f90:1002): the per-unit start blocks become a
            # sharded batch axis
            from jax.sharding import NamedSharding, PartitionSpec as P

            ndev = int(np.prod(list(mesh.shape.values())))
            t_pad = -(-loop_over // ndev) * ndev
            refs = [_psiref(t) for t in range(loop_over)]
            stack = np.stack(refs + [refs[-1]] * (t_pad - loop_over))
            fn = jax.jit(jax.vmap(_one),
                         in_shardings=NamedSharding(mesh, P("chains")))
            mu_all = np.asarray(fn(jnp.asarray(stack)))[:loop_over]
            for t in range(loop_over):
                mu[:, :, :, :, t] = np.transpose(mu_all[t], (2, 3, 0, 1))
            g_logger.info(f"Kubo moments done for {loop_over} "
                          f"{calctype} units "
                          f"(mesh-sharded over {ndev} devices)")
            return mu
        for t in range(loop_over):
            mu_t = np.asarray(_one(jnp.asarray(_psiref(t))))
            # (n, m, 18, 18) -> mu[l1, l2, n, m]
            mu[:, :, :, :, t] = np.transpose(mu_t, (2, 3, 0, 1))
            g_logger.info(f"Kubo moments done for {calctype} unit {t + 1}")
        return mu

    # ------------------------------------------------------------------
    def conductivity_tensor(self, mu_nm, emesh, a, b, cond_ll):
        """Gamma_nm assembly + cumulative conductivity integrals."""
        cfg = self.cfg
        ene = emesh.ene
        w = (ene - b) / a
        acx = np.arccos(w)
        sq = np.sqrt(1.0 - w**2)
        kern = lorentz_kernel(cond_ll, 6.0)
        weights = np.ones(cond_ll)
        weights[0] = 0.5
        n_idx = np.arange(cond_ll)
        cn = (w[:, None] - 1j * n_idx[None, :] * sq[:, None]) \
            * np.exp(1j * n_idx[None, :] * acx[:, None])
        cm = (w[:, None] + 1j * n_idx[None, :] * sq[:, None]) \
            * np.exp(-1j * n_idx[None, :] * acx[:, None])
        tn = np.cos(n_idx[None, :] * acx[:, None])  # T_n(w)
        de = emesh.energy_max - emesh.energy_min
        factor = 16.0 / (np.pi * de**2)
        kw = kern * weights

        ntype = mu_nm.shape[4]
        npts = emesh.npts
        # integrand(E) per orbital: sum_nm Gamma_nm(E) mu_nm[l,l,n,m]
        # Gamma_nm(E) = (cn_n T_m + cm_m T_n)/(1-w^2)^2 * k_n k_m w_n w_m
        pref = 1.0 / (1.0 - w**2) ** 2
        diag_mu = np.einsum("llnmt->lnmt", mu_nm)  # (18, n, m, ntype)
        integrand_at = np.zeros((18, npts, ntype), np.complex128)
        for t in range(ntype):
            m1 = np.einsum("n,m,lnm->lnm", kw, kw, diag_mu[:, :, :, t])
            # sum_nm cn_n T_m mu_nm + cm_m T_n mu_nm
            term1 = np.einsum("en,em,lnm->le", cn, tn, m1)
            term2 = np.einsum("em,en,lnm->le", cm, tn, m1)
            integrand_at[:, :, t] = (term1 + term2) * pref[None, :] * factor

        per_type = getattr(cfg.control, "cond_calctype",
                           "per_type") == "per_type"
        self._write_outputs(integrand_at, emesh, w, per_type=per_type)
        return integrand_at

    # ------------------------------------------------------------------
    def _write_outputs(self, integrand_at, emesh, w, per_type=True):
        """Totals are averaged over the loop units (types or random
        vectors, conductivity.f90:322-328); the per-type files exist
        only for cond_calctype='per_type' (:331-371)."""
        from ..physics.quadrature import simpson_f_cumulative

        cfg = self.cfg
        ntype = integrand_at.shape[2]
        tot = integrand_at.sum(axis=2)  # (18, NE)
        tot_r = tot.real.sum(axis=0)
        tot_i = tot.imag.sum(axis=0)
        npts = emesh.npts
        a = (emesh.energy_max - emesh.energy_min) / (2.0 - 0.3)
        b = (emesh.energy_max + emesh.energy_min) / 2.0

        def cumulative(y):
            # cumulative Fermi-cut Simpson over the scaled variable w
            return simpson_f_cumulative(y, w, emesh.nv1)

        # orbital-resolved cumulative curves (calculate_conductivity_tensor
        # :300-376: cond_total_orb_real/im.out, 18 orbital columns)
        orb_r = np.stack([cumulative(tot[l].real) / ntype
                          for l in range(18)])
        orb_i = np.stack([cumulative(tot[l].imag) / ntype
                          for l in range(18)])
        for name, dat in (("cond_total_orb_real.out", orb_r),
                          ("cond_total_orb_im.out", orb_i)):
            with open(os.path.join(self.workdir, name), "w") as fh:
                for i in range(npts):
                    fh.write(f"{a * w[i] + b - emesh.fermi:16.6e}" + "".join(
                        f"{dat[l, i]:16.6e}" for l in range(18)) + "\n")
        for t in range(ntype if per_type else 0):
            sym = self.sys.atoms[t].element.symbol
            ot_r = np.stack([cumulative(integrand_at[l, :, t].real)
                             for l in range(18)])
            ot_i = np.stack([cumulative(integrand_at[l, :, t].imag)
                             for l in range(18)])
            for suff, dat in (("_cond_orb_real.out", ot_r),
                              ("_cond_orb_im.out", ot_i)):
                with open(os.path.join(self.workdir, sym + suff),
                          "w") as fh:
                    for i in range(npts):
                        fh.write(f"{a * w[i] + b - emesh.fermi:16.6e}"
                                 + "".join(f"{dat[l, i]:16.6e}"
                                           for l in range(18)) + "\n")

        cum_r = cumulative(tot_r) / ntype
        cum_i = cumulative(tot_i) / ntype
        with open(os.path.join(self.workdir, "cond_total.out"), "w") as fh:
            for i in range(npts):
                fh.write(f"{a * w[i] + b - emesh.fermi:16.6e}"
                         f"{cum_r[i]:16.6e}{cum_i[i]:16.6e}\n")
        for t in range(ntype if per_type else 0):
            sym = self.sys.atoms[t].element.symbol
            yr = integrand_at[:, :, t].real.sum(axis=0)
            yi = integrand_at[:, :, t].imag.sum(axis=0)
            cr = cumulative(yr)
            ci = cumulative(yi)
            with open(os.path.join(self.workdir, f"{sym}_cond.out"),
                      "w") as fh:
                for i in range(npts):
                    fh.write(f"{a * w[i] + b - emesh.fermi:16.6e}"
                             f"{cr[i]:16.6e}{ci[i]:16.6e}\n")
