"""Impurity-path validation.

The stored B2FeCo references predate the committed inputs (the example's
``Fe-imp.nml`` is absent and the committed ``*_out.nml`` don't match
ref.json), so the impurity machinery is validated internally: an
"impurity" of the SAME species as the host placed on a host site must
reproduce the bulk calculation exactly — newclu reordering, the local
Hamiltonian zone (hall), and the mixed local/bulk SpMV all cancel out.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

from rslmtoasa.config import JobConfig
from rslmtoasa.models.bulk import BulkSystem
from rslmtoasa.models.scf import SelfConsistency
from rslmtoasa.utils.namelist import read_namelists


def _base_cfg(reference_dir, calctype):
    case = reference_dir / "tests/regression/bccFe_lanczos"
    cfg = JobConfig.from_file(str(case / "input.nml"))
    cfg.control.calctype = calctype
    cfg.control.nsp = 2
    cfg.control.recur = "block"
    cfg.control.lld = 12
    cfg.scf.nstep = 1
    cfg.lattice.rc = 20.0
    cfg.lattice.ndim = 6000
    cfg.energy.channels_ldos = 800
    # identical fixed Fermi level in both runs so the comparison is exact
    cfg.energy.fix_fermi = True
    return cfg


def test_same_species_impurity_matches_bulk(reference_dir):
    case = reference_dir / "tests/regression/bccFe_lanczos"
    # bulk run
    wd_b = tempfile.mkdtemp(prefix="rslmto_blk_")
    cfg_b = _base_cfg(reference_dir, "B")
    cfg_b.atoms.database = str(case)
    sys_b = BulkSystem.build(cfg_b, wd_b)
    scf_b = SelfConsistency(sys_b, wd_b)
    scf_b.run()

    # impurity run: Fe "impurity" at the origin of the same bcc Fe host
    wd_i = tempfile.mkdtemp(prefix="rslmto_imp_")
    shutil.copy(case / "Fe.nml", os.path.join(wd_i, "Fe.nml"))
    shutil.copy(case / "Fe.nml", os.path.join(wd_i, "FeX.nml"))
    cfg_i = _base_cfg(reference_dir, "I")
    cfg_i.atoms.database = wd_i
    cfg_i.atoms.labels = ["Fe", "FeX"]
    cfg_i.lattice.nclu = 1
    cfg_i.lattice.inclu = np.zeros((1, 3))
    cfg_i.energy.fix_fermi = True
    cfg_i.energy.fermi = cfg_b.energy.fermi
    sys_i = BulkSystem.build(cfg_i, wd_i)
    cl = sys_i.cluster
    assert cl.nmax > 0 and cl.nbas > 0 and cl.nrec == 1
    scf_i = SelfConsistency(sys_i, wd_i)
    scf_i.run()

    # impurity must reproduce the host electronic structure
    pot_b = sys_b.atoms[0].potential
    pot_i = sys_i.atoms[1].potential  # FeX, the "impurity"
    assert pot_i.ql[0] == pytest.approx(pot_b.ql[0], abs=2e-6)
    assert pot_i.pl == pytest.approx(pot_b.pl, abs=2e-6)
    assert pot_i.etot == pytest.approx(pot_b.etot, abs=1e-5)
