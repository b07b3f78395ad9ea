"""PAOFLOW export/import round trip.

export_rs2pao writes the effective two-center blocks in cubic harmonics
(eV); import_paoflow must reconstruct exactly the exported operator:
ee[t, m>0] -> sph2cart(ee), ee[t, 0] -> sph2cart(ee_onsite + lsham).
"""

import numpy as np

from rslmtoasa.models.paoflow import export_rs2pao, import_paoflow
from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.physics.harmonics import sph2cart


def _cart(blk):
    out = blk.astype(np.complex128).copy()
    out[:9, :9] = sph2cart(out[:9, :9])
    out[:9, 9:] = sph2cart(out[:9, 9:])
    out[9:, :9] = sph2cart(out[9:, :9])
    out[9:, 9:] = sph2cart(out[9:, 9:])
    return out


def test_rs2pao_roundtrip(tmp_path):
    sys_ = build_synthetic_bcc(rc=9.0, lld=4, nsp=2)
    hb = sys_.ham
    cl = sys_.cluster
    ee_orig = hb.ee.copy()
    lsham = hb.lsham.copy()
    path = str(tmp_path / "rs2paoham.dat")
    export_rs2pao(sys_, path)

    import_paoflow(sys_, path)
    t = 0
    ia = int(cl.atlist[t]) - 1
    nd = cl.dirs[int(cl.num[ia]) - 1].shape[0]
    np.testing.assert_allclose(
        hb.ee[t, 0], _cart(ee_orig[t, 0] + lsham[t]), atol=1e-10
    )
    for m in range(1, nd + 1):
        np.testing.assert_allclose(
            hb.ee[t, m], _cart(ee_orig[t, m]), atol=1e-10
        )
