"""Geometry artifact exports: formats and Fortran record framing."""

import os
import struct

import numpy as np

from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.utils import artifacts


def _read_records(path):
    out = []
    with open(path, "rb") as fh:
        while True:
            head = fh.read(4)
            if not head:
                break
            n = struct.unpack("<i", head)[0]
            payload = fh.read(n)
            tail = struct.unpack("<i", fh.read(4))[0]
            assert tail == n, "record framing mismatch"
            out.append(payload)
    return out


def test_geometry_exports(tmp_path):
    sys_ = build_synthetic_bcc(rc=8.0, lld=4)
    cl = sys_.cluster
    artifacts.export_geometry(sys_, str(tmp_path))

    # clust: header + two atoms per line (lattice.f90 formats 300/200)
    lines = open(os.path.join(tmp_path, "clust")).read().splitlines()
    kk_even = cl.kk - (cl.kk % 2)
    assert lines[0].strip().startswith("II =")
    assert int(lines[0].split("=")[1]) == kk_even
    assert len(lines) == 1 + kk_even // 2
    first = lines[1]
    x = float(first[:14])
    np.testing.assert_allclose(x, cl.cr[0, 0], atol=5e-9)

    # map: one record per atom, int32, count slot first
    recs = _read_records(os.path.join(tmp_path, "map"))
    assert len(recs) == cl.kk
    row0 = np.frombuffer(recs[0], np.int32)
    assert row0[0] == len(row0)
    present = cl.nn[0][cl.nn[0] >= 0] + 1
    np.testing.assert_array_equal(row0[1:], present)

    # sbar: 9-double rows, row-wise per block
    srecs = _read_records(os.path.join(tmp_path, "sbar"))
    assert all(len(r) == 9 * 8 for r in srecs)
    blk0 = np.stack([np.frombuffer(r, np.float64) for r in srecs[:9]])
    np.testing.assert_allclose(blk0, np.asarray(sys_.sbars[0][0]),
                               atol=1e-12)

    # str.out header content
    txt = open(os.path.join(tmp_path, "str.out")).read()
    assert "LATTICE COORDINATES" in txt and f"ndi= {cl.kk}" in txt

    # mad.mat framing
    amad = np.arange(9.0).reshape(3, 3)
    artifacts.write_mad_mat(amad, os.path.join(tmp_path, "mad.mat"))
    mrecs = _read_records(os.path.join(tmp_path, "mad.mat"))
    got = np.stack([np.frombuffer(r, np.float64) for r in mrecs])
    np.testing.assert_array_equal(got, amad)


def test_artifacts_flag_gate(tmp_path):
    sys_ = build_synthetic_bcc(rc=8.0, lld=4)
    cfg = sys_.cfg
    assert not artifacts.wanted(cfg)
    cfg.lattice.write_artifacts = True
    assert artifacts.wanted(cfg)
