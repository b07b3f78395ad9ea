"""ctypes bindings for the native (C++) atomic-sphere solver.

The library is built on demand with g++ (no pybind11 dependency); set
``RSLMTO_NO_NATIVE=1`` to force the pure-Python path (used by the
cross-validation tests).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "radial.cpp")
_LIB = os.path.join(_DIR, "libradial.so")

_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    cmd = ["g++", "-O2", "-shared", "-fPIC", _SRC, "-o", _LIB]
    subprocess.run(cmd, check=True, capture_output=True)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if os.environ.get("RSLMTO_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    try:
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_LIB)
    except Exception:
        return None
    d = ctypes.c_double
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rsl_mesh_size.restype = ctypes.c_int
    lib.rsl_mesh_size.argtypes = [d, d, d]
    lib.rsl_mesh_b.restype = d
    lib.rsl_mesh_b.argtypes = [d, d, ctypes.c_int]
    lib.rsl_atomsc.restype = ctypes.c_int
    lib.rsl_atomsc.argtypes = [
        d, ctypes.c_int, d, d, dp, dp,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        dp, dp, dp, dp, dp, ip,
    ]
    lib.rsl_potpar.restype = ctypes.c_int
    lib.rsl_potpar.argtypes = [d, ctypes.c_int, d, d, dp, dp, dp,
                               ctypes.c_int, dp, dp, dp, dp, dp, dp]
    lib.rsl_racsi.restype = ctypes.c_int
    lib.rsl_racsi.argtypes = [d, d, dp, ctypes.c_int, dp, dp, dp]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


def atomsc_native(z, lmax, a, ws_r, pl, ql, ifcore=0, txc=1, nsp=2,
                  niter=80):
    """Native atomsc; returns an object mirroring
    :class:`rslmtoasa.physics.atomsphere.AtomSCFResult`."""
    from ..physics.atomsphere import AtomSCFResult

    lib = get_lib()
    assert lib is not None
    nl = lmax + 1
    nr = lib.rsl_mesh_size(float(z), float(ws_r), float(a))
    pl_c = np.ascontiguousarray(pl, dtype=np.float64)
    ql_c = np.ascontiguousarray(ql, dtype=np.float64)
    energies = np.zeros(8)
    v = np.zeros((nr, 2))
    rofi = np.zeros(nr)
    fun2 = np.zeros((nr, nl, 2))
    vzt = np.zeros((nr, 2))
    nr_out = ctypes.c_int(0)
    lib.rsl_atomsc(
        float(z), lmax, float(a), float(ws_r), pl_c, ql_c,
        int(ifcore), int(txc), int(nsp), int(niter),
        energies, v.reshape(-1), rofi, fun2.reshape(-1), vzt.reshape(-1),
        ctypes.byref(nr_out),
    )
    res = AtomSCFResult()
    (res.etot, res.utot, res.ekin, res.rhoeps, res.sumev, res.sumec,
     vr0, vr1) = energies
    res.vrmax = np.array([vr0, vr1])
    res.v = v
    res.rofi = rofi
    res.fun2 = fun2
    res.vzt = vzt
    res.nr = nr
    return res


def potpar_native(z, lmax, a, ws_r, pnu, v, rofi):
    lib = get_lib()
    assert lib is not None
    nr = rofi.shape[0]
    nl = lmax + 1
    out = {k: np.zeros((nl, 2)) for k in
           ("enu", "c", "srdel", "qpar", "ppar", "vl")}
    lib.rsl_potpar(
        float(z), lmax, float(a), float(ws_r),
        np.ascontiguousarray(pnu, dtype=np.float64),
        np.ascontiguousarray(v, dtype=np.float64).reshape(-1),
        np.ascontiguousarray(rofi, dtype=np.float64), nr,
        out["enu"].reshape(-1), out["c"].reshape(-1),
        out["srdel"].reshape(-1), out["qpar"].reshape(-1),
        out["ppar"].reshape(-1), out["vl"].reshape(-1),
    )
    return out


def racsi_native(a, b, rofi, fun2, vzt):
    lib = get_lib()
    assert lib is not None
    qsl = np.zeros(6)
    lib.rsl_racsi(
        float(a), float(b),
        np.ascontiguousarray(rofi, dtype=np.float64), rofi.shape[0],
        np.ascontiguousarray(fun2, dtype=np.float64).reshape(-1),
        np.ascontiguousarray(vzt, dtype=np.float64).reshape(-1),
        qsl,
    )
    return qsl
