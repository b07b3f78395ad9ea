#!/usr/bin/env python3
"""Smoke test of the CLI pipeline on one GPU, checked against the CPU.

Drives the product entry point (``rslmtoasa.cli.run_calculation``) on
input decks written from the synthetic bcc preset at the width of the bcc
block case (rc 80: kk 5984, nnmax 14), in native complex128, one phase
at a time:

1. ``scf_block``       SCF, nsp 2, block recursion, HoH, 2 iterations
2. ``scf_chebyshev``   the same with Chebyshev moments, lld 50
3. ``scf_lanczos``     scalar Lanczos SCF (nsp 1), 1 iteration
4. ``exchange``        Jij/DMI pairs on the output of phase 1
5. ``conductivity``    Kubo-Bastin sigma(E), cond_ll 200
6. ``spin_dynamics``   processing='sd', 2 steps
7. ``pytest_gpu``      ``pytest -m gpu`` in this process

Each phase prints its wall time, its compile time, the device's
``peak_bytes_in_use`` and its largest deviation from a CPU complex128 run
of the same input in the same process (``jax.devices("cpu")``):
first-iteration recursion coefficients at 1e-9 absolute (phases 1-3),
observables (``X_out.nml``, ``jij.out``/``dij.out``, ``cond_total.out``,
the spin trajectory) at the repo's 1e-6 abs/rel parity tolerance.  The
conductivity comparison runs at a reduced width (both widths printed).

``--four-cards`` runs only the chain-sharded mesh path instead (scalar
Lanczos chains, the exchange pair driver and ``lanczos_rowsharded``,
each against one card at 1e-10).  ``--compile-only`` compiles each
phase's recursion engine at its full-width shapes, prints
``memory_analysis()`` and stops.

The last stdout line is one JSON object ``{"ok": ..., "device": {...}}``.
Exits nonzero, printing no result, when JAX finds no GPU.

Usage::

    python3 chip_smoke.py [--four-cards | --compile-only]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass

COEF_TOL = 1e-9
OBS_TOL = 1e-6  # abs and rel, the repo's parity tolerance
MESH_TOL = 1e-10

#: phases in run order; ``exchange`` runs in the workdir of ``scf_block``
PHASES = ("scf_block", "scf_chebyshev", "scf_lanczos", "exchange",
          "conductivity", "spin_dynamics", "pytest_gpu")

#: energy window that contains the synthetic spectrum, as the Chebyshev
#: divergence guard requires
WIDE_WINDOW = {"energy_min": -3.0, "energy_max": 2.0}


@dataclass
class Sizes:
    """Widths of a run.  ``rc`` is the squared cut radius in lattice
    units (80 -> kk 5984); ``ref_rc`` is the width of the CPU comparison
    of observables and ``cond_ref_rc`` that of the conductivity."""

    rc: float = 80.0
    ref_rc: float = 80.0
    cond_ref_rc: float = 12.0  # kk 338: cond_ll 200 on the CPU fits
    pairs: int = 8
    cond_ll: int = 200


def phase_deck(name: str, sizes: Sizes) -> dict:
    """Keyword arguments of ``write_synthetic_bcc_inputs`` for a phase."""
    if name == "scf_block":
        return dict(nsp=2, recur="block", lld=20, hoh=True, nstep=2)
    if name == "scf_chebyshev":
        return dict(nsp=2, recur="chebyshev", lld=50, hoh=True, nstep=2,
                    extra={"energy": dict(WIDE_WINDOW)})
    if name == "scf_lanczos":
        return dict(nsp=1, recur="lanczos", lld=20, nstep=1)
    if name == "exchange":
        import numpy as np

        pairs = np.stack([np.ones(sizes.pairs, np.int64),
                          np.arange(2, sizes.pairs + 2)], axis=1)
        return dict(nsp=2, recur="block", lld=20, hoh=True, extra={
            "calculation": {"post_processing": "exchange"},
            "lattice": {"njij": sizes.pairs, "ijpair": pairs}})
    if name == "conductivity":
        return dict(nsp=2, recur="chebyshev", lld=20, extra={
            "calculation": {"post_processing": "conductivity"},
            "control": {"cond_ll": sizes.cond_ll},
            "energy": dict(WIDE_WINDOW)})
    if name == "spin_dynamics":
        return dict(nsp=2, recur="block", lld=20, hoh=True, nstep=1,
                    extra={"calculation": {"processing": "sd"},
                           "sd": {"asd_step": 2}})
    raise ValueError(f"unknown phase {name!r}")


def outputs_of(name: str) -> tuple:
    """Output files a phase's observables are read from."""
    return {"exchange": ("jij.out", "dij.out"),
            "conductivity": ("cond_total.out",),
            "spin_dynamics": ("X_out.nml", "output.lammpstrj")}.get(
                name, ("X_out.nml",))


# ---------------------------------------------------------------- running
def gpu_name_and_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "nvidia-smi printed nothing"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling while active."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        self.active = False
        jax.monitoring.register_event_duration_secs_listener(self._event)

    def _event(self, name, duration, **_):
        if self.active and name.startswith("/jax/core/compile/"):
            self.seconds += duration

    @contextmanager
    def measure(self):
        self.seconds, self.active = 0.0, True
        try:
            yield self
        finally:
            self.active = False


def run_deck(name: str, workdir: str, rc: float, sizes: Sizes, device):
    """Write the phase's deck into ``workdir`` and run it through the CLI
    pipeline on ``device``.  Returns the kk of the cluster."""
    import jax

    from rslmtoasa.cli import run_calculation
    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.presets import write_synthetic_bcc_inputs

    path = write_synthetic_bcc_inputs(workdir, rc=rc,
                                      **phase_deck(name, sizes))
    cfg = JobConfig.from_file(path)
    cfg.atoms.database = workdir
    with jax.default_device(device):
        rc_ = run_calculation(cfg, workdir)
    if rc_ != 0:
        raise RuntimeError(f"run_calculation returned {rc_}")
    return _kk_of(workdir)


def _kk_of(workdir: str) -> int:
    from rslmtoasa.geometry import bravais_cluster, primitive_cell
    from rslmtoasa.utils.namelist import read_namelists

    lat = read_namelists(os.path.join(workdir, "input.nml"))["lattice"]
    cl = bravais_cluster(primitive_cell("bcc"), alat=lat.get_scalar("alat"),
                         rc=lat.get_scalar("rc"),
                         ndim=lat.get_scalar("ndim"),
                         wav=lat.get_scalar("wav"))
    return int(cl.kk)


def first_coefficients(name: str, rc: float, sizes: Sizes, device,
                       workdir: str):
    """The recursion coefficients of the first SCF iteration of an SCF
    phase, computed on ``device``: (a, b2) for block/Lanczos, mu for
    Chebyshev."""
    import jax

    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.bulk import BulkSystem
    from rslmtoasa.models.presets import write_synthetic_bcc_inputs

    path = write_synthetic_bcc_inputs(workdir, rc=rc,
                                      **phase_deck(name, sizes))
    cfg = JobConfig.from_file(path)
    cfg.atoms.database = workdir
    sys_ = BulkSystem.build(cfg, workdir)
    sys_.build_hamiltonian()
    with jax.default_device(device):
        if name == "scf_block":
            return sys_.run_block()
        if name == "scf_chebyshev":
            return (sys_.run_chebyshev(sys_.emesh),)
        return sys_.run_lanczos()


def _numbers(path: str):
    """Every number of an output file, in order (namelists: every
    numeric ``&par`` entry)."""
    import numpy as np

    if path.endswith(".nml"):
        from rslmtoasa.utils.namelist import read_namelists

        return np.asarray([
            float(v) for a in read_namelists(path)["par"].assignments
            for v in a.values
            if isinstance(v, (int, float)) and not isinstance(v, bool)])
    vals = []
    with open(path) as fh:
        for line in fh:
            for tok in line.split():
                try:
                    vals.append(float(tok))
                except ValueError:
                    pass
    return np.asarray(vals)


def observable_deviation(dir_a: str, dir_b: str, files) -> float:
    """Largest |a - b| / max(1, |b|) over the observables in ``files``:
    <= 1e-6 means every value meets the abs/rel 1e-6 rule."""
    import numpy as np

    worst = 0.0
    for f in files:
        a = _numbers(os.path.join(dir_a, f))
        b = _numbers(os.path.join(dir_b, f))
        if a.shape != b.shape:
            raise RuntimeError(f"{f}: {a.shape} vs {b.shape} values")
        if a.size:
            dev = np.abs(a - b) / np.maximum(1.0, np.abs(b))
            worst = max(worst, float(np.nanmax(dev)))
    return worst


def coefficient_deviation(xs, ys) -> float:
    import numpy as np

    return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
               for x, y in zip(xs, ys))


def run_phase(name: str, root: str, sizes: Sizes, accel, ref, clock,
              log=print) -> bool:
    """One phase on ``accel`` against ``ref``; prints its lines and
    returns whether it met its tolerances."""
    tag = f"phase {name}:"
    ok = True
    wd = os.path.join(root, "accel", "scf_block" if name == "exchange"
                      else name)
    t0 = time.perf_counter()
    with clock.measure():
        kk = run_deck(name, wd, sizes.rc, sizes, accel)
    wall = time.perf_counter() - t0
    log(f"{tag} kk {kk} wall {wall!r} s")
    log(f"{tag} compile {clock.seconds!r} s")
    stats = accel.memory_stats() or {}
    log(f"{tag} peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    if name in ("scf_block", "scf_chebyshev", "scf_lanczos"):
        x = first_coefficients(name, sizes.rc, sizes, accel,
                               os.path.join(root, "coef_accel", name))
        y = first_coefficients(name, sizes.rc, sizes, ref,
                               os.path.join(root, "coef_ref", name))
        dev = coefficient_deviation(x, y)
        ok &= dev <= COEF_TOL
        log(f"{tag} first-iteration coefficients max|dev| {dev!r} "
            f"(tol {COEF_TOL}) at kk {kk}")
    ref_rc = sizes.cond_ref_rc if name == "conductivity" else sizes.ref_rc
    a_dir = wd
    if ref_rc != sizes.rc:
        a_dir = os.path.join(root, "accel_ref_width", name)
        run_deck(name, a_dir, ref_rc, sizes, accel)
    b_dir = os.path.join(root, "ref", "scf_block" if name == "exchange"
                         else name)
    ref_kk = run_deck(name, b_dir, ref_rc, sizes, ref)
    dev = observable_deviation(a_dir, b_dir, outputs_of(name))
    ok &= dev <= OBS_TOL
    log(f"{tag} observables max dev {dev!r} (tol {OBS_TOL} abs/rel) "
        f"{accel.platform} kk {_kk_of(a_dir)} vs "
        f"{ref.platform} kk {ref_kk}; full width kk {kk}")
    log(f"{tag} {'ok' if ok else 'FAILED'}")
    return ok


def run_gpu_tests(log=print) -> bool:
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    code = pytest.main(["-q", "--noconftest", "-p", "no:cacheprovider",
                        "-m", "gpu", os.path.join(here, "tests")])
    log(f"phase pytest_gpu: exit code {int(code)} wall "
        f"{time.perf_counter() - t0!r} s")
    return int(code) == 0


# ------------------------------------------------------------ four cards
def four_cards(sizes: Sizes, root: str, log=print) -> bool:
    """The chain-sharded mesh path against one card: scalar-Lanczos
    chains, the exchange pair driver and ``lanczos_rowsharded``."""
    import jax
    import numpy as np

    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.lanczos import lanczos_coefficients, scalar_start_vectors
    from rslmtoasa.parallel import dispatch

    ok = True
    ndev = len(jax.devices())

    def one_card():
        dispatch._mesh_cache.update(mesh=None, checked=True)

    def mesh():
        dispatch._mesh_cache.update(mesh=None, checked=False)

    sys_ = build_synthetic_bcc(rc=sizes.rc, ndim=100000, lld=20)
    hb = sys_.ham
    kk = hb.kk
    blk = hb.ee[:, :, :9, :9]
    nrec = ndev
    rec = list(range(0, kk, max(1, kk // nrec)))[:nrec]
    psi0 = scalar_start_vectors(kk, rec)  # 9 x nrec chains

    mesh()
    t0 = time.perf_counter()
    a_m, b_m = dispatch.lanczos_auto(blk, hb.iz, hb.cols, psi0, 20)
    t_m = time.perf_counter() - t0
    engaged = dispatch.get_mesh() is not None
    one_card()
    a_1, b_1 = dispatch.lanczos_auto(blk, hb.iz, hb.cols, psi0, 20)
    dev = coefficient_deviation((a_m, b_m), (a_1, b_1))
    ok &= engaged and dev <= MESH_TOL
    log(f"four-cards lanczos chains: {psi0.shape[2]} chains over {ndev} "
        f"devices (mesh engaged {engaged}), kk {kk}, max|dev| {dev!r} "
        f"(tol {MESH_TOL}), wall {t_m!r} s")

    os.environ["RSLMTO_ROWSHARD_BYTES"] = "1"
    try:
        mesh()
        a_r, b_r = dispatch.lanczos_auto(blk, hb.iz, hb.cols, psi0, 20)
    finally:
        del os.environ["RSLMTO_ROWSHARD_BYTES"]
    a_s, b_s = (np.asarray(x) for x in lanczos_coefficients(
        jax.numpy.asarray(blk), jax.numpy.asarray(hb.iz),
        jax.numpy.asarray(hb.cols), jax.numpy.asarray(psi0), 20))
    dev = coefficient_deviation((a_r, b_r), (a_s, b_s))
    ok &= dev <= MESH_TOL
    log(f"four-cards lanczos_rowsharded: kk {kk} rows over {ndev} "
        f"devices, max|dev| {dev!r} (tol {MESH_TOL})")

    res = {}
    for label, toggle in (("mesh", mesh), ("one_card", one_card)):
        toggle()
        t0 = time.perf_counter()
        res[label] = exchange_results(
            sizes, os.path.join(root, "exchange_" + label))
        log(f"four-cards exchange ({label}): {sizes.pairs} pairs, "
            f"wall {time.perf_counter() - t0!r} s")
    mesh()
    dev = coefficient_deviation((res["mesh"],), (res["one_card"],))
    ok &= dev <= MESH_TOL
    log(f"four-cards exchange pair driver: {4 * sizes.pairs} chains, "
        f"{res['mesh'].size} values (Jij, DMI, Aij, ...), max|dev| "
        f"{dev!r} (tol {MESH_TOL})")
    return ok


def exchange_results(sizes: Sizes, workdir: str):
    """Every number the exchange pair driver returns for the phase's
    deck, in full precision (the printed files keep 6 decimals)."""
    import numpy as np

    from rslmtoasa.config import JobConfig
    from rslmtoasa.models.bulk import BulkSystem
    from rslmtoasa.models.exchange import ExchangeCalculation
    from rslmtoasa.models.presets import write_synthetic_bcc_inputs

    path = write_synthetic_bcc_inputs(workdir, rc=sizes.rc,
                                      **phase_deck("exchange", sizes))
    cfg = JobConfig.from_file(path)
    cfg.atoms.database = workdir
    sys_ = BulkSystem.build(cfg, workdir)
    out = ExchangeCalculation(sys_, cfg.lattice.ijpair, workdir).run()
    return np.concatenate([
        np.atleast_1d(np.asarray(r[k], np.float64)).ravel()
        for r in out for k in sorted(r) if not isinstance(r[k], str)])


# ----------------------------------------------------------- compile only
def compile_only(sizes: Sizes, log=print) -> bool:
    """Compile each phase's recursion engine at its full-width shapes and
    print ``memory_analysis()``; nothing runs."""
    import jax
    import jax.numpy as jnp

    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.block_lanczos import block_lanczos
    from rslmtoasa.ops.chebyshev import chebyshev_moments
    from rslmtoasa.ops.kubo import kubo_moments
    from rslmtoasa.ops.lanczos import lanczos_coefficients

    sys_ = build_synthetic_bcc(rc=sizes.rc, ndim=100000, lld=20, nsp=2,
                               hoh=True)
    hb = sys_.ham
    kk, ns = hb.kk, hb.nslots
    c128 = jnp.complex128
    s = jax.ShapeDtypeStruct

    def tab(d):
        return s((1, ns, d, d), c128)

    iz = s((kk,), jnp.int32)
    cols = s((kk, ns), jnp.int32)
    onsite = s((1, 18, 18), c128)
    r_pairs = 4 * sizes.pairs
    ok = True
    # nsp 2 carries SOC, so the block phases run full 18x18 blocks (no
    # spin-sector split); nsp 1 runs 9-wide scalar chains per spin
    jobs = {
        "block d18 R1 hoh lld20": (
            lambda h, l, i, c, p: block_lanczos(h, l, i, c, p, 20, hoh=True,
                                                hso=h, enim=l),
            (tab(18), onsite, iz, cols, s((1, kk + 1, 18, 18), c128))),
        "chebyshev d18 R1 hoh lld50": (
            lambda h, l, i, c, p: chebyshev_moments(
                h, l, i, c, p, 50, 2.94, -0.5, hoh=True, hso=h, enim=l),
            (tab(18), onsite, iz, cols, s((1, kk + 1, 18, 18), c128))),
        "lanczos B9 C9 lld20": (
            lambda *a: lanczos_coefficients(*a, lld=20),
            (tab(9), iz, cols, s((kk + 1, 9, 9), c128))),
        f"exchange block d18 R{r_pairs} hoh lld20": (
            lambda h, l, i, c, p: block_lanczos(h, l, i, c, p, 20, hoh=True,
                                                hso=h, enim=l),
            (tab(18), onsite, iz, cols,
             s((r_pairs, kk + 1, 18, 18), c128))),
        f"kubo d18 cond_ll{sizes.cond_ll}": (
            lambda b, l, i, c, va, vb, p: kubo_moments(
                b, l, i, c, va, vb, p, n_moments=sizes.cond_ll,
                block_size=sizes.cond_ll, a=2.94, b=-0.5),
            (tab(18), onsite, iz, cols, tab(18), tab(18),
             s((kk, 18, 18), c128))),
    }
    for label, (fn, args) in jobs.items():
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args).compile()
        n_low = low_precision_dots(compiled.as_text())
        log(f"compile {label} kk {kk}: {time.perf_counter() - t0!r} s; "
            f"memory_analysis {compiled.memory_analysis()}; "
            f"dots below float64 {n_low}")
        ok &= n_low == 0
    return ok


def low_precision_dots(hlo_text: str) -> int:
    """Number of dot/convolution instructions in optimized HLO whose
    result is float32 or narrower (real or complex)."""
    n = 0
    for line in hlo_text.splitlines():
        if " dot(" in line or " convolution(" in line:
            rhs = line.split("=", 1)[-1].strip()
            if rhs.startswith(("f32", "bf16", "f16", "c64", "tf32")):
                n += 1
    return n


# ------------------------------------------------------------------ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the chain-sharded mesh path on 4 GPUs")
    mode.add_argument("--compile-only", action="store_true",
                      help="compile the phase engines and stop")
    args = ap.parse_args(argv)

    # the CPU reference needs the host backend beside the GPU
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import rslmtoasa  # noqa: F401  (enables x64)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU visible to JAX (found "
              f"{devices[0].platform})", file=sys.stderr)
        return 2
    from rslmtoasa.cli import enable_compile_cache

    print(f"compile cache {enable_compile_cache()}")
    print(gpu_name_and_power_limit())
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    sizes = Sizes()
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.four_cards:
            # 4 pairs = 16 chains, 4 per card: the host Green-function
            # work per chain, not the device, sets this phase's time
            ok = four_cards(Sizes(pairs=4), root)
        elif args.compile_only:
            ok = compile_only(sizes)
        else:
            accel, ref = devices[0], jax.devices("cpu")[0]
            clock = CompileClock()
            ok = True
            for name in PHASES:
                try:
                    if name == "pytest_gpu":
                        ok &= run_gpu_tests()
                    else:
                        ok &= run_phase(name, root, sizes, accel, ref,
                                        clock)
                except Exception as e:  # report and go on to the next
                    print(f"phase {name}: FAILED {type(e).__name__}: {e}")
                    ok = False
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(gpu_name_and_power_limit())
    print(json.dumps({"ok": bool(ok), "device": device}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
