"""Command-line driver (the reference binary ``rslmto.x`` equivalent).

Usage (reference ``source/os.f90 argument_parser`` :34-158 and
``calculation.f90 process`` :175-211)::

    python -m rslmtoasa [input.nml] [nml=extra.nml ...] [output=dir]

Reads the namelist input, dispatches on the &calculation pipeline strings
(``bravais``/``newclubulk`` pre-processing, ``sd`` processing, ``exchange``/
``conductivity`` post-processing), runs the SCF / post-processing, writes
the reference's output files (totaldos.out, <El>_out.nml, jij.out, ...),
and prints the hierarchical timing report.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .config import JobConfig
from .utils.logger import g_logger
from .utils.namelist import read_namelists
from .utils.timer import g_timer

VALID_PRE = {"none", "bravais", "buildsurf", "newclubulk", "newclusurf"}
VALID_PROC = {"none", "sd"}
VALID_POST = {"none", "exchange", "exchange_p2rs", "conductivity",
              "conductivity_p2rs", "paoflow2rs", "orbital_modern"}


def parse_args(argv):
    input_file = "input.nml"
    extra = []
    outdir = "."
    for arg in argv:
        if arg.startswith("nml="):
            extra.append(arg[4:])
        elif arg.startswith("output="):
            outdir = arg[7:]
        else:
            input_file = arg
    return input_file, extra, outdir


#: the checkout (or install prefix) that holds the package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir() -> str:
    """Persistent compile-cache directory: ``JAX_COMPILATION_CACHE_DIR``
    when set, else ``<checkout>/.jax_cache``.  A fixed path, because the
    path is part of the cache key."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CHECKOUT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    so repeated runs reuse compiled executables; returns the path."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    enable_compile_cache()
    # multi-host bring-up (reference MPI_INIT, main.f90:26-49); no-op
    # unless the JAX coordinator env vars are set
    from .parallel.dispatch import init_distributed

    init_distributed()
    # RSLMTO_PROFILE=<dir> captures a jax.profiler trace of the whole run
    # (view with tensorboard or xprof)
    prof_dir = os.environ.get("RSLMTO_PROFILE")
    if prof_dir:
        import jax

        jax.profiler.start_trace(prof_dir)
        try:
            return _main_inner(argv)
        finally:
            jax.profiler.stop_trace()
    return _main_inner(argv)


def _main_inner(argv) -> int:
    input_file, extra, outdir = parse_args(argv)
    if not os.path.exists(input_file):
        g_logger.error(f"input file {input_file} not found")
        return 1
    nml = read_namelists(input_file)
    for path in extra:
        nml.merge(read_namelists(path))
    cfg = JobConfig.from_namelists(nml, fname=input_file)
    os.makedirs(outdir, exist_ok=True)
    if cfg.atoms.database in ("", "./", "."):
        cfg.atoms.database = os.path.dirname(os.path.abspath(input_file))
    return run_calculation(cfg, outdir)


def run_calculation(cfg: JobConfig, workdir: str = ".") -> int:
    """Run the full dispatched pipeline for a built config (the body of
    ``calculation%process``, calculation.f90:175-211).  Shared by the CLI
    and the parity test harness so tests exercise the product path."""
    pre = (cfg.calculation.pre_processing or "none").strip()
    proc = (cfg.calculation.processing or "none").strip()
    post = (cfg.calculation.post_processing or "none").strip()
    for val, ok in ((pre, VALID_PRE), (proc, VALID_PROC), (post, VALID_POST)):
        if val not in ok:
            g_logger.error(f"invalid calculation stage {val!r}")
            return 1

    from .models.bulk import BulkSystem
    from .parallel.dispatch import require_native_complex128

    require_native_complex128()
    input_file = cfg.control.fname or "input.nml"
    os.makedirs(workdir, exist_ok=True)
    sys_ = BulkSystem.build(cfg, workdir)

    from .utils import artifacts

    if artifacts.wanted(cfg):
        # clust/map/sbar/str.out interop exports (structb writes,
        # lattice.f90:1819+); mad.mat follows once the SCF builds it
        artifacts.export_geometry(sys_, workdir)

    if post in ("paoflow2rs", "exchange_p2rs", "conductivity_p2rs"):
        # import an external PAOFLOW TB Hamiltonian in place of the
        # LMTO-built one (post_processing_paoflow2rs, calculation.f90
        # :643-838), then run the requested analysis on it
        from .models.paoflow import import_paoflow

        sys_.build_hamiltonian()
        import_paoflow(
            sys_, os.path.join(os.path.dirname(
                os.path.abspath(input_file)), "paoham.dat")
        )
        sys_.freeze_ham = True

    if post in ("exchange", "exchange_p2rs"):
        from .models.exchange import ExchangeCalculation

        if cfg.lattice.njijk > 0:
            # spin-lattice trios: run pair recursion over the 3 pairs of
            # each trio, then the Jijk tensor (calculation.f90 :949)
            trios = cfg.lattice.ijktrio
            pairs = []
            for t in trios:
                i, j, k = int(t[0]), int(t[1]), int(t[2])
                pairs += [(i, j), (i, k), (j, k)]
            xc = ExchangeCalculation(sys_, np.asarray(pairs), workdir)
            xc.run()
            xc.calculate_jijk(trios)
        else:
            xc = ExchangeCalculation(sys_, cfg.lattice.ijpair, workdir)
            xc.run()
            xc.calculate_exchange_twoindex()
    elif post in ("conductivity", "conductivity_p2rs"):
        from .models.conductivity import ConductivityCalculation

        cc = ConductivityCalculation(sys_, workdir)
        cc.run(cond_type=cfg.control.cond_type)
    elif post == "orbital_modern":
        from .models.orbital import OrbitalMoment

        om = OrbitalMoment(sys_, workdir)
        # exact trace up to ~2000 sites, stochastic subsample beyond
        om.run(n_sites=min(sys_.cluster.kk, 2000))
    elif post == "paoflow2rs":
        from .models.scf import SelfConsistency

        scf = SelfConsistency(sys_, workdir)
        scf.run()
    elif proc == "sd":
        from .models.spin_dynamics import SpinDynamics

        sd = SpinDynamics(sys_, workdir)
        sd.run()
    else:
        from .models.scf import SelfConsistency

        scf = SelfConsistency(sys_, workdir)
        state = scf.run()
        g_logger.info(
            f"SCF finished: converged={state.converged} "
            f"delta={state.delta:.3e}"
        )
        scf.report()
        if pre == "bravais" and getattr(scf, "bands", None) is not None:
            # post-SCF exports of pre_processing_bravais
            # (calculation.f90 :619-621): rs2pao + orbital quadrupoles
            from .models.paoflow import export_rs2pao

            export_rs2pao(sys_, os.path.join(workdir, "rs2paoham.dat"))
            scf.bands.calculate_orbital_quadrupoles(scf.last_g0, workdir)

    print(g_timer.report())
    from .utils.alloc import g_alloc

    print(g_alloc.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
