"""The native complex128 path: capability predicate, dispatch routing,
memory budgets, the compile-cache rule and the absence of low-precision
dots on the recursion engines."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rslmtoasa.models.presets import build_synthetic_bcc
from rslmtoasa.parallel import dispatch

WIDE = (1.9, -0.2)  # Chebyshev scaling (a, b) that contains the spectrum


@pytest.fixture(scope="module")
def bcc():
    return build_synthetic_bcc(rc=8.0, ndim=2000, lld=5, nsp=2, hoh=True)


@pytest.fixture
def no_emulation(monkeypatch):
    """Fail if anything builds a df64/realified/split engine."""
    import rslmtoasa.ops.block_lanczos as bl
    import rslmtoasa.ops.chebyshev as ch
    import rslmtoasa.ops.kubo_ms as km
    import rslmtoasa.ops.lanczos as lz
    import rslmtoasa.ops.msconv as ms
    import rslmtoasa.ops.stencil_conv as sc

    def boom(*a, **k):
        raise AssertionError("emulation engine built on the native path")

    for mod, name in ((ms.MSEngine, "__init__"), (km.MSKubo, "__init__"),
                      (sc, "build_conv_stencil"), (bl, "realify_blocks"),
                      (bl, "block_lanczos_split"), (lz, "split_complex"),
                      (lz, "lanczos_coefficients_split"),
                      (ch, "chebyshev_moments_split")):
        monkeypatch.setattr(mod, name, boom)
    yield
    dispatch._mesh_cache.update(mesh=None, checked=False)


@pytest.mark.parametrize("platform,native", [
    ("cpu", True), ("gpu", True), ("cuda", True), ("rocm", True),
    ("metal", False)])
def test_native_complex128_predicate(platform, native):
    assert dispatch.native_complex128(platform) is native


def test_default_backend_is_native_and_foreign_one_refused(monkeypatch):
    from rslmtoasa.utils.logger import FatalError

    assert dispatch.native_complex128()
    dispatch.require_native_complex128()
    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(FatalError):
        dispatch.require_native_complex128()


def _block_ref(sys_, psi0, lld, fn, *extra):
    hb = sys_.ham
    return fn(jnp.asarray(hb.ee), jnp.asarray(hb.lsham), jnp.asarray(hb.iz),
              jnp.asarray(hb.cols), jnp.asarray(psi0), lld, *extra,
              hoh=True, hso=jnp.asarray(hb.eeo), enim=jnp.asarray(hb.enim))


@pytest.mark.parametrize("entry", ["block_lanczos_auto",
                                   "chebyshev_moments_auto", "lanczos_auto",
                                   "run_lanczos", "compute_moments"])
def test_dispatch_entry_runs_complex128(entry, bcc, no_emulation):
    """Every dispatch entry and driver runs the complex128 engine itself
    and builds no emulation engine."""
    from rslmtoasa.ops.block_lanczos import block_lanczos, block_start_vectors
    from rslmtoasa.ops.chebyshev import chebyshev_moments
    from rslmtoasa.ops.lanczos import lanczos_coefficients, scalar_start_vectors

    hb = bcc.ham
    kk = hb.kk
    if entry == "block_lanczos_auto":
        psi0 = block_start_vectors(kk, [0, 3])
        got = dispatch.block_lanczos_auto(
            hb.ee, hb.lsham, hb.iz, hb.cols, psi0, 5, hoh=True,
            hso=hb.eeo, enim=hb.enim)
        want = _block_ref(bcc, psi0, 5, block_lanczos)
    elif entry == "chebyshev_moments_auto":
        psi0 = block_start_vectors(kk, [0, 3])
        got = (dispatch.chebyshev_moments_auto(
            hb.ee, hb.lsham, hb.iz, hb.cols, psi0, 5, *WIDE, hoh=True,
            hso=hb.eeo, enim=hb.enim),)
        want = (_block_ref(bcc, psi0, 5, chebyshev_moments, *WIDE),)
    elif entry == "lanczos_auto":
        psi0 = scalar_start_vectors(kk, [0])
        blk = hb.ee[:, :, :9, :9]
        got = dispatch.lanczos_auto(blk, hb.iz, hb.cols, psi0, 5)
        want = lanczos_coefficients(jnp.asarray(blk), jnp.asarray(hb.iz),
                                    jnp.asarray(hb.cols),
                                    jnp.asarray(psi0), 5)
    elif entry == "run_lanczos":
        got = bcc.run_lanczos()
        psi0 = jnp.asarray(scalar_start_vectors(kk, [0]))
        parts = [lanczos_coefficients(
            jnp.asarray(hb.ee[:, :, 9 * s:9 * s + 9, 9 * s:9 * s + 9]),
            jnp.asarray(hb.iz), jnp.asarray(hb.cols), psi0, 5)
            for s in (0, 1)]
        want = tuple(np.concatenate([np.asarray(p[k]) for p in parts],
                                    axis=1)[:, :, None] for k in (0, 1))
    else:
        from rslmtoasa.models.conductivity import (
            ConductivityCalculation,
            build_velocity_operators,
        )
        from rslmtoasa.ops.kubo import kubo_moments

        v_a, v_b, _, _ = build_velocity_operators(
            bcc, np.array([0.0, 1.0, 0.0]), np.array([1.0, 0.0, 0.0]))
        bcc.cfg.hamiltonian.hoh = False
        try:
            mu = ConductivityCalculation(bcc).compute_moments(
                v_a, v_b, *WIDE, 4)
        finally:
            bcc.cfg.hamiltonian.hoh = True
        got = (mu[..., 0],)
        psi0 = np.zeros((kk, 18, 18), np.complex128)
        psi0[int(bcc.cluster.atlist[0]) - 1] = np.eye(18)
        ref = np.asarray(kubo_moments(
            jnp.asarray(hb.ee), jnp.asarray(hb.lsham), jnp.asarray(hb.iz),
            jnp.asarray(hb.cols), jnp.asarray(v_a), jnp.asarray(v_b),
            jnp.asarray(psi0), n_moments=4, block_size=4, a=WIDE[0],
            b=WIDE[1]))
        want = (np.transpose(ref, (2, 3, 0, 1)),)
    for g, w in zip(got, want):
        g = np.asarray(g)
        assert g.dtype in (np.complex128, np.float64)
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-10)


@pytest.mark.parametrize("kind", ["block_lanczos", "chebyshev_moments"])
def test_spin_split_matches_unsplit(kind, bcc, monkeypatch):
    """The collinear spin-sector split reproduces the full 18x18
    recursion (the split engages on every collinear case)."""
    from rslmtoasa.ops.block_lanczos import block_start_vectors

    hb = bcc.ham
    # spin-diagonal copies: drop the SOC coupling so the problem splits
    lsham = np.zeros_like(hb.lsham)
    psi0 = block_start_vectors(hb.kk, [0, 3])
    assert dispatch._spin_sectors(hb.ee, lsham, hb.eeo, hb.enim,
                                  psi0) is not None
    fn = getattr(dispatch, kind + "_auto")
    extra = WIDE if kind == "chebyshev_moments" else ()

    def run():
        out = fn(hb.ee, lsham, hb.iz, hb.cols, psi0, 5, *extra, hoh=True,
                 hso=hb.eeo, enim=hb.enim)
        return out if isinstance(out, tuple) else (out,)

    split = run()
    monkeypatch.setenv("RSLMTO_NO_SPIN_SPLIT", "1")
    full = run()
    for s, f in zip(split, full):
        np.testing.assert_allclose(s, f, atol=1e-9)


def _dot_dtypes(jaxpr):
    """Operand dtypes of every dot_general/conv in a jaxpr, recursively."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            out.extend(str(v.aval.dtype) for v in eqn.invars)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_dtypes(sub))
    return out


@pytest.mark.parametrize("engine", ["block_lanczos", "chebyshev_moments",
                                    "lanczos_coefficients", "kubo_moments",
                                    "bprldos"])
def test_engine_has_no_low_precision_dot(engine, bcc):
    """No float32 (or narrower) contraction on the recursion engines."""
    from rslmtoasa.ops.block_lanczos import block_lanczos, block_start_vectors
    from rslmtoasa.ops.chebyshev import chebyshev_moments
    from rslmtoasa.ops.kubo import kubo_moments
    from rslmtoasa.ops.lanczos import lanczos_coefficients, scalar_start_vectors
    from rslmtoasa.ops.ldos import _bprldos_shifted

    hb = bcc.ham
    kk = hb.kk
    b0 = jnp.asarray(block_start_vectors(kk, [0]))
    tabs = (jnp.asarray(hb.ee), jnp.asarray(hb.lsham), jnp.asarray(hb.iz),
            jnp.asarray(hb.cols))
    hoh = dict(hoh=True, hso=jnp.asarray(hb.eeo), enim=jnp.asarray(hb.enim))
    if engine == "block_lanczos":
        jx = jax.make_jaxpr(lambda: block_lanczos(*tabs, b0, 5, **hoh))()
    elif engine == "chebyshev_moments":
        jx = jax.make_jaxpr(
            lambda: chebyshev_moments(*tabs, b0, 5, *WIDE, **hoh))()
    elif engine == "lanczos_coefficients":
        jx = jax.make_jaxpr(lambda: lanczos_coefficients(
            tabs[0][:, :, :9, :9], tabs[2], tabs[3],
            jnp.asarray(scalar_start_vectors(kk, [0])), 5))()
    elif engine == "kubo_moments":
        jx = jax.make_jaxpr(lambda: kubo_moments(
            tabs[0], tabs[1], tabs[2], tabs[3], tabs[0], tabs[0], b0[0, :-1],
            n_moments=4, block_size=2, a=WIDE[0], b=WIDE[1], hoh=True,
            vo_a=tabs[0], vo_b=tabs[0], blocks_o=jnp.asarray(hb.eeo),
            enim=jnp.asarray(hb.enim)))()
    else:
        e = jnp.linspace(-1.0, 1.0, 7)[:, None] * jnp.ones((1, 18))
        ab = jnp.ones((5, 18))
        jx = jax.make_jaxpr(lambda: _bprldos_shifted(
            e, ab, ab, -ab[0], ab[0]))()
    dtypes = _dot_dtypes(jx.jaxpr)
    assert set(dtypes) <= {"float64", "complex128", "int32", "int64"}, dtypes


@pytest.mark.parametrize("env", [None, "/some/cache"])
def test_compile_cache_dir_rule(env, monkeypatch):
    from rslmtoasa import cli

    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(cli.CHECKOUT, ".jax_cache")
        assert os.path.isdir(os.path.join(cli.CHECKOUT, "rslmtoasa"))
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        want = env
    assert cli.compile_cache_dir() == want


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,stats,want", [
    ("cpu", None, 123),
    ("gpu", {"bytes_limit": 1000}, 250),
    ("gpu", {}, 123)])
def test_memory_budget_follows_device(platform, stats, want, monkeypatch):
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice(platform, stats)])
    assert dispatch.memory_budget(0.25, 123) == want
