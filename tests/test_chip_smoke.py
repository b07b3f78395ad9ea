"""``chip_smoke.py`` at a tiny width on the CPU: every phase's plumbing
(deck, CLI run, coefficient and observable comparison), the compile-only
and four-card modes on the virtual CPU devices, and the refusal to run
without a GPU."""

import jax
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(rc=8.0, ref_rc=8.0, cond_ref_rc=12.0, pairs=2,
                        cond_ll=8)


@pytest.mark.parametrize("phases", [
    ("scf_block",), ("scf_chebyshev",), ("scf_lanczos",),
    ("scf_block", "exchange"), ("conductivity",), ("spin_dynamics",)],
    ids=lambda p: p[-1])
def test_phase_at_tiny_width(phases, tmp_path):
    cpu = jax.devices("cpu")[0]
    clock = chip_smoke.CompileClock()
    lines = []
    for name in phases:
        assert chip_smoke.run_phase(name, str(tmp_path), TINY, cpu, cpu,
                                    clock, log=lines.append), lines
    assert any("observables max dev 0.0" in ln for ln in lines), lines
    assert lines[-1].endswith("ok")
    if phases[-1] == "conductivity":
        # the reference width differs: both widths are reported
        assert any("kk 338" in ln and "full width kk 180" in ln
                   for ln in lines), lines


def test_compile_only_at_tiny_width():
    lines = []
    assert chip_smoke.compile_only(TINY, log=lines.append)
    assert len(lines) == 5
    assert all("dots below float64 0" in ln for ln in lines)


def test_four_cards_on_virtual_devices(tmp_path):
    """The --four-cards path on the conftest's virtual CPU devices:
    mesh engaged, every comparison within 1e-10."""
    from rslmtoasa.parallel import dispatch

    lines = []
    try:
        assert chip_smoke.four_cards(TINY, str(tmp_path),
                                     log=lines.append), lines
    finally:
        dispatch._mesh_cache.update(mesh=None, checked=False)
    assert any("mesh engaged True" in ln for ln in lines), lines


def test_low_precision_dot_scan():
    hlo = ("  %d = c128[4,4]{1,0} dot(c128[4,4] %a, c128[4,4] %b)\n"
           "  %e = f32[4,4]{1,0} dot(f32[4,4] %x, f32[4,4] %y)\n"
           "  %f = f64[4]{0} add(f64[4] %p, f64[4] %q)\n")
    assert chip_smoke.low_precision_dots(hlo) == 1


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out  # no result line
