#!/usr/bin/env python3
"""Benchmark: the complex128 scalar Haydock recursion on the device.

Runs the batched scalar recursion (``ops.lanczos.lanczos_coefficients``,
the engine ``parallel.dispatch.lanczos_auto`` runs on one device: gathered
block-ELL SpMV + Lanczos updates inside one ``lax.scan``) on the full 30^3
bcc supercell box of the synthetic species (kk 27000, 16 start atoms x 9
orbitals = 144 chains) and reports block-SpMV throughput in Gnnz/s
(nonzero Hamiltonian entries processed per second across all chains and
recursion steps).

A correctness guard compares the first device coefficients with a NumPy
complex128 recursion of the same chains (atol 1e-8), so a silent
precision loss fails the run.  The run refuses a host-only JAX: its
numbers are device numbers.

Prints diagnostics on stderr and ONE JSON line on stdout.
"""

import json
import subprocess
import sys
import time

import numpy as np


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "not available"
    except (OSError, subprocess.TimeoutExpired):
        return "not available"


def main():
    import jax
    import jax.numpy as jnp

    from rslmtoasa.cli import enable_compile_cache
    from rslmtoasa.models.presets import build_synthetic_bcc
    from rslmtoasa.ops.lanczos import lanczos_coefficients, scalar_start_vectors

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench.py measures a device; JAX found none", file=sys.stderr)
        return 1
    enable_compile_cache()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"# device {device}; nvidia-smi: {gpu_name_and_power_limit()}",
          file=sys.stderr)

    lld = 20
    sys_ = build_synthetic_bcc(rc=120.0, ndim=1000000, lld=lld, box=30)
    hb = sys_.ham
    kk = hb.kk
    nslots = hb.nslots
    n_start = 16
    starts = list(range(0, kk, max(1, kk // n_start)))[:n_start]
    hs_np = np.asarray(hb.ee[:, :, :9, :9])  # one spin channel
    psi_c = scalar_start_vectors(kk, starts)
    c = psi_c.shape[2]
    print(f"# cluster kk={kk} nslots={nslots} lld={lld} chains={c}",
          file=sys.stderr)
    hs = jnp.asarray(hs_np)
    iz = jnp.asarray(hb.iz)
    cols = jnp.asarray(hb.cols)
    psi0 = jnp.asarray(psi_c)

    def fn(scale):
        # the scale keeps every repetition a distinct execution
        return lanczos_coefficients(hs, iz, cols, psi0 * scale, lld)

    t0 = time.perf_counter()
    jax.block_until_ready(fn(1.0))
    print(f"# compile+first run: {time.perf_counter()-t0:.2f} s",
          file=sys.stderr)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(1.0))
    dt = (time.perf_counter() - t0) / reps
    a_dev = np.asarray(out[0])

    # nnz = Hamiltonian block entries touched per SpMV (9x9 per slot),
    # processed once per chain per recursion step
    nnz = kk * nslots * 81
    work = nnz * c * (lld - 1)
    gnnz = work / dt / 1e9
    print(f"# device recursion: {dt*1e3:.3f} ms -> {gnnz:.3f} Gnnz/s",
          file=sys.stderr)

    # correctness guard: host complex128 reference of the same recurrence
    iz_np = np.asarray(hb.iz)
    cols_np = np.asarray(hb.cols)
    hi = hs_np[iz_np]  # (kk, nslots, 9, 9)

    def np_spmv(psi):
        acc = np.zeros((kk, 9, c), np.complex128)
        for m in range(nslots):
            acc += np.einsum("iab,ibc->iac", hi[:, m], psi[cols_np[:, m]])
        return acc

    psi = psi_c.copy()
    pmn = np.zeros((kk, 9, c), np.complex128)
    for ll in range(3):
        v = np_spmv(psi)
        a_ll = np.sum((v * psi[:-1].conj()).real, axis=(0, 1))
        pmn = pmn + v - a_ll[None, None, :] * psi[:-1]
        s = np.sqrt(np.sum(np.abs(pmn) ** 2, axis=(0, 1)))
        psi_new = pmn / s[None, None, :]
        pmn = -psi[:-1] * s[None, None, :]
        psi = np.concatenate([psi_new, np.zeros((1, 9, c), np.complex128)])
        err = float(np.abs(a_dev[ll] - a_ll).max())
        assert err <= 1e-8, f"device mismatch at step {ll}: {err:.3e}"

    print(json.dumps({
        "metric": "scalar_recursion_spmv_throughput",
        "value": gnnz,
        "unit": "Gnnz/s",
        "ms_per_step": dt / (lld - 1) * 1e3,
        "kk": kk,
        "chains": c,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
