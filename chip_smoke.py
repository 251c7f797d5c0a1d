#!/usr/bin/env python
"""Smoke test of the chain main path on an NVIDIA GPU.

    python chip_smoke.py          # one card: phases 1-5 below
    python chip_smoke.py --four   # four cards: the chi-partitioned engines

Runs the library's DMRG, TDVP and TCI2 entry points at production width
on the card, compiled for it, and compares each with a plain f64
reference run. Every phase prints one line; the last line is
``{"ok": true, "device": {...}}``. The script needs a GPU: on any other
platform it exits non-zero before computing anything, and it never
catches a phase's failure.

Phases (one card):
  1. card: name and power limit, versions, what each matmul precision
     name computes on this card, optional imports present;
  2. exactness: ``dmrg_chain`` at N=8 against exact diagonalisation;
  3. DMRG: ``dmrg_run`` on the Heisenberg chain N=32, chi=1024 with the
     production schedule, against an f64 run of the same engine;
  4. TDVP: imaginary-time ``tdvp_run`` N=32, chi=512 with the production
     knobs, against an f64 run at precision "highest";
  5. TCI2: ``crossinterpolate2(jax_f=...)`` (device Pi-matrix fill) on the
     10-D Gaussian of ``benchmarks/tci_device.py``.

The phase functions take their sizes as arguments so that CPU tests can
run them at tiny size.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import tensor4all_tpu  # noqa: F401  (enables x64)
from benchmarks.dmrg_chain import PROD_KNOBS, TDVP_KNOBS, _setup
from benchmarks.mxu import card_name_and_power_limit
from tensor4all_tpu.models.chain import heisenberg_chain_mpo, mpo_to_dense
from tensor4all_tpu.ops.dmrg_chain import dmrg_chain, dmrg_run
from tensor4all_tpu.ops.tdvp_chain import tdvp_run
from tensor4all_tpu.utils.compile_cache import use_compile_cache

# Tolerances, each with its reason.
# Phase 2: the reference's energy-parity contract (BASELINE.md).
EXACT_ABS_TOL = 1e-10
# Phase 3: energy_precision="mixed" evaluates the final Rayleigh quotient
# at f32-"highest" grade, which promises ~1e-6 relative.
DMRG_REL_TOL = 1e-6
# Phase 4: the start is a random full-rank state, on which the
# truncating two-site splits amplify rounding (a 1e-14 perturbation costs
# ~5e-7 infidelity in f64, tests/test_tdvp_jit.py); f32 sweeps land at
# 6e-6..6e-5 against f64 on the CPU at N <= 12. 1e-4 holds f32-grade
# arithmetic and leaves a margin over those.
TDVP_INFIDELITY_TOL = 1e-4


def _line(name: str, payload: dict) -> None:
    print(f"[{name}] " + json.dumps(payload, default=str), flush=True)


def _compile(fn, *args, **static):
    """Lower and compile ``fn`` once; return (compiled, seconds)."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args, **static).compile()
    return compiled, time.perf_counter() - t0


def _memory(compiled) -> dict | None:
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    return {k: int(getattr(ma, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes")}


def _peak_bytes(device) -> int | None:
    """High-water mark of the process's arrays on ``device`` so far."""
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


@jax.jit
def _normalized_overlap(a, b):
    """|<a|b>| / sqrt(<a|a><b|b>) of two padded (N, chi, d, chi) MPS, f64."""
    a = a.astype(jnp.float64)
    b = b.astype(jnp.float64)
    hi = jax.lax.Precision.HIGHEST

    def transfer(x, y):
        T0 = jnp.zeros((x.shape[1], y.shape[1]), x.dtype).at[0, 0].set(1.0)

        def body(T, k):
            X, Y = x[k], y[k]
            return jnp.einsum("ax,aib,xiB->bB", T, jnp.conj(X), Y,
                              precision=hi), None

        return jax.lax.scan(body, T0, jnp.arange(x.shape[0]))[0][0, 0]

    return jnp.abs(transfer(a, b)) / jnp.sqrt(
        jnp.abs(transfer(a, a)) * jnp.abs(transfer(b, b)))


def phase_card(n: int = 2048) -> dict:
    """Card identity and what each matmul precision name computes here:
    the relative Frobenius error of an f32 ``n x n`` product against the
    f64 product of the same operands."""
    dev = jax.devices()[0]
    ka, kb = jax.random.split(jax.random.PRNGKey(0))
    a = jax.random.normal(ka, (n, n), jnp.float32)
    b = jax.random.normal(kb, (n, n), jnp.float32)
    ref = jnp.matmul(a.astype(jnp.float64), b.astype(jnp.float64))
    ref_norm = float(jnp.linalg.norm(ref))
    precision = {}
    for name in ("default", "high", "highest"):
        with jax.default_matmul_precision(name):
            c = jax.jit(jnp.matmul)(a, b)
        err = float(jnp.linalg.norm(c.astype(jnp.float64) - ref)) / ref_norm
        grade = ("f32" if err < 1e-5 else "tf32" if err < 1e-3
                 else "bf16")
        precision[name] = {"rel_err": err, "grade": grade}
    import jaxlib

    return {
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "jax": jax.__version__,
        "jaxlib": jaxlib.__version__,
        "matmul_f32_n": n, "matmul_precision_f32": precision,
        "networkx_present": importlib.util.find_spec("networkx") is not None,
        "h5py_present": importlib.util.find_spec("h5py") is not None,
    }


def phase_exact(N: int = 8, chi: int = 32, n_sweeps: int = 4) -> dict:
    """``dmrg_chain`` (f64) against exact diagonalisation."""
    cores = heisenberg_chain_mpo(N)
    e0 = float(np.linalg.eigvalsh(mpo_to_dense(cores))[0])
    t0 = time.perf_counter()
    e, _ = dmrg_chain(cores, chi, n_sweeps=n_sweeps)
    e = float(e)
    wall = time.perf_counter() - t0
    err = abs(e - e0)
    assert err <= EXACT_ABS_TOL, f"dmrg_chain energy error {err:.3e}"
    return {"N": N, "chi": chi, "energy": e, "exact": e0, "abs_err": err,
            "tol": EXACT_ABS_TOL, "wall_s_incl_compile": wall}


def phase_dmrg(N: int = 32, chi: int = 1024, n_sweeps: int = 3,
               lanczos_iters: int = 16, ref_sweeps: int = 6,
               knobs: dict | None = None) -> dict:
    """Production DMRG schedule against the plain f64 run of the same
    engine (f64 sweeps, "highest", full reorthogonalisation, f64 Ritz
    solve and energy, no coarse sweeps)."""
    knobs = PROD_KNOBS if knobs is None else knobs
    dev = jax.devices()[0]
    h, mps0 = (jax.device_put(x, dev) for x in _setup(N, chi))
    prod, t_prod_c = _compile(
        dmrg_run, h, mps0, n_sweeps=n_sweeps, lanczos_iters=lanczos_iters,
        sweep_dtype=jnp.float32, coarse_sweeps=n_sweeps - 1, **knobs)
    prod(h, mps0)[0].block_until_ready()  # warm-up
    t0 = time.perf_counter()
    e, mps = prod(h, mps0)
    e = float(e.block_until_ready())
    wall = time.perf_counter() - t0
    peak = _peak_bytes(dev)
    assert bool(jnp.isfinite(mps).all()), "DMRG state not finite"
    ref, t_ref_c = _compile(dmrg_run, h, mps0, n_sweeps=ref_sweeps,
                            lanczos_iters=lanczos_iters,
                            sweep_dtype=jnp.float64)
    e_ref = float(ref(h, mps0)[0])
    gap = abs(e - e_ref) / abs(e_ref)
    out = {"N": N, "chi": chi, "n_sweeps": n_sweeps,
           "lanczos_iters": lanczos_iters, "knobs": knobs,
           "energy": e, "energy_ref_f64": e_ref, "ref_sweeps": ref_sweeps,
           "rel_gap": gap, "tol": DMRG_REL_TOL, "wall_s": wall,
           "compile_s": t_prod_c, "ref_compile_s": t_ref_c,
           "memory_analysis": _memory(prod),
           "process_peak_bytes_in_use": peak}
    assert gap <= DMRG_REL_TOL, f"DMRG relative energy gap {gap:.3e}"
    return out


def phase_tdvp(N: int = 32, chi: int = 512, nsteps: int = 4,
               t: float = -0.05, krylov_m: int = 12,
               knobs: dict | None = None) -> dict:
    """Production imaginary-time TDVP (f32) against the same engine at
    f64 and precision "highest" with default knobs."""
    knobs = TDVP_KNOBS if knobs is None else knobs
    dev = jax.devices()[0]
    h, mps0 = _setup(N, chi)
    h32, m32 = (jax.device_put(x.astype(jnp.float32), dev)
                for x in (h, mps0))
    h64, m64 = (jax.device_put(x, dev) for x in (h, mps0))
    common = dict(nsteps=nsteps, order=2, krylov_m=krylov_m,
                  orthogonalize=True)
    prod, t_prod_c = _compile(tdvp_run, h32, m32, t,
                              sweep_dtype=jnp.float32, **common, **knobs)
    prod(h32, m32, t).block_until_ready()  # warm-up
    t0 = time.perf_counter()
    out = prod(h32, m32, t).block_until_ready()
    wall = time.perf_counter() - t0
    peak = _peak_bytes(dev)
    assert bool(jnp.isfinite(out).all()), "TDVP state not finite"
    ref, t_ref_c = _compile(tdvp_run, h64, m64, t,
                            sweep_dtype=jnp.float64, **common)
    want = ref(h64, m64, t)
    infid = 1.0 - float(_normalized_overlap(out, want))
    res = {"N": N, "chi": chi, "nsteps": nsteps, "t": t,
           "krylov_m": krylov_m, "knobs": knobs, "infidelity": infid,
           "tol": TDVP_INFIDELITY_TOL, "wall_s": wall,
           "compile_s": t_prod_c, "ref_compile_s": t_ref_c,
           "memory_analysis": _memory(prod),
           "process_peak_bytes_in_use": peak}
    assert infid <= TDVP_INFIDELITY_TOL, f"TDVP infidelity {infid:.3e}"
    return res


def phase_tci(d: int = 10, tol: float = 1e-8, max_iter: int = 12,
              n_samples: int = 2000) -> dict:
    """TCI2 with the device Pi-matrix fill; the sampled error is taken
    against the host-numpy evaluation of the same function."""
    from benchmarks.tci_device import L, make_fns
    from tensor4all_tpu.tci.tensorci2 import TCI2Options, crossinterpolate2

    batch_f, jax_f = make_fns(d, heavy=False)
    t0 = time.perf_counter()
    tci, ranks, _ = crossinterpolate2(
        jax_f=jax_f, local_dims=[d] * L,
        options=TCI2Options(tol=tol, max_iter=max_iter))
    wall = time.perf_counter() - t0
    idx = np.random.default_rng(1).integers(0, d, size=(n_samples, L))
    tv = np.asarray(tci.to_tensortrain().evaluate_batch(idx))
    rel = float(np.abs(batch_f(idx) - tv).max()) / tci.f_max
    res = {"L": L, "d": d, "tol": tol, "rank": int(max(ranks)),
           "n_evals": int(tci.func.num_evals), "sampled_rel_err": rel,
           "wall_s_incl_compile": wall}
    assert rel <= tol, f"TCI2 sampled relative error {rel:.3e}"
    return res


def phase_sharded(n_devices: int = 4, N: int = 32, chi_dmrg: int = 1024,
                  chi_tdvp: int = 512, n_sweeps: int = 2,
                  lanczos_iters: int = 8, nsteps: int = 1,
                  krylov_m: int = 8, t: float = -0.05) -> dict:
    """chi-partitioned DMRG and TDVP on a 1-D mesh of ``n_devices``
    against the one-device engines with the same sweep settings (f32
    sweeps, every matmul at "highest")."""
    from jax.sharding import Mesh

    from tensor4all_tpu.ops.dmrg_chain import dmrg_run_sharded
    from tensor4all_tpu.ops.tdvp_chain import tdvp_run_sharded

    devices = jax.devices()[:n_devices]
    if len(devices) != n_devices:
        raise SystemExit(f"need {n_devices} devices, have {len(devices)}")
    mesh = Mesh(np.array(devices), ("x",))
    h, mps_d = _setup(N, chi_dmrg)
    ht, mps_t = _setup(N, chi_tdvp)
    f32 = jnp.float32
    with jax.default_matmul_precision("highest"):
        t0 = time.perf_counter()
        e_sh, out_d = dmrg_run_sharded(h, mps_d, mesh, n_sweeps=n_sweeps,
                                       lanczos_iters=lanczos_iters,
                                       sweep_dtype=f32)
        e_sh = float(e_sh)
        t_dmrg = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_t = tdvp_run_sharded(ht, mps_t, t, mesh, nsteps=nsteps,
                                 order=2, krylov_m=krylov_m,
                                 sweep_dtype=f32).block_until_ready()
        t_tdvp = time.perf_counter() - t0
    peaks = {str(d): _peak_bytes(d) for d in devices}
    dmrg_devs = len(out_d.sharding.device_set)
    tdvp_devs = len(out_t.sharding.device_set)
    dev0 = devices[0]
    e_one, _ = dmrg_run(*(jax.device_put(x, dev0) for x in (h, mps_d)),
                        n_sweeps=n_sweeps, lanczos_iters=lanczos_iters,
                        sweep_dtype=f32)
    e_one = float(e_one)
    want = tdvp_run(*(jax.device_put(x, dev0) for x in (ht, mps_t)), t,
                    nsteps=nsteps, order=2, krylov_m=krylov_m,
                    sweep_dtype=f32, orthogonalize=True)
    gap = abs(e_sh - e_one) / abs(e_one)
    infid = 1.0 - float(_normalized_overlap(out_t, jax.device_put(
        want, out_t.sharding)))
    res = {"n_devices": n_devices, "N": N, "chi_dmrg": chi_dmrg,
           "chi_tdvp": chi_tdvp, "n_sweeps": n_sweeps,
           "lanczos_iters": lanczos_iters, "nsteps": nsteps,
           "krylov_m": krylov_m, "energy_sharded": e_sh,
           "energy_one_device": e_one, "rel_gap": gap,
           "tdvp_infidelity": infid,
           "dmrg_output_devices": dmrg_devs,
           "tdvp_output_devices": tdvp_devs,
           "peak_bytes_in_use_after_sharded": peaks,
           "dmrg_sharded_s_incl_compile": t_dmrg,
           "tdvp_sharded_s_incl_compile": t_tdvp}
    assert dmrg_devs == n_devices and tdvp_devs == n_devices, res
    assert gap <= DMRG_REL_TOL, f"sharded DMRG energy gap {gap:.3e}"
    assert infid <= TDVP_INFIDELITY_TOL, f"sharded TDVP infid {infid:.3e}"
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the chi-partitioned engines on 4 cards")
    args = ap.parse_args(argv)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {dev.platform!r}")
    print(f"nvidia-smi: {card_name_and_power_limit()}", flush=True)
    print(f"compile cache: {use_compile_cache()}", flush=True)
    t0 = time.perf_counter()
    if args.four:
        _line("sharded", phase_sharded(4))
    else:
        _line("card", phase_card())
        _line("exact", phase_exact())
        _line("dmrg", phase_dmrg())
        _line("tdvp", phase_tdvp())
        _line("tci", phase_tci())
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
