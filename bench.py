#!/usr/bin/env python
"""Benchmark driver: prints ONE JSON line with the headline metric.

Needs a GPU; on any other platform it exits non-zero. Sections run in
value order under a wall budget (``T4A_BENCH_BUDGET_S``, default 2700 s)
with per-section cold-cost estimates, adaptively rescaled by the
observed actual/estimate ratio; sections the budget skips are listed in
``detail.skipped_sections``. All progress goes to stderr; stdout carries
exactly one JSON line. A failed section is recorded under
``detail.<name>_error`` and makes the exit code 1; SIGTERM/SIGINT print
the JSON gathered so far and exit 128 + the signal number.

Headline metric: DMRG chain N=8, chi=32, 4 sweeps (baseline 135.4 ms,
BASELINE.md). vs_baseline = baseline/ours (>1 means faster).
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

T0 = time.monotonic()
BUDGET = float(os.environ.get("T4A_BENCH_BUDGET_S", "2700"))
RESULT: dict = {}
_EMITTED = False


def _elapsed() -> float:
    return time.monotonic() - T0


def _left() -> float:
    return BUDGET - _elapsed()


def _emit() -> None:
    global _EMITTED
    if _EMITTED or not RESULT:
        return
    _EMITTED = True
    detail = RESULT.setdefault("detail", {})
    if isinstance(detail, dict):
        detail["bench_elapsed_s"] = round(_elapsed(), 1)
    print(json.dumps(RESULT), flush=True)


def _on_signal(signum, frame):  # noqa: ARG001
    detail = RESULT.setdefault("detail", {}) if RESULT else {}
    if isinstance(detail, dict):
        detail["bench_interrupted"] = (
            f"signal {signum} at {_elapsed():.0f}s")
    _emit()
    os._exit(128 + signum)


def _log(msg: str) -> None:
    print(f"[bench {_elapsed():7.1f}s] {msg}", file=sys.stderr,
          flush=True)


def _median_time(fn, warmup: int = 2, reps: int = 5) -> float:
    """Median wall time of ``fn``; ``fn`` must end in a device sync
    (``block_until_ready`` or a host read of the result)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def bench_dmrg_headline():
    from benchmarks.dmrg_chain import headline

    return headline(_median_time)


# ----------------------------------------------------------------- #
# detail sections, budgeted individually                            #
# ----------------------------------------------------------------- #

def _sec_dmrg_prod(chip):
    def fn():
        from benchmarks.dmrg_chain import prod_row

        return prod_row(chip, _median_time)

    return fn


def _sec_mxu():
    from benchmarks.mxu import run as mxu_run

    out = {}
    for chi, k in ((512, 512), (1024, 256)):
        for dt, prec in (("bfloat16", "default"), ("float32", "highest")):
            m = mxu_run(chi=chi, dtype_name=dt, precision=prec,
                        k_applies=k, reps=3)
            out[f"apply_chi{chi}_{dt}_{prec}_tflops"] = round(m["tflops"], 2)
    return out


def _sec_tdvp(chi_p):
    """Imaginary-time TDVP at production chi (jitted one-program
    engine); the bf16 Krylov tail, short backward Krylov and
    CholeskyQR splits of TDVP_KNOBS apply from chi=512 on."""
    import jax
    import jax.numpy as jnp

    from benchmarks.dmrg_chain import TDVP_KNOBS, _setup
    from tensor4all_tpu.ops.tdvp_chain import tdvp_run, tdvp_sweep_flops

    N, d, m, nsteps = 32, 2, 12, 4
    knobs = (TDVP_KNOBS if chi_p >= 512 else
             {k: TDVP_KNOBS[k] for k in ("precision", "reortho",
                                         "gemm2_apply")})
    dev = jax.devices()[0]
    h, mps0 = _setup(N, chi_p)
    h_p = jax.device_put(h.astype(jnp.float32), dev)
    mps_p = jax.device_put(mps0.astype(jnp.float32), dev)

    def body():
        return tdvp_run(h_p, mps_p, -0.05, nsteps=nsteps, order=2,
                        krylov_m=m, sweep_dtype=jnp.float32,
                        orthogonalize=True,
                        **knobs).block_until_ready()

    o = body()  # compile
    # NaN trajectories must never report throughput
    assert bool(jnp.isfinite(o).all()), f"TDVP chi={chi_p} state NaN"
    t = _median_time(body, warmup=0, reps=3)
    fl = tdvp_sweep_flops(N, chi_p, d, h.shape[1], m, nsteps, order=2,
                          reortho=False, gemm2_apply=True,
                          krylov_m1=knobs.get("krylov_m1"))
    tflops = fl / t / 1e12
    key = f"tdvp_N32_chi{chi_p}"
    out = {
        "tdvp_engine": "jitted one-program, f32 imaginary-time",
        f"{key}_4steps_ms": round(t * 1e3, 1),
        f"{key}_tflops": round(tflops, 2),
    }
    return out


def _sec_tdvp_rt(chi):
    """Real-time evolution via the real/imag-split engine (Karatsuba
    3-real-GEMM complex multiplies, one-pass pair-CholeskyQR inner
    conditioner)."""
    import jax
    import jax.numpy as jnp

    from benchmarks.dmrg_chain import _setup
    from tensor4all_tpu.ops.tdvp_chain import tdvp_sweep_flops
    from tensor4all_tpu.ops.tdvp_chain_split import tdvp_run_split

    N, d, m, nsteps = 32, 2, 12, 4
    dev = jax.devices()[0]
    h, mps0 = _setup(N, chi)
    h_d = jax.device_put(h.astype(jnp.float32), dev)
    mr = jax.device_put(mps0.astype(jnp.float32), dev)
    mi = jax.device_put(jnp.zeros_like(mr), dev)

    def body():
        # full-rank bench state: dead-slot completion is a no-op and
        # may be skipped (complete_basis docstring)
        r_, i_ = tdvp_run_split(h_d, mr, mi, 0.0, -0.05, nsteps=nsteps,
                                order=2, krylov_m=m,
                                orthogonalize=True, split_iters=1,
                                complete_basis=False, precision="high",
                                reortho=False, bf16_tail=3,
                                krylov_m1=8, expm_max_squarings=8,
                                karatsuba=True, split_orth="cholqr1")
        return jax.block_until_ready((r_, i_))

    r_, i_ = body()  # compile
    assert bool(jnp.isfinite(r_).all() & jnp.isfinite(i_).all()), \
        f"split TDVP chi={chi} state NaN"
    t = _median_time(body, warmup=0, reps=3)
    fl = tdvp_sweep_flops(N, chi, d, h.shape[1], m, nsteps, order=2,
                          complex_dtype=True, reortho=False,
                          krylov_m1=8, karatsuba=True)
    tflops = fl / t / 1e12
    key = f"tdvp_split_realtime_N32_chi{chi}"
    return {
        f"{key}_{nsteps}steps_ms": round(t * 1e3, 1),
        f"{key}_tflops": round(tflops, 2),
        "tdvp_split_engine": "real/imag-split pairs, f32 Karatsuba",
    }


def _linsolve_setup(chi, chib):
    import jax
    import jax.numpy as jnp

    from benchmarks.dmrg_chain import _setup
    from tensor4all_tpu.ops.dmrg_chain import pad_mps
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    N = 32
    dev = jax.devices()[0]
    h, mps0 = _setup(N, chi)
    h = jax.device_put(h.astype(jnp.float32), dev)
    x0 = jax.device_put(mps0.astype(jnp.float32), dev)
    bt = TensorTrain.random(jax.random.PRNGKey(1), [2] * N, rank=chib,
                            dtype=jnp.float32)
    b = jax.device_put(pad_mps(list(bt.cores), chib), dev)
    return h, b, x0


def _sec_linsolve_fixed(chi, chib):
    """Fixed-2-sweep throughput row (the solve-contract row is
    _sec_linsolve_tol)."""
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.ops.linsolve_chain import (
        linsolve_run,
        linsolve_sweep_flops,
    )

    N, m, ns = 32, 10, 2
    h, b, x0 = _linsolve_setup(chi, chib)

    def body():
        # certify=False in the timed region: the f64 certification scan
        # runs ONCE below
        return jax.block_until_ready(linsolve_run(
            h, b, x0, 1.0, 0.05, n_sweeps=ns, minres_m=m,
            gemm2_apply=True, bf16=True, certify=False))

    body()  # compile
    rel, x = linsolve_run(h, b, x0, 1.0, 0.05, n_sweeps=ns,
                          minres_m=m, gemm2_apply=True, bf16=True,
                          certify=True)
    rel = float(rel)
    assert bool(jnp.isfinite(x).all()), f"linsolve chi={chi} NaN"
    t = _median_time(body, warmup=0, reps=3)
    fl = linsolve_sweep_flops(32, chi, chib, 2, h.shape[1], m, ns,
                              gemm2_apply=True)
    tflops = fl / t / 1e12
    key = f"linsolve_N32_chi{chi}_chib{chib}"
    return {
        "linsolve_engine": "jitted one-program MINRES sweeps, f32",
        f"{key}_{ns}sweeps_ms": round(t * 1e3, 1),
        f"{key}_rel_residual": float(rel),
        f"{key}_tflops": round(tflops, 2),
    }


def _sec_linsolve_tol(chi, chib):
    """Sweep-to-tolerance row: solve until the f64-certified relative
    residual meets the target or the engine's f32 fixed point, the
    reference's solve contract (linsolve/square/updater.rs verify
    report). chib=64 keeps the solution inside the chi manifold so the
    certified number shows the engine's floor, not a truncation
    artifact."""
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.ops.linsolve_chain import (
        linsolve_run_tol,
        linsolve_sweep_flops,
    )

    h, b, x0 = _linsolve_setup(chi, chib)

    def body():
        return jax.block_until_ready(linsolve_run_tol(
            h, b, x0, 1.0, 0.05, tol=1e-6, max_sweeps=8, minres_m=16,
            gemm2_apply=True, bf16=True, precision="high"))

    cert, est, x, sw = body()  # compile
    cert, sw = float(cert), float(sw)
    assert bool(jnp.isfinite(x).all()), f"linsolve_tol chi={chi} NaN"
    t = _median_time(body, warmup=0, reps=3)
    # while-loop sweeps + the static refine epilogue actually executed
    fl = linsolve_sweep_flops(32, chi, chib, 2, h.shape[1], 16,
                              int(sw) + 2, gemm2_apply=True)
    tflops = fl / t / 1e12
    key = f"linsolve_tol_N32_chi{chi}_chib{chib}"
    return {
        f"{key}_ms": round(t * 1e3, 1),
        f"{key}_certified_residual": float(f"{cert:.3e}"),
        f"{key}_sweeps_used": sw,
        f"{key}_tflops": round(tflops, 2),
    }


def _sec_comb(chi, ns=4, reps=3):
    """Tree topology at production backbone chi: the jitted comb
    DMRG engine."""
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.ops.dmrg_comb import (
        comb_heisenberg_stacks,
        dmrg_comb_run,
        dmrg_comb_sweep_flops,
        random_comb_state,
    )

    Nb, Mt, chit, d = 16, 2, 4, 2
    dev = jax.devices()[0]
    wb64, wt64 = comb_heisenberg_stacks(Nb, Mt)
    wb = jax.device_put(wb64.astype(jnp.float32), dev)
    wt = jax.device_put(wt64.astype(jnp.float32), dev)
    ab0, at0 = random_comb_state(jax.random.PRNGKey(0), Nb, Mt, chi,
                                 chit)
    ab0 = jax.device_put(ab0.astype(jnp.float32), dev)
    at0 = jax.device_put(at0.astype(jnp.float32), dev)

    def body():
        e, _, _ = dmrg_comb_run(
            wb, wt, ab0, at0, n_sweeps=ns, lanczos_iters=16,
            tooth_lanczos_iters=8, gemm2_apply=True, reortho=False,
            ritz_solver="bisect_f32", energy_precision="mixed",
            precision="high")
        return e.block_until_ready()

    e = float(body())  # compile
    t = _median_time(body, warmup=0, reps=reps)
    fl = dmrg_comb_sweep_flops(Nb, Mt, chi, chit, d, wb.shape[1], ns,
                               16, 8, gemm2_apply=True, reortho=False)
    tflops = fl / t / 1e12
    key = f"comb_dmrg_Nb16Mt2_chi{chi}"
    return {
        "comb_engine": ("jitted one-program comb-tree DMRG, "
                        "Nb=16 Mt=2 chit=4 (48 sites)"),
        f"{key}_{ns}sweeps_ms": round(t * 1e3, 1),
        f"{key}_e_per_site": round(e / (Nb * (1 + Mt)), 8),
        f"{key}_tflops": round(tflops, 2),
    }


def _sec_comb_tdvp(chi, nsteps=4, reps=3):
    """Tree-topology time evolution at production backbone chi: the
    jitted comb TDVP engine, TFLOP/s from the analytic model of the
    executed Euler-tour sweep work."""
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.ops.dmrg_comb import (
        comb_heisenberg_stacks,
        random_comb_state,
    )
    from tensor4all_tpu.ops.tdvp_comb import (
        tdvp_comb_run,
        tdvp_comb_sweep_flops,
    )

    Nb, Mt, chit, d = 16, 2, 4, 2
    mB, mT = 12, 8
    dev = jax.devices()[0]
    wb64, wt64 = comb_heisenberg_stacks(Nb, Mt)
    wb = jax.device_put(wb64.astype(jnp.float32), dev)
    wt = jax.device_put(wt64.astype(jnp.float32), dev)
    ab0, at0 = random_comb_state(jax.random.PRNGKey(0), Nb, Mt, chi,
                                 chit)
    ab0 = jax.device_put(ab0.astype(jnp.float32), dev)
    at0 = jax.device_put(at0.astype(jnp.float32), dev)

    def body():
        ab, at = tdvp_comb_run(
            wb, wt, ab0, at0, -0.05, nsteps=nsteps, order=2,
            krylov_m=mB, tooth_krylov_m=mT,
            sweep_dtype=jnp.float32, gemm2_apply=True, reortho=False,
            precision="high", expm_max_squarings=8)
        return jax.block_until_ready((ab, at))

    ab, at = body()  # compile
    assert bool(jnp.isfinite(ab).all() & jnp.isfinite(at).all()), \
        f"comb TDVP chi={chi} state NaN"
    t = _median_time(body, warmup=0, reps=reps)
    fl = tdvp_comb_sweep_flops(Nb, Mt, chi, chit, d, wb.shape[1],
                               nsteps, order=2, krylov_m=mB,
                               tooth_krylov_m=mT, gemm2_apply=True,
                               reortho=False)
    tflops = fl / t / 1e12
    key = f"comb_tdvp_Nb16Mt2_chi{chi}"
    return {
        "comb_tdvp_engine": ("jitted one-program comb-tree TDVP, "
                             "Nb=16 Mt=2 chit=4 (48 sites)"),
        f"{key}_{nsteps}steps_ms": round(t * 1e3, 1),
        f"{key}_tflops": round(tflops, 2),
    }


def _sec_tci_cfg2():
    """TCI2 on device, BASELINE config 2 (10-D Gaussian, d=10)."""
    from benchmarks.tci_device import run as tci_run

    rows = tci_run(reps=3, heavy_reps=0, heavy_host=False)
    return _tci_rows_to_detail(rows)


def _sec_tci_heavy():
    """TCI2 device rows at production candidate size (expensive
    jittable integrand). The host-CPU path is too slow to run inside
    the bench."""
    from benchmarks.tci_device import run as tci_run

    rows = tci_run(reps=0, heavy_reps=1, heavy_host=False)
    return _tci_rows_to_detail(rows)


def _tci_rows_to_detail(rows):
    out = {}
    for name, row in rows.items():
        for k in ("ms", "rank", "n_evals", "evals_per_s",
                  "device_fraction_profiled"):
            if k in row:
                out[f"{name}_{k}"] = row[k]
        out[f"{name}_rel_err"] = float(f"{row['rel_err']:.2e}")
    return out


# (name, est cold-cache seconds incl. compile, thunk) — value order.
# Estimates are deliberately pessimistic; the adaptive ratio lets a
# warm-cache run complete everything well inside the budget.
def _sections():
    return [
        ("dmrg_chi512", 110, _sec_dmrg_prod(512)),
        ("dmrg_chi256", 90, _sec_dmrg_prod(256)),
        ("tdvp_chi512", 130, lambda: _sec_tdvp(512)),
        ("tdvp_chi256", 100, lambda: _sec_tdvp(256)),
        ("comb_chi256", 130, lambda: _sec_comb(256)),
        ("tci_cfg2", 110, _sec_tci_cfg2),
        ("linsolve_tol_chi512", 120, lambda: _sec_linsolve_tol(512, 64)),
        ("tdvp_rt_chi512", 150, lambda: _sec_tdvp_rt(512)),
        ("dmrg_chi1024", 140, _sec_dmrg_prod(1024)),
        ("apply", 50, _sec_mxu),
        ("tdvp_rt_chi256", 110, lambda: _sec_tdvp_rt(256)),
        # certify is a static argname: each fixed section compiles TWO
        # programs cold (timed certify=False + one certified report)
        ("linsolve_chi512", 150, lambda: _sec_linsolve_fixed(512, 256)),
        ("linsolve_chi256", 120, lambda: _sec_linsolve_fixed(256, 128)),
        ("linsolve_tol_chi256", 100,
         lambda: _sec_linsolve_tol(256, 64)),
        ("dmrg_chi2048", 220, _sec_dmrg_prod(2048)),
        # 2 sweeps: a throughput row; e_per_site at 2 sweeps is less
        # converged (comb256's 4-sweep row carries the convergence
        # point)
        ("comb_chi512", 150, lambda: _sec_comb(512, ns=2)),
        ("comb_tdvp_chi256", 150, lambda: _sec_comb_tdvp(256)),
        ("tci_heavy", 160, _sec_tci_heavy),
    ]


def main():
    global RESULT
    import jax

    from benchmarks.mxu import card_name_and_power_limit, device_peaks
    from tensor4all_tpu.utils.compile_cache import use_compile_cache

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {dev.platform!r}")
    cache = use_compile_cache()
    card = card_name_and_power_limit()
    _log(f"card {card}; compile cache {cache}")

    RESULT = bench_dmrg_headline()
    detail = RESULT.setdefault("detail", {})
    detail.update({"device_kind": dev.device_kind,
                   "device_count": len(jax.devices()),
                   "nvidia_smi": card,
                   "published_peaks": device_peaks(dev.device_kind)})

    skipped, failed = [], []
    ratio = 1.0  # observed actual/estimate, EMA
    for name, est, fn in _sections():
        need = est * ratio * 1.15 + 10.0
        if _left() < need:
            skipped.append(name)
            _log(f"skip {name}: need ~{need:.0f}s, left {_left():.0f}s")
            continue
        t0 = time.monotonic()
        try:
            _log(f"section {name} (est {est}s, left {_left():.0f}s)")
            detail.update(fn())
        except Exception as e:  # noqa: BLE001 — record, exit 1 at the end
            import traceback

            failed.append(name)
            detail[f"{name}_error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc(file=sys.stderr)
        actual = time.monotonic() - t0
        _log(f"section {name} took {actual:.1f}s")
        ratio = min(max(0.5 * ratio + 0.5 * (actual / est), 0.05), 3.0)
    if skipped:
        detail["skipped_sections"] = skipped
    _emit()
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
