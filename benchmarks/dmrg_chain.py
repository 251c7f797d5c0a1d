"""DMRG chain rows of the bench: the N=8 headline and the N=32 rows.

Headline: Heisenberg chain N=8, chi=32, 4 sweeps. Reference: 135.4 ms
mean (Rust, 1 thread), energy err 5.3e-15 vs dense exact — BASELINE.md
row 1.

Uses the fully-jitted fixed-shape sweep engine (ops.dmrg_chain): the
whole multi-sweep run is one XLA program. Both rows need an accelerator;
they never fall back to a host engine.
"""

from __future__ import annotations

import numpy as np


def _setup(N, chi):
    """(padded MPO, padded right-canonical random MPS) for the open
    Heisenberg chain; numpy-built MPO, no networkx."""
    import jax

    from tensor4all_tpu.models.chain import heisenberg_chain_mpo
    from tensor4all_tpu.ops.dmrg_chain import pad_mpo, pad_mps
    from tensor4all_tpu.tt.compression import right_orthogonalize
    from tensor4all_tpu.tt.tensortrain import TensorTrain

    h = pad_mpo(heisenberg_chain_mpo(N))
    tt = right_orthogonalize(TensorTrain.random(
        jax.random.PRNGKey(0), [2] * N, rank=chi))
    return h, pad_mps(list(tt.cores), chi)


def headline(median_time):
    """The BASELINE headline row alone: DMRG chain N=8 chi=32, 4 sweeps
    (reference 135.4 ms). Production-chi rows live in `prod_row` so the
    bench driver can budget them individually."""
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.models.chain import heisenberg_chain_mpo, mpo_to_dense
    from tensor4all_tpu.ops.dmrg_chain import dmrg_run

    N, chi = 8, 32
    h, mps0 = _setup(N, chi)
    device = jax.devices()[0]
    h_d = jax.device_put(h, device)
    mps_d = jax.device_put(mps0, device)
    result = {}

    # f32 sweeps; the energy is a global f64 Rayleigh quotient, so the
    # state error eps_f32 costs only O(eps^2) (ops.dmrg_chain docstring)
    def body():
        e, _ = dmrg_run(h_d, mps_d, n_sweeps=4, lanczos_iters=12,
                        sweep_dtype=jnp.float32)
        result["energy"] = e.block_until_ready()
        return e

    t = median_time(body, warmup=2, reps=5)
    e0 = np.linalg.eigvalsh(mpo_to_dense(heisenberg_chain_mpo(N)))[0]
    return {
        "metric": "dmrg_chain_N8_chi32_4sweeps_ms",
        "value": t * 1e3,
        "unit": "ms",
        "vs_baseline": 135.4 / (t * 1e3),
        "detail": {
            "energy_abs_err": abs(float(result["energy"]) - e0),
            "sweep_dtype": "float32",
            "engine": "jitted one-program",
        },
    }


# Sweep counts per chi for the production schedule below (e/site agrees
# with longer all-fine runs to ~1e-7/site at every chi). chi=2048 is the
# memory-ceiling row: ONE rep — it pins that the engine fits and what it
# costs, not throughput.
PROD_CONFIGS = {256: (4, 16), 512: (4, 16), 1024: (3, 16),
                2048: (3, 16)}

# Production schedule: all but the LAST sweep run coarse (bf16 basis,
# m=8 3-term-recurrence Lanczos, Newton-Schulz splits at one subspace
# iteration); the final fine sweep (m=16, QR splits) restores the
# f32-grade state. Ritz pairs by f32 Sturm bisection; the final Rayleigh
# quotient at f32-'highest' grade (~1e-6 relative, the state itself is
# unchanged). The fine sweep runs at "highest": "high" is TF32 on the
# H100 and left a 1.1e-4 relative energy gap to the f64 run at N=32
# chi=1024, where "highest" gives 5.6e-7 (chip_smoke.py phase 3).
PROD_KNOBS = dict(coarse_lanczos_iters=8, coarse_bf16=True,
                  coarse_reortho=False, coarse_ns_split=True,
                  gemm2_apply=True, fine_reortho=False,
                  fine_precision="highest", ritz_solver="bisect_f32",
                  energy_precision="mixed", fine_split_iters=1)


# Production knobs of the imaginary-time TDVP rows at chi >= 512: a bf16
# Krylov tail after 2 full-precision iterations (factorial coefficient
# decay, tdvp_run docstring), a shorter backward one-site Krylov, a
# tighter expm squaring bound and shifted-CholeskyQR splits.
TDVP_KNOBS = dict(precision="high", reortho=False, gemm2_apply=True,
                  bf16_tail=2, krylov_m1=6, expm_max_squarings=8,
                  cholqr_split=True)


def prod_row(chip, median_time):
    """One production-scale DMRG row (N=32) with TFLOP/s from the
    analytic engine FLOP model. Raises on failure."""
    import jax
    import jax.numpy as jnp

    from tensor4all_tpu.ops.dmrg_chain import dmrg_run, dmrg_sweep_flops

    sweeps, lanc = PROD_CONFIGS[chip]
    Np = 32
    device = jax.devices()[0]
    hp, mpsp = _setup(Np, chip)
    hp = jax.device_put(hp, device)
    mpsp = jax.device_put(mpsp, device)

    def big():
        e, _ = dmrg_run(hp, mpsp, n_sweeps=sweeps, lanczos_iters=lanc,
                        sweep_dtype=jnp.float32, coarse_sweeps=sweeps - 1,
                        **PROD_KNOBS)
        return float(e.block_until_ready())

    ep = big()  # compile
    reps = 1 if chip >= 2048 else 3
    tp = median_time(big, warmup=0, reps=reps)
    fl = dmrg_sweep_flops(Np, chip, 2, hp.shape[1], lanc, sweeps,
                          coarse_sweeps=sweeps - 1,
                          coarse_lanczos_iters=8, coarse_reortho=False,
                          coarse_ns_split=True, fine_reortho=False,
                          gemm2_apply=True, fine_split_iters=1)
    key = f"dmrg_N32_chi{chip}"
    out = {
        f"{key}_{sweeps}sweeps_ms": round(tp * 1e3, 1),
        f"{key}_e_per_site": round(ep / Np, 8),
        f"{key}_tflops": round(fl / tp / 1e12, 2),
    }
    if reps == 1:
        out[f"{key}_reps"] = 1  # memory-ceiling row
    return out
