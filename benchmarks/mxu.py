"""Rate of the plain two-site operator apply, and the card's peaks.

The chi**3 kernel every sweep algorithm rides (DMRG/TDVP/linsolve local
apply): contract the two-site block with its left/right environments
and MPO cores,

    theta' = L . Wl . Wr . theta . R      (einsum alx,lpim,mqjr,aijb,brB)

at production bond dimensions, left to XLA as one ``jnp.einsum``.
Runs K applies chained in one XLA program (one dispatch); FLOPs counted
via opt_einsum's contraction-path cost model on the same path order.

    python benchmarks/mxu.py      # chi 512 and 1024, bf16 and f32-highest
"""

from __future__ import annotations

import subprocess
import time

import numpy as np

# Published dense peaks per card, keyed by ``jax.Device.device_kind``:
# NVIDIA H100 data sheet, SXM part, dense rates without sparsity, at the
# full 700 W power limit. TFLOP/s per precision, HBM bandwidth in TB/s.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0, "tf32_tflops": 495.0, "f32_tflops": 67.0,
        "f64_tensor_tflops": 67.0, "hbm_tbps": 3.35,
    },
}

EXPR = "alx,lpim,mqjr,aijb,brB->xpqB"


def card_name_and_power_limit() -> str:
    """Each card's name and power limit as ``nvidia-smi`` reports them,
    one line per card (a card below its maximum limit runs slower)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def device_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; a card not in the table is an
    error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"add them to benchmarks/mxu.py PEAKS") from None


def _apply_flops(chi: int, w: int, d: int) -> float:
    import opt_einsum as oe

    shapes = [(chi, w, chi), (w, d, d, w), (w, d, d, w),
              (chi, d, d, chi), (chi, w, chi)]
    _, info = oe.contract_path(EXPR, *[np.empty(s, np.float32)
                                       for s in shapes])
    return float(info.opt_cost)


def run(chi: int = 256, w: int = 5, d: int = 2, dtype_name: str = "bfloat16",
        precision: str = "default", k_applies: int = 512,
        reps: int = 5) -> dict:
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(dtype_name)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 5)
    L = jax.random.normal(ks[0], (chi, w, chi), jnp.float32).astype(dtype)
    R = jax.random.normal(ks[1], (chi, w, chi), jnp.float32).astype(dtype)
    Wl = jax.random.normal(ks[2], (w, d, d, w), jnp.float32).astype(dtype)
    Wr = jax.random.normal(ks[3], (w, d, d, w), jnp.float32).astype(dtype)
    th0 = jax.random.normal(ks[4], (chi, d, d, chi), jnp.float32).astype(dtype)

    @jax.jit
    def chain(theta):
        def body(i, th):
            th = jnp.einsum(EXPR, L, Wl, Wr, th, R, optimize=True)
            n = jnp.sqrt(jnp.sum(jnp.square(th.astype(jnp.float32))))
            return (th.astype(jnp.float32)
                    / jnp.maximum(n, 1e-30)).astype(dtype)
        return jax.lax.fori_loop(0, k_applies, body, theta)

    with jax.default_matmul_precision(precision):
        chain(th0).block_until_ready()  # compile
        ts = []
        for r in range(reps):
            th = (th0 * (1.0 + 1e-3 * r)).block_until_ready()
            t0 = time.perf_counter()
            chain(th).block_until_ready()
            ts.append(time.perf_counter() - t0)
    ts.sort()
    t = ts[len(ts) // 2]
    flops = _apply_flops(chi, w, d) * k_applies
    return {
        "chi": chi,
        "w": w,
        "dtype": dtype_name,
        "precision": precision,
        "k_applies": k_applies,
        "total_ms": t * 1e3,
        "tflops": flops / t / 1e12,
    }


if __name__ == "__main__":
    import json

    for chi in (512, 1024):
        for dt, prec in (("bfloat16", "default"), ("float32", "highest")):
            print(json.dumps(run(chi=chi, dtype_name=dt, precision=prec,
                                 k_applies=512 if chi == 512 else 256)))
