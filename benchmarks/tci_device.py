"""TCI2 on the accelerator (BASELINE config 2 and a heavy integrand).

Measures crossinterpolate2 with the jittable-f device paths against the
host-numpy batch path, on two configs:

- ``cfg2``: the BASELINE north-star config 2 — 10-D correlated Gaussian,
  d=10, tol 1e-8. Candidate sets are tiny (rank ~6), so this pins the
  DISPATCH-BOUND regime honestly.
- ``heavy``: same Gaussian geometry but d=64 grid points per dim and an
  integrand that costs ~40 Newton iterations per point (Lambert
  W(e^{1+q}) — the "expensive jittable integrand" regime TCI exists
  for). Candidate sets reach rank*d ~ 640 per side, i.e. ~4e5 f-evals
  per bond fill at production size (SURVEY §3.1: the Pi fill is THE hot
  loop, tensorci2.rs:1583-1619).

Paths per config:
  host   — batch_f in numpy on the host CPU (no device involvement)
  jaxf   — device Pi fill (vmapped jax_f, bucket-padded), host rrLU
           (the r3 wiring)
  fused  — ONE device program per bond: fill + rrLU, meta-only sync
           (TensorCI2._fused_bond_update)

Reported per row: wall ms, n_evals, evals/s, sampled relative error,
and for the device paths the measured device-call fraction of wall
(profiled via per-call block-until-ready timing, not assumed).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

L = 10
W_NP = 0.3 + 0.1 * np.arange(L)
NEWTON_K = 40


def make_fns(d, heavy):
    """(batch_f, jax_f) computing the same integrand on host numpy and
    on device."""
    import jax
    import jax.numpy as jnp

    xs_np = np.linspace(-1.0, 1.0, d)
    xs = jnp.asarray(xs_np)
    w = jnp.asarray(W_NP)

    def batch_f(idx):
        x = xs_np[idx]
        q = np.sum(W_NP * x * x, axis=1) + 0.45 * np.sum(
            x[:, :-1] * x[:, 1:], axis=1)
        if not heavy:
            return np.exp(-q)
        t = np.exp(1.0 + q)
        wv = np.log1p(t)  # safe Newton start (w0 >= W(t) for t > 0)
        for _ in range(NEWTON_K):
            ew = np.exp(wv)
            wv = wv - (wv * ew - t) / (ew * (1.0 + wv))
        return wv

    def jax_f(idx):
        x = xs[idx]
        q = jnp.sum(w * x * x) + 0.45 * jnp.sum(x[:-1] * x[1:])
        if not heavy:
            return jnp.exp(-q)
        t = jnp.exp(1.0 + q)

        def newton(_, wv):
            ew = jnp.exp(wv)
            return wv - (wv * ew - t) / (ew * (1.0 + wv))

        return jax.lax.fori_loop(0, NEWTON_K, newton, jnp.log1p(t))

    return batch_f, jax_f


def _timed(fn, acc):
    """Wrap a device-boundary callable: run to COMPLETION and add the
    elapsed wall to acc[0]."""
    import jax

    def g(*a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        r = jax.tree_util.tree_map(np.asarray, r)
        acc[0] += time.perf_counter() - t0
        return r

    return g


def run(reps: int = 3, heavy_reps: int = 1, heavy_host: bool = True):
    import jax

    from tensor4all_tpu.tci.cached_function import make_jax_batch_f
    from tensor4all_tpu.tci.tensorci2 import (
        TCI2Options,
        TensorCI2,
        crossinterpolate2,
        estimate_true_error,
    )

    out = {}
    on_cpu = jax.default_backend() == "cpu"

    def one(name, d, tol, heavy, path, maxiter=12, reps=3):
        batch_f, jax_f = make_fns(d, heavy)
        dev_acc = [0.0]
        if path == "host":
            kw = dict(batch_f=batch_f)
        elif path == "jaxf":
            # identical to passing jax_f=... (crossinterpolate2 wraps it
            # with make_jax_batch_f), but exposes the device boundary
            # for the profile accounting
            kw = dict(batch_f=_timed(make_jax_batch_f(jax_f, L), dev_acc))
        else:
            kw = dict(jax_f=jax_f)
        opts = TCI2Options(tol=tol, max_iter=maxiter,
                           device_bond_update=(path == "fused"))
        res = {}

        if path == "fused":
            # time the fused per-bond programs at their device boundary
            orig = TensorCI2._fused_bond_update

            def patched(self, I_cand, J_cand, o):
                t0 = time.perf_counter()
                r = orig(self, I_cand, J_cand, o)  # meta sync inside
                dev_acc[0] += time.perf_counter() - t0
                return r

            TensorCI2._fused_bond_update = patched

        try:
            ts = []
            for _ in range(reps):
                dev_acc[0] = 0.0
                t0 = time.perf_counter()
                tci, ranks, errs = crossinterpolate2(
                    local_dims=[d] * L, options=opts, **kw)
                ts.append(time.perf_counter() - t0)
                res["tci"], res["ranks"] = tci, ranks
        finally:
            if path == "fused":
                TensorCI2._fused_bond_update = orig
        t_last = ts[-1]  # dev_acc holds the LAST rep's device time
        ts.sort()
        t = ts[len(ts) // 2]
        tci = res["tci"]
        err = estimate_true_error(tci.to_tensortrain(), tci.func,
                                  n_samples=2000)
        row = {
            "ms": round(t * 1e3, 1),
            "rank": int(max(res["ranks"])),
            "rel_err": float(err / max(tci.f_max, 1e-300)),
            "n_evals": int(tci.func.num_evals),
            "evals_per_s": int(tci.func.num_evals / t),
        }
        if path != "host":
            row["device_fraction_profiled"] = round(
                dev_acc[0] / t_last, 3)
        out[name] = row
        print(name, row, file=sys.stderr, flush=True)
        return row

    if reps:
        one("tci_cfg2_host", 10, 1e-8, False, "host", reps=reps)
        if not on_cpu:
            one("tci_cfg2_jaxf", 10, 1e-8, False, "jaxf", reps=reps)
            one("tci_cfg2_fused", 10, 1e-8, False, "fused", reps=reps)
    if heavy_host and heavy_reps:
        # minutes on one host core: skipped inside bench.py
        one("tci_heavy_host", 64, 1e-9, True, "host", reps=heavy_reps)
    if not on_cpu and heavy_reps:
        one("tci_heavy_jaxf", 64, 1e-9, True, "jaxf", reps=heavy_reps)
        one("tci_heavy_fused", 64, 1e-9, True, "fused",
            reps=heavy_reps)
    return out


if __name__ == "__main__":
    import json

    from tensor4all_tpu.utils.compile_cache import use_compile_cache

    use_compile_cache()
    print(json.dumps(run()))
