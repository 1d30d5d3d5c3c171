"""IRE harness: psi-APF vs BSF vs EKPF log-likelihood efficiency.

Same experimental design as `/root/reference/vignettes/psi_pf.Rmd:107-267`
(different constants — shorter horizon, fewer replications, and the filter
runs at the simulation theta rather than the vignette's modified one, so
the absolute IRE numbers are NOT directly comparable to the published
table; the method ORDERING is): on the nonlinear logistic growth model,
estimate the log-likelihood with each particle filter at N in
{10, 100, 1000} over `--reps` independent replications, and report
IRE = MSE x mean-time against a 100k-particle BSF reference value.  The
reference found the psi-APF IRE "several orders of magnitude smaller" than
BSF/EKPF at equal N; this harness reproduces that ordering (replications
run as one vmapped batch per (method, N) cell, so "mean time" is
wall-time / reps of the batched run — the accelerator cost model, where
replications are free parallelism).  `JAX_PLATFORMS=cpu` runs it on the
host CPU.

Usage: python benchmarks/psi_ire.py [--reps 200] [--n 300] [--ref-N 100000]
"""
from __future__ import annotations
import sys as _sys, pathlib as _pl
_sys.path.insert(0, str(_pl.Path(__file__).resolve().parents[1]))

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--ref-N", type=int, default=100_000)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bssm_tpu.inference import nlg as nlg_mod
    from bssm_tpu.models.examples import nlg_growth, simulate_growth

    y = simulate_growth(n=args.n, seed=42)
    model = nlg_growth(np.asarray(y, dtype=float))
    spec = model.build(jnp.asarray(model.theta_init))

    # ref_N-particle BSF reference log-likelihood, run in 10 memory-bounded
    # chunks combined on the LIKELIHOOD scale (logsumexp - log 10): the
    # average of 10 ref_N/10-particle estimators of the likelihood is
    # exactly one ref_N-particle estimator, so the O(1/N) downward bias of
    # the log matches a true single ref_N run (averaging the chunk LOGS
    # would keep 10x that bias)
    from jax.scipy.special import logsumexp
    ref_lls = []
    for s in range(10):
        ref_lls.append(float(jax.jit(
            lambda k: nlg_mod.bsf_filter_nlg(spec, args.ref_N // 10,
                                             k).loglik)(
            jax.random.PRNGKey(1000 + s))))
    ref_ll = float(logsumexp(jnp.asarray(ref_lls)) - np.log(len(ref_lls)))
    print(json.dumps({"reference_loglik": round(ref_ll, 4),
                      "ref_chunk_sd": round(float(np.std(ref_lls)), 4),
                      "ref_N": args.ref_N,
                      "ref_chunks": f"10x{args.ref_N // 10}"}))

    approx = jax.jit(nlg_mod.approximate_nlg)(spec)

    def make(method, N):
        if method == "psi":
            f = lambda k: nlg_mod.psi_filter_nlg(spec, approx, N, k).loglik
        elif method == "bsf":
            f = lambda k: nlg_mod.bsf_filter_nlg(spec, N, k).loglik
        else:
            f = lambda k: nlg_mod.ekpf_filter(spec, N, k).loglik
        return jax.jit(jax.vmap(f))

    rows = []
    keys = jax.random.split(jax.random.PRNGKey(7), args.reps)
    for method in ("psi", "bsf", "ekpf"):
        for N in (10, 100, 1000):
            fn = make(method, N)
            lls = np.asarray(fn(keys))           # compile warm-up
            t0 = time.time()
            lls = np.asarray(jax.block_until_ready(fn(keys)))
            mean_t = (time.time() - t0) / args.reps
            finite = np.isfinite(lls)
            mse = float(np.mean((lls[finite] - ref_ll) ** 2)) \
                if finite.any() else float("inf")
            row = {"method": method, "N": N,
                   "mean_loglik": round(float(np.mean(lls[finite])), 4)
                   if finite.any() else None,
                   "mse": round(mse, 6),
                   "mean_time_s": round(mean_t, 6),
                   "IRE": round(mse * mean_t, 8),
                   "finite_frac": round(float(finite.mean()), 3)}
            rows.append(row)
            print(json.dumps(row))

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"reference_loglik": ref_ll, "rows": rows}, f,
                      indent=1)


if __name__ == "__main__":
    main()
