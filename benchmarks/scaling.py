"""Chain-scaling / weak-scaling benchmark harness.

Measures IS-MCMC throughput (samples/s) as the chain count grows, on
whatever devices are visible:
  - one device: vectorisation efficiency (throughput should grow ~linearly
    with chains until the device saturates);
  - a multi-device mesh (or the CPU virtual mesh): weak-scaling efficiency
    of the sharded phase-1 chains + phase-2 correction.

Usage: python benchmarks/scaling.py [--chains 4 16 64] [--iter 1000]
Emits one JSON line per configuration plus a final summary line.
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
    ap.add_argument("--chains", type=int, nargs="+",
                    default=[4, 16, 64])
    ap.add_argument("--iter", type=int, default=1000)
    ap.add_argument("--particles", type=int, default=10)
    ap.add_argument("--n", type=int, default=100)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from bssm_tpu.core.priors import halfnormal_prior
    from bssm_tpu.inference.mcmc import run_mcmc
    from bssm_tpu.models.bsm import bsm_ng
    from bssm_tpu.parallel.mesh import make_mesh

    dtype = jnp.float32 if jax.devices()[0].platform != "cpu" \
        else jnp.float64
    rng = np.random.default_rng(0)
    lvl = np.cumsum(rng.normal(0, 0.1, args.n)) + 1.0
    y = rng.poisson(np.exp(0.4 * lvl)).astype(float)
    model = bsm_ng(y, sd_level=halfnormal_prior(0.1, 1.0),
                   sd_slope=halfnormal_prior(0.01, 0.1),
                   distribution="poisson", dtype=dtype)

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev, axes=("chains", "draws"),
                     shape=(n_dev, 1)) if n_dev > 1 else None

    results = []
    for n_chains in args.chains:
        if mesh is not None and n_chains % n_dev != 0:
            continue

        def run(seed):
            return run_mcmc(model, iter=args.iter,
                            particles=args.particles, mcmc_type="is2",
                            n_chains=n_chains, seed=seed,
                            output_type="theta", mesh=mesh, corr_batch=256)

        run(0)                       # warm-up / compile
        t0 = time.time()
        out = run(1)
        dt = time.time() - t0
        sps = n_chains * args.iter / dt
        row = {"chains": n_chains, "elapsed_s": round(dt, 2),
               "samples_per_s": round(sps, 1),
               "per_chain_sps": round(sps / n_chains, 1),
               "devices": n_dev,
               "finite": bool(np.all(np.isfinite(out.posterior)))}
        results.append(row)
        print(json.dumps(row))

    if len(results) >= 2:
        base = results[0]
        eff = (results[-1]["samples_per_s"] / results[-1]["chains"]) / \
            (base["samples_per_s"] / base["chains"])
        print(json.dumps({"metric": "chain_scaling_efficiency",
                          "value": round(eff, 3),
                          "from_chains": base["chains"],
                          "to_chains": results[-1]["chains"]}))


if __name__ == "__main__":
    main()
