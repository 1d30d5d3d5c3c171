"""Benchmark: IS-MCMC (bsm_ng Poisson, psi-APF) samples/s per GPU + ESS/s.

Baseline (BASELINE.md): the reference runs 20k IS2 iterations with 10
psi-APF particles on the airquality bsm_ng in 7.71 s single-thread CPU
=> 2594 samples/s.  Here the same statistical workload (n=153-length
series, psi-APF correction, RAM adaptive chains) runs as vmapped chains on
one GPU: phase 1 (RAM chains + Laplace solve) and phase 2 (one psi-APF
correction per jump-chain head) as XLA-compiled `lax.scan`/`while_loop`
programs.

Five workloads (BASELINE.json metric: "samples/s/chip (IS-MCMC, bsm_ng
psi-APF N=256); ESS/s"):
  - psi_N10: the reference README config (its own headline number);
  - psi_N256 (+ reference-exact variant): the BASELINE flagship particle
    count;
  - pm_bsf_N200: the reference Table-1 bootstrap config as pm-MCMC;
  - gamma_airquality_N10: the exact 7.71 s baseline-anchor model,
    like-for-like.
IS rows report samples/s and ESS_IS (weight-degeneracy effective-sample
fraction — raw samples/s would reward a badly-weighted chain;
`diagnostics/summary.ess_is`); the pm row reports acceptance.

Prints ONE JSON line naming the device JAX ran on (platform, device_kind,
count) and the card's name and power limit as nvidia-smi reports them.
The benchmark needs a GPU: on any other device it exits non-zero before
running a workload.

The model builders and the device check are shared with chip_smoke.py.
"""
import json
import subprocess
import sys
import time

import numpy as np

BASELINE_SAMPLES_PER_S = 20000 / 7.71


def require_gpu():
    """jax.devices(), or exit non-zero when JAX's default device is not a
    GPU: no measurement falls back to another device."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"needs a GPU; JAX's default device is "
                 f"{devs[0].platform!r} ({devs[0].device_kind})")
    return devs


def card_info():
    """`name, power.limit` lines of nvidia-smi, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _series():
    """The flagship series (airquality-scale, n = 153) and the calmer
    series of the BSF row, from one seeded generator."""
    rng = np.random.default_rng(1)
    n = 153
    slope = np.cumsum(rng.normal(0, 0.01, n))
    level = np.cumsum(slope + rng.normal(0, 0.1, n)) + 2.0
    y = rng.poisson(np.exp(0.5 * level / np.abs(level).max() + 1.0))
    yb = rng.poisson(np.exp(np.cumsum(rng.normal(0, 0.03, n)) + 1.0))
    return y.astype(float), yb.astype(float)


def flagship_model(dtype):
    """bsm_ng Poisson, local linear trend (m = 2), n = 153."""
    from bssm_tpu.core.priors import halfnormal_prior
    from bssm_tpu.models.bsm import bsm_ng
    y, _ = _series()
    return bsm_ng(y, sd_level=halfnormal_prior(0.1, 1.0),
                  sd_slope=halfnormal_prior(0.01, 0.1),
                  distribution="poisson", dtype=dtype)


def bsf_model(dtype):
    """bsm_ng Poisson local level on a calmer series: BSF needs
    sd(log-lik) ~<= 1.5 for pm to mix, and the flagship's drift gives
    sd ~2+ at N=200 (a property of the estimator)."""
    from bssm_tpu.core.priors import halfnormal_prior
    from bssm_tpu.models.bsm import bsm_ng
    _, yb = _series()
    return bsm_ng(yb, sd_level=halfnormal_prior(0.05, 0.5),
                  distribution="poisson", dtype=dtype)


def gamma_model(dtype):
    """The reference's own 7.71 s anchor: gamma bsm_ng on airquality Ozone
    with Wind + Temp regressors (`reference/README.md:226-228`)."""
    from bssm_tpu.core.priors import gamma_prior, normal_prior
    from bssm_tpu.models.bsm import bsm_ng
    from bssm_tpu.utils.datasets import airquality
    aq = airquality()
    xreg = np.column_stack([aq["Wind"], aq["Temp"]])
    return bsm_ng(aq["Ozone"], xreg=xreg,
                  beta=normal_prior(np.zeros(2), 0.0, 1.0),
                  distribution="gamma", phi=gamma_prior(1.0, 2.0, 0.01),
                  sd_level=gamma_prior(1.0, 2.0, 0.1),
                  sd_slope=gamma_prior(1.0, 2.0, 0.1), dtype=dtype)


def _run_workload(model, n_chains, iters, particles, corr_batch, label,
                  resample_every=1):
    from bssm_tpu.diagnostics.summary import ess_is
    from bssm_tpu.inference.mcmc import run_mcmc

    def run(seed):
        return run_mcmc(model, iter=iters, particles=particles,
                        mcmc_type="is2", n_chains=n_chains, seed=seed,
                        output_type="theta", corr_batch=corr_batch,
                        store_modes=False,
                        psi_resample_every=resample_every)

    run(0)                      # compile warm-up
    t0 = time.time()
    out = run(1)
    elapsed = time.time() - t0

    total = n_chains * iters
    w = out.flat_weights()
    eif = float(ess_is(w)) / w.size
    return {
        "label": label, "chains": n_chains, "iters": iters,
        "particles": particles, "resample_every": resample_every,
        "samples_per_s": round(total / elapsed, 1),
        "ess_is_per_s": round(eif * total / elapsed, 1),
        "ess_is_frac": round(eif, 4),
        "elapsed_s": round(elapsed, 3),
        "finite": bool(np.all(np.isfinite(out.posterior))),
    }


def _run_pm_bsf(model, n_chains, iters, particles, label):
    from bssm_tpu.inference.mcmc import run_mcmc

    def run(seed):
        return run_mcmc(model, iter=iters, particles=particles,
                        mcmc_type="pm", sampling_method="bsf",
                        n_chains=n_chains, seed=seed, output_type="theta")

    run(0)
    t0 = time.time()
    out = run(1)
    elapsed = time.time() - t0
    total = n_chains * iters
    return {
        "label": label, "chains": n_chains, "iters": iters,
        "particles": particles,
        "samples_per_s": round(total / elapsed, 1),
        "acceptance": round(float(out.acceptance_rate), 3),
        "elapsed_s": round(elapsed, 3),
        "finite": bool(np.all(np.isfinite(out.posterior))),
    }


def main():
    devs = require_gpu()
    import jax.numpy as jnp

    from bssm_tpu.core.config import use_compile_cache
    use_compile_cache()
    cards = card_info()

    f32 = jnp.float32
    model = flagship_model(f32)
    chains = 4096
    iters = 1000

    w10 = _run_workload(model, chains, iters, 10, 16384, "psi_N10")
    # two N = 256 rows: the period-8 resampling schedule (unbiased for any
    # fixed schedule; ESS_IS reported as evidence) and reference-exact
    # every-step resampling
    w256 = _run_workload(model, chains, iters, 256, 16384, "psi_N256",
                         resample_every=8)
    w256x = _run_workload(model, chains // 4, iters, 256, 16384,
                          "psi_N256_refexact", resample_every=1)
    # BSF with 200 particles (the reference Table-1 bootstrap config,
    # `reference/benchmarks/replications.Rmd:27-78`) as
    # pseudo-marginal MCMC — BSF's natural role
    wb = _run_pm_bsf(bsf_model(f32), chains // 4, 500, 200, "pm_bsf_N200")
    wg = _run_workload(gamma_model(f32), chains, iters, 10, 16384,
                       "gamma_airquality_N10")

    workloads = [w10, w256, w256x, wb, wg]
    result = {
        "metric": "samples_per_s_per_gpu_is_mcmc_bsm_ng_psi",
        "value": w10["samples_per_s"],
        "unit": "samples/s/gpu",
        "vs_baseline": round(w10["samples_per_s"] / BASELINE_SAMPLES_PER_S,
                             2),
        "vs_baseline_gamma_like_for_like": round(
            wg["samples_per_s"] / BASELINE_SAMPLES_PER_S, 2),
        "psi_N256_samples_per_s": w256["samples_per_s"],
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "cards": cards,
        "ess_is_per_s": w10["ess_is_per_s"],
        "finite": all(w["finite"] for w in workloads),
        "workloads": workloads,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
