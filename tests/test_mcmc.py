"""End-to-end MCMC tests.

Mirrors the reference's statistical strategy
(`/root/reference/tests/testthat/test_mcmc.R`):
- with all-missing y the posterior must recover the prior;
- Gaussian marginal MCMC on a local-level model recovers simulation truth;
- IS-corrected runs produce finite weights and consistent posteriors.
"""
import numpy as np
import pytest

from bssm_tpu.core.priors import (halfnormal_prior, normal_prior,
                                  uniform_prior)
from bssm_tpu.inference.mcmc import run_mcmc
from bssm_tpu.models.ar1 import ar1_ng
from bssm_tpu.models.bsm import bsm_lg, bsm_ng


def test_prior_recovery_all_missing():
    """Posterior == prior when y is all NaN (`test_mcmc.R:8-36`)."""
    n = 30
    y = np.full(n, np.nan)
    model = ar1_ng(y, rho=uniform_prior(0.5, -1.0, 1.0),
                   sigma=halfnormal_prior(0.5, 0.5),
                   mu=normal_prior(1.0, 1.0, 0.5),
                   distribution="poisson")
    out = run_mcmc(model, iter=20000, mcmc_type="approx", seed=3,
                   output_type="theta")
    th = out.flat_theta()
    # prior means: rho ~ U(-1,1) -> 0; sigma ~ HN(0.5) -> 0.5*sqrt(2/pi);
    # mu ~ N(1, 0.5)
    assert abs(th[:, 0].mean() - 0.0) < 0.1
    assert abs(th[:, 1].mean() - 0.5 * np.sqrt(2 / np.pi)) < 0.06
    assert abs(th[:, 2].mean() - 1.0) < 0.1


def test_gaussian_mcmc_local_level(rng):
    n = 120
    level = np.cumsum(rng.normal(0, 0.5, n))
    y = level + rng.normal(0, 1.0, n)
    model = bsm_lg(y, sd_y=halfnormal_prior(1.0, 5.0),
                   sd_level=halfnormal_prior(0.5, 5.0))
    out = run_mcmc(model, iter=6000, seed=1, output_type="full")
    assert 0.1 < out.acceptance_rate < 0.5
    th = out.flat_theta()
    assert abs(np.log(th[:, 0].mean()) - np.log(1.0)) < 0.5
    assert abs(np.log(th[:, 1].mean()) - np.log(0.5)) < 0.7
    # state draws track the true level
    alpha = out.alpha.reshape(-1, n + 1, 1)
    lvl_mean = alpha[:, :n, 0].mean(axis=0)
    assert np.corrcoef(lvl_mean, level)[0, 1] > 0.9


def test_gaussian_mcmc_summary_mode(rng):
    n = 60
    y = np.cumsum(rng.normal(0, 0.3, n)) + rng.normal(0, 1.0, n)
    model = bsm_lg(y, sd_y=halfnormal_prior(1.0, 5.0),
                   sd_level=halfnormal_prior(0.3, 5.0))
    out = run_mcmc(model, iter=3000, seed=2, output_type="summary")
    assert out.alphahat.shape == (n + 1, 1)
    assert out.Vt.shape == (n + 1, 1, 1)
    assert np.all(np.isfinite(out.alphahat))
    assert np.all(np.linalg.eigvalsh(out.Vt) > -1e-8)


@pytest.mark.parametrize("mcmc_type", ["is2", "pm", "da"])
def test_ng_mcmc_variants(rng, mcmc_type):
    n = 60
    alpha = np.zeros(n)
    for t in range(1, n):
        alpha[t] = 0.2 + 0.8 * alpha[t - 1] + 0.3 * rng.normal()
    y = rng.poisson(np.exp(alpha)).astype(float)
    model = ar1_ng(y, rho=uniform_prior(0.6, -0.99, 0.99),
                   sigma=halfnormal_prior(0.3, 1.0),
                   mu=normal_prior(0.5, 0.0, 2.0),
                   distribution="poisson")
    out = run_mcmc(model, iter=1500, particles=10, mcmc_type=mcmc_type,
                   seed=4, output_type="full")
    th = out.flat_theta()
    assert np.all(np.isfinite(th))
    assert np.all(np.isfinite(out.posterior))
    assert out.alpha is not None and np.all(np.isfinite(out.alpha))
    if mcmc_type == "is2":
        w = out.flat_weights()
        assert np.all(w > 0)
        # IS weights should be well-behaved with psi-APF
        cv = w.std() / w.mean()
        assert cv < 1.0
    # posterior concentrates near truth (loose)
    assert abs(np.average(th[:, 0], weights=out.flat_weights()) - 0.8) < 0.25


def test_is2_matches_is3_statistically(rng):
    n = 40
    alpha = np.zeros(n)
    for t in range(1, n):
        alpha[t] = 0.7 * alpha[t - 1] + 0.4 * rng.normal()
    y = rng.poisson(np.exp(alpha)).astype(float)
    model = ar1_ng(y, rho=uniform_prior(0.6, -0.99, 0.99),
                   sigma=halfnormal_prior(0.4, 1.0),
                   distribution="poisson")
    o2 = run_mcmc(model, iter=2500, particles=10, mcmc_type="is2", seed=6,
                  output_type="theta")
    o3 = run_mcmc(model, iter=2500, particles=10, mcmc_type="is3", seed=7,
                  output_type="theta")

    def wmean(o):
        return np.average(o.flat_theta(), axis=0, weights=o.flat_weights())

    np.testing.assert_allclose(wmean(o2), wmean(o3), atol=0.1)


def test_is2_weights_constant_within_jump_chain(rng):
    """is2 corrects each jump-chain head once and shares the weight across
    duplicates (`/root/reference/src/approx_mcmc.cpp:364-368`): within a
    segment of rejected proposals the IS weight must be exactly constant."""
    n = 40
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, 0.2, n)))).astype(float)
    model = bsm_ng(y, sd_level=halfnormal_prior(0.2, 1.0),
                   distribution="poisson")
    out = run_mcmc(model, iter=800, particles=10, mcmc_type="is2", seed=4,
                   output_type="full", n_chains=2)
    for c in range(2):
        acc = out.accepted[c].astype(bool).copy()
        acc[0] = True
        seg = np.cumsum(acc)
        w = out.weights[c]
        a = out.alpha[c]
        for s in np.unique(seg):
            sel = seg == s
            assert np.all(w[sel] == w[sel][0])
            assert np.all(a[sel] == a[sel][0])


def test_local_approx_false_global_approximation(rng):
    """local_approx=False freezes (ytilde, Htilde) at the initial theta
    (`/root/reference/src/model_ssm_ung.cpp:104-113`); the resulting IS
    posterior must agree with the default local approximation within MC
    error because the psi-APF correction is exact for both."""
    n = 50
    alpha = np.zeros(n)
    for t in range(1, n):
        alpha[t] = 0.75 * alpha[t - 1] + 0.35 * rng.normal()
    y = rng.poisson(np.exp(alpha)).astype(float)
    model = ar1_ng(y, rho=uniform_prior(0.6, -0.99, 0.99),
                   sigma=halfnormal_prior(0.4, 1.0),
                   distribution="poisson")
    o_loc = run_mcmc(model, iter=2500, particles=10, mcmc_type="is2",
                     seed=11, output_type="theta", local_approx=True)
    o_glob = run_mcmc(model, iter=2500, particles=10, mcmc_type="is2",
                      seed=12, output_type="theta", local_approx=False)

    def wmean(o):
        return np.average(o.flat_theta(), axis=0, weights=o.flat_weights())

    assert np.all(np.isfinite(o_glob.posterior))
    assert np.all(o_glob.flat_weights() > 0)
    np.testing.assert_allclose(wmean(o_loc), wmean(o_glob), atol=0.12)


def test_store_modes_false_matches(rng):
    """run_mcmc(store_modes=False) drops the (chains, S, n) Laplace-mode
    stack (the long-series device-memory wall) and recomputes
    modes cold in the correction — identical chains, log-weights equal to
    approximation tolerance."""
    import jax.numpy as jnp
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, 35)))).astype(float)

    def build():
        return bsm_ng(y, sd_level=halfnormal_prior(0.1, 1),
                      distribution="poisson", dtype=jnp.float32)

    a = run_mcmc(build(), iter=200, particles=10, mcmc_type="is2",
                 n_chains=2, output_type="theta", seed=5, store_modes=True)
    b = run_mcmc(build(), iter=200, particles=10, mcmc_type="is2",
                 n_chains=2, output_type="theta", seed=5, store_modes=False)
    np.testing.assert_array_equal(np.asarray(a.theta), np.asarray(b.theta))
    # log-weights agree to psi-filter MC tolerance: the recomputed
    # approximation differs by ~conv_tol, which can flip individual
    # stratified-resampling selections inside the psi filter — per-slot
    # differences are bounded by the estimator's MC noise, and the mean
    # correction must agree tightly
    d = np.asarray(a.posterior) - np.asarray(b.posterior)
    assert np.abs(d).max() < 1.0
    assert abs(d.mean()) < 0.02
    assert b.modes is None
    # summary output exercises the ops.psi mode-recompute path
    c = run_mcmc(build(), iter=150, particles=10, mcmc_type="is2",
                 n_chains=2, output_type="summary", seed=5,
                 store_modes=False)
    assert np.all(np.isfinite(np.asarray(c.alphahat)))
