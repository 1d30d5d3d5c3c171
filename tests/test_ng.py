"""Non-Gaussian stack tests: Laplace approximation, psi-APF / BSF / SPDK.

Oracles:
- exact marginal likelihood of a tiny AR(1)-Poisson model by dense Gauss
  quadrature over the joint state grid;
- LG-exactness: the bootstrap filter on a linear-Gaussian model must
  reproduce the Kalman log-likelihood within Monte-Carlo error
  (`/root/reference/tests/testthat/test_particle_smoother.R` strategy);
- internal consistency: psi / bsf / spdk estimates agree within MC error.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bssm_tpu.core.spec import POISSON
from bssm_tpu.inference import approx as approx_mod
from bssm_tpu.inference import particle as pf_mod
from bssm_tpu.models.ar1 import ar1_ng
from bssm_tpu.models.bsm import bsm_lg
from bssm_tpu.core.priors import uniform_prior, halfnormal_prior
from bssm_tpu.ops import kalman


def exact_poisson_ar1_loglik(y, u, rho, sigma, mu, ngrid=400, width=8.0):
    """Dense-grid integration of the AR(1)-Poisson marginal likelihood."""
    from scipy.stats import norm, poisson

    n = len(y)
    sd_stat = sigma / np.sqrt(1 - rho ** 2)
    grid = np.linspace(mu - width * sd_stat, mu + width * sd_stat, ngrid)
    dx = grid[1] - grid[0]
    # p(alpha_1)
    logp = norm.logpdf(grid, mu, sd_stat)
    for t in range(n):
        if np.isfinite(y[t]):
            logp = logp + poisson.logpmf(y[t], u[t] * np.exp(grid))
        if t < n - 1:
            # integrate: p(a_{t+1}) = int p(a_t) N(a_{t+1}; mu(1-rho)+rho a_t, sigma^2)
            trans = norm.logpdf(grid[None, :],
                                mu * (1 - rho) + rho * grid[:, None], sigma)
            m = logp.max()
            logp = m + np.log(
                (np.exp(logp - m)[:, None] * np.exp(trans) * dx).sum(0))
    m = logp.max()
    return m + np.log(np.exp(logp - m).sum() * dx)


@pytest.fixture
def small_poisson():
    rng = np.random.default_rng(7)
    n = 10
    rho, sigma, mu = 0.7, 0.45, 0.8
    alpha = np.zeros(n)
    alpha[0] = rng.normal(mu, sigma / np.sqrt(1 - rho ** 2))
    for t in range(1, n):
        alpha[t] = mu * (1 - rho) + rho * alpha[t - 1] + sigma * rng.normal()
    y = rng.poisson(np.exp(alpha)).astype(float)
    y[4] = np.nan
    model = ar1_ng(y, rho=uniform_prior(rho, -0.99, 0.99),
                   sigma=halfnormal_prior(sigma, 1.0),
                   mu=uniform_prior(mu, -5, 5), distribution="poisson")
    return model, y, (rho, sigma, mu)


def test_approx_loglik_close_to_exact(small_poisson):
    model, y, (rho, sigma, mu) = small_poisson
    spec = model.build(model.theta_init)
    al = approx_mod.approx_loglik(spec)
    exact = exact_poisson_ar1_loglik(y, np.ones(len(y)), rho, sigma, mu)
    # Laplace approximation is accurate but not exact
    assert abs(float(al.loglik) - exact) < 0.1
    assert int(al.approx.niter) < 100


def test_psi_filter_unbiased(small_poisson):
    model, y, (rho, sigma, mu) = small_poisson
    spec = model.build(model.theta_init)
    al = approx_mod.approx_loglik(spec)
    exact = exact_poisson_ar1_loglik(y, np.ones(len(y)), rho, sigma, mu)

    run = jax.jit(lambda k: pf_mod.psi_filter(spec, al, 64, k).loglik)
    keys = jax.random.split(jax.random.PRNGKey(3), 300)
    lls = np.array([float(run(k)) for k in keys])
    # unbiasedness of the likelihood estimate: E[exp(ll)] = L
    est = np.log(np.mean(np.exp(lls - exact)))
    se = np.std(np.exp(lls - exact)) / np.sqrt(len(lls))
    assert abs(np.exp(est) - 1.0) < 4 * se + 0.02
    # psi-APF should be low variance
    assert np.std(lls) < 0.2


def test_bsf_and_spdk_consistent(small_poisson):
    model, y, (rho, sigma, mu) = small_poisson
    spec = model.build(model.theta_init)
    al = approx_mod.approx_loglik(spec)
    exact = exact_poisson_ar1_loglik(y, np.ones(len(y)), rho, sigma, mu)

    bsf = jax.jit(lambda k: pf_mod.bsf_filter(spec, 512, k).loglik)
    spdk = jax.jit(lambda k: pf_mod.spdk_sample(spec, al, 512, k).loglik)
    kb = jax.random.split(jax.random.PRNGKey(11), 60)
    ll_b = np.array([float(bsf(k)) for k in kb])
    ll_s = np.array([float(spdk(k)) for k in kb])
    est_b = np.log(np.mean(np.exp(ll_b - exact)))
    est_s = np.log(np.mean(np.exp(ll_s - exact)))
    assert abs(est_b) < 0.05
    assert abs(est_s) < 0.05


def test_bsf_lg_matches_kalman(rng):
    y = np.cumsum(rng.normal(size=40) * 0.3) + rng.normal(size=40)
    model = bsm_lg(y, sd_y=uniform_prior(1.0, 0, 10),
                   sd_level=uniform_prior(0.3, 0, 10))
    spec = model.build(model.theta_init)
    ll_kf = float(kalman.log_likelihood(spec))
    run = jax.jit(lambda k: pf_mod.bsf_filter_lg(spec, 2048, k).loglik)
    keys = jax.random.split(jax.random.PRNGKey(5), 40)
    lls = np.array([float(run(k)) for k in keys])
    est = np.log(np.mean(np.exp(lls - ll_kf)))
    assert abs(est) < 0.1


def test_psi_smoother_matches_kalman_smoother(small_poisson):
    """Weighted psi-APF trajectories must reproduce the (approximate)
    smoothed mean within MC error; with many particles, close to the
    exact smoothed mean of the NG model."""
    from bssm_tpu.inference.filters import particle_smoother
    model, y, _ = small_poisson
    res = particle_smoother(model, particles=2000, method="psi", seed=2)
    # oracle: dense-grid smoother marginal means
    spec = model.build(model.theta_init)
    al = approx_mod.approx_loglik(spec)
    g = al.approx.gaussian(spec)
    sm = kalman.smoother(g)
    # psi smoother of the NG model vs its Gaussian approx: close but with
    # non-Gaussian correction; loose tolerance
    np.testing.assert_allclose(np.asarray(res.alphahat[:-1, 0]),
                               np.asarray(sm.alphahat[:-1, 0]), atol=0.15)


def test_bsm_ng_seasonal_noise_T_quirk(rng):
    """With a noise state, the seasonal T row extends its -1 block into the
    noise column, replicating `/root/reference/R/models.R:1024` (the C++
    update_model never rewrites T, so this is the reference's effective
    dynamic); the model must still filter/approximate finite."""
    from bssm_tpu.models.bsm import bsm_ng
    y = rng.poisson(3.0, size=30).astype(float)
    model = bsm_ng(y, sd_level=halfnormal_prior(0.1, 1),
                   sd_slope=halfnormal_prior(0.01, 1),
                   sd_seasonal=halfnormal_prior(0.05, 1),
                   sd_noise=halfnormal_prior(0.05, 1),
                   period=4, distribution="poisson")
    spec = model.build(model.theta_init)
    m = spec.a1.shape[0]            # 1 + 1 + (4-1) + 1 = 6
    assert m == 6
    T = np.asarray(spec.T[0])
    s0 = 2                          # level, slope, then seasonal rows
    np.testing.assert_array_equal(T[s0, s0:m], -np.ones(m - s0))
    # noise sd sits in its own (last) R column only
    R = np.asarray(spec.R[0])
    assert R[m - 1, -1] > 0 and np.all(R[m - 1, :-1] == 0)
    ll = float(approx_mod.approx_loglik(spec).loglik)
    assert np.isfinite(ll)


def test_bsm_ng_seasonal12_dense_oracle_and_recovery(rng):
    """Period-12 seasonal bsm_ng (m = 13).  (a) The Laplace approximation's Gaussian
    model must agree with the exact dense-conditioning oracle at m = 13
    (`/root/reference/R/models.R:926` headline component); (b) the
    smoothed seasonal state must recover the injected monthly pattern."""
    from test_kalman import oracle_conditional
    from bssm_tpu.models.bsm import bsm_ng
    period = 12
    n = 96
    seas_true = 0.8 * np.sin(2 * np.pi * np.arange(period) / period)
    lam = np.exp(1.2 + np.tile(seas_true, n // period))
    y = rng.poisson(lam).astype(float)
    y[10] = np.nan
    model = bsm_ng(y, sd_level=halfnormal_prior(0.02, 0.2),
                   sd_seasonal=halfnormal_prior(0.02, 0.2),
                   period=period, distribution="poisson")
    spec = model.build(model.theta_init)
    assert spec.a1.shape[0] == 1 + (period - 1)    # level + 11 seasonal
    al = approx_mod.approx_loglik(spec)
    g = al.approx.gaussian(spec)

    mean, cov, ll = oracle_conditional(g)
    sm = kalman.smoother(g)
    np.testing.assert_allclose(float(kalman.log_likelihood(g)), ll,
                               rtol=1e-8)
    np.testing.assert_allclose(np.asarray(sm.alphahat).reshape(-1),
                               mean, atol=1e-6)
    m = spec.a1.shape[0]
    cov4 = cov.reshape(g.n + 1, m, g.n + 1, m)
    marg = np.stack([cov4[t, :, t, :] for t in range(g.n + 1)])
    np.testing.assert_allclose(np.asarray(sm.Vt), marg, atol=1e-6)

    # (b) smoothed seasonal component tracks the injected pattern
    seas_hat = np.asarray(sm.alphahat)[period:2 * period, 1]
    err = np.abs(seas_hat - seas_true)
    assert err.mean() < 0.25, (seas_hat, seas_true)
