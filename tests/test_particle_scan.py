"""The plain `lax.scan` recursions against independent oracles.

- Kalman log-likelihood, fast smoother and backward (FFBS) factors against
  dense joint-Gaussian conditioning of the stacked states, for m = 1..4
  with missing data and time-varying H / D;
- the Laplace mode against a dense Newton iteration on the signal, and the
  approximating model's log-likelihood against the dense Gaussian density,
  per observation family;
- the psi-APF and bootstrap filters: exactness for a Gaussian observation
  family, agreement at high particle counts, the choice of random stream,
  and the resampling schedules (`resample_every` 1, 3 and 4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bssm_tpu.core.spec import GAUSSIAN, LGSpec, NGSpec
from bssm_tpu.inference import approx as amod
from bssm_tpu.inference import particle as pf
from bssm_tpu.ops import kalman

LOG2PI = np.log(2.0 * np.pi)


# ---------------------------------------------------------------------------
# dense oracles
# ---------------------------------------------------------------------------

def _at(A, t):
    A = np.asarray(A, np.float64)
    return A[t] if A.shape[0] > 1 else A[0]


def _dense_prior(spec):
    """Mean (n+1, m) and covariance ((n+1) m, (n+1) m) of the stacked
    states alpha_0..alpha_n under the state equation alone."""
    n = spec.y.shape[0]
    m = spec.a1.shape[0]
    mu = np.zeros((n + 1, m))
    S = np.zeros((n + 1, m, n + 1, m))
    mu[0] = np.asarray(spec.a1)
    S[0, :, 0, :] = np.asarray(spec.P1)
    for t in range(n):
        T, R, C = _at(spec.T, t), _at(spec.R, t), _at(spec.C, t)
        mu[t + 1] = C + T @ mu[t]
        S[t + 1, :, :t + 1, :] = np.einsum('ij,jsk->isk', T,
                                           S[t, :, :t + 1, :])
        S[:t + 1, :, t + 1, :] = np.transpose(S[t + 1, :, :t + 1, :],
                                              (1, 2, 0))
        S[t + 1, :, t + 1, :] = T @ S[t, :, t, :] @ T.T + R @ R.T
    return mu, S.reshape((n + 1) * m, (n + 1) * m)


def _gauss_logpdf(x, mean, cov):
    L = np.linalg.cholesky(cov)
    z = np.linalg.solve(L, x - mean)
    return -0.5 * (len(x) * LOG2PI + 2 * np.log(np.diag(L)).sum() + z @ z)


def _dense_posterior(spec):
    """(log-likelihood, smoothed means (n+1, m), smoothed covariance
    (n+1, m, n+1, m)) of an LGSpec by conditioning the joint Gaussian of
    (states, observed y)."""
    y = np.asarray(spec.y, np.float64)
    n, m = y.shape[0], np.asarray(spec.a1).shape[0]
    mu, Sig = _dense_prior(spec)
    obs = np.where(np.isfinite(y))[0]
    G = np.zeros((len(obs), (n + 1) * m))
    for r, t in enumerate(obs):
        G[r, t * m:(t + 1) * m] = _at(spec.Z, t)
    D = np.array([_at(spec.D, t) for t in obs])
    H = np.array([_at(spec.H, t) for t in obs])
    mean_y = D + G @ mu.ravel()
    Sy = G @ Sig @ G.T + np.diag(H * H)
    ll = _gauss_logpdf(y[obs], mean_y, Sy)
    K = np.linalg.solve(Sy, G @ Sig).T
    post_mu = mu.ravel() + K @ (y[obs] - mean_y)
    post_S = Sig - K @ G @ Sig
    return (ll, post_mu.reshape(n + 1, m),
            post_S.reshape(n + 1, m, n + 1, m))


def _lg_batch(rng, n, m, batch):
    """Random LG specs (float64) with time-varying H and D, a full-rank
    state noise and shared missing observations."""
    y = rng.normal(size=(batch, n))
    y[:, rng.integers(0, n, size=max(1, n // 5))] = np.nan
    A = rng.normal(size=(batch, m, m))
    P = rng.normal(size=(batch, m, m))
    return LGSpec(
        y=jnp.asarray(y), Z=jnp.asarray(rng.normal(size=(batch, 1, m))),
        H=jnp.asarray(np.abs(rng.normal(size=(batch, n))) + 0.3),
        T=jnp.asarray((0.8 * np.eye(m) + 0.1 * A)[:, None]),
        R=jnp.asarray(rng.normal(size=(batch, 1, m, m)) * 0.4),
        a1=jnp.asarray(rng.normal(size=(batch, m))),
        P1=jnp.asarray(np.einsum('bij,bkj->bik', P, P)),
        D=jnp.asarray(rng.normal(size=(batch, n))),
        C=jnp.asarray(rng.normal(size=(batch, 1, m)) * 0.1))


def _one(tree, b):
    return jax.tree_util.tree_map(lambda a: a[b], tree)


LG_GRID = [(37, 1, 3), (37, 2, 5), (23, 3, 2), (19, 4, 130)]


@pytest.mark.parametrize("n,m,batch", LG_GRID)
def test_fast_smoother_ll_matches_dense_oracle(rng, n, m, batch):
    specs = _lg_batch(rng, n, m, batch)
    alpha, ll = jax.jit(jax.vmap(kalman.fast_smoother_ll))(specs)
    for b in range(batch):
        ll_d, mu_d, _ = _dense_posterior(_one(specs, b))
        np.testing.assert_allclose(float(ll[b]), ll_d, rtol=1e-9)
        np.testing.assert_allclose(np.asarray(alpha[b]), mu_d, rtol=1e-7,
                                   atol=1e-8)


@pytest.mark.parametrize("n,m,batch", LG_GRID)
def test_log_likelihood_matches_dense_oracle(rng, n, m, batch):
    specs = _lg_batch(rng, n, m, batch)
    ll = jax.jit(jax.vmap(kalman.log_likelihood))(specs)
    for b in range(batch):
        np.testing.assert_allclose(float(ll[b]),
                                   _dense_posterior(_one(specs, b))[0],
                                   rtol=1e-9)


@pytest.mark.parametrize("n,m,batch", LG_GRID)
def test_smoother_bwd_factors_match_dense_oracle(rng, n, m, batch):
    """(ahat, Lb, Ab) against the dense smoothing law: alpha_t given
    alpha_{t+1} and y has gain J_t = V[t, t+1] V[t+1, t+1]^-1 and
    covariance V[t, t] - J_t V[t+1, t]; alpha_n has covariance V[n, n]."""
    specs = _lg_batch(rng, n, m, batch)
    ahat, Lb, Ab = jax.jit(jax.vmap(kalman.smoother_bwd_factors))(specs)
    LL = np.einsum('btij,btkj->btik', np.asarray(Lb), np.asarray(Lb))
    for b in range(min(batch, 8)):
        _, mu_d, V = _dense_posterior(_one(specs, b))
        np.testing.assert_allclose(np.asarray(ahat[b]), mu_d, rtol=1e-7,
                                   atol=1e-8)
        for t in range(n):
            J = np.linalg.solve(V[t + 1, :, t + 1, :].T,
                                V[t, :, t + 1, :].T).T
            Sig = V[t, :, t, :] - J @ V[t + 1, :, t, :]
            np.testing.assert_allclose(np.asarray(Ab[b, t]), J, rtol=1e-6,
                                       atol=1e-8)
            np.testing.assert_allclose(LL[b, t], Sig, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(LL[b, n], V[n, :, n, :], rtol=1e-7,
                                   atol=1e-9)
        np.testing.assert_array_equal(np.asarray(Ab[b, n]), 0.0)


# ---------------------------------------------------------------------------
# Laplace mode: dense Newton on the signal
# ---------------------------------------------------------------------------

def _family_model(rng, family):
    from bssm_tpu.core.priors import halfnormal_prior, uniform_prior
    from bssm_tpu.models.bsm import bsm_ng
    from bssm_tpu.models.svm import svm
    n = 41
    lvl = np.cumsum(rng.normal(0, .1, n))
    if family == "svm":
        y = rng.normal(0, 1, n) * np.exp(0.4 * np.sin(np.arange(n) / 5))
        return svm(y, rho=uniform_prior(0.9, -0.999, 0.999),
                   sd_ar=halfnormal_prior(0.3, 1.0),
                   sigma=halfnormal_prior(1.0, 2.0))
    kw = dict(sd_level=halfnormal_prior(0.1, 1),
              sd_slope=halfnormal_prior(0.01, 0.1), distribution=family)
    if family == "poisson":
        y = rng.poisson(np.exp(1.0 + lvl)).astype(float)
    elif family == "binomial":
        y = rng.binomial(20, 1 / (1 + np.exp(-lvl))).astype(float)
        kw["u"] = np.full(n, 20.0)
    elif family == "negative binomial":
        y = rng.negative_binomial(3.0, 3.0 / (3.0 + np.exp(1.0 + lvl))
                                  ).astype(float)
        kw["phi"] = 3.0
    else:
        y = rng.gamma(2.0, np.exp(lvl) / 2.0)
        kw["phi"] = 2.0
    y[n // 4] = np.nan
    return bsm_ng(y, **kw)


def _obs_derivs(family, y, u, phi, s):
    """First derivative and negative second derivative of log g(y | s)."""
    if family == "poisson":
        e = u * np.exp(s)
        return y - e, e
    if family == "binomial":
        p = 1.0 / (1.0 + np.exp(-s))
        return y - u * p, u * p * (1 - p)
    if family == "negative binomial":
        e = u * np.exp(s)
        return y - (y + phi) * e / (phi + e), (y + phi) * phi * e / (
            phi + e) ** 2
    if family == "gamma":
        r = phi * y * np.exp(-s) / u
        return r - phi, r
    r = 0.5 * y * y / phi ** 2 * np.exp(-s)                     # svm
    return r - 0.5, r


@pytest.mark.parametrize("family", ["poisson", "binomial",
                                    "negative binomial", "gamma", "svm"])
def test_laplace_mode_matches_dense_newton(rng, family):
    """The converged mode maximises log g(y | s) + log p(s) with the signal
    prior s = D + Z alpha built densely; Newton steps are solved as dense
    Gaussian conditioning.  The Gaussian log-likelihood fused out of the
    last smoother pass equals the dense density of (ytilde, Htilde)."""
    model = _family_model(rng, family)
    spec = model.build(model.theta_init)
    ar = amod.approximate(spec, conv_tol=1e-14, max_iter=200)

    y = np.asarray(spec.y, np.float64)
    n, m = y.shape[0], spec.m
    u = np.asarray(spec.u, np.float64)
    phi = float(spec.phi)
    mu, Sig = _dense_prior(spec)
    G = np.zeros((n, (n + 1) * m))
    for t in range(n):
        if family == "svm":
            G[t, t * m] = 1.0
        else:
            G[t, t * m:(t + 1) * m] = _at(spec.Z, t)
    D = np.zeros(n) if family == "svm" else \
        np.broadcast_to(np.asarray(spec.D, np.float64), (n,))
    mu_s, S_s = D + G @ mu.ravel(), G @ Sig @ G.T
    obs = np.isfinite(y)
    s = np.asarray(spec.initial_mode, np.float64)
    for _ in range(200):
        g1, w = _obs_derivs(family, y[obs], u[obs], phi, s[obs])
        yt = s[obs] + g1 / w
        gain = np.linalg.solve(S_s[np.ix_(obs, obs)] + np.diag(1.0 / w),
                               yt - mu_s[obs])
        s_new = mu_s + S_s[:, obs] @ gain
        done = np.max(np.abs(s_new - s)) < 1e-13
        s = s_new
        if done:
            break
    np.testing.assert_allclose(np.asarray(ar.mode), s, rtol=1e-7,
                               atol=1e-8)

    yt, Ht = np.asarray(ar.ytilde), np.asarray(ar.Htilde)
    dens = _gauss_logpdf(yt[obs], mu_s[obs],
                         S_s[np.ix_(obs, obs)] + np.diag(Ht[obs] ** 2))
    np.testing.assert_allclose(float(ar.gloglik), dens, rtol=1e-9)


# ---------------------------------------------------------------------------
# psi-APF and bootstrap filters
# ---------------------------------------------------------------------------

def _gauss_ng_spec(rng, n=25, m=2, sd=0.8):
    """A linear-Gaussian model written as an NGSpec with the GAUSSIAN
    observation family, so its Laplace approximation is exact."""
    lg = _one(_lg_batch(rng, n, m, 1), 0)
    y = np.asarray(lg.y)
    spec = NGSpec(y=lg.y, Z=lg.Z, T=lg.T, R=lg.R, a1=lg.a1, P1=lg.P1,
                  D=lg.D, C=lg.C, phi=jnp.asarray(sd), u=jnp.ones(n),
                  distribution=GAUSSIAN,
                  initial_mode=jnp.asarray(np.where(np.isfinite(y), y, 0.)))
    lg = lg._replace(H=jnp.full((1,), sd))
    return spec, float(kalman.log_likelihood(lg))


@pytest.mark.parametrize("kk", [1, 3, 4])
def test_psi_exact_for_gaussian_family(rng, kk):
    """With Gaussian observations the approximating model is the model:
    the approximate log-likelihood is the Kalman one, and every psi-APF
    weight is 1, whatever the stream or the resampling schedule."""
    spec, ll_kf = _gauss_ng_spec(rng)
    al = amod.approx_loglik(spec)
    np.testing.assert_allclose(float(al.loglik), ll_kf, rtol=1e-10)
    keys = jax.random.split(jax.random.PRNGKey(kk), 4)
    for nsim in (10, 48):
        lw = jax.jit(jax.vmap(lambda k: pf.psi_logw(
            spec, al, nsim, k, resample_every=kk)))(keys)
        np.testing.assert_allclose(np.asarray(lw), ll_kf, rtol=0,
                                   atol=1e-9)


def _lme(x):
    x = np.asarray(x, np.float64)
    mx = x.max()
    return mx + np.log(np.mean(np.exp(x - mx)))


@pytest.mark.parametrize("kk", [1, 3, 4])
def test_bsf_high_n_matches_kalman_for_gaussian_family(rng, kk):
    """The bootstrap filter's likelihood estimate is unbiased for any
    fixed resampling schedule: at N = 1024 its log-mean-exp over keys is
    the Kalman log-likelihood within Monte Carlo error."""
    spec, ll_kf = _gauss_ng_spec(rng)
    keys = jax.random.split(jax.random.PRNGKey(10 + kk), 16)
    ll = np.asarray(jax.jit(jax.vmap(lambda k: pf.bsf_logw(
        spec, 1024, k, resample_every=kk)))(keys))
    assert np.all(np.isfinite(ll))
    se = ll.std() / np.sqrt(len(ll))
    assert abs(_lme(ll) - ll_kf) < 5 * se + 0.02, (_lme(ll), ll_kf, se)


def _poisson_spec_al(rng, n=23):
    from bssm_tpu.core.priors import halfnormal_prior
    from bssm_tpu.models.bsm import bsm_ng
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, .1, n)))).astype(float)
    y[n // 3] = np.nan
    model = bsm_ng(y, sd_level=halfnormal_prior(0.1, 1),
                   sd_slope=halfnormal_prior(0.01, 0.1),
                   distribution="poisson")
    spec = model.build(model.theta_init)
    return spec, amod.approx_loglik(spec)


@pytest.mark.parametrize("kk", [1, 3, 4])
def test_psi_and_bsf_agree_at_high_n(rng, kk):
    """psi-APF (N = 64) and BSF (N = 1024) estimate the same non-Gaussian
    likelihood, under every resampling schedule."""
    spec, al = _poisson_spec_al(rng)
    keys = jax.random.split(jax.random.PRNGKey(20 + kk), 32)
    a = np.asarray(jax.jit(jax.vmap(lambda k: pf.psi_logw(
        spec, al, 64, k, resample_every=kk)))(keys))
    b = np.asarray(jax.jit(jax.vmap(lambda k: pf.bsf_logw(
        spec, 1024, k, resample_every=kk)))(keys))
    se = (a.std() + b.std()) / np.sqrt(len(keys))
    assert abs(_lme(a) - _lme(b)) < 5 * se + 0.02, (_lme(a), _lme(b), se)


@pytest.mark.parametrize("nsim", [10, 32, 33, 256])
def test_psi_logw_stream_choice(rng, nsim):
    """Up to PREDRAW_MAX_N particles psi_logw consumes randomness drawn in
    one sweep (psi_logw_scan); above it, per-step keys (_psi_logw_keyed).
    The two streams give different estimates, so the threshold is part of
    a run's numerics."""
    spec, al = _poisson_spec_al(rng)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    got = np.asarray(jax.jit(jax.vmap(
        lambda k: pf.psi_logw(spec, al, nsim, k)))(keys))

    def predrawn(k):
        k_e, k_r = jax.random.split(k)
        eps = jax.random.normal(k_e, (spec.n + 1, nsim, spec.m))
        us = jax.random.uniform(k_r, (spec.n, nsim))
        return al.loglik + pf.psi_logw_scan(spec, al, eps, us)

    def keyed(k):
        return al.loglik + pf._psi_logw_keyed(spec, al, nsim, k)

    a = np.asarray(jax.jit(jax.vmap(predrawn))(keys))
    b = np.asarray(jax.jit(jax.vmap(keyed))(keys))
    want, other = (a, b) if nsim <= pf.PREDRAW_MAX_N else (b, a)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert not np.allclose(got, other, rtol=1e-6)


@pytest.mark.parametrize("nsim", [24, 200])
def test_bsf_logw_equals_bsf_filter(rng, nsim):
    """bsf_logw is bsf_filter's log-likelihood without the trajectories:
    same random stream, same value."""
    spec, _ = _poisson_spec_al(rng)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    a = jax.jit(jax.vmap(lambda k: pf.bsf_logw(spec, nsim, k)))(keys)
    b = jax.jit(jax.vmap(lambda k: pf.bsf_filter(spec, nsim, k).loglik))(
        keys)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10)


# ---------------------------------------------------------------------------
# scan-tier consistency and f32 regression tests
# ---------------------------------------------------------------------------

def _ng_batch(rng, n, batch, m2=True, family="poisson"):
    from bssm_tpu.core.priors import halfnormal_prior, uniform_prior
    from bssm_tpu.models.bsm import bsm_ng
    from bssm_tpu.models.svm import svm as svm_model
    if family == "svm":
        y = rng.normal(0, 1, n) * np.exp(0.3 * np.sin(np.arange(n) / 5))
        model = svm_model(y, rho=uniform_prior(0.9, -0.999, 0.999),
                          sd_ar=halfnormal_prior(0.3, 1.0),
                          sigma=halfnormal_prior(1.0, 2.0),
                          dtype=jnp.float32)
        thetas = jnp.asarray(np.stack(
            [rng.normal([0.9, -1.2, 0.0], 0.05) for _ in range(batch)]),
            jnp.float32)
    else:
        y = rng.poisson(
            np.exp(np.cumsum(rng.normal(0, .1, n)))).astype(float)
        y[n // 3] = np.nan
        kw = dict(sd_level=halfnormal_prior(0.1, 1),
                  distribution=family, dtype=jnp.float32)
        if m2:
            kw["sd_slope"] = halfnormal_prior(0.01, 0.1)
        model = bsm_ng(y, **kw)
        d = 2 if m2 else 1
        thetas = jnp.asarray(rng.normal(-2.5, .2, (batch, d)), jnp.float32)

    def make_al(theta):
        spec = model.build(theta)
        al = amod.approx_loglik(spec)
        z = jnp.zeros((), jnp.float32)
        return spec, amod.ApproxLoglik(al.approx, al.scales, z, z)

    return jax.vmap(make_al)(thetas)


def test_psi_logw_estimates_match_psi_filter(rng):
    """psi_logw (pre-generated randomness) and psi_filter (per-step keys)
    estimate the same log-likelihood within MC error at larger N."""
    specs, als = _ng_batch(rng, 31, 1)
    spec = jax.tree_util.tree_map(lambda a: a[0], specs)
    al = jax.tree_util.tree_map(lambda a: a[0], als)
    keys = jax.random.split(jax.random.PRNGKey(0), 96)
    logw_fn = jax.jit(jax.vmap(lambda k: pf.psi_logw(spec, al, 64, k)))
    filt_fn = jax.jit(jax.vmap(lambda k: pf.psi_filter(spec, al, 64,
                                                       k).loglik))
    a = float(np.mean(np.asarray(logw_fn(keys[:48]))))
    b = float(np.mean(np.asarray(filt_fn(keys[48:]))))
    # per-key sd ~= 0.07 => MC se of the diff ~= 0.014; 0.05 ~= 3.5 sigma
    assert abs(a - b) < 0.05


def test_f32_is_weights_stable_at_degenerate_theta(rng):
    """Regression: the f32 psi-APF IS correction must not blow up at
    near-degenerate state noise.  Pre-J-form-smoother, the Durbin-Koopman
    N-recursion (V = P - P N P) lost the smoothed covariance to diffuse-P1
    cancellation (negative variances), and the hard pinv tolerance turned
    eigenvalue noise into conditional gains |A| ~ 500: single corrections
    returned log-weights in the thousands and ESS_IS collapsed to ~1.
    The psi correction satisfies |log_w| <~ 1 by design (suggest_N targets
    sd < 1, `reference/R/post_correction.R:12-46`)."""
    from bssm_tpu.core.priors import halfnormal_prior
    from bssm_tpu.inference.mcmc import _make_correct_one
    from bssm_tpu.models.bsm import bsm_ng

    n = 97
    slope = np.cumsum(rng.normal(0, 0.01, n))
    level = np.cumsum(slope + rng.normal(0, 0.1, n)) + 2.0
    y = rng.poisson(np.exp(0.5 * level / np.abs(level).max() + 1.0))
    model = bsm_ng(y.astype(float), sd_level=halfnormal_prior(0.1, 1.0),
                   sd_slope=halfnormal_prior(0.01, 0.1),
                   distribution="poisson", dtype=jnp.float32)
    # the observed failure regime: sd_level ~ 2e-3, sd_slope ~ 3e-5
    th = jnp.asarray(np.log([[1.9e-3, 2.9e-5], [2.4e-4, 3.9e-3],
                             [1.0e-5, 1.0e-5], [0.04, 0.003]]), jnp.float32)
    modes = jnp.stack([amod.approximate(model.build(t)).mode for t in th])
    c1 = _make_correct_one(model, 10, "psi",
                           want_states=False, want_moments=False)
    f = jax.jit(jax.vmap(lambda t, m, k: c1((t, m, k))["log_w"]))
    for seed in (0, 1, 2, 7, 8, 9):
        keys = jax.random.split(jax.random.PRNGKey(seed), 4)
        lw = np.asarray(f(th, modes, keys))
        assert np.all(np.isfinite(lw)), lw
        assert np.abs(lw).max() < 3.0, lw


def test_psi_logw_large_n_keyed_matches_psi_filter(rng):
    """N > PREDRAW_MAX_N routes psi_logw through the per-step-RNG scan (no
    pre-generated randomness tensor); its stream is exactly psi_filter's,
    so the values must match identically."""
    specs, als = _ng_batch(rng, 23, 1)
    spec = jax.tree_util.tree_map(lambda a: a[0], specs)
    al = jax.tree_util.tree_map(lambda a: a[0], als)
    N = pf.PREDRAW_MAX_N + 16
    key = jax.random.PRNGKey(9)
    lw = float(pf.psi_logw(spec, al, N, key))
    ref = float(pf.psi_filter(spec, al, N, key).loglik)
    np.testing.assert_allclose(lw, ref, rtol=0, atol=5e-5)


def test_psi_keyed_resample_every_consistent(rng):
    """The keyed scan's general weight recursion (resample_every > 1) is
    statistically consistent with every-step resampling."""
    n, B, N = 17, 192, 48
    specs, als = _ng_batch(rng, n, 1, m2=False, family="poisson")
    spec1, al1 = jax.tree_util.tree_map(lambda a: a[0], (specs, als))
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    a = np.asarray(jax.jit(jax.vmap(
        lambda k: pf._psi_logw_keyed(spec1, al1, N, k)))(keys))
    b = np.asarray(jax.jit(jax.vmap(
        lambda k: pf._psi_logw_keyed(spec1, al1, N, k,
                                     resample_every=3)))(keys))
    se = (a.std() + b.std()) / np.sqrt(B)
    assert abs(a.mean() - b.mean()) < 5 * se + 0.02


def test_bsf_logw_keyed_matches_bsf_filter(rng):
    """At resample_every=1 the keyed BSF log-lik equals bsf_filter's
    bitwise (same RNG stream), and resample_every>1 stays consistent."""
    from bssm_tpu.core import distributions as fam
    specs, als = _ng_batch(rng, 23, 1, m2=True, family="poisson")
    spec1 = jax.tree_util.tree_map(lambda a: a[0], specs)
    key = jax.random.PRNGKey(2)
    a = float(pf.bsf_filter(spec1, 24, key).loglik)
    const = float(fam.obs_log_const(spec1.distribution, spec1.y, spec1.u,
                                    spec1.phi))
    b = float(pf._bsf_logw_keyed(spec1, 24, key)) + const
    assert abs(a - b) < 1e-4
    keys = jax.random.split(key, 128)
    c = np.asarray(jax.jit(jax.vmap(
        lambda k: pf.bsf_logw(spec1, 48, k)))(keys))
    d = np.asarray(jax.jit(jax.vmap(
        lambda k: pf.bsf_logw(spec1, 48, k, resample_every=3)))(keys))
    se = (c.std() + d.std()) / np.sqrt(128)
    assert abs(c.mean() - d.mean()) < 5 * se + 0.05
