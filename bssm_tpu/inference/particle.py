"""Particle filters: psi-APF, bootstrap, and SPDK importance sampling.

Re-design of `reference/src/model_ssm_ung.cpp:511-712` and
`/root/reference/src/model_ssm_ulg.cpp:557-672`:

- the particle axis is fully vectorised (`vmap`-free batched algebra); the
  only sequential axis is time (`lax.scan`);
- stratified resampling happens every step exactly as in the reference
  (no ESS adaptivity) so statistics match;
- log-sum-exp weight normalisation with max-shift, degenerate ensembles
  collapse the log-likelihood to -inf instead of erroring;
- RNG is a threefry key per (step, purpose) — replaces the sequential
  sitmo engine draws.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import distributions as fam
from ..core.spec import LGSpec, NGSpec, SVM
from ..ops import kalman
from ..ops.chol import psd_chol
from ..ops.resample import stratified_indices, stratified_select
from .approx import ApproxLoglik

# Particle counts up to which `psi_logw` pre-draws all of its randomness;
# above it the randomness is drawn per step (see `psi_logw`).
PREDRAW_MAX_N = 32


class PFResult(NamedTuple):
    """Particle-filter output.  ORDER CONTRACT: ``alpha`` is always in time
    order (alpha[:, t] is time t).  ``weights`` columns are in *generation*
    order: time order for the forward filters (bsf), REVERSE time order for
    the backward-factorized ``psi_filter`` (column 0 = t = n).  In both
    cases ``weights[:, -1]`` is the final importance weight of the complete
    trajectories — the only column downstream consumers may use.  Per-time
    weighted summaries from a psi PFResult must flip the weight axis."""
    loglik: jnp.ndarray
    alpha: jnp.ndarray     # (N, n+1, m) particle trajectories (pre-tracing)
    weights: jnp.ndarray   # (N, n+1) normalised weights, generation order
    indices: jnp.ndarray   # (N, n) resampling ancestors


def _lse_update(logw, N, dtype):
    # non-finite particle weights (f32 overflow artifacts) count as zero
    logw = jnp.where(jnp.isfinite(logw), logw, -jnp.inf)
    mx = jnp.max(logw)
    w = jnp.exp(logw - mx)
    sw = jnp.sum(w)
    ok = (sw > 0) & jnp.isfinite(mx)
    inc = jnp.where(ok, mx + jnp.log(sw / N), -jnp.inf)
    normw = jnp.where(ok, w / jnp.where(sw > 0, sw, 1.0),
                      jnp.ones_like(w) / N)
    return inc.astype(dtype), normw


def _bc(A, n):
    return jnp.broadcast_to(A, (n,) + A.shape[1:]) if A.shape[0] == 1 else A


def _signals(spec, alpha_particles, Z_t, D_t):
    """Per-particle signal at one time: alpha (N, m) -> (N,)."""
    if spec.distribution == SVM:
        return alpha_particles[:, 0]
    return D_t + alpha_particles @ Z_t


def psi_filter(spec: NGSpec, al: ApproxLoglik, nsim: int, key) -> PFResult:
    """psi-auxiliary particle filter twisted by the Gaussian approximation
    (`/root/reference/src/model_ssm_ung.cpp:511-609`).

    Proposal: the smoothing distribution of the approximating LG model in
    its BACKWARD (FFBS) factorization — generation runs t = n..0, drawing
    alpha_n from the smoothed marginal and then each alpha_t from
    N(ahat_t + J_t (alpha_{t+1} - ahat_{t+1}), Lb_t Lb_t'); observation
    weights attach at the step that generates their state.  The estimator
    is the same psi-APF (the factorization order does not change the
    proposal's joint law); the backward gains are f32-stable where the
    reference's forward conditionals (ccov' V^+) are not — see
    `ops.kalman.smoother_bwd_factors`.

    The returned PFResult carries ALREADY-TRACED trajectories in time
    order with identity resampling indices, so downstream
    `ancestor_trace(pf.alpha, pf.indices)` is a no-op gather and
    `pf.weights[:, -1]` are the final (t = 0 generation step) weights."""
    n, m = spec.n, spec.m
    dt = spec.y.dtype
    g = al.approx.gaussian(spec)
    from ..ops.resample import ancestor_trace
    ahat, Lb, Ab = kalman.smoother_bwd_factors(g)          # (n+1, m), ...

    Zb = _bc(spec.Z, n)
    Db = _bc(spec.D.astype(dt), n)
    scl = al.scales

    key, k0 = jax.random.split(key)
    u0 = jax.random.normal(k0, (nsim, m), dt)
    alpha0 = ahat[n] + u0 @ Lb[n].T         # alpha_n: no observation
    nw0 = jnp.ones((nsim,), dt) / nsim
    loglik0 = al.loglik

    def weight_at(alpha_p, y_t, u_t, Z_t, D_t, yt_t, H_t, sc_t):
        s = _signals(spec, alpha_p, Z_t, D_t)
        return fam.log_weights(spec.distribution, y_t, u_t, spec.phi,
                               s, yt_t, H_t) - sc_t

    keys = jax.random.split(key, n)
    flip = lambda a: jnp.flip(a, axis=0)                   # noqa: E731

    def step(carry, xs):
        alpha_prev, nw, ll = carry          # ensemble of state t+1
        (kt, ah_t, ah_prev, A_t, L_t, y_t, u_t, yt_t, H_t, sc_t,
         Z_t, D_t) = xs
        kr, kp = jax.random.split(kt)
        anc, idx = stratified_select(nw, kr, alpha_prev)
        um = jax.random.normal(kp, (nsim, m), dt)
        alpha_t = ah_t + (anc - ah_prev) @ A_t.T + um @ L_t.T
        ok = jnp.isfinite(y_t)
        lw = weight_at(alpha_t, y_t, u_t, Z_t, D_t, yt_t, H_t, sc_t)
        inc, nw_new = _lse_update(jnp.where(ok, lw, 0.0), nsim, dt)
        ll = ll + jnp.where(ok, inc, 0.0)
        nw_new = jnp.where(ok, nw_new, jnp.ones((nsim,), dt) / nsim)
        return (alpha_t, nw_new, ll), (alpha_t, nw_new, idx)

    xs = (keys, flip(ahat[:-1]), flip(ahat[1:]), flip(Ab[:-1]),
          flip(Lb[:-1]), flip(spec.y), flip(spec.u),
          flip(al.approx.ytilde), flip(al.approx.Htilde), flip(scl),
          flip(Zb), flip(Db))
    (_, _, loglik), (alphas, nws, idxs) = jax.lax.scan(
        step, (alpha0, nw0, loglik0), xs)

    # generation-order cloud (step 0 = t = n), traced then time-flipped
    alpha_gen = jnp.concatenate([alpha0[None], alphas], axis=0)
    traced = ancestor_trace(jnp.swapaxes(alpha_gen, 0, 1), idxs.T)
    traced = jnp.flip(traced, axis=1)                      # (N, n+1, m)
    weights = jnp.concatenate([nw0[None], nws], axis=0)    # gen order
    identity = jnp.broadcast_to(jnp.arange(nsim, dtype=idxs.dtype)[:, None],
                                (nsim, n))
    return PFResult(loglik, traced, weights.T, identity)


def _prior_particles(a1, P1, nsim, key, dt):
    L = psd_chol(P1)
    u = jax.random.normal(key, (nsim, a1.shape[0]), dt)
    return a1 + u @ L.T


def bsf_filter(spec: NGSpec, nsim: int, key) -> PFResult:
    """Bootstrap particle filter for non-Gaussian models
    (`reference/src/model_ssm_ung.cpp:611-712`)."""
    n, m, k = spec.n, spec.m, spec.k
    dt = spec.y.dtype

    Zb, Db = _bc(spec.Z, n), _bc(spec.D.astype(dt), n)
    Tb, Cb = _bc(spec.T, n), _bc(spec.C, n)
    Rb = _bc(spec.R, n)

    key, k0 = jax.random.split(key)
    alpha0 = _prior_particles(spec.a1, spec.P1, nsim, k0, dt)

    def dens_at(alpha_p, y_t, u_t, Z_t, D_t):
        s = _signals(spec, alpha_p, Z_t, D_t)
        return fam.log_obs_density(spec.distribution, y_t, u_t, spec.phi, s)

    y0ok = jnp.isfinite(spec.y[0])
    lw0 = dens_at(alpha0, spec.y[0], spec.u[0], Zb[0], Db[0])
    inc0, nw0 = _lse_update(jnp.where(y0ok, lw0, 0.0), nsim, dt)
    loglik0 = jnp.where(y0ok, inc0, 0.0)
    nw0 = jnp.where(y0ok, nw0, jnp.ones((nsim,), dt) / nsim)

    pad_nan = jnp.full((1,), jnp.nan, dt)
    y_next = jnp.concatenate([spec.y[1:], pad_nan])
    u_next = jnp.concatenate([spec.u[1:], jnp.ones((1,), dt)])
    Z_next = jnp.concatenate([Zb[1:], Zb[-1:]])
    D_next = jnp.concatenate([Db[1:], Db[-1:]])

    keys = jax.random.split(key, n)

    def step(carry, xs):
        alpha_t, nw, ll = carry
        kt, T_t, C_t, R_t, y_n, u_n, Z_n, D_n = xs
        kr, kp = jax.random.split(kt)
        anc, idx = stratified_select(nw, kr, alpha_t)
        eta = jax.random.normal(kp, (nsim, R_t.shape[1]), dt)
        alpha_next = C_t + anc @ T_t.T + eta @ R_t.T
        ok = jnp.isfinite(y_n)
        lw = dens_at(alpha_next, y_n, u_n, Z_n, D_n)
        inc, nw_new = _lse_update(jnp.where(ok, lw, 0.0), nsim, dt)
        ll = ll + jnp.where(ok, inc, 0.0)
        nw_new = jnp.where(ok, nw_new, jnp.ones((nsim,), dt) / nsim)
        return (alpha_next, nw_new, ll), (alpha_next, nw_new, idx)

    xs = (keys, Tb, Cb, Rb, y_next, u_next, Z_next, D_next)
    (_, _, loglik), (alphas, nws, idxs) = jax.lax.scan(
        step, (alpha0, nw0, loglik0), xs)

    loglik = loglik + fam.obs_log_const(spec.distribution, spec.y, spec.u,
                                        spec.phi)
    alpha = jnp.concatenate([alpha0[None], alphas], axis=0)
    weights = jnp.concatenate([nw0[None], nws], axis=0)
    return PFResult(loglik, jnp.swapaxes(alpha, 0, 1), weights.T, idxs.T)


def bsf_filter_lg(spec: LGSpec, nsim: int, key) -> PFResult:
    """Bootstrap filter for a linear-Gaussian model (testing / parity with
    `/root/reference/src/model_ssm_ulg.cpp:557-643`)."""
    n, m = spec.n, spec.m
    dt = spec.y.dtype
    Zb, Db = _bc(spec.Z, n), _bc(spec.D.astype(dt), n)
    Tb, Cb, Rb = _bc(spec.T, n), _bc(spec.C, n), _bc(spec.R, n)
    HHb = _bc(spec.HH, n)

    key, k0 = jax.random.split(key)
    alpha0 = _prior_particles(spec.a1, spec.P1, nsim, k0, dt)

    def dens_at(alpha_p, y_t, Z_t, D_t, HH_t):
        mu = D_t + alpha_p @ Z_t
        return -0.5 * jnp.square(y_t - mu) / HH_t

    y0ok = jnp.isfinite(spec.y[0])
    lw0 = dens_at(alpha0, spec.y[0], Zb[0], Db[0], HHb[0])
    inc0, nw0 = _lse_update(jnp.where(y0ok, lw0, 0.0), nsim, dt)
    loglik0 = jnp.where(y0ok, inc0 - 0.5 * fam.LOG2PI
                        - 0.5 * jnp.log(HHb[0]), 0.0)
    nw0 = jnp.where(y0ok, nw0, jnp.ones((nsim,), dt) / nsim)

    pad_nan = jnp.full((1,), jnp.nan, dt)
    y_next = jnp.concatenate([spec.y[1:], pad_nan])
    Z_next = jnp.concatenate([Zb[1:], Zb[-1:]])
    D_next = jnp.concatenate([Db[1:], Db[-1:]])
    HH_next = jnp.concatenate([HHb[1:], jnp.ones((1,), dt)])

    keys = jax.random.split(key, n)

    def step(carry, xs):
        alpha_t, nw, ll = carry
        kt, T_t, C_t, R_t, y_n, Z_n, D_n, HH_n = xs
        kr, kp = jax.random.split(kt)
        anc, idx = stratified_select(nw, kr, alpha_t)
        eta = jax.random.normal(kp, (nsim, R_t.shape[1]), dt)
        alpha_next = C_t + anc @ T_t.T + eta @ R_t.T
        ok = jnp.isfinite(y_n)
        lw = dens_at(alpha_next, y_n, Z_n, D_n, HH_n)
        inc, nw_new = _lse_update(jnp.where(ok, lw, 0.0), nsim, dt)
        ll = ll + jnp.where(ok, inc - 0.5 * fam.LOG2PI
                            - 0.5 * jnp.log(HH_n), 0.0)
        nw_new = jnp.where(ok, nw_new, jnp.ones((nsim,), dt) / nsim)
        return (alpha_next, nw_new, ll), (alpha_next, nw_new, idx)

    xs = (keys, Tb, Cb, Rb, y_next, Z_next, D_next, HH_next)
    (_, _, loglik), (alphas, nws, idxs) = jax.lax.scan(
        step, (alpha0, nw0, loglik0), xs)
    alpha = jnp.concatenate([alpha0[None], alphas], axis=0)
    weights = jnp.concatenate([nw0[None], nws], axis=0)
    return PFResult(loglik, jnp.swapaxes(alpha, 0, 1), weights.T, idxs.T)


def psi_logw(spec: NGSpec, al: ApproxLoglik, nsim: int, key,
             resample_every: int = 1) -> jnp.ndarray:
    """The psi-APF log-likelihood estimate ONLY (no trajectories) — the IS
    post-correction's inner quantity when states aren't requested.

    Up to ``PREDRAW_MAX_N`` particles the randomness is pre-generated in one
    threefry sweep and consumed by `psi_logw_scan`.  Above it the
    pre-generated tensor is pure overhead — (n+1, N, m) normals per draw —
    so `_psi_logw_keyed` generates its randomness per scan step (the same
    stream as `psi_filter`).  The two streams give different (equally
    valid) estimates, so the threshold is part of a run's numerics.

    ``resample_every`` (keyed tier only): stratified-resample every k-th
    step instead of every step — a fixed schedule keeps the estimator
    unbiased while skipping the dominant selection cost; 1 (default)
    matches the reference exactly."""
    if nsim > PREDRAW_MAX_N:
        return al.loglik + _psi_logw_keyed(spec, al, nsim, key,
                                           resample_every=resample_every)
    n, m = spec.n, spec.m
    dt = spec.y.dtype
    k_e, k_r = jax.random.split(key)
    eps = jax.random.normal(k_e, (n + 1, nsim, m), dt)
    us = jax.random.uniform(k_r, (n, nsim), dt)
    return al.loglik + psi_logw_scan(spec, al, eps, us)


def _psi_logw_keyed(spec: NGSpec, al: ApproxLoglik, nsim: int, key,
                    resample_every: int = 1) -> jnp.ndarray:
    """Large-N psi-APF log-weight with per-step RNG — exactly
    ``psi_filter``'s stream minus trajectory storage, so
    `_psi_logw_keyed(..., key) == psi_filter(..., key).loglik - al.loglik`
    holds identically (at resample_every=1).

    resample_every > 1 uses the general adaptive-SMC weight recursion
    (log-weight carry across non-resampled steps); the k=1 branch is kept
    byte-identical to round-4 numerics."""
    n, m = spec.n, spec.m
    dt = spec.y.dtype
    g = al.approx.gaussian(spec)
    ahat, Lb, Ab = kalman.smoother_bwd_factors(g)
    Zb = _bc(spec.Z, n)
    Db = _bc(spec.D.astype(dt), n)
    scl = al.scales

    key, k0 = jax.random.split(key)
    u0 = jax.random.normal(k0, (nsim, m), dt)
    alpha0 = ahat[n] + u0 @ Lb[n].T
    nw0 = jnp.ones((nsim,), dt) / nsim
    ll0 = jnp.zeros((), dt)
    keys = jax.random.split(key, n)
    flip = lambda a: jnp.flip(a, axis=0)                   # noqa: E731

    from ..ops.resample import stratified_gather

    if resample_every == 1:
        def step(carry, xs):
            alpha_prev, nw, ll = carry
            (kt, ah_t, ah_prev, A_t, L_t, y_t, u_t, yt_t, H_t, sc_t,
             Z_t, D_t) = xs
            kr, kp = jax.random.split(kt)
            # one-hot matmul selection: same draw as
            # alpha_prev[stratified_indices(nw, kr)] without a gather
            anc = stratified_gather(nw, kr, alpha_prev)
            um = jax.random.normal(kp, (nsim, m), dt)
            alpha_t = ah_t + (anc - ah_prev) @ A_t.T + um @ L_t.T
            ok = jnp.isfinite(y_t)
            s = _signals(spec, alpha_t, Z_t, D_t)
            lw = fam.log_weights(spec.distribution, y_t, u_t, spec.phi, s,
                                 yt_t, H_t) - sc_t
            inc, nw_new = _lse_update(jnp.where(ok, lw, 0.0), nsim, dt)
            ll = ll + jnp.where(ok, inc, 0.0)
            nw_new = jnp.where(ok, nw_new, jnp.ones((nsim,), dt) / nsim)
            return (alpha_t, nw_new, ll), None

        xs = (keys, flip(ahat[:-1]), flip(ahat[1:]), flip(Ab[:-1]),
              flip(Lb[:-1]), flip(spec.y), flip(spec.u),
              flip(al.approx.ytilde), flip(al.approx.Htilde), flip(scl),
              flip(Zb), flip(Db))
        (_, _, ll), _ = jax.lax.scan(step, (alpha0, nw0, ll0), xs)
        return ll

    kk = int(resample_every)
    do_rs = (jnp.arange(n) % kk) == 0          # step s=1.. -> (s-1) % kk
    unif = jnp.ones((nsim,), dt) / nsim

    def step(carry, xs):
        alpha_prev, nw, ll = carry
        (kt, do, ah_t, ah_prev, A_t, L_t, y_t, u_t, yt_t, H_t, sc_t,
         Z_t, D_t) = xs
        kr, kp = jax.random.split(kt)
        anc_rs = stratified_gather(nw, kr, alpha_prev)
        anc = jnp.where(do, anc_rs, alpha_prev)
        nw_eff = jnp.where(do, unif, nw)
        um = jax.random.normal(kp, (nsim, m), dt)
        alpha_t = ah_t + (anc - ah_prev) @ A_t.T + um @ L_t.T
        ok = jnp.isfinite(y_t)
        s = _signals(spec, alpha_t, Z_t, D_t)
        lw = fam.log_weights(spec.distribution, y_t, u_t, spec.phi, s,
                             yt_t, H_t) - sc_t
        lw = jnp.where(ok, lw, 0.0)
        lt = jnp.log(nw_eff) + jnp.where(jnp.isfinite(lw), lw, -jnp.inf)
        mx = jnp.max(lt)
        mx_ok = jnp.isfinite(mx)
        mxs = jnp.where(mx_ok, mx, 0.0)
        w = jnp.where(jnp.isfinite(lt), jnp.exp(lt - mxs), 0.0)
        sw = jnp.sum(w)
        ok2 = (sw > 0) & mx_ok
        inc = jnp.where(ok2, mxs + jnp.log(jnp.maximum(sw, 1e-35)),
                        -jnp.inf)
        ll = ll + jnp.where(ok, inc, 0.0)
        nw_new = jnp.where(ok2, w / jnp.maximum(sw, 1e-35), unif)
        return (alpha_t, nw_new, ll), None

    xs = (keys, do_rs, flip(ahat[:-1]), flip(ahat[1:]), flip(Ab[:-1]),
          flip(Lb[:-1]), flip(spec.y), flip(spec.u),
          flip(al.approx.ytilde), flip(al.approx.Htilde), flip(scl),
          flip(Zb), flip(Db))
    (_, _, ll), _ = jax.lax.scan(step, (alpha0, nw0, ll0), xs)
    return ll


def psi_logw_scan(spec: NGSpec, al: ApproxLoglik, eps: jnp.ndarray,
                  us: jnp.ndarray) -> jnp.ndarray:
    """Scan implementation of the psi-APF log-weight with injected
    randomness; semantics identical to ``psi_filter`` (backward-factorized
    proposal) minus trajectory storage
    (`/root/reference/src/model_ssm_ung.cpp:511-609`)."""
    from ..ops.resample import stratified_gather_from_uniforms
    n, m = spec.n, spec.m
    nsim = eps.shape[1]
    dt = spec.y.dtype
    g = al.approx.gaussian(spec)
    ahat, Lb, Ab = kalman.smoother_bwd_factors(g)
    Zb = _bc(spec.Z, n)
    Db = _bc(spec.D.astype(dt), n)
    scl = al.scales

    alpha0 = ahat[n] + eps[0] @ Lb[n].T     # alpha_n: no observation
    nw0 = jnp.ones((nsim,), dt) / nsim
    ll0 = jnp.zeros((), dt)
    flip = lambda a: jnp.flip(a, axis=0)                   # noqa: E731

    def step(carry, xs):
        alpha_prev, nw, ll = carry          # ensemble of state t+1
        (r_t, e_t, ah_t, ah_prev, A_t, L_t, y_t, u_t, yt_t, H_t, sc_t,
         Z_t, D_t) = xs
        anc = stratified_gather_from_uniforms(nw, r_t, alpha_prev)
        alpha_t = ah_t + (anc - ah_prev) @ A_t.T + e_t @ L_t.T
        ok = jnp.isfinite(y_t)
        s = _signals(spec, alpha_t, Z_t, D_t)
        lw = fam.log_weights(spec.distribution, y_t, u_t, spec.phi, s,
                             yt_t, H_t) - sc_t
        inc, nw_new = _lse_update(jnp.where(ok, lw, 0.0), nsim, dt)
        ll = ll + jnp.where(ok, inc, 0.0)
        nw_new = jnp.where(ok, nw_new, jnp.ones((nsim,), dt) / nsim)
        return (alpha_t, nw_new, ll), None

    xs = (us, eps[1:], flip(ahat[:-1]), flip(ahat[1:]), flip(Ab[:-1]),
          flip(Lb[:-1]), flip(spec.y), flip(spec.u),
          flip(al.approx.ytilde), flip(al.approx.Htilde), flip(scl),
          flip(Zb), flip(Db))
    (_, _, ll), _ = jax.lax.scan(step, (alpha0, nw0, ll0), xs)
    return ll


class SPDKResult(NamedTuple):
    loglik: jnp.ndarray
    alpha: jnp.ndarray     # (N, n+1, m) independent smoother draws
    weights: jnp.ndarray   # (N,) normalised importance weights


def spdk_sample(spec: NGSpec, al: ApproxLoglik, nsim: int, key,
                antithetic: bool = True) -> SPDKResult:
    """Shephard-Pitt-Durbin-Koopman importance sampling: simulate from the
    approximating model's smoothing distribution and weight by the density
    ratio (`/root/reference/src/model_ssm_ung.cpp:199-211`)."""
    from ..ops.simsmooth import simulate_states
    n = spec.n
    dt = spec.y.dtype
    g = al.approx.gaussian(spec)
    alpha = simulate_states(g, nsim, key, use_antithetic=antithetic)
    Zb, Db = _bc(spec.Z, n), _bc(spec.D.astype(dt), n)
    if spec.distribution == SVM:
        sig = alpha[:, :n, 0]
    else:
        sig = Db + jnp.einsum('itm,tm->it', alpha[:, :n, :], Zb)
    lw = fam.log_weights(spec.distribution, spec.y, spec.u, spec.phi,
                         sig, al.approx.ytilde, al.approx.Htilde)
    w = jnp.sum(lw, axis=1) - jnp.sum(al.scales)
    mx = jnp.max(w)
    we = jnp.exp(w - mx)
    loglik = al.loglik + jnp.log(jnp.mean(we)) + mx
    return SPDKResult(loglik, alpha, we / jnp.sum(we))


def bsf_logw(spec: NGSpec, nsim: int, key,
             resample_every: int = 1) -> jnp.ndarray:
    """Bootstrap-filter log-likelihood ONLY (no trajectories) — the
    pm/da/is-bsf inner quantity when states aren't requested
    (`reference/src/model_ssm_ung.cpp:611-712`)."""
    const = fam.obs_log_const(spec.distribution, spec.y, spec.u, spec.phi)
    return _bsf_logw_keyed(spec, nsim, key,
                           resample_every=resample_every) + const


def _bsf_logw_keyed(spec: NGSpec, nsim: int, key,
                    resample_every: int = 1) -> jnp.ndarray:
    """``bsf_filter``'s log-likelihood minus trajectory storage and minus
    the observation constants; at resample_every=1,
    `_bsf_logw_keyed(...) + obs_log_const == bsf_filter(...).loglik`
    holds identically (same RNG stream)."""
    n, m = spec.n, spec.m
    dt = spec.y.dtype

    Zb, Db = _bc(spec.Z, n), _bc(spec.D.astype(dt), n)
    Tb, Cb = _bc(spec.T, n), _bc(spec.C, n)
    Rb = _bc(spec.R, n)

    key, k0 = jax.random.split(key)
    alpha0 = _prior_particles(spec.a1, spec.P1, nsim, k0, dt)

    def dens_at(alpha_p, y_t, u_t, Z_t, D_t):
        s = _signals(spec, alpha_p, Z_t, D_t)
        return fam.log_obs_density(spec.distribution, y_t, u_t, spec.phi, s)

    y0ok = jnp.isfinite(spec.y[0])
    lw0 = dens_at(alpha0, spec.y[0], spec.u[0], Zb[0], Db[0])
    inc0, nw0 = _lse_update(jnp.where(y0ok, lw0, 0.0), nsim, dt)
    loglik0 = jnp.where(y0ok, inc0, 0.0)
    nw0 = jnp.where(y0ok, nw0, jnp.ones((nsim,), dt) / nsim)

    pad_nan = jnp.full((1,), jnp.nan, dt)
    y_next = jnp.concatenate([spec.y[1:], pad_nan])
    u_next = jnp.concatenate([spec.u[1:], jnp.ones((1,), dt)])
    Z_next = jnp.concatenate([Zb[1:], Zb[-1:]])
    D_next = jnp.concatenate([Db[1:], Db[-1:]])

    keys = jax.random.split(key, n)
    from ..ops.resample import stratified_gather
    kk = int(resample_every)
    do_rs = (jnp.arange(n) % kk) == 0
    unif = jnp.ones((nsim,), dt) / nsim

    def step(carry, xs):
        alpha_t, nw, ll = carry
        kt, do, T_t, C_t, R_t, y_n, u_n, Z_n, D_n = xs
        kr, kp = jax.random.split(kt)
        anc_rs = stratified_gather(nw, kr, alpha_t)
        anc = jnp.where(do, anc_rs, alpha_t) if kk > 1 else anc_rs
        nw_eff = jnp.where(do, unif, nw) if kk > 1 else unif
        eta = jax.random.normal(kp, (nsim, R_t.shape[1]), dt)
        alpha_next = C_t + anc @ T_t.T + eta @ R_t.T
        ok = jnp.isfinite(y_n)
        lw = dens_at(alpha_next, y_n, u_n, Z_n, D_n)
        if kk == 1:
            inc, nw_new = _lse_update(jnp.where(ok, lw, 0.0), nsim, dt)
            ll = ll + jnp.where(ok, inc, 0.0)
            nw_new = jnp.where(ok, nw_new, unif)
        else:
            lw = jnp.where(ok, lw, 0.0)
            lt = jnp.log(nw_eff) + jnp.where(jnp.isfinite(lw), lw,
                                             -jnp.inf)
            mx = jnp.max(lt)
            mx_ok = jnp.isfinite(mx)
            mxs = jnp.where(mx_ok, mx, 0.0)
            w = jnp.where(jnp.isfinite(lt), jnp.exp(lt - mxs), 0.0)
            sw = jnp.sum(w)
            ok2 = (sw > 0) & mx_ok
            inc = jnp.where(ok2, mxs + jnp.log(jnp.maximum(sw, 1e-35)),
                            -jnp.inf)
            ll = ll + jnp.where(ok, inc, 0.0)
            nw_new = jnp.where(ok2, w / jnp.maximum(sw, 1e-35), nw_eff)
            nw_new = jnp.where(ok, nw_new, nw_eff)
        return (alpha_next, nw_new, ll), None

    xs = (keys, do_rs, Tb, Cb, Rb, y_next, u_next, Z_next, D_next)
    (_, _, loglik), _ = jax.lax.scan(step, (alpha0, nw0, loglik0), xs)
    return loglik
