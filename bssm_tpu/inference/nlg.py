"""Inference kernels for nonlinear-Gaussian models: EKF/IEKF, UKF, extended
Kalman smoothing, mode approximation with damped Gauss-Newton, psi-APF with
transition-ratio weights, bootstrap filter and EKPF.

Re-design of `reference/src/model_ssm_nlg.cpp`:
- the per-time linearisations are batched function evaluations (vmap over t);
- the mode iteration is a `lax.while_loop` with the reference's step-halving
  backtracking (`model_ssm_nlg.cpp:119-144`) as an inner bounded loop;
- particle propagation/weighting vectorises over the particle axis with
  pseudo-density ratios handled by masked Cholesky.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.spec import MVLGSpec
from ..models.nlg import NLGSpec
from ..ops import kalman_mv
from ..ops.chol import conditional_cov_factors, psd_chol
from ..ops.dmvnorm import dmvnorm
from ..ops.resample import (stratified_indices,
                            stratified_select)

LOG2PI = 1.8378770664093453


def _masked_lin(spec: NLGSpec, t, a):
    """Linearisation at state a with missing-series masking
    (`model_ssm_nlg.cpp:297-308`)."""
    dt = spec.y.dtype
    mask = jnp.isfinite(spec.y[t])
    mp = mask.astype(dt)
    Zg = spec.Z_gn(t, a, spec.theta) * mp[:, None]
    H = spec.H_fn(t, a, spec.theta)
    HH = H @ H.T
    HHm = HH * jnp.outer(mp, mp) + jnp.diag(1.0 - mp)
    zfn = spec.Z_fn(t, a, spec.theta)
    return mask, mp, Zg, HHm, zfn


def ekf_update_step(spec: NLGSpec, t, y_t, a, P):
    """One (iterated) EKF measurement update
    (`/root/reference/src/model_ssm_nlg.cpp:284-381`).
    Returns att, Ptt, loglik contribution."""
    m = spec.m
    p = spec.p
    dt = spec.y.dtype

    def linear_update(a_lin):
        mask, mp, Zg, HHm, zfn = _masked_lin(spec, t, a_lin)
        F = Zg @ P @ Zg.T + HHm
        F = 0.5 * (F + F.T)
        cholF = jnp.linalg.cholesky(F)
        ok = jnp.all(jnp.isfinite(cholF)) & jnp.all(jnp.diag(cholF) > 0)
        cholF = jnp.where(ok, cholF, jnp.eye(p, dtype=dt))
        v = jnp.where(mask, y_t - zfn - Zg @ (a - a_lin), 0.0)
        K = jax.scipy.linalg.cho_solve((cholF, True), Zg @ P).T
        return mask, Zg, HHm, cholF, v, K, ok

    mask, Zg, HHm, cholF, v, K, ok = linear_update(a)
    att = a + K @ v

    if spec.iekf_iter > 0:
        def cond(c):
            att_c, _, i, diff = c
            return (diff > 1e-4) & (i < spec.iekf_iter)

        def body(c):
            att_c, _, i, _ = c
            mask2, Zg2, HHm2, cholF2, v2, K2, ok2 = linear_update(att_c)
            att_new = a + K2 @ v2
            diff = jnp.mean(jnp.square(att_c - att_new))
            return (att_new, (mask2, Zg2, HHm2, cholF2, v2, K2, ok2),
                    i + 1, diff)

        att, lin, _, _ = jax.lax.while_loop(
            cond, body, (att, (mask, Zg, HHm, cholF, v, K, ok),
                         jnp.zeros((), jnp.int32), jnp.asarray(1.0, dt)))
        mask, Zg, HHm, cholF, v, K, ok = lin

    ImKZ = jnp.eye(m, dtype=dt) - K @ Zg
    Ptt = ImKZ @ P @ ImKZ.T + K @ HHm @ K.T
    Ptt = 0.5 * (Ptt + Ptt.T)
    Fv = jax.scipy.linalg.solve_triangular(cholF, v, lower=True)
    n_obs = jnp.sum(mask.astype(dt))
    ll_obs = -0.5 * (n_obs * LOG2PI
                     + 2.0 * jnp.sum(jnp.where(mask,
                                               jnp.log(jnp.diag(cholF)), 0.0))
                     + Fv @ Fv)
    any_obs = jnp.any(mask)
    att = jnp.where(any_obs, att, a)
    Ptt = jnp.where(any_obs, Ptt, P)
    ll = jnp.where(any_obs, jnp.where(ok, ll_obs, -jnp.inf), 0.0)
    return att, Ptt, ll


class EKFResult(NamedTuple):
    at: jnp.ndarray
    att: jnp.ndarray
    Pt: jnp.ndarray
    Ptt: jnp.ndarray
    logLik: jnp.ndarray


def ekf(spec: NLGSpec) -> EKFResult:
    """(Iterated) extended Kalman filter
    (`/root/reference/src/model_ssm_nlg.cpp:284-381`)."""
    n, m = spec.n, spec.m

    def step(carry, t):
        a, P = carry
        att, Ptt, ll = ekf_update_step(spec, t, spec.y[t], a, P)
        a_next = spec.T_fn(t, att, spec.theta)
        Tg = spec.T_gn(t, att, spec.theta)
        R = spec.R_fn(t, att, spec.theta)
        P_next = Tg @ Ptt @ Tg.T + R @ R.T
        P_next = 0.5 * (P_next + P_next.T)
        return (a_next, P_next), (a, P, att, Ptt, ll)

    (a_n, P_n), (at, Pt, att, Ptt, lls) = jax.lax.scan(
        step, (spec.a1(), spec.P1()), jnp.arange(n))
    at = jnp.concatenate([at, a_n[None]], axis=0)
    Pt = jnp.concatenate([Pt, P_n[None]], axis=0)
    return EKFResult(at, att, Pt, Ptt, jnp.sum(lls))


def ekf_loglik(spec: NLGSpec) -> jnp.ndarray:
    return ekf(spec).logLik


def build_approx(spec: NLGSpec, mode: jnp.ndarray,
                 att: jnp.ndarray | None = None) -> MVLGSpec:
    """Linearise the model around a state trajectory (n, m) to a fully
    time-varying MV linear-Gaussian model
    (`/root/reference/src/model_ssm_nlg.cpp:164-186`).  With ``att`` given,
    the transition functions are linearised at ``att`` instead (EKF-style
    initial approximation, `model_ssm_nlg.cpp:192-222`)."""
    n = spec.n
    tr = jnp.arange(n)
    at_T = mode if att is None else att

    Z = jax.vmap(lambda t, a: spec.Z_gn(t, a, spec.theta))(tr, mode)
    H = jax.vmap(lambda t, a: spec.H_fn(t, a, spec.theta))(tr, mode)
    T = jax.vmap(lambda t, a: spec.T_gn(t, a, spec.theta))(tr, at_T)
    R = jax.vmap(lambda t, a: spec.R_fn(t, a, spec.theta))(tr, at_T)
    D = jax.vmap(lambda t, a, Zt: spec.Z_fn(t, a, spec.theta) - Zt @ a)(
        tr, mode, Z)
    C = jax.vmap(lambda t, a, Tt: spec.T_fn(t, a, spec.theta) - Tt @ a)(
        tr, at_T, T)
    return MVLGSpec(y=spec.y, Z=Z, H=H, T=T, R=R, a1=spec.a1(),
                    P1=spec.P1(), D=D, C=C)


def log_signal_pdf(spec: NLGSpec, alpha: jnp.ndarray) -> jnp.ndarray:
    """Joint log-density of a state trajectory and the data
    (`/root/reference/src/model_ssm_nlg.cpp:1295-1320`)."""
    n = spec.n
    ll = dmvnorm(alpha[0], spec.a1(), spec.P1())

    def obs_t(t, a):
        H = spec.H_fn(t, a, spec.theta)
        lo = dmvnorm(spec.y[t], spec.Z_fn(t, a, spec.theta), H, lwr=True)
        return jnp.where(jnp.any(jnp.isfinite(spec.y[t])), lo, 0.0)

    # NOTE: reference passes H (a factor) with lwr=TRUE; it also masks
    # missing series inside dmvnorm via nonfinite x -- we zero them:
    def obs_masked(t, a):
        mask = jnp.isfinite(spec.y[t])
        H = spec.H_fn(t, a, spec.theta)
        HH = H @ H.T
        mp = mask.astype(alpha.dtype)
        HHm = HH * jnp.outer(mp, mp) + jnp.diag(1.0 - mp)
        yv = jnp.where(mask, spec.y[t], 0.0)
        muv = jnp.where(mask, spec.Z_fn(t, a, spec.theta), 0.0)
        lo = dmvnorm(yv, muv, HHm)
        # subtract the unit-diagonal padding contribution (zero quad, but
        # counts toward k): dmvnorm counts active dims by diag>eps, padding
        # diag is 1 -> masked dims DO count; compensate:
        n_pad = jnp.sum(1.0 - mp)
        return jnp.where(jnp.any(mask), lo + 0.5 * n_pad * LOG2PI, 0.0)

    tr = jnp.arange(n)
    ll = ll + jnp.sum(jax.vmap(obs_masked)(tr, alpha))

    def trans_t(t, a_prev, a_next):
        mean = spec.T_fn(t, a_prev, spec.theta)
        R = spec.R_fn(t, a_prev, spec.theta)
        return dmvnorm(a_next, mean, R @ R.T)

    ll = ll + jnp.sum(jax.vmap(trans_t)(tr[:-1], alpha[:-1], alpha[1:]))
    return ll


class NLGApprox(NamedTuple):
    mode: jnp.ndarray        # (n, m)
    approx: MVLGSpec
    scales: jnp.ndarray      # (n,)
    loglik: jnp.ndarray      # approximate marginal loglik
    niter: jnp.ndarray


def approximate_nlg(spec: NLGSpec) -> NLGApprox:
    """EKF-initialised damped Gauss-Newton mode estimation
    (`/root/reference/src/model_ssm_nlg.cpp:62-151`)."""
    n = spec.n
    dt = spec.y.dtype
    conv_tol = max(spec.conv_tol, 50.0 * float(jnp.finfo(dt).eps))
    r = ekf(spec)
    g0 = build_approx(spec, r.at[:-1], att=r.att)
    mode0 = kalman_mv.fast_smoother_mv(g0)[:n]
    ll0 = log_signal_pdf(spec, mode0)

    def cond(c):
        mode, ll, i, rel_diff, abs_diff, ok = c
        return ok & (i < spec.max_iter) & (rel_diff > conv_tol) \
            & (abs_diff > 1e-4)

    def body(c):
        mode, ll, i, _, _, ok = c
        g = build_approx(spec, mode)
        mode_new = kalman_mv.fast_smoother_mv(g)[:n]
        ll_new = log_signal_pdf(spec, mode_new)
        abs_diff = ll_new - ll
        rel_diff = abs_diff / jnp.abs(ll)

        # step-halving backtracking when the objective decreased
        def bt_cond(b):
            mode_b, ll_b, rel_b, abs_b, ii = b
            return (rel_b < -conv_tol) & (ii < 15) & (abs_b > 1e-4)

        def bt_body(b):
            mode_b, ll_b, rel_b, abs_b, ii = b
            step = 0.5 ** (ii + 1.0)
            mode_try = (1.0 - step) * mode + step * mode_new
            ll_try = log_signal_pdf(spec, mode_try)
            return (mode_try, ll_try, (ll_try - ll) / jnp.abs(ll),
                    ll_try - ll, ii + 1)

        need_bt = (rel_diff < -conv_tol) & (i > 0) & (abs_diff > 1e-4)
        mode_b, ll_b, rel_b, abs_b, ii = jax.lax.while_loop(
            bt_cond, bt_body,
            (mode_new, ll_new, jnp.where(need_bt, rel_diff, 0.0),
             jnp.where(need_bt, abs_diff, 0.0), jnp.zeros((), dt)))
        mode_f = jnp.where(need_bt, mode_b, mode_new)
        ll_f = jnp.where(need_bt, ll_b, ll_new)
        rel_f = jnp.where(need_bt, rel_b, rel_diff)
        abs_f = jnp.where(need_bt, abs_b, abs_diff)
        ok_new = jnp.all(jnp.isfinite(mode_f)) & jnp.isfinite(ll_f) \
            & (ii < 15)
        return (mode_f, ll_f, i + 1, rel_f, jnp.abs(abs_f), ok_new)

    init = (mode0, ll0, jnp.zeros((), jnp.int32),
            jnp.asarray(jnp.inf, dt), jnp.asarray(1.0, dt),
            jnp.all(jnp.isfinite(mode0)) & jnp.isfinite(ll0))
    mode, ll, niter, _, _, ok = jax.lax.while_loop(cond, body, init)

    g = build_approx(spec, mode)
    sc = _scales_nlg(spec, mode, g)
    gll = kalman_mv.log_likelihood_mv(g)
    approx_ll = jnp.where(ok, gll + jnp.sum(sc), -jnp.inf)
    return NLGApprox(mode, g, sc, approx_ll, niter)


def approximate_for_is_nlg(spec: NLGSpec, mode: jnp.ndarray) -> NLGApprox:
    """Rebuild the linearisation from a stored mode (no iteration)
    (`/root/reference/src/model_ssm_nlg.cpp:153-187`); approx loglik set to 0
    so psi-filter output is the pure correction term."""
    g = build_approx(spec, mode)
    sc = _scales_nlg(spec, mode, g)
    return NLGApprox(mode, g, sc, jnp.zeros((), spec.y.dtype),
                     jnp.zeros((), jnp.int32))


def _obs_logdens(spec: NLGSpec, t, a):
    """Normalised masked obs density log g(y_t | a)."""
    mask = jnp.isfinite(spec.y[t])
    dt = spec.y.dtype
    mp = mask.astype(dt)
    H = spec.H_fn(t, a, spec.theta)
    HH = H @ H.T
    HHm = HH * jnp.outer(mp, mp) + jnp.diag(1.0 - mp)
    yv = jnp.where(mask, spec.y[t], 0.0)
    muv = jnp.where(mask, spec.Z_fn(t, a, spec.theta), 0.0)
    lo = dmvnorm(yv, muv, HHm) + 0.5 * jnp.sum(1.0 - mp) * LOG2PI
    return jnp.where(jnp.any(mask), lo, 0.0)


def _approx_obs_logdens(g: MVLGSpec, mask, t, a, dt):
    mp = mask.astype(dt)
    HH = jnp.einsum('ij,kj->ik', g.H[t], g.H[t])
    HHm = HH * jnp.outer(mp, mp) + jnp.diag(1.0 - mp)
    yv = jnp.where(mask, g.y[t], 0.0)
    muv = jnp.where(mask, g.D[t] + g.Z[t] @ a, 0.0)
    lo = dmvnorm(yv, muv, HHm) + 0.5 * jnp.sum(1.0 - mp) * LOG2PI
    return jnp.where(jnp.any(mask), lo, 0.0)


def _scales_nlg(spec: NLGSpec, mode, g: MVLGSpec):
    """Normalised mode-based correction terms incl. transition ratio
    (`/root/reference/src/model_ssm_nlg.cpp:851-878`)."""
    n = spec.n
    dt = spec.y.dtype
    tr = jnp.arange(n)

    def obs_ratio(t, a):
        mask = jnp.isfinite(spec.y[t])
        return _obs_logdens(spec, t, a) - _approx_obs_logdens(
            g, mask, t, a, dt)

    sc = jax.vmap(obs_ratio)(tr, mode)

    def trans_ratio(t, a_prev, a):
        mean = spec.T_fn(t, a_prev, spec.theta)
        R = spec.R_fn(t, a_prev, spec.theta)
        amean = g.C[t] + g.T[t] @ a_prev
        RR = jnp.einsum('ij,kj->ik', g.R[t], g.R[t])
        return dmvnorm(a, mean, R @ R.T) - dmvnorm(a, amean, RR)

    tratio = jax.vmap(trans_ratio)(tr[:-1], mode[:-1], mode[1:])
    sc = sc.at[1:].add(tratio)
    return sc


class NLGPFResult(NamedTuple):
    loglik: jnp.ndarray
    alpha: jnp.ndarray
    weights: jnp.ndarray
    indices: jnp.ndarray


def _lse(logw, N, dt):
    # non-finite particle weights (f32 overflow artifacts) count as zero
    logw = jnp.where(jnp.isfinite(logw), logw, -jnp.inf)
    mx = jnp.max(logw)
    w = jnp.exp(logw - mx)
    sw = jnp.sum(w)
    ok = (sw > 0) & jnp.isfinite(mx)
    inc = jnp.where(ok, mx + jnp.log(sw / N), -jnp.inf)
    nw = jnp.where(ok, w / jnp.where(sw > 0, sw, 1.0),
                   jnp.ones_like(w) / N)
    return inc.astype(dt), nw


def psi_filter_nlg(spec: NLGSpec, ap: NLGApprox, nsim: int, key
                   ) -> NLGPFResult:
    """psi-APF for nonlinear models: weights are obs-density ratios plus
    the transition-density ratio mu/mu~
    (`/root/reference/src/model_ssm_nlg.cpp:971-1065,880-937`).

    Backward-factorized proposal (generation t = n..0, see
    `particle.psi_filter`); the transition ratio for the pair
    (alpha_t, alpha_{t+1}) attaches at the step that generates alpha_t —
    the extended target's last transition (into the obs-free alpha_n)
    cancels the proposal's exactly, so only pairs with t+1 <= n-1 carry a
    ratio, matching the forward formulation term-for-term.  Returns
    pre-traced time-ordered trajectories with identity indices."""
    from ..ops.resample import ancestor_trace
    n, m = spec.n, spec.m
    dt = spec.y.dtype
    g = ap.approx
    ahat, Lb, Ab = kalman_mv.smoother_bwd_factors_mv(g)

    def obs_w(t, alpha_t):
        mask = jnp.isfinite(spec.y[t])

        def one_obs(a):
            return _obs_logdens(spec, t, a) - _approx_obs_logdens(
                g, mask, t, a, dt)

        return jnp.where(jnp.any(mask),
                         jax.vmap(one_obs)(alpha_t) - ap.scales[t], 0.0)

    def trans_w(t, alpha_t, alpha_next):
        """log mu(alpha_{t+1}|alpha_t) - log mu~(...), pair (t, t+1)."""
        def one(a, a_next):
            mean = spec.T_fn(t, a, spec.theta)
            R = spec.R_fn(t, a, spec.theta)
            amean = g.C[t] + g.T[t] @ a
            RR = jnp.einsum('ij,kj->ik', g.R[t], g.R[t])
            return dmvnorm(a_next, mean, R @ R.T) - dmvnorm(a_next, amean,
                                                            RR)

        return jax.vmap(one)(alpha_t, alpha_next)

    key, k0 = jax.random.split(key)
    u0 = jax.random.normal(k0, (nsim, m), dt)
    alpha0 = ahat[n] + u0 @ Lb[n].T         # alpha_n: no obs, no ratio
    nw0 = jnp.ones((nsim,), dt) / nsim
    ll0 = ap.loglik

    keys = jax.random.split(key, n)

    def step(carry, xs):
        alpha_prev, nw, ll, s = carry       # ensemble of state t+1
        kt = xs
        t = n - 1 - s                       # state generated this step
        kr, kp = jax.random.split(kt)
        anc, idx = stratified_select(nw, kr, alpha_prev)
        um = jax.random.normal(kp, (nsim, m), dt)
        ah_t = ahat[t]
        alpha_t = ah_t + (anc - ahat[t + 1]) @ Ab[t].T + um @ Lb[t].T
        lw = obs_w(t, alpha_t)
        # transition ratio for (t -> t+1); the pair into alpha_n cancels
        lw = lw + jnp.where(t + 1 <= n - 1,
                            trans_w(t, alpha_t, anc), 0.0)
        inc, nw_new = _lse(lw, nsim, dt)
        ok = jnp.isfinite(inc)
        ll = ll + jnp.where(ok, inc, 0.0)
        nw_new = jnp.where(ok, nw_new, jnp.ones((nsim,), dt) / nsim)
        return (alpha_t, nw_new, ll, s + 1), (alpha_t, nw_new, idx)

    (_, _, ll, _), (alphas, nws, idxs) = jax.lax.scan(
        step, (alpha0, nw0, ll0, jnp.zeros((), jnp.int32)), keys)
    alpha_gen = jnp.concatenate([alpha0[None], alphas], axis=0)
    traced = ancestor_trace(jnp.swapaxes(alpha_gen, 0, 1), idxs.T)
    traced = jnp.flip(traced, axis=1)
    weights = jnp.concatenate([nw0[None], nws], axis=0)
    identity = jnp.broadcast_to(jnp.arange(nsim, dtype=idxs.dtype)[:, None],
                                (nsim, n))
    return NLGPFResult(ll, traced, weights.T, identity)


def bsf_filter_nlg(spec: NLGSpec, nsim: int, key) -> NLGPFResult:
    """Bootstrap filter (`/root/reference/src/model_ssm_nlg.cpp:1066-1150`)."""
    n, m, k = spec.n, spec.m, spec.k
    dt = spec.y.dtype

    key, k0 = jax.random.split(key)
    L1 = psd_chol(spec.P1())
    alpha0 = spec.a1() + jax.random.normal(k0, (nsim, m), dt) @ L1.T

    def dens(t, alpha_t):
        return jax.vmap(lambda a: _obs_logdens(spec, t, a))(alpha_t)

    y0_any = jnp.any(jnp.isfinite(spec.y[0]))
    inc0, nw0 = _lse(jnp.where(y0_any, dens(0, alpha0), 0.0), nsim, dt)
    ll0 = jnp.where(y0_any, inc0, 0.0)
    nw0 = jnp.where(y0_any, nw0, jnp.ones((nsim,), dt) / nsim)

    keys = jax.random.split(key, n)

    def step(carry, xs):
        alpha_t, nw, ll, t = carry
        kt = xs
        kr, kp = jax.random.split(kt)
        anc, idx = stratified_select(nw, kr, alpha_t)
        eta = jax.random.normal(kp, (nsim, k), dt)

        def prop(a, e):
            return spec.T_fn(t, a, spec.theta) \
                + spec.R_fn(t, a, spec.theta) @ e

        alpha_next = jax.vmap(prop)(anc, eta)
        is_last = t + 1 >= n
        tt = jnp.minimum(t + 1, n - 1)
        yn_any = jnp.any(jnp.isfinite(spec.y[tt])) & (~is_last)
        lw = dens(tt, alpha_next)
        inc, nw_new = _lse(jnp.where(yn_any, lw, 0.0), nsim, dt)
        ll = ll + jnp.where(yn_any, inc, 0.0)
        nw_new = jnp.where(yn_any, nw_new, jnp.ones((nsim,), dt) / nsim)
        return (alpha_next, nw_new, ll, t + 1), (alpha_next, nw_new, idx)

    (_, _, ll, _), (alphas, nws, idxs) = jax.lax.scan(
        step, (alpha0, nw0, ll0, jnp.zeros((), jnp.int32)), keys)
    alpha = jnp.concatenate([alpha0[None], alphas], axis=0)
    weights = jnp.concatenate([nw0[None], nws], axis=0)
    return NLGPFResult(ll, jnp.swapaxes(alpha, 0, 1), weights.T, idxs.T)


def ekpf_filter(spec: NLGSpec, nsim: int, key) -> NLGPFResult:
    """Extended Kalman particle filter (van der Merwe et al.)
    (`/root/reference/src/model_ssm_nlg.cpp:1151-1261`): per-particle EKF
    proposal, weights correct prior/proposal mismatch."""
    n, m = spec.n, spec.m
    dt = spec.y.dtype

    a1 = spec.a1()
    P1 = spec.P1()
    att1, Ptt1, _ = ekf_update_step(spec, 0, spec.y[0], a1, P1)
    L1 = psd_chol(Ptt1)

    key, k0 = jax.random.split(key)
    alpha0 = att1 + jax.random.normal(k0, (nsim, m), dt) @ L1.T

    def dens(t, alpha_t):
        return jax.vmap(lambda a: _obs_logdens(spec, t, a))(alpha_t)

    y0_any = jnp.any(jnp.isfinite(spec.y[0]))
    lw0 = dens(0, alpha0) \
        + jax.vmap(lambda a: dmvnorm(a, a1, P1))(alpha0) \
        - jax.vmap(lambda a: dmvnorm(a, att1, L1, lwr=True))(alpha0)
    inc0, nw0 = _lse(jnp.where(y0_any, lw0, 0.0), nsim, dt)
    ll0 = jnp.where(y0_any, inc0, 0.0)
    nw0 = jnp.where(y0_any, nw0, jnp.ones((nsim,), dt) / nsim)

    keys = jax.random.split(key, n)

    def step(carry, xs):
        alpha_t, nw, ll, t = carry
        kt = xs
        kr, kp = jax.random.split(kt)
        anc, idx = stratified_select(nw, kr, alpha_t)
        is_last = t + 1 >= n
        tt = jnp.minimum(t + 1, n - 1)

        def prop_one(a, u):
            at = spec.T_fn(t, a, spec.theta)
            R = spec.R_fn(t, a, spec.theta)
            Pt = R @ R.T

            def with_update(_):
                att, Ptt, _ = ekf_update_step(spec, tt, spec.y[tt], at, Pt)
                return att, psd_chol(Ptt)

            def no_update(_):
                return at, psd_chol(Pt)

            att, L = jax.lax.cond(is_last, no_update, with_update, None)
            a_new = att + L @ u
            # weight: prior transition / proposal
            corr = dmvnorm(a_new, at, Pt) - dmvnorm(a_new, att, L, lwr=True)
            return a_new, corr

        um = jax.random.normal(kp, (nsim, m), dt)
        alpha_next, corr = jax.vmap(prop_one)(anc, um)
        yn_any = jnp.any(jnp.isfinite(spec.y[tt])) & (~is_last)
        lw = dens(tt, alpha_next) + corr
        inc, nw_new = _lse(jnp.where(yn_any, lw, 0.0), nsim, dt)
        ll = ll + jnp.where(yn_any, inc, 0.0)
        nw_new = jnp.where(yn_any, nw_new, jnp.ones((nsim,), dt) / nsim)
        return (alpha_next, nw_new, ll, t + 1), (alpha_next, nw_new, idx)

    (_, _, ll, _), (alphas, nws, idxs) = jax.lax.scan(
        step, (alpha0, nw0, ll0, jnp.zeros((), jnp.int32)), keys)
    alpha = jnp.concatenate([alpha0[None], alphas], axis=0)
    weights = jnp.concatenate([nw0[None], nws], axis=0)
    return NLGPFResult(ll, jnp.swapaxes(alpha, 0, 1), weights.T, idxs.T)


def ukf(spec: NLGSpec, alpha: float = 1.0, beta: float = 0.0,
        kappa: float = 2.0) -> EKFResult:
    """Unscented Kalman filter, Sarkka-style sigma points
    (`/root/reference/src/model_ssm_nlg.cpp:746-850`)."""
    n, m, p = spec.n, spec.m, spec.p
    dt = spec.y.dtype
    lam = alpha * alpha * (m + kappa) - m
    n_sigma = 2 * m + 1
    wm = jnp.full((n_sigma,), 1.0 / (2.0 * (lam + m)), dt)
    wm = wm.at[0].set(lam / (lam + m))
    wc = wm.at[0].add(1.0 - alpha * alpha + beta)
    sq = jnp.sqrt(m + lam)

    def step(carry, t):
        a, P = carry
        cholP = psd_chol(P)
        sig = jnp.concatenate(
            [a[None], a[None] + sq * cholP.T, a[None] - sq * cholP.T],
            axis=0)                                       # (n_sigma, m)
        mask = jnp.isfinite(spec.y[t])
        mp = mask.astype(dt)
        any_obs = jnp.any(mask)

        sig_y = jax.vmap(lambda s: spec.Z_fn(t, s, spec.theta))(sig)
        sig_y = sig_y * mp[None, :]
        pred_mean = wm @ sig_y
        H = spec.H_fn(t, a, spec.theta)
        HH = (H @ H.T) * jnp.outer(mp, mp) + jnp.diag(1.0 - mp)
        dy = sig_y - pred_mean
        pred_var = HH + jnp.einsum('i,ij,ik->jk', wc, dy, dy)
        da = sig - a
        pred_cov = jnp.einsum('i,ij,ik->jk', wc, da, dy)
        v = jnp.where(mask, spec.y[t] - pred_mean, 0.0)
        cholF = jnp.linalg.cholesky(0.5 * (pred_var + pred_var.T))
        ok = jnp.all(jnp.isfinite(cholF))
        cholF = jnp.where(ok, cholF, jnp.eye(p, dtype=dt))
        K = jax.scipy.linalg.cho_solve((cholF, True), pred_cov.T).T
        att = jnp.where(any_obs, a + K @ v, a)
        Ptt = jnp.where(any_obs, P - K @ pred_var @ K.T, P)
        Ptt = 0.5 * (Ptt + Ptt.T)
        Fv = jax.scipy.linalg.solve_triangular(cholF, v, lower=True)
        ll = jnp.where(
            any_obs,
            -0.5 * (jnp.sum(mp) * LOG2PI
                    + 2.0 * jnp.sum(jnp.where(mask,
                                              jnp.log(jnp.diag(cholF)), 0.0))
                    + Fv @ Fv), 0.0)
        ll = jnp.where(ok, ll, -jnp.inf)

        cholPtt = psd_chol(Ptt)
        sig2 = jnp.concatenate(
            [att[None], att[None] + sq * cholPtt.T, att[None] - sq * cholPtt.T],
            axis=0)
        sig2p = jax.vmap(lambda s: spec.T_fn(t, s, spec.theta))(sig2)
        a_next = wm @ sig2p
        R = spec.R_fn(t, att, spec.theta)
        d2 = sig2p - a_next
        P_next = R @ R.T + jnp.einsum('i,ij,ik->jk', wc, d2, d2)
        P_next = 0.5 * (P_next + P_next.T)
        return (a_next, P_next), (a, P, att, Ptt, ll)

    (a_n, P_n), (at, Pt, att, Ptt, lls) = jax.lax.scan(
        step, (spec.a1(), spec.P1()), jnp.arange(n))
    at = jnp.concatenate([at, a_n[None]], axis=0)
    Pt = jnp.concatenate([Pt, P_n[None]], axis=0)
    return EKFResult(at, att, Pt, Ptt, jnp.sum(lls))


def ekf_smoother(spec: NLGSpec) -> kalman_mv.MVSmoothResult:
    """Extended Kalman smoother: EKF + RTS backward pass on the linearised
    system (`/root/reference/src/model_ssm_nlg.cpp:483-742`)."""
    r = ekf(spec)
    g = build_approx(spec, r.at[:-1], att=r.att)
    return kalman_mv.smoother_mv(g)


def ekf_fast_smoother(spec: NLGSpec) -> jnp.ndarray:
    """Means-only extended Kalman smoothing, (n+1, m): EKF pass + the
    disturbance-smoother mean recursion on the linearised system — no
    variance recursions (`/root/reference/src/model_ssm_nlg.cpp:483-556`,
    `ekf_fast_smoother`; exposed via `R/smoother.R`)."""
    r = ekf(spec)
    g = build_approx(spec, r.at[:-1], att=r.att)
    return kalman_mv.fast_smoother_mv(g)
