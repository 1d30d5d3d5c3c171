"""Multivariate-observation Kalman filtering/smoothing with partial
missingness, as masked `lax.scan` recursions.

Re-design of `reference/src/model_ssm_mlg.cpp`: per-time
`find_finite` slicing becomes static-shape masking — missing series get a
zeroed Z row, a unit pseudo-variance on the H H' diagonal and a zeroed
innovation, which reproduces the partial update exactly (the masked block of
F is the identity, contributing nothing to the log-determinant or the
quadratic form).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.spec import MVLGSpec

LOG2PI = 1.8378770664093453


def _bc(A, n):
    return jnp.broadcast_to(A, (n,) + A.shape[1:]) if A.shape[0] == 1 else A


def _step_arrays(spec: MVLGSpec):
    n = spec.n
    dt = spec.y.dtype
    HH = jnp.einsum('tij,tkj->tik', spec.H, spec.H)
    return (spec.y, spec.obs_mask, _bc(spec.Z, n), _bc(HH, n),
            _bc(spec.T, n), _bc(spec.RR, n), _bc(spec.D.astype(dt), n),
            _bc(spec.C, n))


def _masked_sys(Z, HH, mask, dt):
    """Zero Z rows / HH rows+cols for missing series; unit diag on missing."""
    mp = mask.astype(dt)
    Zm = Z * mp[:, None]
    HHm = HH * jnp.outer(mp, mp) + jnp.diag(1.0 - mp)
    return Zm, HHm


def _update_mv(a, P, y, mask, Z, HH, T, RR, D, C):
    p = y.shape[0]
    m = a.shape[0]
    dt = a.dtype
    HH = jnp.where(jnp.isfinite(HH), HH, 0.0)
    Zm, HHm = _masked_sys(Z, HH, mask, dt)
    F = Zm @ P @ Zm.T + HHm
    F = 0.5 * (F + F.T)
    cholF = jnp.linalg.cholesky(F)
    ok_chol = jnp.all(jnp.isfinite(cholF)) & jnp.all(jnp.diag(cholF) > 0)
    cholF = jnp.where(ok_chol, cholF, jnp.eye(p, dtype=dt))
    v = jnp.where(mask, y - D - Zm @ a, 0.0)
    # K = P Z' F^{-1}
    Finv_ZP = jax.scipy.linalg.cho_solve((cholF, True), Zm @ P)
    K = Finv_ZP.T                                   # (m, p)
    att = a + K @ v
    a_next = C + T @ att
    ImKZ = jnp.eye(m, dtype=dt) - K @ Zm
    Ptt = ImKZ @ P @ ImKZ.T + K @ HHm @ K.T
    Ptt = 0.5 * (Ptt + Ptt.T)
    P_next = T @ Ptt @ T.T + RR
    P_next = 0.5 * (P_next + P_next.T)
    Fv = jax.scipy.linalg.solve_triangular(cholF, v, lower=True)
    n_obs = jnp.sum(mask.astype(dt))
    ll = -0.5 * (n_obs * LOG2PI
                 + 2.0 * jnp.sum(jnp.where(mask,
                                           jnp.log(jnp.diag(cholF)), 0.0))
                 + Fv @ Fv)
    ll = jnp.where(ok_chol, ll, -jnp.inf)
    any_obs = jnp.any(mask)
    att = jnp.where(any_obs, att, a)
    Ptt = jnp.where(any_obs, Ptt, P)
    a_next = jnp.where(any_obs, C + T @ att, C + T @ a)
    P_next = jnp.where(any_obs, P_next, T @ P @ T.T + RR)
    ll = jnp.where(any_obs, ll, 0.0)
    return a_next, P_next, att, Ptt, v, cholF, K, Zm, ll


def log_likelihood_mv(spec: MVLGSpec) -> jnp.ndarray:
    def step(carry, xs):
        a, P, acc = carry
        y, mask, Z, HH, T, RR, D, C = xs
        a, P, *_, ll = _update_mv(a, P, y, mask, Z, HH, T, RR, D, C)
        return (a, P, acc + ll), None

    (_, _, ll), _ = jax.lax.scan(
        step, (spec.a1, spec.P1, jnp.zeros((), spec.y.dtype)),
        _step_arrays(spec))
    return ll


class MVFilterResult(NamedTuple):
    at: jnp.ndarray
    att: jnp.ndarray
    Pt: jnp.ndarray
    Ptt: jnp.ndarray
    logLik: jnp.ndarray
    vt: jnp.ndarray       # (n, p)
    cholF: jnp.ndarray    # (n, p, p)
    Kt: jnp.ndarray       # (n, m, p)
    Zm: jnp.ndarray       # (n, p, m) masked Z


def kfilter_mv(spec: MVLGSpec) -> MVFilterResult:
    def step(carry, xs):
        a, P = carry
        y, mask, Z, HH, T, RR, D, C = xs
        a2, P2, att, Ptt, v, cholF, K, Zm, ll = _update_mv(
            a, P, y, mask, Z, HH, T, RR, D, C)
        return (a2, P2), (a, P, att, Ptt, v, cholF, K, Zm, ll)

    (a_n, P_n), ys = jax.lax.scan(step, (spec.a1, spec.P1),
                                  _step_arrays(spec))
    at, Pt, att, Ptt, vt, cholF, Kt, Zm, lls = ys
    at = jnp.concatenate([at, a_n[None]], axis=0)
    Pt = jnp.concatenate([Pt, P_n[None]], axis=0)
    return MVFilterResult(at, att, Pt, Ptt, jnp.sum(lls), vt, cholF, Kt, Zm)


class MVSmoothResult(NamedTuple):
    alphahat: jnp.ndarray
    Vt: jnp.ndarray
    ccov: jnp.ndarray
    logLik: jnp.ndarray


def smoother_bwd_factors_mv(spec: MVLGSpec):
    """(ahat, Lb, Ab): backward (FFBS) factorization of the smoothing law
    for the psi-APF proposal — multivariate analogue of
    `ops.kalman.smoother_bwd_factors` (see its docstring for why this
    replaces the reference's forward conditionals at f32)."""
    from .chol import _psd_factor, _psd_pinv
    r = kfilter_mv(spec)
    _, _, _, _, Tb, RRb, _, _ = _step_arrays(spec)
    m = spec.m

    def back(ahat_next, xs):
        T, RR, att, Ptt, a_next, P_next = xs
        J = Ptt @ T.T @ _psd_pinv(P_next)
        ahat = att + J @ (ahat_next - a_next)
        # Joseph form (see ops.kalman.smoother_bwd_factors): all-additive
        ImJT = jnp.eye(m, dtype=Ptt.dtype) - J @ T
        Sig = ImJT @ Ptt @ ImJT.T + J @ RR @ J.T
        Sig = 0.5 * (Sig + Sig.T)
        return ahat, (ahat, _psd_factor(Sig), J)

    xs = (Tb, RRb, r.att, r.Ptt, r.at[1:], r.Pt[1:])
    _, (ahat, Lb, Ab) = jax.lax.scan(back, r.at[-1], xs, reverse=True)
    ahat = jnp.concatenate([ahat, r.at[-1][None]], axis=0)
    Lb = jnp.concatenate([Lb, _psd_factor(r.Pt[-1])[None]], axis=0)
    Ab = jnp.concatenate([Ab, jnp.zeros_like(Ab[:1])], axis=0)
    return ahat, Lb, Ab


def smoother_mv(spec: MVLGSpec) -> MVSmoothResult:
    """RTS smoother with lag-1 cross-covariances
    (`/root/reference/src/model_ssm_mlg.cpp:140-398`).

    J-form recursion rather than the reference's Durbin-Koopman
    N-recursion, for the same f32 diffuse-P1 stability reason as
    `ops.kalman.smoother` (see its docstring)."""
    from .chol import _psd_pinv
    r = kfilter_mv(spec)
    m = spec.m
    dt = spec.y.dtype
    _, _, _, _, Tb, _, _, _ = _step_arrays(spec)

    def back(carry, xs):
        ahat_next, V_next = carry
        T, att, Ptt, a_next, P_next = xs
        J = Ptt @ T.T @ _psd_pinv(P_next)
        ahat = att + J @ (ahat_next - a_next)
        V = Ptt + J @ (V_next - P_next) @ J.T
        V = 0.5 * (V + V.T)
        ccov = J @ V_next
        return (ahat, V), (ahat, V, ccov)

    init = (r.at[-1], r.Pt[-1])
    xs = (Tb, r.att, r.Ptt, r.at[1:], r.Pt[1:])
    _, (ahat, Vt, ccov) = jax.lax.scan(back, init, xs, reverse=True)
    ahat = jnp.concatenate([ahat, r.at[-1][None]], axis=0)
    Vt = jnp.concatenate([Vt, r.Pt[-1][None]], axis=0)
    ccov = jnp.concatenate([ccov, jnp.zeros((1, m, m), dt)], axis=0)
    return MVSmoothResult(ahat, Vt, ccov, r.logLik)


def fast_smoother_mv(spec: MVLGSpec, flt: MVFilterResult | None = None
                     ) -> jnp.ndarray:
    """Mean-only smoother; with ``flt`` given, reuses y-independent gains and
    re-runs only the mean recursions (for the simulation smoother)."""
    n, m = spec.n, spec.m
    dt = spec.y.dtype
    yb, maskb, Zb, HHb, Tb, RRb, Db, Cb = _step_arrays(spec)
    if flt is None:
        flt = kfilter_mv(spec)
        vt = flt.vt
    else:
        def fwd(a, xs):
            y, mask, Z, D, C, T, K = xs
            Zm = Z * mask.astype(dt)[:, None]
            v = jnp.where(mask, y - D - Zm @ a, 0.0)
            a_next = C + T @ (a + K @ v)
            return a_next, v

        _, vt = jax.lax.scan(fwd, spec.a1,
                             (yb, maskb, Zb, Db, Cb, Tb, flt.Kt))
    return _mv_mean_passes(spec, flt, vt)


def fast_smoother_mv_ll(spec: MVLGSpec) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(smoothed means, filter log-likelihood) sharing one forward pass;
    means via alphahat_t = a_t + P_t r_{t-1} (see `kalman.fast_smoother_ll`):
    2 sequential scans instead of 3."""
    flt = kfilter_mv(spec)
    m = spec.m
    dt = spec.y.dtype
    _, maskb, _, _, Tb, _, _, _ = _step_arrays(spec)

    def back(rt, xs):
        v, cholF, K, Zm, T, mask = xs
        any_obs = jnp.any(mask)
        ZFinv = jax.scipy.linalg.cho_solve((cholF, True), Zm).T
        L = jnp.where(any_obs, T @ (jnp.eye(m, dtype=dt) - K @ Zm), T)
        r_new = jnp.where(any_obs, ZFinv @ v, 0.0) + L.T @ rt
        return r_new, r_new

    _, rprev = jax.lax.scan(back, jnp.zeros((m,), dt),
                            (flt.vt, flt.cholF, flt.Kt, flt.Zm, Tb, maskb),
                            reverse=True)
    alphas = flt.at[:-1] + jnp.einsum('tij,tj->ti', flt.Pt[:-1], rprev)
    alpha = jnp.concatenate([alphas, flt.at[-1][None]], axis=0)
    return alpha, flt.logLik


def _mv_mean_passes(spec: MVLGSpec, flt: MVFilterResult, vt: jnp.ndarray
                    ) -> jnp.ndarray:
    m = spec.m
    dt = spec.y.dtype
    _, maskb, _, _, Tb, RRb, _, Cb = _step_arrays(spec)

    def back(rt, xs):
        v, cholF, K, Zm, T, mask = xs
        any_obs = jnp.any(mask)
        ZFinv = jax.scipy.linalg.cho_solve((cholF, True), Zm).T
        L = jnp.where(any_obs, T @ (jnp.eye(m, dtype=dt) - K @ Zm), T)
        r_new = jnp.where(any_obs, ZFinv @ v, 0.0) + L.T @ rt
        return r_new, rt

    r0, rs = jax.lax.scan(back, jnp.zeros((m,), dt),
                          (vt, flt.cholF, flt.Kt, flt.Zm, Tb, maskb),
                          reverse=True)
    alpha0 = spec.a1 + spec.P1 @ r0

    def fwd2(a, xs):
        T, C, RR, r = xs
        return C + T @ a + RR @ r, a

    a_n, alphas = jax.lax.scan(fwd2, alpha0, (Tb, Cb, RRb, rs))
    return jnp.concatenate([alphas, a_n[None]], axis=0)


def simulate_states_mv(spec: MVLGSpec, nsim: int, key,
                       use_antithetic: bool = True) -> jnp.ndarray:
    """DK simulation smoother for multivariate models
    (`/root/reference/src/model_ssm_mlg.cpp:473-541`)."""
    from .chol import psd_chol
    n, m, k, p = spec.n, spec.m, spec.k, spec.p
    dt = spec.y.dtype
    yb, maskb, Zb, HHb, Tb, RRb, Db, Cb = _step_arrays(spec)
    Hb = _bc(spec.H, n)
    Rb = _bc(spec.R, n)

    flt = kfilter_mv(spec)
    alphahat = fast_smoother_mv(spec, None)

    n_base = (nsim + 1) // 2 if use_antithetic else nsim
    keys = jax.random.split(key, n_base)

    def one(kk):
        k0, k1, k2 = jax.random.split(kk, 3)
        um = jax.random.normal(k0, (m,), dt)
        eps = jax.random.normal(k1, (n, p), dt)
        eta = jax.random.normal(k2, (n, k), dt)
        L1 = psd_chol(spec.P1)
        a0 = spec.a1 + L1 @ um

        def step(a, xs):
            Z, H, T, R, C, D, e, w = xs
            ysim = D + Z @ a + H @ e
            return C + T @ a + R @ w, ysim

        _, ysim = jax.lax.scan(step, a0,
                               (Zb, Hb, Tb, Rb, Cb, Db, eps, eta))
        # need aplus too: redo with collection
        def step2(a, xs):
            T, R, C, w = xs
            return C + T @ a + R @ w, a

        a_nn, aplus = jax.lax.scan(step2, a0, (Tb, Rb, Cb, eta))
        aplus = jnp.concatenate([aplus, a_nn[None]], axis=0)
        ystar = jnp.where(maskb, ysim, spec.y)
        cond = fast_smoother_mv(spec._replace(y=ystar), flt)
        return alphahat - cond + aplus

    base = jax.vmap(one)(keys)
    if use_antithetic:
        anti = 2.0 * alphahat[None] - base
        out = jnp.concatenate([base, anti], axis=0)[:nsim]
    else:
        out = base[:nsim]
    return out
