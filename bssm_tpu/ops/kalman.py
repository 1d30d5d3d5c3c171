"""Univariate-observation Kalman filtering/smoothing as `lax.scan` recursions.

Re-design of `reference/src/model_ssm_ulg.cpp` (scalar-F fast
path, NA-skip, Joseph-form covariance update).  Missing observations are
handled branch-free with masks premultiplied into the updates; all functions
are pure in the model spec and `vmap`/`pjit` friendly.

Numerics follow the reference exactly:
  F_t = Z' P Z + H^2               (innovation variance)
  K_t = P Z / F
  a_{t+1} = C + T (a + K v),  v = y - D - Z' a
  P_{t+1} = T ((I-KZ')P(I-KZ')' + K H^2 K') T' + R R'   (Joseph form,
            `/root/reference/src/model_ssm_ulg.cpp:276-277`)
with the "no update" branch when y is missing or F <= zero_tol.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.spec import LGSpec, at_t

LOG2PI = 1.8378770664093453
ZERO_TOL = 1e-8   # reference default zero_tol (`model_ssm_ulg.h` ctor)


class FilterResult(NamedTuple):
    at: jnp.ndarray    # (n+1, m)  predicted means  a_t = E[alpha_t | y_{1:t-1}]
    att: jnp.ndarray   # (n, m)    filtered means
    Pt: jnp.ndarray    # (n+1, m, m)
    Ptt: jnp.ndarray   # (n, m, m)
    logLik: jnp.ndarray
    vt: jnp.ndarray    # (n,) innovations (0 where missing)
    Ft: jnp.ndarray    # (n,) innovation variances
    Kt: jnp.ndarray    # (n, m) gains (0 where missing)


def _step_arrays(spec: LGSpec):
    """Per-time tuples for scan xs: (y, obs, Z, HH, T, RR, D, C) broadcast."""
    n = spec.n
    dt = spec.y.dtype

    def bc(A):
        if A.shape[0] == 1:
            return jnp.broadcast_to(A, (n,) + A.shape[1:])
        return A
    return (spec.y, spec.obs_mask, bc(spec.Z), bc(spec.HH), bc(spec.T),
            bc(spec.RR), bc(spec.D).astype(dt), bc(spec.C))


def _update(a, P, y, obs, Z, HH, T, RR, D, C):
    """One masked predict+update step; returns new (a, P) and stats."""
    m = a.shape[0]
    # sanitize: a missing y may come with NaN pseudo-variance (Laplace
    # approximations leave H undefined there); keep the algebra NaN-free.
    HH = jnp.where(jnp.isfinite(HH), HH, 1.0)
    F = Z @ P @ Z + HH
    ok = obs & (F > ZERO_TOL)
    okf = ok.astype(a.dtype)
    Fs = jnp.where(ok, F, 1.0)
    v = jnp.where(ok, y - D - Z @ a, 0.0)
    K = jnp.where(ok, (P @ Z) / Fs, 0.0)
    att = a + K * v
    a_next = C + T @ att
    ImKZ = jnp.eye(m, dtype=a.dtype) - jnp.outer(K, Z)
    P_upd = ImKZ @ P @ ImKZ.T + HH * jnp.outer(K, K)
    Ptt = okf * P_upd + (1.0 - okf) * P
    Ptt = 0.5 * (Ptt + Ptt.T)
    P_next = T @ Ptt @ T.T + RR
    P_next = 0.5 * (P_next + P_next.T)
    ll = okf * (-0.5 * (LOG2PI + jnp.log(Fs) + v * v / Fs))
    return a_next, P_next, att, Ptt, v, Fs, K, ll, ok


def log_likelihood(spec: LGSpec) -> jnp.ndarray:
    """Marginal log-likelihood via the Kalman filter
    (`/root/reference/src/model_ssm_ulg.cpp:106-138`)."""

    def step(carry, xs):
        a, P, acc = carry
        y, obs, Z, HH, T, RR, D, C = xs
        a, P, _, _, _, _, _, ll, _ = _update(a, P, y, obs, Z, HH, T, RR, D, C)
        return (a, P, acc + ll), None

    (_, _, logLik), _ = jax.lax.scan(
        step, (spec.a1, spec.P1, jnp.zeros((), spec.y.dtype)),
        _step_arrays(spec))
    # degenerate model (all noise zero) -> -inf, matching the reference guard
    degenerate = (jnp.sum(spec.HH) + jnp.sum(jnp.abs(spec.R))) < ZERO_TOL
    return jnp.where(degenerate, -jnp.inf, logLik)


def kfilter(spec: LGSpec) -> FilterResult:
    """Full Kalman filter storing predicted/filtered moments
    (`/root/reference/src/model_ssm_ulg.cpp:475-509`)."""

    def step(carry, xs):
        a, P = carry
        y, obs, Z, HH, T, RR, D, C = xs
        a2, P2, att, Ptt, v, F, K, ll, _ = _update(
            a, P, y, obs, Z, HH, T, RR, D, C)
        return (a2, P2), (a, P, att, Ptt, v, F, K, ll)

    (a_n, P_n), (at, Pt, att, Ptt, vt, Ft, Kt, lls) = jax.lax.scan(
        step, (spec.a1, spec.P1), _step_arrays(spec))
    at = jnp.concatenate([at, a_n[None]], axis=0)
    Pt = jnp.concatenate([Pt, P_n[None]], axis=0)
    return FilterResult(at, att, Pt, Ptt, jnp.sum(lls), vt, Ft, Kt)


class SmootherStats(NamedTuple):
    """Forward-pass quantities reused by every smoothing variant."""
    vt: jnp.ndarray    # (n,)
    Ft: jnp.ndarray    # (n,)   (1 where masked)
    Kt: jnp.ndarray    # (n, m) (0 where masked)
    ok: jnp.ndarray    # (n,)   update mask
    at: jnp.ndarray    # (n+1, m)
    Pt: jnp.ndarray    # (n+1, m, m)


def forward_stats(spec: LGSpec) -> SmootherStats:
    r = kfilter(spec)
    ok = spec.obs_mask & (r.Ft > ZERO_TOL)
    return SmootherStats(r.vt, r.Ft, r.Kt, ok, r.at, r.Pt)


def fast_smoother(spec: LGSpec, stats: SmootherStats | None = None) -> jnp.ndarray:
    """Mean-only two-pass smoother, E[alpha_t | y], shape (n+1, m)
    (`/root/reference/src/model_ssm_ulg.cpp:252-305`).

    Passing precomputed ``stats`` mirrors the reference's
    ``fast_smoother(Ft, Kt, Lt)`` reuse inside the simulation smoother: the
    y-independent gains (Ft, Kt, ok) are reused and only the O(n m) mean
    recursions are re-run against ``spec.y``.
    """
    yb, obsb, Zb, _, Tb, _, Db, Cb = _step_arrays(spec)
    if stats is None:
        stats = forward_stats(spec)
    else:
        # recompute y-dependent forward means with the shared gains
        def fwd_mean(a, xs):
            y, obs, Z, T, D, C, F, K = xs
            ok = obs & (F > ZERO_TOL)
            v = jnp.where(ok, y - D - Z @ a, 0.0)
            a_next = C + T @ (a + K * v)
            return a_next, v

        _, vt = jax.lax.scan(
            fwd_mean, spec.a1,
            (yb, obsb, Zb, Tb, Db, Cb, stats.Ft, stats.Kt))
        stats = stats._replace(vt=vt, ok=obsb & (stats.Ft > ZERO_TOL))
    return _mean_passes(spec, stats)


def fast_smoother_ll(spec: LGSpec) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(smoothed means, filter log-likelihood) from ONE shared forward pass —
    the Laplace-iteration hot path runs the smoother anyway, so the Gaussian
    log-likelihood of the approximating model comes for free instead of
    costing a second O(n) scan (`/root/reference/src/model_ssm_ung.cpp:185`
    runs them separately).

    Means come from the moment identity alphahat_t = a_t + P_t r_{t-1}
    (Durbin-Koopman eq. 4.44): since the filter pass already stores (at, Pt),
    the forward mean recursion of the classic fast smoother collapses to one
    batched einsum — 2 sequential scans instead of 3."""
    r = kfilter(spec)
    ok = spec.obs_mask & (r.Ft > ZERO_TOL)
    m = spec.m
    dt = spec.y.dtype
    _, _, Zb, _, Tb, _, _, _ = _step_arrays(spec)

    def back(rc, xs):
        v, F, K, okt, Z, T = xs
        okf = okt.astype(dt)
        L = T @ (jnp.eye(m, dtype=dt) - jnp.outer(K, Z))
        r_new = okf * (Z * (v / F) + L.T @ rc) + (1 - okf) * (T.T @ rc)
        return r_new, r_new

    # ys[t] = carry AFTER processing t in reverse = r_{t-1}
    _, rprev = jax.lax.scan(back, jnp.zeros((m,), dt),
                            (r.vt, r.Ft, r.Kt, ok, Zb, Tb), reverse=True)
    alphas = r.at[:-1] + jnp.einsum('tij,tj->ti', r.Pt[:-1], rprev)
    alpha = jnp.concatenate([alphas, r.at[-1][None]], axis=0)
    degenerate = (jnp.sum(spec.HH) + jnp.sum(jnp.abs(spec.R))) < ZERO_TOL
    ll = jnp.where(degenerate, -jnp.inf, r.logLik)
    return alpha, ll


def _mean_passes(spec: LGSpec, stats: SmootherStats) -> jnp.ndarray:
    """Backward r-recursion + forward mean pass of the fast smoother."""
    m = spec.m
    dt = spec.y.dtype
    _, _, Zb, _, Tb, RRb, _, Cb = _step_arrays(spec)

    def back(r, xs):
        v, F, K, ok, Z, T = xs
        okf = ok.astype(dt)
        L = T @ (jnp.eye(m, dtype=dt) - jnp.outer(K, Z))
        r_obs = Z * (v / F) + L.T @ r
        r_mis = T.T @ r
        return okf * r_obs + (1 - okf) * r_mis, r

    # r_t defined for t = 0..n-1 with r_{n-1} = 0; backward recursion
    r0, rs_rev = jax.lax.scan(
        back, jnp.zeros((m,), dt),
        (stats.vt, stats.Ft, stats.Kt, stats.ok, Zb, Tb), reverse=True)
    # rs_rev[t] is the value fed *into* step t, i.e. r_t; r0 = output of t=0
    rt = rs_rev  # (n, m): rt[t] = r_t with r_{n-1}=0 ... careful below
    # scan(reverse) ys are aligned with xs: ys[t] = value of carry *before*
    # processing t in reverse order = r_t.  r0 is r_{-1}.
    alpha0 = spec.a1 + spec.P1 @ r0

    def fwd(a, xs):
        T, C, RR, r = xs
        a_next = C + T @ a + RR @ r
        return a_next, a

    alpha_n, alphas = jax.lax.scan(fwd, alpha0, (Tb, Cb, RRb, rt))
    # alphas[t] = alpha_t for t=0..n-1; final carry = alpha_n
    return jnp.concatenate([alphas, alpha_n[None]], axis=0)


def smoother_bwd_factors(spec: LGSpec):
    """(ahat, Lb, Ab): the BACKWARD (FFBS) factorization of the smoothing
    law — the psi-APF proposal factors.

    The smoothing distribution factorizes backward in time,
        alpha_n ~ N(ahat_n, P_{n|n-1}),
        alpha_t | alpha_{t+1} ~ N(ahat_t + J_t (alpha_{t+1} - ahat_{t+1}),
                                  Ptt_t - J_t P_{t+1|t} J_t'),
    with J_t = Ptt_t T_t' P_{t+1|t}^+ the smoothing gain (identical
    functional form to the forward factorization the reference samples,
    `/root/reference/src/model_ssm_ung.cpp:511-609`, just time-reversed).

    Deliberate deviation: the reference computes FORWARD conditionals
    A = ccov' Vt^+ (`/root/reference/src/conditional_dist.cpp:4-67`), which
    pseudo-inverts the smoothed covariance — a quantity formed by
    cancellation whose small eigenvalues carry ~100% relative error at
    f32, turning A into garbage (|A| ~ 500 observed in f32 runs).  The backward
    gain J needs only filter quantities whose per-direction scales match,
    and is f32-stable by construction.

    Returns (ahat (n+1, m), Lb (n+1, m, m), Ab (n+1, m, m)) where
    Ab[t] = J_t for t < n (gain from alpha_{t+1} to alpha_t), Ab[n] = 0,
    Lb[t] = a square-root factor of the backward conditional covariance,
    Lb[n] = factor(P_{n|n-1})."""
    from .chol import _psd_factor, _psd_pinv
    r = kfilter(spec)
    _, _, _, _, Tb, RRb, _, _ = _step_arrays(spec)
    m = spec.m

    def back(ahat_next, xs):
        T, RR, att, Ptt, a_next, P_next = xs
        J = Ptt @ T.T @ _psd_pinv(P_next)
        ahat = att + J @ (ahat_next - a_next)
        # Joseph form of the backward conditional covariance: identical to
        # Ptt - J P_pred J' (via J P_pred = Ptt T') but all-additive — the
        # difference form cancels to ~0 for near-deterministic coordinates
        # and f32 roundoff over-disperses them by ~1e6x
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


class SmoothResult(NamedTuple):
    alphahat: jnp.ndarray  # (n+1, m)
    Vt: jnp.ndarray        # (n+1, m, m)
    ccov: jnp.ndarray      # (n+1, m, m)  Cov(alpha_t, alpha_{t+1} | y); [n]=0
    logLik: jnp.ndarray


def smoother(spec: LGSpec, want_ccov: bool = False) -> SmoothResult:
    """Full RTS smoother with variances (and the lag-1 cross-covariances
    needed by the psi-APF proposal)
    (`/root/reference/src/model_ssm_ulg.cpp:419-473,511-555`).

    Deliberate deviation from the reference's Durbin-Koopman N-recursion
    (V_t = P_t - P_t N_t P_t): with a diffuse-scale P1 (the bsm default is
    100 I) that form cancels ~P1-sized quantities to recover V ~ 1e-4, an
    absolute error of eps*P1^2*N — fatal in f32 (observed: negative smoothed
    variances, conditional gains |A| ~ 500, psi-APF IS log-weights +3000).
    The classic J-form recursion below is algebraically identical but
    propagates the correction through J (V_next - P_pred) J', so early-time
    errors are squashed by J ~ Ptt/P_pred; f32 matches f64 to ~1e-4
    relative even at near-degenerate state noise."""
    from .chol import _psd_pinv
    r = kfilter(spec)
    m = spec.m
    dt = spec.y.dtype
    _, _, _, _, Tb, _, _, _ = _step_arrays(spec)

    def back(carry, xs):
        ahat_next, V_next = carry
        T, att, Ptt, a_next, P_next = xs
        # J_t = Ptt T' P_pred^+ ; pinv handles deterministic (zero-noise)
        # state components, cf. `/root/reference/src/conditional_dist.cpp`
        J = Ptt @ T.T @ _psd_pinv(P_next)
        ahat = att + J @ (ahat_next - a_next)
        V = Ptt + J @ (V_next - P_next) @ J.T
        V = 0.5 * (V + V.T)
        ccov = J @ V_next           # Cov(alpha_t, alpha_{t+1} | y)
        return (ahat, V), (ahat, V, ccov)

    init = (r.at[-1], r.Pt[-1])
    xs = (Tb, r.att, r.Ptt, r.at[1:], r.Pt[1:])
    _, (ahat, Vt, ccov) = jax.lax.scan(back, init, xs, reverse=True)
    ahat = jnp.concatenate([ahat, r.at[-1][None]], axis=0)
    Vt = jnp.concatenate([Vt, r.Pt[-1][None]], axis=0)
    ccov = jnp.concatenate([ccov, jnp.zeros((1, m, m), dt)], axis=0)
    return SmoothResult(ahat, Vt, ccov, r.logLik)
