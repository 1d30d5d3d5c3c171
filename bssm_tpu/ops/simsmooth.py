"""Durbin-Koopman simulation smoother (with antithetic variates).

Vectorised version of `reference/src/model_ssm_ulg.cpp:141-247`:
draw an unconditional trajectory (alpha+, y+), smooth the synthetic data, and
combine  alpha_sim = alphahat - E[alpha | y+] + alpha+.

Design notes:
- The per-draw smoothing pass reuses the shared forward gains (F_t, K_t) of
  the model — only the y-dependent mean recursions are re-run per draw, so
  the whole thing is one `vmap` over draws of two O(n m) scans.
- Antithetic pairs: draw i' = 2*alphahat - draw i (the reference's
  `use_antithetic` path, `model_ssm_ulg.cpp:187-190`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.spec import LGSpec
from .chol import psd_chol
from .kalman import SmootherStats, _step_arrays, fast_smoother, forward_stats


def _simulate_prior_and_obs(spec: LGSpec, key, zero_mean: bool):
    """One unconditional draw of (alpha+, y+); y+ only at observed times.

    With ``zero_mean`` the intercepts / a1 are dropped (Jarocinski's note,
    used by the reference's single-draw fast path)."""
    n, m, k = spec.n, spec.m, spec.k
    dt = spec.y.dtype
    yb, obs, Zb, HHb, Tb, RRb, Db, Cb = _step_arrays(spec)
    Rb = jnp.broadcast_to(spec.R, (n,) + spec.R.shape[1:]) \
        if spec.R.shape[0] == 1 else spec.R
    Hb = jnp.sqrt(HHb)

    k0, k1, k2 = jax.random.split(key, 3)
    um = jax.random.normal(k0, (m,), dt)
    eps = jax.random.normal(k1, (n,), dt)
    eta = jax.random.normal(k2, (n, k), dt)

    L1 = psd_chol(spec.P1)
    a0 = L1 @ um if zero_mean else spec.a1 + L1 @ um

    def step(a, xs):
        Z, H, T, R, C, e, w = xs
        ysim = (Z @ a) + H * e
        a_next = (T @ a + R @ w) if zero_mean else (C + T @ a + R @ w)
        return a_next, (a, ysim)

    a_n, (aplus, ysim) = jax.lax.scan(
        step, a0, (Zb, Hb, Tb, Rb, Cb, eps, eta))
    aplus = jnp.concatenate([aplus, a_n[None]], axis=0)   # (n+1, m)
    if not zero_mean:
        ysim = ysim + Db
    return aplus, ysim


def simulate_states_single(spec: LGSpec, key) -> jnp.ndarray:
    """One posterior draw of the state trajectory, (n+1, m)."""
    aplus, ysim = _simulate_prior_and_obs(spec, key, zero_mean=True)
    ystar = jnp.where(spec.obs_mask, spec.y - ysim, spec.y)
    cond = fast_smoother(spec._replace(y=ystar))
    return cond + aplus


def simulate_states(spec: LGSpec, nsim: int, key,
                    use_antithetic: bool = True) -> jnp.ndarray:
    """``nsim`` posterior draws, shape (nsim, n+1, m)
    (`/root/reference/src/model_ssm_ulg.cpp:141-247`)."""
    if nsim == 1:
        return simulate_states_single(spec, key)[None]

    stats = forward_stats(spec)
    alphahat = fast_smoother(spec, stats)

    n_base = (nsim + 1) // 2 if use_antithetic else nsim
    keys = jax.random.split(key, n_base)

    def one(k):
        aplus, ysim = _simulate_prior_and_obs(spec, k, zero_mean=False)
        ystar = jnp.where(spec.obs_mask, ysim, spec.y)
        # smoothing pass on synthetic y reuses the shared y-independent gains
        cond = fast_smoother(spec._replace(y=ystar), stats)
        return alphahat - cond + aplus

    base = jax.vmap(one)(keys)                    # (n_base, n+1, m)
    if use_antithetic:
        anti = 2.0 * alphahat[None] - base
        out = jnp.concatenate([base, anti], axis=0)[:nsim]
    else:
        out = base[:nsim]
    return out
