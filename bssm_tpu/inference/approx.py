"""Gaussian (Laplace) approximation of non-Gaussian models.

The mode-matching iteration of Durbin-Koopman / Shephard-Pitt
(`/root/reference/src/model_ssm_ung.cpp:87-161`): iterate
{ build pseudo-obs (ytilde, Htilde) at the current signal mode ->
  Kalman fast-smooth the approximating LG model -> new signal mode }
until the mean-squared signal change drops below ``conv_tol`` (max
``max_iter`` iterations) — here as a `lax.while_loop`, fully jittable and
history-independent (the iteration always starts from ``spec.initial_mode``,
matching the reference's reset at `/root/reference/src/model_ssm_ung.cpp:217`).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import config as _config
from ..core import distributions as fam
from ..core.spec import LGSpec, NGSpec, SVM
from ..ops import kalman

CONV_TOL = 1e-8
MAX_ITER = 100


def signal_from_states(spec: NGSpec, alpha: jnp.ndarray) -> jnp.ndarray:
    """Linear signal s_t = D_t + Z_t' alpha_t, (n,) from alpha (n, m).
    For the SV family the signal is the log-volatility state itself
    (`/root/reference/src/model_ssm_ung.cpp:105-112`)."""
    if spec.distribution == SVM:
        return alpha[:, 0]
    n = spec.n
    Z = jnp.broadcast_to(spec.Z, (n,) + spec.Z.shape[1:]) \
        if spec.Z.shape[0] == 1 else spec.Z
    D = jnp.broadcast_to(spec.D, (n,)) if spec.D.shape[0] == 1 else spec.D
    return D + jnp.einsum('tm,tm->t', Z, alpha)


class ApproxResult(NamedTuple):
    mode: jnp.ndarray       # (n,) converged signal mode
    ytilde: jnp.ndarray     # (n,) pseudo-observations (NaN at missing y)
    Htilde: jnp.ndarray     # (n,) pseudo-std-devs
    niter: jnp.ndarray      # iterations used
    diff: jnp.ndarray       # final mean-squared change
    gloglik: jnp.ndarray | None = None   # KF loglik of the approximating
    # model at (ytilde, Htilde), fused out of the final smoother pass

    def gaussian(self, spec: NGSpec) -> LGSpec:
        return spec.approx_gaussian(self.ytilde, self.Htilde)


def _one_match(spec: NGSpec, mode):
    yt, HH = fam.laplace_match(spec.distribution, spec.y, spec.u,
                               spec.phi, mode)
    H = jnp.sqrt(jnp.where(jnp.isfinite(HH) & (HH > 0), HH, 1.0))
    yt = jnp.where(spec.obs_mask, yt, jnp.nan)
    return yt, H


def approximate(spec: NGSpec, conv_tol: float = CONV_TOL,
                max_iter: int = MAX_ITER, mode0=None) -> ApproxResult:
    """Full Laplace iteration from ``spec.initial_mode``.

    ``mode0`` optionally warm-starts the iteration (e.g. from the previous
    accepted draw's converged mode inside MCMC).  For the supported
    exponential families the observation log-density is concave in the
    signal, so the fixed point is unique and a warm start changes only the
    iteration count, not the converged mode (up to ``conv_tol``) — the
    reference always cold-starts from the data-derived mode
    (`/root/reference/src/model_ssm_ung.cpp:217`)."""
    n = spec.n
    if mode0 is None:
        mode0 = spec.initial_mode.astype(spec.y.dtype)
    else:
        mode0 = mode0.astype(spec.y.dtype)
    # conv_tol below the dtype noise floor would always exhaust max_iter
    # (f32 eps ~1e-7); clamp to a resolvable tolerance
    conv_tol = max(conv_tol, 50.0 * float(jnp.finfo(spec.y.dtype).eps))

    if _config.time_parallel:
        from ..ops.pkalman import fast_smoother_parallel

        def cond_tp(carry):
            _, _, _, i, diff, _ = carry
            return (i < max_iter) & (diff > conv_tol)

        def body_tp(carry):
            mode, _, _, i, _, _ = carry
            yt, H = _one_match(spec, mode)
            approx = spec.approx_gaussian(yt, H)
            alpha = fast_smoother_parallel(approx)
            new_mode = signal_from_states(spec, alpha[:n])
            diff = jnp.sum(jnp.square(new_mode - mode)) / n
            return (new_mode, yt, H, i + 1, diff,
                    jnp.zeros((), spec.y.dtype))

        yt0, H0 = _one_match(spec, mode0)
        init = (mode0, yt0, H0, jnp.zeros((), jnp.int32),
                jnp.asarray(conv_tol + 1.0, spec.y.dtype),
                jnp.zeros((), spec.y.dtype))
        mode, yt, H, niter, diff, _ = jax.lax.while_loop(cond_tp, body_tp,
                                                         init)
        return ApproxResult(mode, yt, H, niter, diff, None)

    # the (ytilde, Htilde) of the final approximation are re-derived from
    # the penultimate mode afterwards — exactly the pair the last smoother
    # pass consumed
    mode, prev, niter, diff, gll = _laplace_solve(spec, mode0, conv_tol,
                                                  max_iter)
    yt, H = _one_match(spec, prev)
    return ApproxResult(mode, yt, H, niter, diff, gll)


def _laplace_step(spec: NGSpec, mode):
    """One mode-matching iteration: (new mode, KF log-likelihood of the
    approximating model at match(mode), mean-squared signal change)."""
    n = spec.n
    yt, H = _one_match(spec, mode)
    alpha, ll = kalman.fast_smoother_ll(spec.approx_gaussian(yt, H))
    new_mode = signal_from_states(spec, alpha[:n])
    diff = jnp.sum(jnp.square(new_mode - mode)) / n
    return new_mode, ll, diff


def _laplace_solve(spec: NGSpec, mode0, conv_tol: float, max_iter: int):
    """`lax.while_loop` over `_laplace_step` until the mean-squared change
    drops below ``conv_tol``: (mode, previous mode, iterations, last change,
    Gaussian log-likelihood of the last approximation)."""

    def cond(carry):
        _, _, i, diff, _ = carry
        return (i < max_iter) & (diff > conv_tol)

    def body(carry):
        mode, _, i, _, _ = carry
        new_mode, gll, diff = _laplace_step(spec, mode)
        return (new_mode, mode, i + 1, diff, gll)

    dt = mode0.dtype
    init = (mode0, mode0, jnp.zeros((), jnp.int32),
            jnp.asarray(conv_tol + 1.0, dt), jnp.zeros((), dt))
    return jax.lax.while_loop(cond, body, init)


def approximate_for_is(spec: NGSpec, stored_mode: jnp.ndarray) -> ApproxResult:
    """Rebuild the approximation from a stored mode without iterating
    (`/root/reference/src/model_ssm_ung.cpp:143-161`)."""
    yt, H = _one_match(spec, stored_mode)
    return ApproxResult(stored_mode, yt, H, jnp.ones((), jnp.int32),
                        jnp.zeros((), spec.y.dtype))


class ApproxLoglik(NamedTuple):
    approx: ApproxResult
    scales: jnp.ndarray        # (n,) mode-based correction terms
    loglik: jnp.ndarray        # scalar approximate marginal log-likelihood
    gaussian_loglik: jnp.ndarray


def approx_loglik(spec: NGSpec, approx: ApproxResult | None = None,
                  conv_tol: float = CONV_TOL,
                  max_iter: int = MAX_ITER, mode0=None) -> ApproxLoglik:
    """Approximate marginal log-likelihood = KF loglik of the approximating
    model + exact constant term + sum of mode-based scales
    (`/root/reference/src/model_ssm_ung.cpp:164-236`)."""
    if approx is None:
        approx = approximate(spec, conv_tol, max_iter, mode0=mode0)
    if approx.gloglik is not None:
        gll = approx.gloglik
    elif _config.time_parallel:
        from ..ops.pkalman import log_likelihood_parallel
        gll = log_likelihood_parallel(approx.gaussian(spec))
    else:
        gll = kalman.log_likelihood(approx.gaussian(spec))
    sc = fam.scales(spec.distribution, spec.y, spec.u, spec.phi,
                    approx.mode, approx.ytilde, approx.Htilde)
    sc = jnp.where(spec.obs_mask, sc, 0.0)
    ct = fam.const_term(spec.distribution, spec.y, spec.u, spec.phi,
                        approx.ytilde, approx.Htilde)
    return ApproxLoglik(approx, sc, gll + ct + jnp.sum(sc), gll)


def gaussian_approx(spec, conv_tol: float = CONV_TOL,
                    max_iter: int = MAX_ITER):
    """Public API: the approximating linear-Gaussian model
    (`/root/reference/R/approx.R:42`).  Dispatches over ung/mng/nlg."""
    from ..core.spec import MVNGSpec
    from ..models.base import Model as _Model
    if isinstance(spec, _Model):
        spec = spec.build(spec.theta_init)
    if isinstance(spec, NGSpec):
        return approximate(spec, conv_tol, max_iter).gaussian(spec)
    if isinstance(spec, MVNGSpec):
        from . import approx_mv as mv_mod
        return mv_mod.approximate_mv(spec, conv_tol,
                                     max_iter).gaussian(spec)
    from ..models.nlg import NLGSpec
    if isinstance(spec, NLGSpec):
        from .nlg import approximate_nlg
        return approximate_nlg(spec).approx
    raise TypeError(type(spec))
