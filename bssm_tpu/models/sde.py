"""Univariate diffusion models observed at integer times.

  d alpha_t = drift(alpha_t, theta) dt + diffusion(alpha_t, theta) dB_t,
  y_k ~ g(y_k | alpha_k),   k = 1..n,

propagated by the Milstein scheme at discretisation level 2^L
(`/root/reference/src/model_ssm_sde.{h,cpp}`, `/root/reference/src/milstein.cpp`).

The reference couples coarse (2^L_c) and fine (2^L_f) levels through a
dedicated `coarse_engine` so the delayed-acceptance / IS corrections have
positively correlated estimators; here the same effect comes from deriving
the coarse Brownian increments by summing the fine ones under one key
(`milstein_coupled`).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pytree as struct
from .base import Model


@struct.dataclass
class SDESpec:
    y: jnp.ndarray     # (n,)
    theta: jnp.ndarray
    x0: jnp.ndarray    # scalar initial state (fixed, as in the reference)
    drift: Callable = struct.field(pytree_node=False)
    diffusion: Callable = struct.field(pytree_node=False)
    ddiffusion: Callable = struct.field(pytree_node=False)
    log_obs_density: Callable = struct.field(pytree_node=False)  # (y, x, th)
    positive: bool = struct.field(pytree_node=False, default=False)
    L_f: int = struct.field(pytree_node=False, default=5)
    L_c: int = struct.field(pytree_node=False, default=2)

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def m(self) -> int:
        return 1


def milstein_step(x, dB, dt, theta, spec: SDESpec):
    """One Milstein update (`/root/reference/src/milstein_functions.h:38-48`)."""
    d = spec.diffusion(x, theta)
    x = x + spec.drift(x, theta) * dt + d * dB \
        + 0.5 * d * spec.ddiffusion(x, theta) * (dB * dB - dt)
    return jnp.abs(x) if spec.positive else x


def milstein(spec: SDESpec, x0, key, L: int, t: float = 1.0,
             gen_L: int | None = None):
    """Terminal value of a 2^L-step Milstein discretisation on [0, t].

    ``gen_L >= L`` generates the Brownian increments at the FINER level
    2^gen_L and sums them onto the 2^L grid: two filters run at different
    levels from the same ``key`` then share the same Brownian path — the
    multilevel coupling the reference routes through a dedicated
    `coarse_engine` (`/root/reference/src/model_ssm_sde.h:45-48`,
    seeded at `/root/reference/src/approx_mcmc.cpp:537-538`)."""
    if gen_L is None:
        gen_L = L
    nf = 2 ** gen_L
    dtf = t / nf
    dBf = jnp.sqrt(dtf) * jax.random.normal(key, (nf,), spec.y.dtype)
    ratio = 2 ** (gen_L - L)
    dB = dBf.reshape(-1, ratio).sum(axis=1) if ratio > 1 else dBf
    dt = t / (2 ** L)

    def body(x, db):
        return milstein_step(x, db, dt, spec.theta, spec), None

    x, _ = jax.lax.scan(body, x0, dB)
    return x


def milstein_coupled(spec: SDESpec, x0_f, x0_c, key, t: float = 1.0):
    """Propagate one interval at both fine and coarse levels from the SAME
    Brownian path: coarse increments = sums of 2^(L_f-L_c) fine increments
    (replaces the reference's shared `coarse_engine`,
    `/root/reference/src/model_ssm_sde.h:45-48`)."""
    nf = 2 ** spec.L_f
    ratio = 2 ** (spec.L_f - spec.L_c)
    dtf = t / nf
    dBf = jnp.sqrt(dtf) * jax.random.normal(key, (nf,), spec.y.dtype)
    dBc = dBf.reshape(-1, ratio).sum(axis=1)
    dtc = t / (2 ** spec.L_c)

    def bf(x, db):
        return milstein_step(x, db, dtf, spec.theta, spec), None

    def bc(x, db):
        return milstein_step(x, db, dtc, spec.theta, spec), None

    xf, _ = jax.lax.scan(bf, x0_f, dBf)
    xc, _ = jax.lax.scan(bc, x0_c, dBc)
    return xf, xc


def ssm_sde(y, drift, diffusion, ddiffusion, log_obs_density, *,
            x0: float, positive: bool = False, L_f: int = 5, L_c: int = 2,
            theta_init=(), log_prior=None, theta_names=None,
            dtype=jnp.float64) -> Model:
    """Construct an SDE model (`/root/reference/R/models.R:1637`)."""
    y_np = np.asarray(y, np.float64)
    yj = jnp.asarray(y_np, dtype)
    theta0 = jnp.asarray(np.atleast_1d(np.asarray(theta_init, np.float64)),
                         dtype)

    def build(theta):
        return SDESpec(y=yj, theta=theta.astype(dtype),
                       x0=jnp.asarray(float(x0), dtype), drift=drift,
                       diffusion=diffusion, ddiffusion=ddiffusion,
                       log_obs_density=log_obs_density, positive=positive,
                       L_f=L_f, L_c=L_c)

    lp = (lambda th: jnp.zeros((), dtype)) if log_prior is None else log_prior
    names = theta_names or tuple(f"theta_{i + 1}"
                                 for i in range(theta0.shape[0]))
    return Model(build=build, log_prior=lp, theta_init=theta0,
                 theta_names=names,
                 transforms=np.zeros(theta0.shape[0], np.int32),
                 kind="sde", extra={"n": y_np.shape[0], "m": 1})


# ---------------------------------------------------------------------------
# built-in examples (`/root/reference/R/cpp_example_models.R:24-190`)
# ---------------------------------------------------------------------------

def sde_poisson_ou(y, x0=0.0, L_f=5, L_c=2, dtype=jnp.float64) -> Model:
    """Latent OU process with Poisson observations; theta = (log rho, nu,
    log sigma) (`cpp_example_models.R:24-118`)."""
    from jax.scipy.special import gammaln

    def drift(x, th):
        return jnp.exp(th[0]) * (th[1] - x)

    def diffusion(x, th):
        return jnp.exp(th[2]) * jnp.ones_like(x)

    def ddiffusion(x, th):
        return jnp.zeros_like(x)

    def log_obs(yv, x, th):
        lam = jnp.exp(x)
        return yv * x - lam - gammaln(yv + 1.0)

    def log_prior(th):
        rho = jnp.exp(th[0])
        sig = jnp.exp(th[2])
        lp = (2.0 - 1.0) * jnp.log(rho) - rho / 0.5   # gamma(2, scale .5)
        lp = lp - 0.5 * jnp.square(th[1] / 4.0)
        lp = lp - 0.5 * jnp.square(sig)
        return lp + th[0] + th[2]

    return ssm_sde(y, drift, diffusion, ddiffusion, log_obs, x0=x0,
                   positive=False, L_f=L_f, L_c=L_c,
                   theta_init=(np.log(0.5), 0.0, np.log(0.3)),
                   log_prior=log_prior,
                   theta_names=("log_rho", "nu", "log_sigma"), dtype=dtype)


def sde_gbm(y, x0=1.0, L_f=5, L_c=2, dtype=jnp.float64) -> Model:
    """Geometric Brownian motion with log-normal observations; theta =
    (mu, sigma_x, sigma_y) (`cpp_example_models.R:118-190`)."""
    def drift(x, th):
        return th[0] * x

    def diffusion(x, th):
        return jnp.maximum(0.0, th[1] * x)

    def ddiffusion(x, th):
        return th[1] * (x > 0.0)

    def log_obs(yv, x, th):
        xs = jnp.maximum(x, 1e-300)
        return -0.5 * jnp.square((yv - jnp.log(xs)) / th[2]) \
            - jnp.log(th[2]) - 0.9189385332046727

    def log_prior(th):
        ok = (th[0] >= 0) & (th[1] >= 0) & (th[2] >= 0.5)
        lp = (-0.5 * jnp.square(th[0] / 0.1)
              - 0.5 * jnp.square(th[1] / 0.5)
              - 0.5 * jnp.square((th[2] - 1.5) / 0.5))
        return jnp.where(ok, lp, -jnp.inf)

    return ssm_sde(y, drift, diffusion, ddiffusion, log_obs, x0=x0,
                   positive=True, L_f=L_f, L_c=L_c,
                   theta_init=(0.05, 0.3, 1.5), log_prior=log_prior,
                   theta_names=("mu", "sigma_x", "sigma_y"), dtype=dtype)
