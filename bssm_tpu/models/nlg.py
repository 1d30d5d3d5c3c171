"""General nonlinear-Gaussian state-space models.

  y_t     = Z(t, alpha_t, theta) + H(t, alpha_t, theta) eps_t
  alpha_t+1 = T(t, alpha_t, theta) + R(t, alpha_t, theta) eta_t

The reference takes raw C function pointers compiled from user snippets
(`/root/reference/src/model_ssm_nlg.h:10-21`); here the model functions are
**JAX callables** traced into every kernel, and the Jacobians Z_gn/T_gn
default to `jax.jacfwd` (the reference requires hand-coded derivatives).

Function signatures mirror the reference:
  Z_fn(t, alpha, theta) -> (p,)      H_fn(t, alpha, theta) -> (p, p)
  T_fn(t, alpha, theta) -> (m,)      R_fn(t, alpha, theta) -> (m, k)
  a1_fn(theta) -> (m,)               P1_fn(theta) -> (m, m)
(known_params are closed over by the user functions.)
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core import pytree as struct
from .base import Model


@struct.dataclass
class NLGSpec:
    """Parameterised nonlinear model instance (functions static)."""
    y: jnp.ndarray       # (n, p)
    theta: jnp.ndarray
    Z_fn: Callable = struct.field(pytree_node=False)
    H_fn: Callable = struct.field(pytree_node=False)
    T_fn: Callable = struct.field(pytree_node=False)
    R_fn: Callable = struct.field(pytree_node=False)
    Z_gn: Callable = struct.field(pytree_node=False)
    T_gn: Callable = struct.field(pytree_node=False)
    a1_fn: Callable = struct.field(pytree_node=False)
    P1_fn: Callable = struct.field(pytree_node=False)
    m: int = struct.field(pytree_node=False, default=1)
    k: int = struct.field(pytree_node=False, default=1)
    iekf_iter: int = struct.field(pytree_node=False, default=0)
    max_iter: int = struct.field(pytree_node=False, default=100)
    conv_tol: float = struct.field(pytree_node=False, default=1e-8)

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def p(self) -> int:
        return self.y.shape[1]

    @property
    def obs_mask(self) -> jnp.ndarray:
        return jnp.isfinite(self.y)

    def a1(self):
        return self.a1_fn(self.theta)

    def P1(self):
        return self.P1_fn(self.theta)


def ssm_nlg(y, Z_fn, H_fn, T_fn, R_fn, *, m: int, k: Optional[int] = None,
            a1_fn=None, P1_fn=None, Z_gn=None, T_gn=None,
            theta_init=(), log_prior=None, theta_names=None,
            iekf_iter: int = 0, max_iter: int = 100, conv_tol: float = 1e-8,
            dtype=jnp.float64) -> Model:
    """Construct a nonlinear model (`/root/reference/R/models.R:1545`)."""
    y_np = np.asarray(y, np.float64)
    if y_np.ndim == 1:
        y_np = y_np[:, None]
    yj = jnp.asarray(y_np, dtype)
    k = k if k is not None else m

    if a1_fn is None:
        a1_fn = lambda th: jnp.zeros(m, dtype)            # noqa: E731
    if P1_fn is None:
        P1_fn = lambda th: jnp.eye(m, dtype=dtype)        # noqa: E731
    if Z_gn is None:
        Z_gn = lambda t, a, th: jax.jacfwd(               # noqa: E731
            lambda aa: Z_fn(t, aa, th))(a)
    if T_gn is None:
        T_gn = lambda t, a, th: jax.jacfwd(               # noqa: E731
            lambda aa: T_fn(t, aa, th))(a)

    theta0 = jnp.asarray(np.atleast_1d(np.asarray(theta_init, np.float64)),
                         dtype)

    def build(theta):
        return NLGSpec(y=yj, theta=theta.astype(dtype), Z_fn=Z_fn, H_fn=H_fn,
                       T_fn=T_fn, R_fn=R_fn, Z_gn=Z_gn, T_gn=T_gn,
                       a1_fn=a1_fn, P1_fn=P1_fn, m=m, k=k,
                       iekf_iter=iekf_iter, max_iter=max_iter,
                       conv_tol=conv_tol)

    lp = (lambda th: jnp.zeros((), dtype)) if log_prior is None else log_prior
    names = theta_names or tuple(f"theta_{i + 1}"
                                 for i in range(theta0.shape[0]))
    return Model(build=build, log_prior=lp, theta_init=theta0,
                 theta_names=names,
                 transforms=np.zeros(theta0.shape[0], np.int32),
                 kind="nlg", extra={"m": m, "n": y_np.shape[0],
                                    "p": y_np.shape[1]})
