"""General state-space models with user-supplied JAX update functions.

The reference's `ssm_ulg`/`ssm_ung`/`ssm_mlg`/`ssm_mng` take R callback
functions ``update_fn``/``prior_fn`` re-entered from C++ on every proposal
(`/root/reference/src/model_ssm_ulg.cpp:64-104`) — the main serial bottleneck
the `parset_*` machinery works around.  Here the callbacks are **JAX
functions** traced once into the MCMC kernel: ``update_fn(theta)`` returns a
dict of system arrays to override, ``prior_fn(theta)`` a scalar log-density.

Array shape conventions follow R (time axis last on input) and are
normalised to the spec convention (time axis first).
"""
from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..core import validate as val
from ..core.spec import LGSpec, MVLGSpec, MVNGSpec, NGSpec
from .base import Model, init_mode
from .bsm import _DIST_NAMES


def _tfirst(A, core_ndim):
    """Move a trailing time axis (if any) to the front; add it if absent."""
    A = jnp.asarray(A)
    if A.ndim == core_ndim:
        return A[None]
    return jnp.moveaxis(A, -1, 0)


def _norm_uni(Z, H, T, R, n):
    """Univariate-obs system arrays, R-style layouts validated and moved
    to the spec (time-first) convention.  Returns (m, Z, H, T, R)."""
    Z = val.check_Z(Z, 1, n)                       # (m, 1|n)
    m = Z.shape[0]
    T = val.check_T(T, m, n)                       # (m, m, 1|n)
    R = val.check_R(R, m, n)                       # (m, k, 1|n)
    H = val.check_H(H, 1, n)                       # (1|n,)
    return m, (jnp.asarray(Z.T), jnp.asarray(H), jnp.asarray(
        np.moveaxis(T, -1, 0)), jnp.asarray(np.moveaxis(R, -1, 0)))


def _norm_mv(Z, H, T, R, p, n, with_H=True):
    """Multivariate-obs system arrays -> spec layout."""
    Z = val.check_Z(Z, p, n, multivariate=True)    # (p, m, 1|n)
    m = Z.shape[1]
    T = val.check_T(T, m, n)
    R = val.check_R(R, m, n)
    out = [jnp.asarray(np.moveaxis(Z, -1, 0)),
           jnp.asarray(np.moveaxis(T, -1, 0)),
           jnp.asarray(np.moveaxis(R, -1, 0))]
    if with_H:
        H = val.check_H(H, p, n, multivariate=True)
        out.append(jnp.asarray(np.moveaxis(H, -1, 0)))
    return m, out


def _defaults(m, a1, P1, D, C, n, p=None, dtype=jnp.float64):
    a1_ = jnp.asarray(val.check_a1(a1, m), dtype)
    P1_ = jnp.asarray(val.check_P1(P1, m), dtype)
    D_np = val.check_D(D, 1 if p is None else p, n)
    if p is None:
        D_ = jnp.asarray(D_np, dtype)                  # (1|n,)
    else:
        # multivariate intercept is always 2-D (1|n, p), incl. p == 1
        # (check_D returns 1-D for p == 1)
        D2 = np.atleast_2d(D_np) if D_np.ndim == 1 else D_np
        D_ = jnp.asarray(D2.T, dtype)                  # (1|n, p)
    C_ = jnp.asarray(val.check_C(C, m, n).T, dtype)    # (1|n, m)
    return a1_, P1_, D_, C_


def _make_model(base_spec, update_fn, prior_fn, init_theta, kind, extra,
                names=None):
    theta0 = jnp.asarray(np.atleast_1d(np.asarray(init_theta,
                                                  dtype=np.float64)))

    def build(theta):
        spec = base_spec
        if update_fn is not None:
            upd = update_fn(theta)
            norm = {}
            for k, v in upd.items():
                cur = getattr(spec, k)
                v = jnp.asarray(v, cur.dtype)
                if k in ("y", "a1", "H", "u", "phi", "initial_mode"):
                    norm[k] = v.reshape(cur.shape) if v.shape != cur.shape \
                        and v.ndim == cur.ndim else v
                elif k == "P1":
                    norm[k] = v.reshape(cur.shape[-2:])
                elif k in ("Z", "T", "R", "C", "D"):
                    core = cur.ndim - 1
                    if v.ndim == core:
                        norm[k] = v[None]
                    elif v.shape[0] == cur.shape[0]:
                        norm[k] = v
                    else:
                        norm[k] = jnp.moveaxis(v, -1, 0)
                else:
                    norm[k] = v
            # LGSpec/MVLGSpec are NamedTuples (_replace); NG specs are
            # core.pytree dataclasses (replace)
            spec = (spec._replace(**norm) if hasattr(spec, "_replace")
                    else spec.replace(**norm))
        return spec

    lp = (lambda th: jnp.zeros((), theta0.dtype)) if prior_fn is None \
        else prior_fn
    if names is None:
        names = tuple(f"theta_{i + 1}" for i in range(theta0.shape[0]))
    return Model(build=build, log_prior=lp, theta_init=theta0,
                 theta_names=names,
                 transforms=np.zeros(theta0.shape[0], np.int32),
                 kind=kind, extra=extra)


def ssm_ulg(y, Z, H, T, R, a1=None, P1=None, D=None, C=None,
            init_theta=(), update_fn: Optional[Callable] = None,
            prior_fn: Optional[Callable] = None, theta_names=None,
            dtype=jnp.float64) -> Model:
    """Univariate linear-Gaussian model (`/root/reference/R/models.R:193`)."""
    y_np = val.check_y(y)
    n = y_np.shape[0]
    y = jnp.asarray(y_np, dtype)
    m, (Zj, Hj, Tj, Rj) = _norm_uni(Z, H, T, R, n)
    a1_, P1_, D_, C_ = _defaults(m, a1, P1, D, C, n, dtype=dtype)
    val.check_missingness({"Z": Zj, "H": Hj, "T": Tj, "R": Rj,
                           "a1": a1_, "P1": P1_, "D": D_, "C": C_})
    spec = LGSpec(y=y, Z=Zj.astype(dtype), H=Hj.astype(dtype),
                  T=Tj.astype(dtype), R=Rj.astype(dtype), a1=a1_, P1=P1_,
                  D=D_, C=C_)
    return _make_model(spec, update_fn, prior_fn, init_theta, "lg",
                       {"m": m, "n": n}, theta_names)


def ssm_ung(y, Z, T, R, distribution, phi=1.0, u=None, a1=None, P1=None,
            D=None, C=None, init_theta=(), update_fn=None, prior_fn=None,
            theta_names=None, dtype=jnp.float64) -> Model:
    """Univariate non-Gaussian model (`/root/reference/R/models.R:309`)."""
    dist = _DIST_NAMES[distribution] if isinstance(distribution, str) \
        else int(distribution)
    y_np = val.check_y(y, distribution=distribution
                       if isinstance(distribution, str) else None)
    n = y_np.shape[0]
    u_np = np.ones(n) if u is None else val.check_u(u, y_np)
    m, (Zj, _, Tj, Rj) = _norm_uni(Z, np.ones(1), T, R, n)
    a1_, P1_, D_, C_ = _defaults(m, a1, P1, D, C, n, dtype=dtype)
    val.check_missingness({"Z": Zj, "T": Tj, "R": Rj, "a1": a1_,
                           "P1": P1_, "D": D_, "C": C_, "u": u_np})
    spec = NGSpec(y=jnp.asarray(y_np, dtype), Z=Zj.astype(dtype),
                  T=Tj.astype(dtype), R=Rj.astype(dtype), a1=a1_, P1=P1_,
                  D=D_, C=C_, phi=jnp.asarray(float(phi), dtype),
                  u=jnp.asarray(u_np, dtype), distribution=dist,
                  initial_mode=jnp.asarray(init_mode(y_np, u_np, dist), dtype))
    return _make_model(spec, update_fn, prior_fn, init_theta, "ng",
                       {"m": m, "n": n, "distribution": dist}, theta_names)


def ssm_mlg(y, Z, H, T, R, a1=None, P1=None, D=None, C=None,
            init_theta=(), update_fn=None, prior_fn=None, theta_names=None,
            dtype=jnp.float64) -> Model:
    """Multivariate linear-Gaussian model (`/root/reference/R/models.R:414`)."""
    y_np = val.check_y(y, multivariate=True)
    y = jnp.asarray(y_np, dtype)
    n, p = y.shape
    m, (Zj, Tj, Rj, Hj) = _norm_mv(Z, H, T, R, p, n)
    a1_, P1_, D_, C_ = _defaults(m, a1, P1, D, C, n, p=p, dtype=dtype)
    val.check_missingness({"Z": Zj, "H": Hj, "T": Tj, "R": Rj,
                           "a1": a1_, "P1": P1_, "D": D_, "C": C_})
    spec = MVLGSpec(y=y, Z=Zj.astype(dtype), H=Hj.astype(dtype),
                    T=Tj.astype(dtype), R=Rj.astype(dtype), a1=a1_, P1=P1_,
                    D=D_, C=C_)
    return _make_model(spec, update_fn, prior_fn, init_theta, "mlg",
                       {"m": m, "n": n, "p": p}, theta_names)


def ssm_mng(y, Z, T, R, distributions, phi=None, u=None, a1=None, P1=None,
            D=None, C=None, init_theta=(), update_fn=None, prior_fn=None,
            theta_names=None, dtype=jnp.float64) -> Model:
    """Multivariate non-Gaussian model with per-series families
    (`/root/reference/R/models.R:538`)."""
    y_np = val.check_y(y, multivariate=True)
    n, p = y_np.shape
    if isinstance(distributions, (str, int)):
        distributions = [distributions] * p
    dist_names = [d if isinstance(d, str) else None for d in distributions]
    if all(isinstance(d, str) for d in distributions):
        val.check_distribution(y_np, dist_names)
    dists = tuple(_DIST_NAMES[d] if isinstance(d, str) else int(d)
                  for d in distributions)
    u_np = np.ones((n, p)) if u is None else np.broadcast_to(
        np.asarray(u, np.float64), (n, p)).copy()
    if (u_np <= 0).any() or not np.isfinite(u_np).all():
        raise ValueError("Argument 'u' must contain only positive finite "
                         "values.")
    phi_np = np.ones(p) if phi is None else np.broadcast_to(
        np.asarray(phi, np.float64), (p,)).copy()
    m, (Zj, Tj, Rj) = _norm_mv(Z, None, T, R, p, n, with_H=False)
    a1_, P1_, D_, C_ = _defaults(m, a1, P1, D, C, n, p=p, dtype=dtype)
    val.check_missingness({"Z": Zj, "T": Tj, "R": Rj, "a1": a1_,
                           "P1": P1_, "D": D_, "C": C_, "u": u_np})
    mode0 = np.stack([init_mode(y_np[:, j], u_np[:, j], dists[j])
                      for j in range(p)], axis=1)
    spec = MVNGSpec(y=jnp.asarray(y_np, dtype), Z=Zj.astype(dtype),
                    T=Tj.astype(dtype), R=Rj.astype(dtype), a1=a1_, P1=P1_,
                    D=D_, C=C_, phi=jnp.asarray(phi_np, dtype),
                    u=jnp.asarray(u_np, dtype), distributions=dists,
                    initial_mode=jnp.asarray(mode0, dtype))
    return _make_model(spec, update_fn, prior_fn, init_theta, "mng",
                       {"m": m, "n": n, "p": p}, theta_names)


def as_bssm(y, Z=None, H=None, T=None, R=None, a1=None, P1=None, D=None,
            C=None, distribution=None, phi=1.0, u=None, kappa=100.0,
            **kwargs):
    """Convert a KFAS `SSModel` — a parsed dict or a path to a `saveRDS`
    .rds file — or raw system matrices into the matching bssm model
    (`/root/reference/R/as_bssm.R:26-154`).  SSModel ingestion replicates
    the reference's kappa-for-diffuse P1 handling and R/H re-factorisation
    (see `utils.kfas.as_bssm_kfas`)."""
    import numpy as _np
    if isinstance(y, (str, dict)):
        from ..utils.kfas import as_bssm_kfas
        return as_bssm_kfas(y, kappa=kappa, **kwargs)
    if Z is None or H is None and distribution is None or T is None \
            or R is None:
        raise ValueError("as_bssm needs an SSModel (dict/.rds path) or the "
                         "full Z/H/T/R system")
    y_np = _np.asarray(y, _np.float64)
    multivariate = y_np.ndim == 2 and y_np.shape[1] > 1
    if distribution is None:
        if multivariate:
            return ssm_mlg(y, Z, H, T, R, a1=a1, P1=P1, D=D, C=C, **kwargs)
        return ssm_ulg(y, Z, H, T, R, a1=a1, P1=P1, D=D, C=C, **kwargs)
    if multivariate:
        return ssm_mng(y, Z, T, R, distributions=distribution, phi=phi, u=u,
                       a1=a1, P1=P1, D=D, C=C, **kwargs)
    return ssm_ung(y, Z, T, R, distribution=distribution, phi=phi, u=u,
                   a1=a1, P1=P1, D=D, C=C, **kwargs)
