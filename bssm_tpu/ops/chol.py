"""Branch-free Cholesky utilities for (possibly) singular covariances.

State-space models routinely carry deterministic state components, so
covariance matrices have exact zero rows/columns.  The reference handles this
by slicing out the nonzero submatrix (`/root/reference/src/psd_chol.cpp:5-18`,
`reference/src/conditional_dist.cpp:33-65`); under jit we need static
shapes, so we use the "unit-diagonal padding" trick: add 1 to the diagonal of
(near-)zero rows, factor, and zero them back out.  Because those rows/columns
are zero off-diagonal, the resulting factor is exactly the padded-submatrix
factor — no approximation.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 2.220446049250313e-16  # double eps; threshold semantics follow the ref


def _zero_diag_mask(x: jnp.ndarray, rel: bool = True) -> jnp.ndarray:
    """True for rows considered active (diagonal > tolerance)."""
    d = jnp.diagonal(x)
    if rel:
        tol = jnp.maximum(_EPS, _EPS * x.shape[-1] * jnp.max(d))
    else:
        tol = _EPS
    return d > tol


def psd_chol(x: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky of a PSD matrix whose singularity comes from zero
    diagonal entries (deterministic states).  Matches
    `/root/reference/src/psd_chol.cpp:5-18` semantics with static shapes."""
    active = _zero_diag_mask(x, rel=True)
    return masked_chol(x, active)


def masked_chol(x: jnp.ndarray, active: jnp.ndarray) -> jnp.ndarray:
    """Cholesky of ``x`` restricted to ``active`` rows/cols; inactive rows and
    columns of the result are exactly zero."""
    am = active.astype(x.dtype)
    outer = am[:, None] * am[None, :]
    padded = x * outer + jnp.diag(1.0 - am)
    L = jnp.linalg.cholesky(padded)
    # Guard NaNs from genuinely indefinite input the same way the reference's
    # chol would abort — propagate zeros instead (callers check diagnostics).
    L = jnp.where(jnp.isfinite(L), L, 0.0)
    return L * outer


def masked_tri_solve(L: jnp.ndarray, b: jnp.ndarray, active: jnp.ndarray,
                     lower: bool = True) -> jnp.ndarray:
    """Solve L x = b on the active subspace (L from ``masked_chol``)."""
    am = active.astype(L.dtype)
    Ls = L + jnp.diag(1.0 - am)
    x = jax.scipy.linalg.solve_triangular(Ls, b, lower=lower)
    if b.ndim == 1:
        return x * am
    return x * am[:, None]


def _eigh2x2(Vs: jnp.ndarray):
    """Closed-form eigendecomposition of a symmetric 2x2 matrix.

    The XLA `eigh` lowers to an iterative Jacobi sweep — far too heavy for
    the psi-APF hot path, which factorises one tiny covariance per
    (correction, time-step).  For m=2 the spectrum is analytic:
    lambda = mean(tr) +- sqrt(((a-c)/2)^2 + b^2).  Returns (w, U) with
    columns of U the orthonormal eigenvectors, ascending eigenvalues,
    matching `jnp.linalg.eigh`'s convention."""
    a, b, c = Vs[0, 0], Vs[0, 1], Vs[1, 1]
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    r = jnp.sqrt(half_diff * half_diff + b * b)
    w = jnp.stack([half_tr - r, half_tr + r])
    # eigenvector for the larger eigenvalue: (b, r - half_diff) or
    # (r + half_diff, b); pick the better-conditioned form branch-free
    use_first = jnp.abs(r - half_diff) > jnp.abs(r + half_diff)
    v1 = jnp.where(use_first, b, r + half_diff)
    v2 = jnp.where(use_first, r - half_diff, b)
    nrm = jnp.sqrt(v1 * v1 + v2 * v2)
    ok = nrm > 0
    nrm = jnp.where(ok, nrm, 1.0)
    v1 = jnp.where(ok, v1 / nrm, 1.0)
    v2 = jnp.where(ok, v2 / nrm, 0.0)
    # eigenvector of the smaller eigenvalue is the orthogonal complement
    U = jnp.stack([jnp.stack([-v2, v1]), jnp.stack([v1, v2])], axis=1)
    return w, U


def _sym_eigh(Vs: jnp.ndarray):
    """eigh with a closed-form fast path for the m<=2 shapes that dominate
    every reference benchmark config (BASELINE.md: bsm m=2, ar1/svm m=1)."""
    m = Vs.shape[-1]
    if m == 1:
        return Vs[..., 0], jnp.ones_like(Vs)
    if m == 2:
        return _eigh2x2(Vs)
    return jnp.linalg.eigh(Vs)


def _psd_factor(V: jnp.ndarray) -> jnp.ndarray:
    """Symmetric square-root factor of a (numerically) PSD matrix via eigh
    with eigenvalue clipping — the reference's SVD branch
    (`/root/reference/src/conditional_dist.cpp:8-31`), robust at f32 where
    Cholesky fails on cancellation-indefinite smoother covariances."""
    Vs = 0.5 * (V + V.T)
    w, U = _sym_eigh(Vs)
    w = jnp.clip(w, 0.0, None)
    return U * jnp.sqrt(w)[None, :]


def _psd_pinv(V: jnp.ndarray) -> jnp.ndarray:
    """Pseudo-inverse of a PSD matrix (eigh, Tikhonov-smoothed).

    A hard keep/drop tolerance is a cliff: an eigenvalue whose absolute
    error (~eps * lambda_max, from the covariance recursions that produced
    V) is as large as itself can land just above the cutoff and contribute
    a garbage 1/lambda — at f32 this produced conditional gains |A| ~ 500
    and psi-APF IS log-weights in the thousands.  The smoothed inverse
    lambda / (lambda^2 + delta^2) equals 1/lambda for healthy eigenvalues
    (relative error (delta/lambda)^2), and rolls off to 0 for directions
    below the noise floor — numerically-deterministic state components get
    treated as exactly deterministic, matching the reference's zero-row
    pruning (`/root/reference/src/conditional_dist.cpp:33-65`) without a
    branch."""
    m = V.shape[-1]
    Vs = 0.5 * (V + V.T)
    w, U = _sym_eigh(Vs)
    w = jnp.clip(w, 0.0, None)
    delta = 4.0 * m * jnp.finfo(V.dtype).eps * jnp.max(w)
    den = w * w + delta * delta
    winv = jnp.where(den > 0, w / jnp.where(den > 0, den, 1.0), 0.0)
    return (U * winv[None, :]) @ U.T


def conditional_cov_factors(Vt: jnp.ndarray, Ct: jnp.ndarray):
    """Convert smoothed marginal covariances + lag-1 cross-covariances into
    the psi-APF conditional proposal parameters.

    Inputs (cf. `/root/reference/src/conditional_dist.cpp:4-31`, SVD branch):
      Vt:  (n+1, m, m) smoothed covariances Var(alpha_t | y)
      Ct:  (n+1, m, m) with Ct[t] = Cov(alpha_t, alpha_{t+1} | y) for t < n
    Returns:
      Lcond: (n+1, m, m) square-root factors of Var(alpha_t | alpha_{t-1}, y)
             (symmetric-eigh factors, used only as linear maps on normals)
      Acond: (n+1, m, m) regression coefs: E[a_t|a_{t-1}] = ahat_t +
             Acond[t] (a_{t-1} - ahat_{t-1});  Acond[0] = 0.
    """
    n1, m, _ = Vt.shape

    def one(V_prev, C_prev, V_t):
        # A = Cov(a_t, a_{t-1}) Var(a_{t-1})^+  (exact conditional coef;
        # validated against a dense joint-Gaussian oracle)
        A = C_prev.T @ _psd_pinv(V_prev)
        V_c = V_t - A @ C_prev
        return _psd_factor(V_c), A

    Ls, As = jax.vmap(one)(Vt[:-1], Ct[:-1], Vt[1:])
    L0 = _psd_factor(Vt[0])
    Lcond = jnp.concatenate([L0[None], Ls], axis=0)
    Acond = jnp.concatenate([jnp.zeros((1, m, m), Vt.dtype), As], axis=0)
    return Lcond, Acond


def chol_rank1_update(L: jnp.ndarray, v: jnp.ndarray, down: bool) -> jnp.ndarray:
    """Rank-1 Cholesky update (``down=False``) / downdate (``down=True``) of a
    lower-triangular factor, L L' +- v v'.

    Re-derivation of the RAM adaptation primitive used via the `ramcmc`
    header library by the reference (`/root/reference/src/mcmc.cpp:277`);
    standard hyperbolic/Givens rotation algorithm, sequential over the (small)
    parameter dimension.
    """
    d = L.shape[0]
    sign = jnp.where(down, -1.0, 1.0).astype(L.dtype)

    def body(k, carry):
        L, v = carry
        Lkk = L[k, k]
        vk = v[k]
        r2 = Lkk * Lkk + sign * vk * vk
        r = jnp.sqrt(jnp.maximum(r2, jnp.finfo(L.dtype).tiny))
        c = r / Lkk
        s = vk / Lkk
        col = L[:, k]
        new_col = (col + sign * s * v) / c
        new_v = c * v - s * new_col
        # only touch rows > k (strictly below diagonal) plus the diagonal
        rows = jnp.arange(d)
        below = rows > k
        L = L.at[:, k].set(jnp.where(below, new_col, col))
        L = L.at[k, k].set(r)
        v = jnp.where(below, new_v, v)
        return L, v

    L, _ = jax.lax.fori_loop(0, d, body, (L, v))
    return L
