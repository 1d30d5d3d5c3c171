"""Model-specification PyTrees for the state-space engine.

Design (see SURVEY.md §7.1): instead of the reference's mutable C++ model
classes (`/root/reference/src/model_ssm_ulg.h:12-118`), a model is an
*immutable* PyTree of system arrays produced by a pure ``build(theta)``
function.  Everything downstream (`jit`, `vmap`, `shard_map`) traces through
it, so the reference's ``update_model`` is free at run time.

Conventions
-----------
All system matrices carry a leading "time" axis of size either 1 (time
invariant) or ``n`` (time varying); ``at_t(A, t)`` indexes it.  Shapes for a
univariate-observation linear-Gaussian model with state dim ``m`` and ``k``
state-noise columns:

==========  ==================  =============================================
field       shape               role (Durbin & Koopman notation)
==========  ==================  =============================================
``y``       ``(n,)``            observations (NaN == missing)
``Z``       ``(nz, m)``         observation vector  y_t = D_t + Z_t' a_t + e
``H``       ``(nh,)``           obs noise std-dev   e ~ N(0, H_t^2)
``T``       ``(nt, m, m)``      transition matrix
``R``       ``(nr, m, k)``      state noise loading a_{t+1} = C + T a + R eta
``a1``      ``(m,)``            prior state mean
``P1``      ``(m, m)``          prior state covariance
``D``       ``(nd,)``           obs intercept (xreg effect folded in here)
``C``       ``(nc, m)``         state intercept
==========  ==================  =============================================

The multivariate variant stores ``y: (n, p)``, ``Z: (nz, p, m)``,
``H: (nh, p, p)`` (a lower-triangular factor so obs cov = H H'), ``D: (nd, p)``.

Reference parity: `/root/reference/src/model_ssm_ulg.cpp` (univariate LG),
`/root/reference/src/model_ssm_mlg.cpp` (multivariate LG),
`/root/reference/src/model_ssm_ung.cpp` (univariate non-Gaussian).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

from . import pytree as struct


def at_t(A: jnp.ndarray, t) -> jnp.ndarray:
    """Index the leading time axis, broadcasting a size-1 axis to every t.

    Mirrors the reference's ``A.slice(t * Atv)`` trick
    (`/root/reference/src/model_ssm_ulg.cpp:124-133`) with static shape logic:
    the multiplier ``A.shape[0] > 1`` is a Python bool at trace time.
    """
    if A.shape[0] == 1:
        return A[0]
    return A[t]


class LGSpec(NamedTuple):
    """Univariate-observation linear-Gaussian state-space model."""
    y: jnp.ndarray      # (n,)
    Z: jnp.ndarray      # (nz, m)
    H: jnp.ndarray      # (nh,)
    T: jnp.ndarray      # (nt, m, m)
    R: jnp.ndarray      # (nr, m, k)
    a1: jnp.ndarray     # (m,)
    P1: jnp.ndarray     # (m, m)
    D: jnp.ndarray      # (nd,)
    C: jnp.ndarray      # (nc, m)

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def m(self) -> int:
        return self.a1.shape[0]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def HH(self) -> jnp.ndarray:
        return self.H * self.H

    @property
    def RR(self) -> jnp.ndarray:   # (nr, m, m)
        return jnp.einsum('tij,tkj->tik', self.R, self.R)

    @property
    def obs_mask(self) -> jnp.ndarray:
        """finite-y mask, (n,); replaces the reference's isfinite branches."""
        return jnp.isfinite(self.y)


class MVLGSpec(NamedTuple):
    """Multivariate-observation linear-Gaussian state-space model."""
    y: jnp.ndarray      # (n, p)
    Z: jnp.ndarray      # (nz, p, m)
    H: jnp.ndarray      # (nh, p, p)  lower-tri factor; obs cov = H H'
    T: jnp.ndarray      # (nt, m, m)
    R: jnp.ndarray      # (nr, m, k)
    a1: jnp.ndarray     # (m,)
    P1: jnp.ndarray     # (m, m)
    D: jnp.ndarray      # (nd, p)
    C: jnp.ndarray      # (nc, m)

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def p(self) -> int:
        return self.y.shape[1]

    @property
    def m(self) -> int:
        return self.a1.shape[0]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def RR(self) -> jnp.ndarray:
        return jnp.einsum('tij,tkj->tik', self.R, self.R)

    @property
    def obs_mask(self) -> jnp.ndarray:
        """(n, p) finite mask — partial missingness allowed per series."""
        return jnp.isfinite(self.y)


# Observation-family codes, matching the reference's integer encoding
# (`/root/reference/src/model_ssm_ung.cpp:296-342`).
SVM = 0
POISSON = 1
BINOMIAL = 2
NEGBIN = 3
GAMMA = 4
GAUSSIAN = 5   # only used inside multivariate mixed-family models


@struct.dataclass
class NGSpec:
    """Univariate non-Gaussian model: LG state dynamics + exponential-family
    observations (`/root/reference/src/model_ssm_ung.h:14-133`).

    ``distribution`` is a *static* (non-pytree) field — trace-time dispatch,
    matching the reference's switch statements.  ``phi`` is the auxiliary
    parameter (SV sigma, negbin dispersion, gamma shape), ``u`` the
    exposure/trials.
    """
    y: jnp.ndarray      # (n,)
    Z: jnp.ndarray      # (nz, m)
    T: jnp.ndarray      # (nt, m, m)
    R: jnp.ndarray      # (nr, m, k)
    a1: jnp.ndarray     # (m,)
    P1: jnp.ndarray     # (m, m)
    D: jnp.ndarray      # (nd,)
    C: jnp.ndarray      # (nc, m)
    phi: jnp.ndarray    # scalar
    u: jnp.ndarray      # (n,)
    distribution: int = struct.field(pytree_node=False, default=POISSON)
    initial_mode: Optional[jnp.ndarray] = None   # (n,)

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def m(self) -> int:
        return self.a1.shape[0]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def obs_mask(self) -> jnp.ndarray:
        return jnp.isfinite(self.y)

    def approx_gaussian(self, ytilde: jnp.ndarray, Htilde: jnp.ndarray) -> LGSpec:
        """The approximating LG model sharing this model's state dynamics."""
        return LGSpec(y=ytilde, Z=self.Z, H=Htilde, T=self.T, R=self.R,
                      a1=self.a1, P1=self.P1, D=self.D, C=self.C)


@struct.dataclass
class MVNGSpec:
    """Multivariate non-Gaussian model with per-series observation families
    (`/root/reference/src/model_ssm_mng.cpp`).  ``distributions`` is a static
    tuple of ints (may include GAUSSIAN)."""
    y: jnp.ndarray      # (n, p)
    Z: jnp.ndarray      # (nz, p, m)
    T: jnp.ndarray      # (nt, m, m)
    R: jnp.ndarray      # (nr, m, k)
    a1: jnp.ndarray     # (m,)
    P1: jnp.ndarray     # (m, m)
    D: jnp.ndarray      # (nd, p)
    C: jnp.ndarray      # (nc, m)
    phi: jnp.ndarray    # (p,)
    u: jnp.ndarray      # (n, p)
    distributions: tuple = struct.field(pytree_node=False, default=())
    initial_mode: Optional[jnp.ndarray] = None   # (n, p)

    @property
    def n(self) -> int:
        return self.y.shape[0]

    @property
    def p(self) -> int:
        return self.y.shape[1]

    @property
    def m(self) -> int:
        return self.a1.shape[0]

    @property
    def k(self) -> int:
        return self.R.shape[-1]

    @property
    def obs_mask(self) -> jnp.ndarray:
        return jnp.isfinite(self.y)

    def approx_gaussian(self, ytilde: jnp.ndarray, Htilde: jnp.ndarray) -> MVLGSpec:
        """Approximating MV LG model; Htilde (n, p) diagonal stds -> (n, p, p)."""
        Hmat = jnp.zeros((Htilde.shape[0], self.p, self.p), Htilde.dtype)
        ii = jnp.arange(self.p)
        Hmat = Hmat.at[:, ii, ii].set(Htilde)
        return MVLGSpec(y=ytilde, Z=self.Z, H=Hmat, T=self.T, R=self.R,
                        a1=self.a1, P1=self.P1, D=self.D, C=self.C)
