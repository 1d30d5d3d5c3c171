"""Particle resampling and ancestor tracing, vmappable and shape-static.

Stratified resampling follows `/root/reference/src/stratified_sample.cpp:9-28`
(Vihola's O(N) cumsum walk): with normalised weights w and uniforms
r_j ~ U(0,1), index_j = min{ k : cumsum(w)_k >= (j + r_j)/N }.  Implemented
as searchsorted over the cumulative weights — O(N log N) but fully
parallel, where the reference walks sequentially in O(N).

Ancestor tracing re-designs `/root/reference/src/filter_smoother.cpp:5-20`
(in-place cube rewrite) as a reverse scan composing index maps, followed by
one gather — no in-place mutation, O(n N) instead of O(n N m) moves.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def stratified_indices(weights: jnp.ndarray, key) -> jnp.ndarray:
    """Stratified resampling indices, (N,) int32.  ``weights`` normalised."""
    N = weights.shape[0]
    cp = jnp.cumsum(weights)
    cp = cp.at[-1].set(1.0)
    r = jax.random.uniform(key, (N,), weights.dtype)
    u = (jnp.arange(N, dtype=weights.dtype) + r) / N
    return jnp.clip(jnp.searchsorted(cp, u, side="left"), 0, N - 1).astype(jnp.int32)


def stratified_select(weights: jnp.ndarray, key, alpha: jnp.ndarray):
    """(resampled values, indices) sharing one uniform draw: the values
    come from the one-hot selection matmul (`stratified_gather`) and the
    indices from the same
    uniforms via searchsorted, for ancestor tracing.  Both agree with
    ``alpha[stratified_indices(weights, key)]`` identically."""
    N = weights.shape[0]
    dt = weights.dtype
    cp = jnp.cumsum(weights)
    cp = cp.at[-1].set(1.0)
    r = jax.random.uniform(key, (N,), dt)
    u = (jnp.arange(N, dtype=dt) + r) / N
    idx = jnp.clip(jnp.searchsorted(cp, u, side="left"), 0,
                   N - 1).astype(jnp.int32)
    ge = cp[None, :] >= u[:, None]
    # prev[0] = -1 (not 0): u == 0.0 must select column 0, matching
    # searchsorted's side="left"
    prev = jnp.concatenate([jnp.full((1,), -1.0, dt), cp[:-1]])
    lt = prev[None, :] < u[:, None]
    H = (ge & lt).astype(alpha.dtype)
    return H @ alpha, idx


def stratified_gather(weights: jnp.ndarray, key, alpha: jnp.ndarray
                      ) -> jnp.ndarray:
    """Resampled particle VALUES via a one-hot selection matmul: returns
    ``alpha[stratified_indices(weights, key)]`` without the gather.

    The selection matrix H[p, q] = 1{cp[q-1] < u_p <= cp[q]} has exactly
    one 1 per row by construction, so H @ alpha is the gathered ensemble,
    at O(N^2 m) multiply-adds.  Whether this beats a searchsorted +
    gather on the GPU is unmeasured (ROADMAP speed item 3)."""
    N = weights.shape[0]
    dt = weights.dtype
    cp = jnp.cumsum(weights)
    cp = cp.at[-1].set(1.0)
    r = jax.random.uniform(key, (N,), dt)
    u = (jnp.arange(N, dtype=dt) + r) / N
    ge = cp[None, :] >= u[:, None]                       # (N, N)
    prev = jnp.concatenate([jnp.full((1,), -1.0, dt), cp[:-1]])
    lt = prev[None, :] < u[:, None]
    H = (ge & lt).astype(alpha.dtype)
    return H @ alpha


def ancestor_trace(alpha: jnp.ndarray, indices: jnp.ndarray) -> jnp.ndarray:
    """Kitagawa filter-smoother backward tracing.

    alpha:   (N, n+1, m) particle trajectories (post-filter storage where
             alpha[:, t+1] are children of alpha[indices[:, t], t])
    indices: (N, n) resampling ancestors
    returns: (N, n+1, m) traced trajectories: row i is the full path ending
             at particle i at time n.
    """
    N, n1, m = alpha.shape
    n = n1 - 1

    def back(b, idx_t):
        b_new = idx_t[b]
        return b_new, b_new

    # b_t for t = n-1..0: lineage of particle i at time t
    _, bs_rev = jax.lax.scan(back, jnp.arange(N, dtype=indices.dtype),
                             jnp.swapaxes(indices, 0, 1), reverse=True)
    # bs_rev[t] = ancestor index of final particle i at time t  (t=0..n-1)
    gather = jnp.concatenate(
        [jnp.swapaxes(bs_rev, 0, 1),
         jnp.arange(N, dtype=indices.dtype)[:, None]], axis=1)  # (N, n+1)
    return jnp.take_along_axis(alpha, gather[:, :, None], axis=0)


def stratified_indices_from_uniforms(weights: jnp.ndarray,
                                     r: jnp.ndarray) -> jnp.ndarray:
    """Stratified resampling with caller-supplied uniforms r ~ U(0,1)^N —
    lets filters pre-generate all randomness up front (one threefry
    sweep)."""
    N = weights.shape[0]
    cp = jnp.cumsum(weights)
    cp = cp.at[-1].set(1.0)
    u = (jnp.arange(N, dtype=weights.dtype) + r) / N
    return jnp.clip(jnp.searchsorted(cp, u, side="left"), 0,
                    N - 1).astype(jnp.int32)


def systematic_indices(weights: jnp.ndarray, key) -> jnp.ndarray:
    """Systematic resampling (single uniform); cheaper collective, offered as
    an alternative to stratified for large ensembles."""
    N = weights.shape[0]
    cp = jnp.cumsum(weights)
    cp = cp.at[-1].set(1.0)
    r = jax.random.uniform(key, (), weights.dtype)
    u = (jnp.arange(N, dtype=weights.dtype) + r) / N
    return jnp.clip(jnp.searchsorted(cp, u, side="left"), 0, N - 1).astype(jnp.int32)

def stratified_gather_from_uniforms(weights: jnp.ndarray, r: jnp.ndarray,
                                    alpha: jnp.ndarray) -> jnp.ndarray:
    """`stratified_gather` with caller-supplied uniforms (one-hot matmul
    selection; identical draws to
    ``alpha[stratified_indices_from_uniforms(weights, r)]``)."""
    N = weights.shape[0]
    dt = weights.dtype
    cp = jnp.cumsum(weights)
    cp = cp.at[-1].set(1.0)
    u = (jnp.arange(N, dtype=dt) + r) / N
    ge = cp[None, :] >= u[:, None]
    prev = jnp.concatenate([jnp.full((1,), -1.0, dt), cp[:-1]])
    lt = prev[None, :] < u[:, None]
    H = (ge & lt).astype(alpha.dtype)
    return H @ alpha
