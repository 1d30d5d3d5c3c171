"""MCMC engines: RAM Metropolis with gaussian / approx / IS / PM / DA flavours.

Re-design of `reference/src/mcmc.cpp` and
`/root/reference/src/approx_mcmc.cpp`:

- One chain = one `lax.scan` over iterations; **many chains = `vmap`** over a
  keys axis (sharded over the device mesh by `parallel.chains`), replacing
  the reference's single chain + OpenMP post-correction threads.
- Storage is dense per post-burnin iteration (the jump-chain with counts is a
  compression; dense storage keeps shapes static — SURVEY.md §7.1).  The
  ``accepted`` flag marks jump-chain heads, so is1/is2/is3 semantics are
  reproduced exactly (is2 forward-fills head results across duplicates).
- The IS post-correction phase is an embarrassingly parallel `vmap` over
  stored draws — the reference's `#pragma omp parallel` loop
  (`/root/reference/src/approx_mcmc.cpp:353-427`) becomes a batched psi-APF.

Statistical defaults follow the reference: burnin = iter/2, target
acceptance 0.234, gamma = 2/3, RAM adaptation every iteration unless
``end_adaptive_phase`` freezes it after burnin.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import LGSpec, NGSpec
from ..models.base import Model
from ..ops.resample import ancestor_trace
from ..ops.simsmooth import simulate_states_single
from . import approx as approx_mod
from . import particle as pf_mod
from .ram import adapt_S

_NEG_INF = -jnp.inf


# --------------------------------------------------------------------------
# generic RAM-MH scan
# --------------------------------------------------------------------------

class ChainState(NamedTuple):
    theta: jnp.ndarray
    lp_prior: jnp.ndarray
    ll_accept: jnp.ndarray     # log-lik entering the accept ratio
    ll_ram: jnp.ndarray        # log-lik entering the RAM acceptance prob
    aux: Any                   # flavour-specific extras carried with theta
    S: jnp.ndarray
    key: jnp.ndarray


def _ram_scan(logdens: Callable, log_prior: Callable, theta0, S0, key,
              n_iter: int, burnin: int, target: float, gamma: float,
              end_ram: bool, aux0):
    """Run the RAM-MH chain; returns per-iteration storage for all n_iter.

    ``logdens(theta, key, aux_carry) -> (ll_accept, ll_ram, aux)``;
    aux is a PyTree stored alongside theta (e.g. Laplace mode, state draw).
    """
    d = theta0.shape[0]
    dt = theta0.dtype

    key, k0 = jax.random.split(key)
    ll_a0, ll_r0, aux_init = logdens(theta0, k0, aux0)
    # loglik dtype may differ from theta dtype (f32 model under x64);
    # normalise so the lax.cond branches below have equal output types
    ll_a0, ll_r0 = jnp.asarray(ll_a0, dt), jnp.asarray(ll_r0, dt)
    lp0 = log_prior(theta0)

    def body(carry: ChainState, i):
        key, k_u, k_acc, k_den = jax.random.split(carry.key, 4)
        u = jax.random.normal(k_u, (d,), dt)
        prop = carry.theta + carry.S @ u
        lp_prop = log_prior(prop)
        ok = lp_prop > _NEG_INF

        def eval_prop(_):
            a, r, aux = logdens(prop, k_den, carry.aux)
            return jnp.asarray(a, dt), jnp.asarray(r, dt), aux

        def skip(_):
            return (jnp.asarray(_NEG_INF, dt), jnp.asarray(_NEG_INF, dt),
                    carry.aux)

        ll_a_prop, ll_r_prop, aux_prop = jax.lax.cond(ok, eval_prop, skip,
                                                      None)
        ram_diff = ll_r_prop - carry.ll_ram + lp_prop - carry.lp_prior
        acc_prob = jnp.where(ok, jnp.minimum(1.0, jnp.exp(ram_diff)), 0.0)
        acc_diff = ll_a_prop - carry.ll_accept + lp_prop - carry.lp_prior
        accept = ok & (jnp.log(jax.random.uniform(k_acc, (), dt)) < acc_diff)

        new = ChainState(
            theta=jnp.where(accept, prop, carry.theta),
            lp_prior=jnp.where(accept, lp_prop, carry.lp_prior),
            ll_accept=jnp.where(accept, ll_a_prop, carry.ll_accept),
            ll_ram=jnp.where(accept, ll_r_prop, carry.ll_ram),
            aux=jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), aux_prop, carry.aux),
            S=carry.S, key=key)

        do_adapt = jnp.asarray(True) if not end_ram else (i <= burnin)
        S_new = adapt_S(carry.S, u, acc_prob, target, i, gamma)
        new = new._replace(S=jnp.where(do_adapt, S_new, carry.S))

        ys = (new.theta, new.lp_prior, new.ll_accept, accept, new.aux)
        return new, ys

    init = ChainState(theta0, lp0, ll_a0, ll_r0, aux_init, S0, key)
    final, ys = jax.lax.scan(body, init, jnp.arange(1, n_iter + 1))
    thetas, lps, lls, accepted, auxs = ys
    return final, thetas, lps, lls, accepted, auxs


# --------------------------------------------------------------------------
# results container
# --------------------------------------------------------------------------

_LAZY_ARRAY_FIELDS = frozenset((
    "theta", "posterior", "accepted", "S", "alpha", "alphahat", "Vt",
    "weights", "modes", "approx_loglik", "prior", "theta_sampled"))


@dataclasses.dataclass(repr=False, eq=False)
class McmcOutput:
    """Posterior sample container (dense storage, chain axis first).

    theta is reported in the *natural* space (log-sampled parameters
    exponentiated back, `/root/reference/R/run_mcmc.R:255-261`).

    Array fields are **device-lazy**: `run_mcmc` stores the device arrays it
    computed (after `block_until_ready`, so the run is complete) and the
    device->host copy happens on first attribute access, converting to a
    cached numpy array.  Consumers always see plain numpy; producers never
    pay for transfers of fields the caller does not touch (e.g. the
    (chains, S, n) Laplace-mode stack)."""
    theta: np.ndarray            # (chains, S, d)
    posterior: np.ndarray        # (chains, S)
    accepted: np.ndarray         # (chains, S) jump-chain head flags
    acceptance_rate: float
    S: np.ndarray                # (chains, d, d) final RAM factors
    theta_names: tuple
    mcmc_type: str
    output_type: str
    iter: int
    burnin: int
    thin: int
    alpha: Optional[np.ndarray] = None       # (chains, S, n+1, m) draws
    alphahat: Optional[np.ndarray] = None    # (n+1, m) weighted smoothed mean
    Vt: Optional[np.ndarray] = None          # (n+1, m, m)
    weights: Optional[np.ndarray] = None     # (chains, S) IS weights
    modes: Optional[np.ndarray] = None       # (chains, S, n) Laplace modes
    approx_loglik: Optional[np.ndarray] = None
    prior: Optional[np.ndarray] = None
    time: Optional[dict] = None
    theta_sampled: Optional[np.ndarray] = None  # (chains, S, d) sampled-space
    # copy stored alongside modes so post_correct replays bit-exactly
    # (avoids the exp/log round-trip through the natural-space theta)

    def __getattribute__(self, name):
        v = object.__getattribute__(self, name)
        if name in _LAZY_ARRAY_FIELDS and v is not None \
                and not isinstance(v, np.ndarray):
            v = np.asarray(v)
            object.__setattr__(self, name, v)
        return v

    @property
    def counts(self) -> np.ndarray:
        return np.ones_like(self.posterior, dtype=np.int64)

    # -- checkpointing ----------------------------------------------------
    # The stored (theta, modes, S, weights) ARE the resumable state
    # (SURVEY.md §5.4); `run_mcmc(theta_init=out.last_theta(model), S=out.S,
    # burnin=0)` continues the run.
    def save(self, path: str) -> None:
        arrays = {k: v for k, v in dataclasses.asdict(self).items()
                  if isinstance(v, np.ndarray)}
        meta = {k: v for k, v in dataclasses.asdict(self).items()
                if not isinstance(v, np.ndarray) and v is not None}
        np.savez_compressed(path, __meta__=np.asarray([repr(meta)]),
                            **arrays)

    @staticmethod
    def load(path: str) -> "McmcOutput":
        import ast
        z = np.load(path, allow_pickle=False)
        meta = ast.literal_eval(str(z["__meta__"][0]))
        fields = {f.name for f in dataclasses.fields(McmcOutput)}
        kw = {k: z[k] for k in z.files if k in fields}
        kw.update({k: v for k, v in meta.items() if k in fields})
        kw["theta_names"] = tuple(kw.get("theta_names", ()))
        return McmcOutput(**kw)

    def last_theta(self, model) -> np.ndarray:
        """Per-chain final draws mapped back to the sampled space, for
        warm-starting a continuation run."""
        from ..core.priors import LOG
        th = self.theta[:, -1, :]
        tr = np.asarray(model.transforms)
        return np.where(tr == LOG, np.log(np.maximum(th, 1e-300)), th)

    def flat_theta(self) -> np.ndarray:
        return self.theta.reshape(-1, self.theta.shape[-1])

    def flat_weights(self) -> np.ndarray:
        if self.weights is None:
            return np.ones(self.posterior.size)
        return self.weights.reshape(-1)

    # -- exports ----------------------------------------------------------
    def to_dataframe(self, variable: str = "theta"):
        """Long-format draws, mirroring `as.data.frame.mcmc_output`
        (`/root/reference/R/as.data.frame.mcmc_output.R:45`)."""
        import pandas as pd
        C, S = self.posterior.shape
        w = self.weights if self.weights is not None else np.ones((C, S))
        if variable == "theta":
            frames = []
            for j, name in enumerate(self.theta_names):
                frames.append(pd.DataFrame({
                    "iter": np.tile(np.arange(S), C),
                    "chain": np.repeat(np.arange(C), S),
                    "variable": name,
                    "value": self.theta[..., j].reshape(-1),
                    "weight": w.reshape(-1)}))
            return pd.concat(frames, ignore_index=True)
        if variable == "states":
            if self.alpha is None:
                raise ValueError("state draws need output_type='full'")
            C, S, n1, m = self.alpha.shape
            recs = []
            for j in range(m):
                df = pd.DataFrame(
                    self.alpha[..., j].reshape(C * S, n1))
                df.insert(0, "chain", np.repeat(np.arange(C), S))
                df.insert(1, "iter", np.tile(np.arange(S), C))
                df.insert(2, "variable", f"state_{j + 1}")
                df.insert(3, "weight", w.reshape(-1))
                recs.append(df)
            return pd.concat(recs, ignore_index=True)
        raise ValueError(variable)

    def __repr__(self) -> str:
        """Cheap shape/dtype report: the dataclass-generated __repr__ would
        materialize every lazy device field (a full host transfer of the
        (chains, S, n) modes stack) just to print."""
        parts = []
        for f in dataclasses.fields(self):
            v = object.__getattribute__(self, f.name)
            if v is None:
                continue
            if hasattr(v, "shape") and hasattr(v, "dtype"):
                parts.append(f"{f.name}=<{'x'.join(map(str, v.shape))} "
                             f"{v.dtype}>")
            elif f.name in ("mcmc_type", "output_type", "acceptance_rate",
                            "iter"):
                parts.append(f"{f.name}={v!r}")
        return f"McmcOutput({', '.join(parts)})"

    def __str__(self) -> str:
        """Basic run summary, mirroring `print.mcmc_output`
        (`/root/reference/R/print_mcmc.R:15-49`)."""
        from ..diagnostics.summary import summary as _summary
        lines = [f"Iterations = {self.burnin + 1}:{self.iter}",
                 f"Thinning interval = {self.thin}",
                 f"MCMC type = {self.mcmc_type} "
                 f"({self.posterior.shape[0]} chains x "
                 f"{self.posterior.shape[1]} stored draws)",
                 "",
                 "Acceptance rate after the burn-in period: "
                 f"{self.acceptance_rate:.3f}", "", "Summary for theta:"]
        for row in _summary(self, variable="theta", return_se=True):
            lines.append(
                "  {variable}: mean {Mean:.4g} sd {SD:.4g} se {SE:.3g} "
                "ess {ESS:.0f}".format(**row))
        if self.alphahat is not None:
            n = self.alphahat.shape[0] - 1
            mean = np.atleast_1d(self.alphahat[n])
            sd = np.sqrt(np.atleast_1d(np.diag(np.atleast_2d(self.Vt[n]))))
            lines.append(f"\nSummary for alpha_{n + 1}:")
            for j, (mu, s) in enumerate(zip(mean, sd)):
                lines.append(f"  state_{j + 1}: mean {mu:.4g} sd {s:.4g}")
        elif self.alpha is not None:
            n = self.alpha.shape[2] - 1
            w = self.flat_weights()
            a = self.alpha.reshape((-1,) + self.alpha.shape[2:])[:, n, :]
            sw = w.sum()
            mean = (w[:, None] * a).sum(0) / sw
            sd = np.sqrt((w[:, None] * (a - mean) ** 2).sum(0) / sw)
            lines.append(f"\nSummary for alpha_{n + 1}:")
            for j in range(a.shape[1]):
                lines.append(
                    f"  state_{j + 1}: mean {mean[j]:.4g} sd {sd[j]:.4g}")
        else:
            lines.append("\nNo posterior samples for states available.")
        if self.time:
            lines.append("\nRun time (s): " + ", ".join(
                f"{k} {v:.2f}" for k, v in self.time.items()))
        return "\n".join(lines)

    def plot(self, variables=None, bins: int = 40):
        """Trace + density plots of theta, mirroring `plot.mcmc_output`
        (`/root/reference/R/plot_mcmc.R:26-41`; bayesplot::mcmc_combo).
        For IS runs the plots show the approximate (non-weighted) chains,
        as in the reference.  Returns the matplotlib Figure."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        if self.mcmc_type in ("is1", "is2", "is3"):
            import warnings
            warnings.warn("Input is based on a IS-weighted MCMC, the plots "
                          "correspond to the approximate MCMC.")
        names = list(variables or self.theta_names)
        fig, axes = plt.subplots(len(names), 2,
                                 figsize=(9, 2.2 * len(names)),
                                 squeeze=False)
        for r, name in enumerate(names):
            j = self.theta_names.index(name)
            for c in range(self.theta.shape[0]):
                axes[r][0].plot(self.theta[c, :, j], lw=0.5)
                axes[r][1].hist(self.theta[c, :, j], bins=bins,
                                histtype="step", density=True)
            axes[r][0].set_ylabel(name)
        axes[-1][0].set_xlabel("iteration")
        fig.tight_layout()
        return fig

    def as_draws(self) -> dict:
        """ArviZ/posterior-style dict: {name: (chains, draws) array},
        mirroring `as_draws_df` (`/root/reference/R/as_draws.R:54`).
        IS weights are exposed as the reserved column ``.weight``."""
        out = {name: self.theta[..., j]
               for j, name in enumerate(self.theta_names)}
        out[".log_posterior"] = self.posterior
        if self.weights is not None:
            out[".weight"] = self.weights
        return out


def _slots(n_iter: int, burnin: int, thin: int) -> np.ndarray:
    idx = np.arange(burnin, n_iter, thin)
    return idx


def _forward_fill_heads(x, accepted):
    """Replace each slot's value with the most recent head slot's value.
    x: (S, ...); accepted: (S,) bool (slot 0 treated as head)."""
    S = accepted.shape[0]
    ar = jnp.arange(S)
    heads = jnp.where(accepted | (ar == 0), ar, -1)
    src = jax.lax.associative_scan(jnp.maximum, heads)
    return jax.tree_util.tree_map(lambda a: a[src], x)


# --------------------------------------------------------------------------
# linear-Gaussian marginal MCMC
# --------------------------------------------------------------------------

def _gaussian_chain(model: Model, n_iter, burnin, thin, target, gamma,
                    end_ram, output_type):
    from ..ops import kalman, kalman_mv

    mv = model.kind == "mlg"
    _loglik = kalman_mv.log_likelihood_mv if mv else kalman.log_likelihood
    _smoother = kalman_mv.smoother_mv if mv else kalman.smoother

    def _draw_states(spec, k):
        if mv:
            return kalman_mv.simulate_states_mv(spec, 1, k,
                                                use_antithetic=False)[0]
        return simulate_states_single(spec, k)

    def logdens(theta, key, aux):
        spec = model.build(theta)
        ll = _loglik(spec)
        return ll, ll, aux

    def chain(key, theta0, S0):
        final, thetas, lps, lls, accepted, _ = _ram_scan(
            logdens, model.log_prior, theta0, S0, key, n_iter, burnin,
            target, gamma, end_ram, aux0=())
        sl = _slots(n_iter, burnin, thin)
        out = dict(theta=thetas[sl], posterior=(lps + lls)[sl],
                   accepted=accepted[sl], S=final.S,
                   acc_rate=jnp.mean(accepted[burnin:].astype(jnp.float32)))
        if output_type == "full":
            keys = jax.random.split(final.key, len(sl))

            def draw(th, k):
                return _draw_states(model.build(th), k).reshape(-1)

            out["alpha"] = jax.vmap(draw)(out["theta"], keys)
        elif output_type == "summary":
            def smooth(th):
                sm = _smoother(model.build(th))
                return sm.alphahat, sm.Vt

            ahat, vts = jax.lax.map(smooth, out["theta"], batch_size=64)
            mean = jnp.mean(ahat, axis=0)
            dev = ahat - mean
            vt = (jnp.mean(vts, axis=0)
                  + jnp.einsum('sti,stj->tij', dev, dev) / ahat.shape[0])
            out["alphahat"], out["Vt"] = mean, vt
        return out

    return chain


# --------------------------------------------------------------------------
# family ops: uniform interface over ng / nlg model kinds
# --------------------------------------------------------------------------

class _FamilyOps(NamedTuple):
    """approx_eval(spec, key, mode_prev=None)->(loglik, mode);
    psi(spec, mode, nsim, key)-> (log_corr, traced, final_w);
    bsf(spec, nsim, key)->(ll, traced, final_w);
    spdk or None; mode0(spec)->initial mode array."""
    approx_eval: Any
    psi: Any
    bsf: Any
    spdk: Any
    mode0: Any


def _family_ops(model: Model, conv_tol, max_iter,
                local_approx: bool = True,
                coarse_nsim: int = 32) -> _FamilyOps:
    if model.kind == "ng":
        if local_approx:
            def approx_eval(spec, key, mode_prev=None):
                # ALWAYS cold-start the Laplace iteration from the
                # data-derived mode (reference `model_ssm_ung.cpp:217`):
                # warm-starting from the carried mode makes the approximate
                # posterior history-dependent and measurably breaks negbin
                # parity (phi 3.0 vs published 5.39)
                al = approx_mod.approx_loglik(spec, conv_tol=conv_tol,
                                              max_iter=max_iter)
                return al.loglik, al.approx.mode
        else:
            # global approximation: (ytilde, Htilde) fixed at the initial
            # theta; per proposal only one fast-smoother pass recomputes the
            # mode (`/root/reference/src/model_ssm_ung.cpp:104-113`)
            ap0 = approx_mod.approximate(model.build(model.theta_init),
                                         conv_tol, max_iter)
            yt0 = jax.lax.stop_gradient(ap0.ytilde)
            H0 = jax.lax.stop_gradient(ap0.Htilde)

            def approx_eval(spec, key, mode_prev=None):
                from ..ops import kalman
                g = spec.approx_gaussian(yt0, H0)
                alpha = kalman.fast_smoother(g)
                mode = approx_mod.signal_from_states(spec, alpha[:spec.n])
                sc = jnp.where(spec.obs_mask,
                               approx_mod.fam.scales(
                                   spec.distribution, spec.y, spec.u,
                                   spec.phi, mode, yt0, H0), 0.0)
                ct = approx_mod.fam.const_term(
                    spec.distribution, spec.y, spec.u, spec.phi, yt0, H0)
                ll = kalman.log_likelihood(g) + ct + jnp.sum(sc)
                return ll, mode

        def _al_from_mode(spec, mode):
            if mode.shape[-1] != spec.n:
                # modes were not stored (run_mcmc(store_modes=False), the
                # memory fix for long-series theta runs): recompute the
                # Laplace approximation cold.  Phase 1 also cold-starts
                # every evaluation (see approx_eval above), so the
                # recomputed approximation is IDENTICAL to the stored one
                # — same iteration from the same data-derived start.
                ar = approx_mod.approximate(spec, conv_tol, max_iter)
            else:
                ar = approx_mod.approximate_for_is(spec, mode)
            sc = jnp.where(spec.obs_mask,
                           approx_mod.fam.scales(
                               spec.distribution, spec.y, spec.u, spec.phi,
                               ar.mode, ar.ytilde, ar.Htilde), 0.0)
            zero = jnp.zeros((), spec.y.dtype)
            return approx_mod.ApproxLoglik(ar, sc, zero, zero)

        def psi(spec, mode, nsim, key):
            al = _al_from_mode(spec, mode)
            pf = pf_mod.psi_filter(spec, al, nsim, key)
            traced = ancestor_trace(pf.alpha, pf.indices)
            return pf.loglik, traced, pf.weights[:, -1]

        def bsf(spec, nsim, key):
            pf = pf_mod.bsf_filter(spec, nsim, key)
            traced = ancestor_trace(pf.alpha, pf.indices)
            return pf.loglik, traced, pf.weights[:, -1]

        def spdk(spec, mode, nsim, key):
            al = _al_from_mode(spec, mode)
            r = pf_mod.spdk_sample(spec, al, nsim, key)
            return r.loglik, r.alpha, r.weights

        def mode0(spec):
            return spec.initial_mode.astype(spec.y.dtype)

        return _FamilyOps(approx_eval, psi, bsf, spdk, mode0)

    if model.kind == "nlg":
        from . import nlg as nlg_mod

        def approx_eval(spec, key, mode_prev=None):
            ap = nlg_mod.approximate_nlg(spec)
            return ap.loglik, ap.mode

        def psi(spec, mode, nsim, key):
            ap = nlg_mod.approximate_for_is_nlg(spec, mode)
            pf = nlg_mod.psi_filter_nlg(spec, ap, nsim, key)
            traced = ancestor_trace(pf.alpha, pf.indices)
            return pf.loglik, traced, pf.weights[:, -1]

        def bsf(spec, nsim, key):
            pf = nlg_mod.bsf_filter_nlg(spec, nsim, key)
            traced = ancestor_trace(pf.alpha, pf.indices)
            return pf.loglik, traced, pf.weights[:, -1]

        def mode0(spec):
            return jnp.zeros((spec.n, spec.m), spec.y.dtype)

        return _FamilyOps(approx_eval, psi, bsf, None, mode0)

    if model.kind == "mng":
        from . import approx_mv as mv_mod

        if local_approx:
            def approx_eval(spec, key, mode_prev=None):
                # cold start only — see the ng branch note
                al = mv_mod.approx_loglik_mv(spec, conv_tol=conv_tol,
                                             max_iter=max_iter)
                return al.loglik, al.approx.mode
        else:
            ap0 = mv_mod.approximate_mv(model.build(model.theta_init),
                                        conv_tol, max_iter)
            yt0 = jax.lax.stop_gradient(ap0.ytilde)
            H0 = jax.lax.stop_gradient(ap0.Htilde)

            def approx_eval(spec, key, mode_prev=None):
                from ..ops import kalman_mv
                g = spec.approx_gaussian(yt0, H0)
                alpha = kalman_mv.fast_smoother_mv(g)
                mode = mv_mod.signal_mv(spec, alpha[:spec.n])
                sc = mv_mod._series_scales(spec, mode, yt0, H0)
                ct = jnp.zeros((), spec.y.dtype)
                for j, d in enumerate(spec.distributions):
                    ct = ct + mv_mod.fam.const_term(
                        d, spec.y[:, j], spec.u[:, j], spec.phi[j],
                        yt0[:, j], H0[:, j])
                ll = kalman_mv.log_likelihood_mv(g) + ct + jnp.sum(sc)
                return ll, mode

        def psi(spec, mode, nsim, key):
            al = mv_mod.approximate_for_is_mv(spec, mode)
            pf = mv_mod.psi_filter_mv(spec, al, nsim, key)
            traced = ancestor_trace(pf.alpha, pf.indices)
            return pf.loglik, traced, pf.weights[:, -1]

        def bsf(spec, nsim, key):
            pf = mv_mod.bsf_filter_mv(spec, nsim, key)
            traced = ancestor_trace(pf.alpha, pf.indices)
            return pf.loglik, traced, pf.weights[:, -1]

        def spdk(spec, mode, nsim, key):
            al = mv_mod.approximate_for_is_mv(spec, mode)
            return mv_mod.spdk_sample_mv(spec, al, nsim, key)

        def mode0(spec):
            return spec.initial_mode.astype(spec.y.dtype)

        return _FamilyOps(approx_eval, psi, bsf, spdk, mode0)

    if model.kind == "sde":
        from . import sde as sde_mod

        def approx_eval(spec, key, mode_prev=None):
            # phase-1 "approximation" = coarse-level bootstrap filter
            # (`/root/reference/src/approx_mcmc.cpp:230-334`).  The Brownian
            # increments are derived from `key` at the FINE resolution and
            # summed to the coarse grid, so a later fine-level filter with the
            # same key is coupled to this estimate (the reference's shared
            # `coarse_engine`, `/root/reference/src/model_ssm_sde.h:45-48`).
            pf = sde_mod.bsf_filter_sde(spec, coarse_nsim, spec.L_c, key,
                                        couple=True)
            return pf.loglik, jnp.zeros((1,), spec.y.dtype)

        def bsf(spec, nsim, key):
            pf = sde_mod.bsf_filter_sde(spec, nsim, spec.L_f, key,
                                        couple=True)
            traced = ancestor_trace(pf.alpha, pf.indices)
            return pf.loglik, traced, pf.weights[:, -1]

        def mode0(spec):
            return jnp.zeros((1,), spec.y.dtype)

        return _FamilyOps(approx_eval, None, bsf, None, mode0)

    raise ValueError(f"no family ops for model kind {model.kind}")


# --------------------------------------------------------------------------
# non-Gaussian: approximate MCMC (phase 1)
# --------------------------------------------------------------------------

def _approx_chain(model: Model, n_iter, burnin, thin, target, gamma,
                  end_ram, conv_tol, max_iter, local_approx=True,
                  coarse_nsim=32, scan_modes=True):
    ops = _family_ops(model, conv_tol, max_iter, local_approx, coarse_nsim)

    if model.kind == "sde":
        # aux stores the evaluation KEY: the phase-2 fine-level filter reuses
        # it so coarse/fine log-likelihoods share Brownian paths (coupling,
        # `/root/reference/src/approx_mcmc.cpp:537-538`)
        def logdens(theta, key, aux):
            spec = model.build(theta)
            ll, _ = ops.approx_eval(spec, key)
            return ll, ll, key
    elif scan_modes:
        # aux carries the converged Laplace mode of the CURRENT state so it
        # is stored per accepted draw for the IS correction (it is NOT fed
        # back into the next evaluation — cold start, see _family_ops)
        def logdens(theta, key, aux):
            spec = model.build(theta)
            ll, mode = ops.approx_eval(spec, key)
            return ll, ll, mode
    else:
        # store_modes=False: skip the (S, n) per-chain mode stack — at
        # n ~ 1000 x 2048 chains it is the device-memory wall.  The
        # correction recomputes the (identical) cold-started approximation
        # from theta; aux shrinks to one element.
        def logdens(theta, key, aux):
            spec = model.build(theta)
            ll, _ = ops.approx_eval(spec, key)
            return ll, ll, aux

    def chain(key, theta0, S0):
        spec0 = model.build(theta0)
        if model.kind == "sde":
            aux0 = jax.random.PRNGKey(0)
        elif scan_modes:
            aux0 = ops.mode0(spec0)
        else:
            aux0 = jnp.zeros((1,), theta0.dtype)
        final, thetas, lps, lls, accepted, modes = _ram_scan(
            logdens, model.log_prior, theta0, S0, key, n_iter, burnin,
            target, gamma, end_ram, aux0=aux0)
        sl = _slots(n_iter, burnin, thin)
        return dict(theta=thetas[sl], prior=lps[sl], approx_ll=lls[sl],
                    accepted=accepted[sl], modes=modes[sl], S=final.S,
                    key=final.key,
                    acc_rate=jnp.mean(accepted[burnin:].astype(jnp.float32)))

    return chain


def _ekf_chain(model: Model, n_iter, burnin, thin, target, gamma, end_ram,
               output_type):
    """EKF-marginal MCMC for nonlinear models: the (i)EKF log-likelihood
    is the target (`/root/reference/src/approx_mcmc.cpp:1523-1671`)."""
    from . import nlg as nlg_mod

    def logdens(theta, key, aux):
        spec = model.build(theta)
        ll = nlg_mod.ekf_loglik(spec)
        return ll, ll, aux

    def chain(key, theta0, S0):
        final, thetas, lps, lls, accepted, _ = _ram_scan(
            logdens, model.log_prior, theta0, S0, key, n_iter, burnin,
            target, gamma, end_ram, aux0=())
        sl = _slots(n_iter, burnin, thin)
        out = dict(theta=thetas[sl], posterior=(lps + lls)[sl],
                   accepted=accepted[sl], S=final.S,
                   acc_rate=jnp.mean(accepted[burnin:].astype(jnp.float32)))
        if output_type == "full":
            keys = jax.random.split(final.key, len(sl))

            def draw(th, k):
                from ..ops.kalman_mv import simulate_states_mv
                spec = model.build(th)
                r = nlg_mod.ekf(spec)
                g = nlg_mod.build_approx(spec, r.at[:-1], att=r.att)
                return simulate_states_mv(
                    g, 1, k, use_antithetic=False)[0].reshape(-1)

            out["alpha"] = jax.lax.map(
                lambda a: draw(a[0], a[1]), (out["theta"], keys),
                batch_size=64)
        elif output_type == "summary":
            # EKF-smoother mean/variance per stored theta; law of total
            # variance over draws (`/root/reference/src/approx_mcmc.cpp:
            # 1633-1671` ekf_state_summary)
            def smooth(th):
                sm = nlg_mod.ekf_smoother(model.build(th))
                return sm.alphahat, sm.Vt

            ahat, vts = jax.lax.map(smooth, out["theta"], batch_size=64)
            mean = jnp.mean(ahat, axis=0)
            dev = ahat - mean
            out["alphahat"] = mean
            out["Vt"] = (jnp.mean(vts, axis=0)
                         + jnp.einsum('sti,stj->tij', dev, dev)
                         / ahat.shape[0])
        return out

    return chain


# --------------------------------------------------------------------------
# non-Gaussian: IS post-correction (phase 2)
# --------------------------------------------------------------------------

def _make_correct_one(model: Model, nsim, sampling_method,
                      conv_tol=1e-8, max_iter=100,
                      want_states=True, want_moments=True,
                      psi_resample_every=1):
    """One psi/bsf/spdk correction for a single stored draw
    (`/root/reference/src/approx_mcmc.cpp:353-427,447-518,606-678`).

    Per-slot state and moment outputs are flattened to 1-D; the caller
    reshapes them to (n+1, m) / (n+1, m, m)."""
    ops = _family_ops(model, conv_tol, max_iter)

    logw_only = not want_states and not want_moments

    def correct_one(args):
        theta_i, mode_i, key_i = args
        spec = model.build(theta_i)
        k_pf, k_draw = jax.random.split(key_i)
        if model.kind == "sde":
            # mode_i IS the stored phase-1 evaluation key: reusing it couples
            # the fine-level filter to the stored coarse estimate
            # (`/root/reference/src/approx_mcmc.cpp:537-538`)
            k_pf = mode_i
        if sampling_method == "psi" and logw_only and model.kind == "ng":
            # log-weight-only corrections skip trajectory storage
            from .approx import ApproxLoglik, approximate_for_is
            from . import approx as _amod
            if mode_i.shape[-1] != spec.n:
                # store_modes=False: recompute cold (identical result —
                # phase 1 cold-starts too; see _family_ops._al_from_mode)
                ar = _amod.approximate(spec, conv_tol, max_iter)
            else:
                ar = approximate_for_is(spec, mode_i)
            sc = jnp.where(spec.obs_mask,
                           _amod.fam.scales(spec.distribution, spec.y,
                                            spec.u, spec.phi, ar.mode,
                                            ar.ytilde, ar.Htilde), 0.0)
            zero = jnp.zeros((), spec.y.dtype)
            al = ApproxLoglik(ar, sc, zero, zero)
            return {"log_w": pf_mod.psi_logw(
                spec, al, nsim, k_pf,
                resample_every=psi_resample_every)}
        if sampling_method == "bsf" and logw_only and model.kind == "ng":
            # _is_finish subtracts the stored approx_ll from this
            return {"log_w": pf_mod.bsf_logw(
                spec, nsim, k_pf, resample_every=psi_resample_every)}
        if sampling_method == "psi":
            log_w, traced, final_w = ops.psi(spec, mode_i, nsim, k_pf)
        elif sampling_method == "bsf":
            # minus approx_ll applied by caller
            log_w, traced, final_w = ops.bsf(spec, nsim, k_pf)
        elif sampling_method == "spdk":
            if ops.spdk is None:
                raise ValueError("spdk not available for this model family")
            log_w, traced, final_w = ops.spdk(spec, mode_i, nsim, k_pf)
        else:
            raise ValueError(sampling_method)
        out = {"log_w": log_w}
        if want_states:
            idx = jax.random.categorical(k_draw, jnp.log(final_w + 1e-300))
            out["alpha"] = traced[idx].reshape(-1)       # (n+1)*m flat
        if want_moments:
            sw = jnp.sum(final_w)
            mean_i = jnp.einsum('i,itm->tm', final_w, traced) / sw
            dev = traced - mean_i
            Vt_i = jnp.einsum('i,itm,itk->tmk', final_w, dev, dev) / sw
            out["mean"] = mean_i.reshape(-1)
            out["Vt"] = Vt_i.reshape(-1)
        return out

    return correct_one


def _is_correction_flat(model: Model, thetas, modes, keys, nsim,
                        sampling_method, batch_size, mesh=None,
                        want_states=True, want_moments=True,
                        jit_cache=None, psi_resample_every=1):
    """IS correction over a flat axis of stored draws — the reference's
    OpenMP loop (`approx_mcmc.cpp:364-368`) as HOST-chunked, mesh-sharded
    vmaps.

    thetas: (S, d); modes: (S, n); keys: (S, 2).  Returns a dict of arrays
    with leading axis S.  Each chunk of ``batch_size`` rows is a separate
    jit execution (compiled once, cached), which bounds the device memory
    of one execution.  With a mesh, each chunk's batch axis is sharded over
    the full device mesh (chains x draws)."""
    correct_one = _make_correct_one(model, nsim, sampling_method,
                                    want_states=want_states,
                                    want_moments=want_moments,
                                    psi_resample_every=psi_resample_every)
    Ns = thetas.shape[0]
    jit_cache = {} if jit_cache is None else jit_cache

    if mesh is None:
        B = min(Ns, batch_size)
        ckey = ("corr-chunk", nsim, sampling_method, want_states,
                want_moments, B, psi_resample_every)
        chunk_fn = jit_cache.get(ckey)
        if chunk_fn is None:
            chunk_fn = jax.jit(jax.vmap(lambda t, m, k: correct_one(
                (t, m, k))))
            jit_cache[ckey] = chunk_fn
    else:
        from jax.sharding import PartitionSpec as _P
        n_dev = mesh.devices.size
        B = max(min(Ns, batch_size) // n_dev, 1) * n_dev
        flat_axes = _P(mesh.axis_names)
        ckey = ("corr-chunk-mesh", nsim, sampling_method, want_states,
                want_moments, B, id(mesh), psi_resample_every)
        chunk_fn = jit_cache.get(ckey)
        if chunk_fn is None:
            # shard_map (not sharding constraints): each device runs the
            # vmapped correction on its local B/n_dev rows; draws are
            # independent, so no cross-device communication is needed.
            chunk_fn = jax.jit(jax.shard_map(
                jax.vmap(lambda t, m, k: correct_one((t, m, k))),
                mesh=mesh, in_specs=(flat_axes, flat_axes, flat_axes),
                out_specs=flat_axes, check_vma=False))
            jit_cache[ckey] = chunk_fn

    pad = (-Ns) % B
    if pad:
        thetas = jnp.concatenate([thetas, thetas[:pad]])
        modes = jnp.concatenate([modes, modes[:pad]])
        keys = jnp.concatenate([keys, keys[:pad]])
    parts = []
    for lo in range(0, thetas.shape[0], B):
        parts.append(chunk_fn(thetas[lo:lo + B], modes[lo:lo + B],
                              keys[lo:lo + B]))
    out = jax.tree_util.tree_map(
        lambda *xs: jnp.concatenate(xs)[:Ns], *parts)
    return out


def _is_postprocess(model: Model, thetas, modes, accepted, approx_ll, key, *,
                    is_type, nsim, sampling_method, batch_size, bucket,
                    mesh, want_states, want_moments, n1m, jit_cache=None,
                    psi_resample_every=1):
    """Host-orchestrated IS post-correction: jitted head selection,
    host-chunked corrections (`_is_correction_flat`), and a jitted assembly
    pass.  All data stays on device between pieces.

    is2: correct each jump-chain head once with ``nsim`` particles;
         duplicate slots share the head's result
         (`/root/reference/src/approx_mcmc.cpp:364-427`).
    is1: correct EVERY stored slot with ``nsim`` particles and average each
         jump-chain segment's ``count`` independent estimates in probability
         space: an unbiased correction whose per-head particle budget is
         nsim x count — the reference's count-scaled is1
         (`/root/reference/src/approx_mcmc.cpp:375-377`) runs one PF with
         nsim*count particles, which has the same total cost and the same
         1/(nsim*count) variance scaling but is not shape-static.  The
         sampled state trajectory / moments are the segment mixture.
    is3: correct every stored slot independently.

    Returns {"log_w": (C, S)} plus "alpha" (C, S, n+1, m) for full output
    or "alphahat"/"Vt" global weighted moments for summary output.
    """
    C, Sn = thetas.shape[:2]
    CS = C * Sn
    jit_cache = {} if jit_cache is None else jit_cache

    if is_type == 2:
        pkey = ("corr-prep", bucket, CS)
        prep = jit_cache.get(pkey)
        if prep is None:
            def _prep(th, mo, acc):
                fl = lambda a: a.reshape((CS,) + a.shape[2:])  # noqa: E731
                hm = acc.astype(bool).at[:, 0].set(True).reshape(-1)
                hidx = jnp.nonzero(hm, size=bucket, fill_value=0)[0]
                return (jnp.take(fl(th), hidx, axis=0),
                        jnp.take(fl(mo), hidx, axis=0), hm)
            prep = jax.jit(_prep)
            jit_cache[pkey] = prep
        th_rows, mo_rows, hmask = prep(thetas, modes, accepted)
        Ns = bucket
    else:
        fl = lambda a: a.reshape((CS,) + a.shape[2:])          # noqa: E731
        th_rows, mo_rows = fl(thetas), fl(modes)
        hmask = accepted.astype(bool).at[:, 0].set(True).reshape(-1)
        Ns = CS

    keys = jax.random.split(key, Ns)
    corr = _is_correction_flat(model, th_rows, mo_rows, keys, nsim,
                               sampling_method, batch_size, mesh=mesh,
                               want_states=want_states,
                               want_moments=want_moments,
                               psi_resample_every=psi_resample_every,
                               jit_cache=jit_cache)

    fkey = ("corr-finish", is_type, sampling_method, want_states,
            want_moments, bucket, n1m, CS)
    finish = jit_cache.get(fkey)
    if finish is None:
        finish = jax.jit(lambda co, hm, al, k: _is_finish(
            co, hm, al, k, is_type=is_type,
            sampling_method=sampling_method, want_states=want_states,
            want_moments=want_moments, n1m=n1m))
        jit_cache[fkey] = finish
    return finish(corr, hmask, approx_ll, key)


def _is_finish(corr, hmask, approx_ll, key, *, is_type, sampling_method,
               want_states, want_moments, n1m):
    """Assembly pass: jump-chain fill, weight/moment reduction."""
    C, Sn = approx_ll.shape
    CS = C * Sn
    flat = lambda a: a.reshape((CS,) + a.shape[2:])            # noqa: E731

    if is_type == 2:
        src = jnp.cumsum(hmask) - 1                 # head ordinal per slot
        corr = jax.tree_util.tree_map(
            lambda a: jnp.take(a, src, axis=0), corr)

    log_w = corr["log_w"]
    if sampling_method == "bsf":
        # BSF estimates the full likelihood; the IS weight is the ratio to
        # the stored approximate likelihood (`approx_mcmc.cpp:479`)
        log_w = log_w - flat(approx_ll)
    log_w = jnp.where(jnp.isfinite(log_w), log_w, -jnp.inf)
    alpha = corr.get("alpha")
    mean_s, vt_s = corr.get("mean"), corr.get("Vt")

    if is_type == 1:
        seg = jnp.cumsum(hmask) - 1                 # global segment ids
        M = jax.ops.segment_max(log_w, seg, num_segments=CS)
        Ms = jnp.where(jnp.isfinite(M), M, 0.0)[seg]
        p = jnp.where(jnp.isfinite(log_w), jnp.exp(log_w - Ms), 0.0)
        psum = jax.ops.segment_sum(p, seg, num_segments=CS)
        cnt = jax.ops.segment_sum(jnp.ones_like(p), seg, num_segments=CS)
        cnt = jnp.maximum(cnt, 1.0)
        log_w = (M + jnp.log(psum) - jnp.log(cnt))[seg]
        pn = p / jnp.where(psum[seg] > 0, psum[seg], 1.0)
        if alpha is not None:
            # mixture draw: pick one slot per segment with prob w_j / sum w
            g = jax.random.gumbel(jax.random.fold_in(key, 17), (CS,),
                                  p.dtype)
            val = jnp.where(p > 0, jnp.log(p) + g, -jnp.inf)
            vmax = jax.ops.segment_max(val, seg, num_segments=CS)[seg]
            cand = jnp.where(val >= vmax, jnp.arange(CS), -1)
            sel = jax.ops.segment_max(cand, seg, num_segments=CS)
            alpha = jnp.take(alpha, jnp.maximum(sel, 0)[seg], axis=0)
        if mean_s is not None:
            # mixture moments: E = sum_j pn_j E_j; V via second moments
            means = mean_s.reshape((CS,) + n1m)
            vts = vt_s.reshape((CS,) + n1m + (n1m[-1],))
            mbar = jax.ops.segment_sum(pn[:, None, None] * means, seg,
                                       num_segments=CS)
            e2 = vts + jnp.einsum('stm,stk->stmk', means, means)
            e2bar = jax.ops.segment_sum(pn[:, None, None, None] * e2, seg,
                                        num_segments=CS)
            vbar = e2bar - jnp.einsum('stm,stk->stmk', mbar, mbar)
            mean_s = jnp.take(mbar, seg, axis=0).reshape(CS, -1)
            vt_s = jnp.take(vbar, seg, axis=0).reshape(CS, -1)

    out = {"log_w": log_w.reshape(C, Sn)}
    if want_states and alpha is not None:
        out["alpha"] = alpha.reshape((C, Sn) + n1m)
    if want_moments and mean_s is not None:
        # global weighted moments over all slots (law of total variance;
        # the between-draw deviation term included, `summary.cpp` semantics)
        mx = jnp.max(log_w)
        w = jnp.exp(log_w - jnp.where(jnp.isfinite(mx), mx, 0.0))
        sw = jnp.maximum(jnp.sum(w), jnp.finfo(w.dtype).tiny)
        means = mean_s.reshape((CS,) + n1m)
        vts = vt_s.reshape((CS,) + n1m + (n1m[-1],))
        mean = jnp.einsum('s,stm->tm', w, means) / sw
        dev = means - mean
        out["alphahat"] = mean
        out["Vt"] = (jnp.einsum('s,stmk->tmk', w, vts)
                     + jnp.einsum('s,stm,stk->tmk', w, dev, dev)) / sw
    return out


# --------------------------------------------------------------------------
# non-Gaussian: pseudo-marginal and delayed-acceptance MCMC
# --------------------------------------------------------------------------

def _pf_loglik(model: Model, theta, key, nsim, sampling_method, conv_tol,
               max_iter, local_approx=True, need_states=True,
               coarse_nsim=32):
    """(exact_ll, approx_ll, sampled trajectory) for one theta
    (`/root/reference/src/model_ssm_ung.cpp:164-236`).  With
    ``need_states=False`` the trajectory is a placeholder and the psi and
    bsf paths run their log-weight-only filters."""
    ops = _family_ops(model, conv_tol, max_iter, local_approx, coarse_nsim)
    spec = model.build(theta)
    k_pf, k_draw = jax.random.split(key)
    if sampling_method == "bsf":
        if not need_states and model.kind == "ng":
            ll = pf_mod.bsf_logw(spec, nsim, k_pf)
            dummy = jnp.zeros((spec.n + 1, spec.m), spec.y.dtype)
            return ll, ll, dummy
        ll, traced, final_w = ops.bsf(spec, nsim, k_pf)
        idx = jax.random.categorical(k_draw, jnp.log(final_w + 1e-300))
        return ll, ll, traced[idx]
    k_ap, k_pf = jax.random.split(k_pf)
    approx_ll, mode = ops.approx_eval(spec, k_ap)
    if sampling_method == "psi":
        if not need_states and model.kind == "ng":
            from . import approx as _amod
            ar = _amod.approximate_for_is(spec, mode)
            sc = jnp.where(spec.obs_mask,
                           _amod.fam.scales(spec.distribution, spec.y,
                                            spec.u, spec.phi, ar.mode,
                                            ar.ytilde, ar.Htilde), 0.0)
            zero = jnp.zeros((), spec.y.dtype)
            al = _amod.ApproxLoglik(ar, sc, zero, zero)
            log_corr = pf_mod.psi_logw(spec, al, nsim, k_pf)
            dummy = jnp.zeros((spec.n + 1, spec.m), spec.y.dtype)
            return approx_ll + log_corr, approx_ll, dummy
        log_corr, traced, final_w = ops.psi(spec, mode, nsim, k_pf)
        idx = jax.random.categorical(k_draw, jnp.log(final_w + 1e-300))
        return approx_ll + log_corr, approx_ll, traced[idx]
    if ops.spdk is None:
        raise ValueError("spdk not available for this model family")
    log_corr, traced, final_w = ops.spdk(spec, mode, nsim, k_pf)
    idx = jax.random.categorical(k_draw, jnp.log(final_w + 1e-300))
    return approx_ll + log_corr, approx_ll, traced[idx]


def _pm_chain(model: Model, n_iter, burnin, thin, target, gamma, end_ram,
              nsim, sampling_method, conv_tol, max_iter, output_type,
              local_approx=True, coarse_nsim=32):
    spec0 = model.build(model.theta_init)
    m = spec0.m
    n = spec0.n
    store_alpha = output_type == "full"

    def logdens(theta, key, aux):
        ll, all_, alpha = _pf_loglik(model, theta, key, nsim,
                                     sampling_method, conv_tol, max_iter,
                                     local_approx, need_states=store_alpha,
                                     coarse_nsim=coarse_nsim)
        aux_new = alpha.reshape(-1) if store_alpha else ()
        return ll, all_, aux_new

    def chain(key, theta0, S0):
        aux0 = jnp.zeros(((n + 1) * m,), spec0.y.dtype) if store_alpha \
            else ()
        final, thetas, lps, lls, accepted, auxs = _ram_scan(
            logdens, model.log_prior, theta0, S0, key, n_iter, burnin,
            target, gamma, end_ram, aux0=aux0)
        sl = _slots(n_iter, burnin, thin)
        out = dict(theta=thetas[sl], posterior=(lps + lls)[sl],
                   accepted=accepted[sl], S=final.S,
                   acc_rate=jnp.mean(accepted[burnin:].astype(jnp.float32)))
        if store_alpha:
            out["alpha"] = auxs[sl]
        return out

    return chain


def _da_chain(model: Model, n_iter, burnin, thin, target, gamma, end_ram,
              nsim, sampling_method, conv_tol, max_iter, output_type,
              local_approx=True, coarse_nsim=32):
    """Delayed acceptance: stage 1 on the approximate posterior, stage 2
    corrects with the PF estimate (`/root/reference/src/mcmc.cpp:530-685`).
    For SDE models stage 1 (coarse BSF) and stage 2 (fine BSF) derive their
    Brownian increments from the SAME key, so the second-stage ratio
    exp(ll_f - ll_c) is the coupled multilevel estimator
    (`/root/reference/src/mcmc.cpp:840-992`)."""
    spec0 = model.build(model.theta_init)
    m, n = spec0.m, spec0.n
    dt = spec0.y.dtype
    store_alpha = output_type == "full"
    d = model.theta_init.shape[0]
    ops = _family_ops(model, conv_tol, max_iter, local_approx, coarse_nsim)
    sde = model.kind == "sde"

    def full_eval(theta, key):
        return _pf_loglik(model, theta, key, nsim, sampling_method,
                          conv_tol, max_iter, local_approx,
                          need_states=store_alpha, coarse_nsim=coarse_nsim)

    def chain(key, theta0, S0):
        key, k0 = jax.random.split(key)
        ll0, all0, alpha0 = full_eval(theta0, k0)
        if sde:
            # coarse-level stage-1 loglik from the same PF key the fine
            # filter consumed (k_pf = split(k0)[0] inside _pf_loglik)
            all0 = ops.approx_eval(model.build(theta0),
                                   jax.random.split(k0)[0])[0]
        ll0, all0 = jnp.asarray(ll0, dt), jnp.asarray(all0, dt)
        alpha0 = alpha0.reshape(-1)
        lp0 = model.log_prior(theta0)

        def body(carry, i):
            theta, lp, ll, ll_approx, alpha_cur, S, key = carry
            key, k_u, k_a1, k_a2, k_den = jax.random.split(key, 5)
            u = jax.random.normal(k_u, (d,), dt)
            prop = theta + S @ u
            lp_prop = model.log_prior(prop)
            ok = lp_prop > _NEG_INF

            def stage1(k):
                spec = model.build(prop)
                ll_a, _ = ops.approx_eval(spec, k)
                return jnp.asarray(ll_a, dt)

            if sde:
                # same Brownian key as the stage-2 fine filter (coupling)
                k_s1 = jax.random.split(k_den)[0]
            else:
                key, k_s1 = jax.random.split(key)
            ll_approx_prop = jax.lax.cond(
                ok, stage1, lambda _: jnp.asarray(_NEG_INF, dt), k_s1)
            acc_prob = jnp.where(
                ok, jnp.minimum(1.0, jnp.exp(
                    ll_approx_prop - ll_approx + lp_prop - lp)), 0.0)
            pass1 = jax.random.uniform(k_a1, (), dt) < acc_prob

            def stage2(_):
                ll_prop, _, alpha_prop = full_eval(prop, k_den)
                ll_prop = jnp.asarray(ll_prop, dt)
                log_alpha = ll_prop + ll_approx - ll - ll_approx_prop
                acc2 = jnp.log(jax.random.uniform(k_a2, (), dt)) < log_alpha
                return acc2, ll_prop, alpha_prop.reshape(-1)

            def no2(_):
                return jnp.asarray(False), jnp.asarray(_NEG_INF, dt), \
                    alpha_cur

            accept, ll_prop, alpha_prop = jax.lax.cond(pass1, stage2, no2,
                                                       None)
            theta = jnp.where(accept, prop, theta)
            lp = jnp.where(accept, lp_prop, lp)
            ll = jnp.where(accept, ll_prop, ll)
            ll_approx = jnp.where(accept, ll_approx_prop, ll_approx)
            alpha_cur = jnp.where(accept, alpha_prop, alpha_cur)
            S = adapt_S(S, u, acc_prob, target, i, gamma) \
                if not end_ram else jnp.where(i <= burnin,
                                              adapt_S(S, u, acc_prob,
                                                      target, i, gamma), S)
            ys = (theta, lp, ll, accept, alpha_cur if store_alpha else ())
            return (theta, lp, ll, ll_approx, alpha_cur, S, key), ys

        init = (theta0, lp0, ll0, all0, alpha0, S0, key)
        final, ys = jax.lax.scan(body, init, jnp.arange(1, n_iter + 1))
        thetas, lps, lls, accepted, alphas = ys
        sl = _slots(n_iter, burnin, thin)
        out = dict(theta=thetas[sl], posterior=(lps + lls)[sl],
                   accepted=accepted[sl], S=final[5],
                   acc_rate=jnp.mean(accepted[burnin:].astype(jnp.float32)))
        if store_alpha:
            out["alpha"] = alphas[sl]
        return out

    return chain


# --------------------------------------------------------------------------
# public driver
# --------------------------------------------------------------------------

def is_correction_key(seed: int, n_chains: int):
    """The phase-2 IS-correction key `run_mcmc` derives from ``seed`` —
    pass to ``post_correct(key=...)`` to replay a stored run's correction
    bit-exactly."""
    return jax.random.split(jax.random.PRNGKey(seed), n_chains + 1)[0]


def run_mcmc(model: Model, iter: int = 2000, *, burnin: Optional[int] = None,
             thin: int = 1, particles: int = 0, mcmc_type: Optional[str] = None,
             sampling_method: Optional[str] = None,
             target_acceptance: float = 0.234, gamma: float = 2.0 / 3.0,
             S: Optional[jnp.ndarray] = None, end_adaptive_phase: bool = False,
             output_type: str = "full", n_chains: int = 1,
             seed: int = 1, conv_tol: float = 1e-8, max_iter: int = 100,
             theta_init: Optional[jnp.ndarray] = None,
             mesh=None, corr_batch: Optional[int] = None,
             local_approx: bool = True,
             store_modes: bool = True,
             psi_resample_every: int = 1) -> McmcOutput:
    """Bayesian inference via adaptive MCMC (`/root/reference/R/run_mcmc.R`).

    mcmc_type: lg models -> "gaussian"; ng models: "is2" (default), "is1",
    "is3", "approx", "pm", "da".  sampling_method: "psi" (default), "bsf",
    "spdk".  local_approx=False freezes the Gaussian approximation's
    pseudo-observations at the initial theta (one smoother pass per
    proposal instead of the full Laplace iteration,
    `/root/reference/R/run_mcmc.R:75,434-436`).

    psi_resample_every: stratified-resample period of the log-weight-only
    particle filters of the IS correction (theta output): BSF at any
    particle count, psi-APF above `particle.PREDRAW_MAX_N` = 32
    particles.  1 (default) = every step, matching
    the reference exactly; k > 1 skips the selection pass on all but
    every k-th step — a fixed schedule keeps the likelihood-ratio
    estimator unbiased (standard adaptive-SMC) while removing the
    dominant large-N cost.  Check ESS_IS when raising it.
    """
    import time as _time
    t0 = _time.time()

    if burnin is None:
        burnin = iter // 2
    if model.kind in ("lg", "mlg"):
        mcmc_type = mcmc_type or "gaussian"
    else:
        mcmc_type = mcmc_type or "is2"
        # reference defaults: psi for exponential-family, bsf for nonlinear
        sampling_method = sampling_method or (
            "bsf" if model.kind in ("nlg", "sde") else "psi")
        if mcmc_type not in ("approx", "ekf") and particles < 2:
            raise ValueError("particles >= 2 required for non-approx MCMC")
        if model.kind == "sde":
            sampling_method = "bsf"
    # coarse phase-1 sde filter uses the same particle count
    # (`/root/reference/src/approx_mcmc.cpp:230-334`)
    coarse_nsim = max(int(particles), 2) if model.kind == "sde" else 32

    theta0 = model.theta_init if theta_init is None else theta_init
    S0 = model.initial_S() if S is None else jnp.asarray(S)
    S0 = S0.astype(theta0.dtype)
    key = jax.random.PRNGKey(seed)
    chain_keys = jax.random.split(key, n_chains + 1)
    is_key, chain_keys = chain_keys[0], chain_keys[1:]

    # fail fast on non-finite initial prior (reference `mcmc.cpp:201-205`)
    th_check = theta0 if jnp.asarray(theta0).ndim == 1 \
        else jnp.asarray(theta0)[0]
    lp0 = float(model.log_prior(jnp.asarray(th_check)))
    if not np.isfinite(lp0):
        raise ValueError("Initial prior probability is not finite.")

    common = dict(n_iter=iter, burnin=burnin, thin=thin,
                  target=target_acceptance, gamma=gamma,
                  end_ram=end_adaptive_phase)

    if mcmc_type == "gaussian":
        chain = _gaussian_chain(model, output_type=output_type, **common)
    elif mcmc_type in ("approx", "is1", "is2", "is3"):
        # store_modes=False additionally drops the (chains, S, n) scan-time
        # mode stack for ng IS runs (the long-series HBM wall); "approx"
        # keeps it (its state draws replay the stored modes), and so does
        # local_approx=False — the cold recompute would rebuild the LOCAL
        # approximation, mismatching the stored global-approx density
        scan_modes = (store_modes or model.kind != "ng"
                      or mcmc_type == "approx" or not local_approx)
        chain = _approx_chain(model, conv_tol=conv_tol, max_iter=max_iter,
                              local_approx=local_approx,
                              coarse_nsim=coarse_nsim,
                              scan_modes=scan_modes, **common)
    elif mcmc_type == "ekf":
        if model.kind != "nlg":
            raise ValueError("mcmc_type='ekf' requires a nonlinear model")
        chain = _ekf_chain(model, output_type=output_type, **common)
    elif mcmc_type == "pm":
        chain = _pm_chain(model, nsim=particles,
                          sampling_method=sampling_method,
                          conv_tol=conv_tol, max_iter=max_iter,
                          output_type=output_type,
                          local_approx=local_approx,
                          coarse_nsim=coarse_nsim, **common)
    elif mcmc_type == "da":
        chain = _da_chain(model, nsim=particles,
                          sampling_method=sampling_method,
                          conv_tol=conv_tol, max_iter=max_iter,
                          output_type=output_type,
                          local_approx=local_approx,
                          coarse_nsim=coarse_nsim, **common)
    else:
        raise ValueError(f"unknown mcmc_type {mcmc_type}")

    theta0 = jnp.asarray(theta0)
    # cache the jitted chain program on the model: repeated run_mcmc calls
    # (warm-up + measured runs, post_correct re-runs, scaling sweeps) would
    # otherwise rebuild a fresh jit wrapper each time and re-trace the whole
    # program even though XLA's compile cache hits
    jit_cache = model.extra.setdefault("_jit_cache", {})
    ckey = ("chain", mcmc_type, iter, burnin, thin, particles,
            sampling_method, output_type, target_acceptance, gamma,
            end_adaptive_phase, conv_tol, max_iter, local_approx,
            store_modes, theta0.ndim, None if mesh is None else id(mesh))
    run = jit_cache.get(ckey)
    if theta0.ndim == 2:       # per-chain restart states (checkpoint resume)
        S0b = S0 if S0.ndim == 3 else jnp.broadcast_to(
            S0, (n_chains,) + S0.shape)
        if run is None:
            run = jax.jit(jax.vmap(chain))
            jit_cache[ckey] = run
        run_args = (chain_keys, theta0, S0b)
    else:
        if run is None:
            run = jax.jit(jax.vmap(chain, in_axes=(0, None, None)))
            jit_cache[ckey] = run
        run_args = (chain_keys, theta0, S0)
    if mesh is not None:
        from ..parallel.mesh import chains_sharding
        run_args = (jax.device_put(run_args[0], chains_sharding(mesh)),
                    ) + run_args[1:]
    res = run(*run_args)
    res = jax.tree_util.tree_map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready")
        else a, res)
    t_mcmc = _time.time() - t0

    # all result arrays stay on device (lazy McmcOutput fields); only the
    # scalar acceptance rate syncs here
    posterior0 = (res["posterior"] if "posterior" in res
                  else jnp.zeros(res["theta"].shape[:2]))
    out = McmcOutput(
        theta=model.to_natural(res["theta"]),
        posterior=posterior0,
        accepted=res["accepted"],
        acceptance_rate=float(np.mean(np.asarray(res["acc_rate"]))),
        S=res["S"],
        theta_names=model.theta_names, mcmc_type=mcmc_type,
        output_type=output_type, iter=iter, burnin=burnin, thin=thin)

    spec00 = model.build(theta0 if jnp.asarray(theta0).ndim == 1
                         else jnp.asarray(theta0)[0])
    n1m_shape = (spec00.n + 1, spec00.m)
    if mcmc_type in ("gaussian", "ekf"):
        if output_type == "full" and "alpha" in res:
            out.alpha = res["alpha"].reshape(
                res["alpha"].shape[:2] + n1m_shape)
        elif output_type == "summary" and "alphahat" in res:
            # across chains: law of total variance again — per-chain Vt
            # already carries the within-chain theta variation, the
            # between-chain deviation term is added here (the reference's
            # streaming moments pool all draws, `src/mcmc.cpp:150-177`)
            ahat_c, vt_c = res["alphahat"], res["Vt"]
            mean = jnp.mean(ahat_c, axis=0)
            dev = ahat_c - mean
            out.alphahat = mean
            out.Vt = (jnp.mean(vt_c, axis=0)
                      + jnp.einsum('cti,ctj->tij', dev, dev)
                      / ahat_c.shape[0])
    elif mcmc_type in ("pm", "da"):
        if output_type == "full":
            out.alpha = res["alpha"].reshape(
                res["alpha"].shape[:2] + n1m_shape)
    elif mcmc_type == "approx":
        out.prior = res["prior"]
        out.approx_loglik = res["approx_ll"]
        out.posterior = res["prior"] + res["approx_ll"]
        if output_type == "full":
            t1 = _time.time()
            out.alpha = _approx_state_draws(model, res, is_key)
        if store_modes:
            out.modes = res["modes"]
            out.theta_sampled = res["theta"]
    else:  # is1 / is2 / is3
        out.prior = res["prior"]
        out.approx_loglik = res["approx_ll"]
        if store_modes:
            # (chains, S, n) — only needed afterwards by
            # post_correct/checkpointing; the correction itself reads the
            # device-resident copies
            out.modes = res["modes"]
            out.theta_sampled = res["theta"]
        t1 = _time.time()
        is_type = int(mcmc_type[-1])
        C, Sn = res["theta"].shape[:2]
        want_states = output_type == "full"
        want_moments = output_type == "summary"
        if is_type == 2:
            # head count: ONE scalar device->host sync; the actual head
            # gather stays on device inside _is_postprocess.  Pad to a
            # power-of-2 bucket so runs with similar acceptance rates reuse
            # the compiled program.
            acc = res["accepted"]
            nh = int(jnp.sum(acc)) + C - int(jnp.sum(acc[:, 0]))
            bucket = max(int(corr_batch or 256),
                         1 << max(nh - 1, 1).bit_length())
            bucket = min(bucket, C * Sn) if C * Sn >= nh else nh
        else:
            bucket = 0
        spec0 = model.build(model.theta_init)
        n1m = (spec0.n + 1, spec0.m)
        post = _is_postprocess(
            model, res["theta"], res["modes"], res["accepted"],
            res["approx_ll"], is_key, is_type=is_type, nsim=particles,
            sampling_method=sampling_method, batch_size=corr_batch or 256,
            bucket=bucket, mesh=mesh, want_states=want_states,
            want_moments=want_moments, n1m=n1m, jit_cache=jit_cache,
            psi_resample_every=psi_resample_every)
        post = jax.tree_util.tree_map(
            lambda a: a.block_until_ready(), post)
        log_w = post["log_w"]
        # store weights shifted by the global max so exp never overflows
        # (IS averages are scale-invariant); all on device — host sees
        # these lazily
        mx = jnp.max(jnp.where(jnp.isfinite(log_w), log_w, -jnp.inf))
        shift = jnp.maximum(jnp.where(jnp.isfinite(mx), mx, 0.0), 0.0)
        out.weights = jnp.exp(log_w - shift)
        out.posterior = res["prior"] + res["approx_ll"] + log_w
        if want_states:
            out.alpha = post["alpha"]
        elif want_moments:
            out.alphahat = post["alphahat"]
            out.Vt = post["Vt"]
        out.time = {"mcmc": t_mcmc, "correction": _time.time() - t1}

    if out.time is None:
        out.time = {"mcmc": t_mcmc}
    if out.acceptance_rate == 0.0:
        import warnings
        warnings.warn("No proposals were accepted after burn-in. "
                      "Check your model.", RuntimeWarning)
    return out


def _approx_state_draws(model: Model, res, key):
    """Draws from the approximating Gaussian posterior for mcmc_type='approx'
    (`/root/reference/src/approx_mcmc.cpp:1400-1462`)."""
    thetas = res["theta"]                      # (chains, S, d)
    modes = res["modes"]
    C, Ns = thetas.shape[0], thetas.shape[1]
    keys = jax.random.split(key, C * Ns).reshape(C, Ns, 2)

    def draw_one(theta_i, mode_i, k):
        spec = model.build(theta_i)
        if model.kind == "nlg":
            from ..ops.kalman_mv import simulate_states_mv
            from .nlg import build_approx
            g = build_approx(spec, mode_i)
            a = simulate_states_mv(g, 1, k, use_antithetic=False)[0]
        else:
            ar = approx_mod.approximate_for_is(spec, mode_i)
            g = ar.gaussian(spec)
            a = simulate_states_single(g, k)
        return a.reshape(-1)

    cache = model.extra.setdefault("_jit_cache", {})
    f = cache.get("approx_draws")
    if f is None:
        f = jax.jit(jax.vmap(jax.vmap(draw_one)))
        cache["approx_draws"] = f
    flat = f(thetas, modes, keys)
    spec0 = model.build(thetas[0, 0])
    return flat.reshape(flat.shape[:2] + (spec0.n + 1, spec0.m))
