"""Run the IS-MCMC main path once on one GPU and check what comes out.

Phases, in order; any failure ends the run with a non-zero exit:

  (a) device: the default JAX device must be a GPU; prints the JAX
      version, device kind and count, XLA_FLAGS, the compile-cache
      directory and nvidia-smi's name and power limit of each card;
  (b) op checks at real widths: float32 on the GPU against the same plain
      code in float64 on the host CPU, each with its tolerance and reason;
  (c) the psi_N10 deployment through `run_mcmc` (bsm_ng Poisson, n = 153,
      is2, psi-APF N = 10, 4096 chains x 1000 iterations, theta output),
      timed cold and warm, its IS-weighted posterior means checked against
      a float64 run of 256 chains on the same GPU;
  (d) one short run through each path that once had its own kernel
      (Gaussian log-likelihood, large-N psi, large-N BSF) and the gamma
      model with regressors.

usage: python chip_smoke.py               phases (a)-(d) on one GPU
       python chip_smoke.py --four        (a) + the four-GPU sharding check
       python chip_smoke.py --trace DIR   (a) + one profiler trace of a
                                          phase-1 window, reduced to kernels
                                          per scan step and device idle share

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
import argparse
import glob
import json
import os
import time

import numpy as np

import jax
import jax.numpy as jnp

import bench
from bssm_tpu.core.config import use_compile_cache
from bssm_tpu.diagnostics.summary import ess_is, summary
from bssm_tpu.inference import approx as approx_mod
from bssm_tpu.inference.mcmc import _make_correct_one, run_mcmc
from bssm_tpu.ops import kalman

N_CHAINS = 4096
N_ITER = 1000
FOUR_ITER = 100                 # iterations of the --four cells
CARD = "card not read"          # "name, power limit" of GPU 0 (phase a)


def say(*args):
    print(*args, flush=True)


def on_card(value):
    """A measured number with the card it was measured on."""
    return f"{value} [{CARD}]"


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------

def check_device(cache_dir):
    global CARD
    devs = bench.require_gpu()
    cards = bench.card_info()
    CARD = cards[0]
    say(f"jax {jax.__version__}; device_kind {devs[0].device_kind}; "
        f"device count {len(devs)}")
    say(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    say(f"compile cache: {cache_dir}")
    for line in cards:
        say(f"nvidia-smi name, power.limit: {line}")
    return devs


# ---------------------------------------------------------------------------
# (b) op checks: float32 on the GPU vs float64 on the host CPU
# ---------------------------------------------------------------------------

def f32_vs_f64(make, *args):
    """Run ``make(dtype)`` (a function of numpy ``args``) in float32 on the
    default device and in float64 on the host CPU; floating args are cast
    to each dtype, integer args (PRNG keys) passed as they are."""
    def cast(a, dt):
        return a.astype(dt) if np.issubdtype(a.dtype, np.floating) else a

    out32 = jax.device_get(jax.jit(make(jnp.float32))(
        *[jnp.asarray(cast(a, np.float32)) for a in args]))
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        out64 = jax.device_get(jax.jit(make(jnp.float64))(
            *[jax.device_put(cast(a, np.float64), cpu) for a in args]))
    return out32, out64


def verdict(name, value, limit, reason):
    """Print one check's tolerance (with its reason) and result; raise if
    the value exceeds the limit."""
    say(f"  tolerance {name}: <= {limit:.3g} ({reason})")
    ok = bool(np.isfinite(value) and value <= limit)
    say(f"  {'PASS' if ok else 'FAIL'} {name}: {value:.3g}")
    if not ok:
        raise AssertionError(f"op check {name}: {value:.3g} > {limit:.3g}")


def _thetas(model, n, seed):
    """``n`` parameter vectors around ``model.theta_init``: log-scale
    parameters spread by 0.3, the others (autoregression, regression
    coefficients on covariates of size ~100, SV scale) by 0.01 so that
    every draw stays inside its prior's support."""
    from bssm_tpu.core.priors import LOG
    rng = np.random.default_rng(seed)
    sd = np.where(np.asarray(model.transforms) == LOG, 0.3, 0.01)
    th0 = np.asarray(model.theta_init, np.float64)
    return th0 + sd * rng.standard_normal((n, th0.size))


def _lg_models():
    """bsm_lg at m = 2 (level + slope) and m = 13 (+ period-12 seasonal)
    on a seeded Gaussian series of length 153."""
    from bssm_tpu.core.priors import halfnormal_prior
    from bssm_tpu.models.bsm import bsm_lg
    rng = np.random.default_rng(11)
    n = 153
    trend = np.cumsum(np.cumsum(rng.normal(0, 0.02, n)) + rng.normal(0, .3, n))
    seas = 2.0 * np.sin(2 * np.pi * np.arange(n) / 12)
    y = trend + seas + rng.normal(0, 1.0, n)

    def m2(dt):
        return bsm_lg(y, sd_y=halfnormal_prior(1.0, 5.0),
                      sd_level=halfnormal_prior(0.3, 2.0),
                      sd_slope=halfnormal_prior(0.02, 0.5), dtype=dt)

    def m13(dt):
        return bsm_lg(y, sd_y=halfnormal_prior(1.0, 5.0),
                      sd_level=halfnormal_prior(0.3, 2.0),
                      sd_slope=halfnormal_prior(0.02, 0.5),
                      sd_seasonal=halfnormal_prior(0.1, 1.0), period=12,
                      dtype=dt)
    return {"m=2": m2, "m=13": m13}


def _ng_models():
    """One n = 153 model per Laplace family."""
    from bssm_tpu.core.priors import halfnormal_prior, uniform_prior
    from bssm_tpu.models.bsm import bsm_ng
    from bssm_tpu.models.svm import svm
    rng = np.random.default_rng(12)
    n = 153
    lvl = np.cumsum(rng.normal(0, 0.1, n))
    yb = rng.binomial(20, 1.0 / (1.0 + np.exp(-lvl))).astype(float)
    ynb = rng.negative_binomial(5.0, 5.0 / (5.0 + np.exp(1.0 + lvl))
                                ).astype(float)
    ysv = rng.normal(0, 1, n) * np.exp(0.5 * np.sin(np.arange(n) / 9))
    sd = dict(sd_level=halfnormal_prior(0.1, 1.0),
              sd_slope=halfnormal_prior(0.01, 0.1))
    return {
        "poisson": bench.flagship_model,
        "binomial": lambda dt: bsm_ng(yb, u=np.full(n, 20.0),
                                      distribution="binomial", dtype=dt,
                                      **sd),
        "negative binomial": lambda dt: bsm_ng(
            ynb, phi=5.0, distribution="negative binomial", dtype=dt, **sd),
        "gamma": bench.gamma_model,
        "svm": lambda dt: svm(ysv, rho=uniform_prior(0.9, -0.999, 0.999),
                              sd_ar=halfnormal_prior(0.3, 1.0),
                              sigma=halfnormal_prior(1.0, 2.0), dtype=dt),
    }


def _rel_max(a, b):
    """Largest per-row max |a - b| relative to that row's max |b|."""
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    scale = np.maximum(np.abs(b).max(axis=1), 1e-30)
    return float((np.abs(a - b).max(axis=1) / scale).max())


def _mc_gap(w32, w64):
    """|mean difference| in units of its Monte Carlo standard error."""
    w32 = np.asarray(w32, np.float64)
    w64 = np.asarray(w64, np.float64)
    se = np.sqrt(w32.var(ddof=1) / w32.size + w64.var(ddof=1) / w64.size)
    return float(abs(w32.mean() - w64.mean()) / se)


def op_checks():
    t0 = time.time()
    f32_noise = ("f32 rounding, eps 1.2e-7, accumulated over the n = 153 "
                 "step recursion from a diffuse initial covariance")
    for tag, mk in _lg_models().items():
        th = _thetas(mk(jnp.float32), N_CHAINS, seed=1)

        def make(dt, mk=mk):
            model = mk(dt)

            def one(t):
                spec = model.build(t)
                alpha, ll2 = kalman.fast_smoother_ll(spec)
                return kalman.log_likelihood(spec), alpha, ll2
            return jax.vmap(one)
        (ll32, a32, l232), (ll64, a64, l264) = f32_vs_f64(make, th)
        say(f"kalman {tag}: {N_CHAINS} specs, n = 153")
        verdict(f"log_likelihood {tag} max |d ll| / |ll|",
                float(np.max(np.abs(ll32 - ll64) / np.abs(ll64))), 1e-4,
                f32_noise)
        verdict(f"fast_smoother_ll {tag} loglik max |d ll| / |ll|",
                float(np.max(np.abs(l232 - l264) / np.abs(l264))), 1e-4,
                f32_noise)
        verdict(f"fast_smoother_ll {tag} smoothed means, max rel",
                _rel_max(a32, a64), 1e-3, f32_noise)

    lap_reason = ("the f32 solve stops at mean-squared change 6e-6 "
                  "(50 f32 eps), f64 at 1e-8")
    approx_gauss = {}
    for fam, mk in _ng_models().items():
        th = _thetas(mk(jnp.float32), N_CHAINS, seed=2)

        def make(dt, mk=mk):
            model = mk(dt)

            def one(t):
                al = approx_mod.approx_loglik(model.build(t))
                return (al.approx.mode, al.loglik, al.approx.ytilde,
                        al.approx.Htilde)
            return jax.vmap(one)
        (m32, l32, yt32, h32), (m64, l64, _, _) = f32_vs_f64(make, th)
        say(f"Laplace solve {fam}: {N_CHAINS} specs, n = 153")
        verdict(f"laplace {fam} mode max |d|", float(np.abs(m32 - m64).max()),
                1e-2, lap_reason)
        verdict(f"laplace {fam} approx loglik max |d ll| / |ll|",
                float(np.max(np.abs(l32 - l64) / np.abs(l64))), 5e-4,
                lap_reason)
        if fam == "poisson":
            approx_gauss = (mk, th, yt32, h32)

    # backward factors on the poisson approximating models: both precisions
    # start from the SAME (f32) pseudo-observations, so the check sees the
    # smoother's arithmetic only
    mk, th, yt, ht = approx_gauss

    def make_bwd(dt):
        model = mk(dt)

        def one(t, y_, h_):
            g = model.build(t).approx_gaussian(y_, h_)
            ahat, Lb, Ab = kalman.smoother_bwd_factors(g)
            return ahat, jnp.einsum('tij,tkj->tik', Lb, Lb), Ab
        return jax.vmap(one)
    (ah32, ll32, ab32), (ah64, ll64, ab64) = f32_vs_f64(make_bwd, th, yt, ht)
    say(f"smoother_bwd_factors: {N_CHAINS} specs, n = 153, m = 2")
    verdict("bwd factors smoothed means, max rel", _rel_max(ah32, ah64),
            1e-3, f32_noise)
    verdict("bwd factors L L', max rel", _rel_max(ll32, ll64), 1e-2,
            f32_noise + ", in a covariance formed by cancellation")
    verdict("bwd factors gains J, max |d|", float(np.abs(ab32 - ab64).max()),
            1e-2, f32_noise + "; J = Ptt T' P_pred^+ (smoothed pinv)")

    # particle filters: the f32 and f64 random streams differ, so compare
    # the means of 1024 independent log-weights
    n_keys = 1024
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(7), n_keys))
    mc_reason = "means of two independent 1024-key samples"
    for label, mk, nsim, method, kk in (
            ("psi N=10", bench.flagship_model, 10, "psi", 1),
            ("psi N=256 resample_every=1", bench.flagship_model, 256, "psi",
             1),
            ("psi N=256 resample_every=8", bench.flagship_model, 256, "psi",
             8),
            ("bsf N=200", bench.bsf_model, 200, "bsf", 1)):
        def make_pf(dt, mk=mk, nsim=nsim, method=method, kk=kk):
            model = mk(dt)
            correct = _make_correct_one(model, nsim, method,
                                        want_states=False, want_moments=False,
                                        psi_resample_every=kk)
            theta = jnp.asarray(model.theta_init, dt)
            nomode = jnp.zeros((1,), dt)
            return jax.vmap(lambda k: correct((theta, nomode, k))["log_w"])
        w32, w64 = f32_vs_f64(make_pf, keys)
        say(f"{label} log-weights: {n_keys} keys, mean f32 "
            f"{np.mean(w32):.6g}, f64 {np.mean(w64):.6g}, sd f32 "
            f"{np.std(w32):.3g}, f64 {np.std(w64):.3g}")
        if not (np.all(np.isfinite(w32)) and np.all(np.isfinite(w64))):
            raise AssertionError(f"{label}: non-finite log-weights")
        verdict(f"{label} |mean f32 - mean f64| / MC se", _mc_gap(w32, w64),
                4.0, mc_reason)
    say(f"phase (b) op checks: {time.time() - t0:.1f} s wall")


# ---------------------------------------------------------------------------
# (c) the main path
# ---------------------------------------------------------------------------

class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling, from its
    monitoring events."""
    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.seconds += duration


def _posterior_means(out):
    rows = summary(out, return_se=True)
    return ({r["variable"]: r["Mean"] for r in rows},
            {r["variable"]: r["SE"] for r in rows})


def main_path(clock):
    model = bench.flagship_model(jnp.float32)
    kw = dict(iter=N_ITER, particles=10, mcmc_type="is2", n_chains=N_CHAINS,
              output_type="theta", corr_batch=16384, store_modes=False)
    c0, t0 = clock.seconds, time.time()
    run_mcmc(model, seed=0, **kw)
    cold, compile_s = time.time() - t0, clock.seconds - c0
    t0 = time.time()
    out = run_mcmc(model, seed=1, **kw)
    warm = time.time() - t0
    total = N_CHAINS * N_ITER
    w = out.flat_weights()
    eif = float(ess_is(w)) / w.size
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", "not reported by the device")
    say(f"main path psi_N10: {N_CHAINS} chains x {N_ITER} iterations, "
        f"is2, psi-APF N = 10, float32")
    say("  cold first call (compile included) s: " + on_card(f"{cold:.2f}"))
    say("  compile (trace + lower + compile) s: " + on_card(f"{compile_s:.2f}"))
    say("  warm call s: " + on_card(f"{warm:.2f}"))
    say("  McmcOutput.time mcmc s: " + on_card(f"{out.time['mcmc']:.3f}"))
    say("  McmcOutput.time correction s: "
        + on_card(f"{out.time['correction']:.3f}"))
    say("  samples/s: " + on_card(f"{total / warm:.1f}"))
    say("  peak_bytes_in_use (process, since start): "
        + on_card(f"{peak}"))
    say("  ESS_IS fraction: " + on_card(f"{eif:.4f}"))
    say("  acceptance: " + on_card(f"{out.acceptance_rate:.4f}"))
    if not np.all(np.isfinite(out.posterior)):
        raise AssertionError("main path: non-finite posterior")

    n_ref = 256
    t0 = time.time()
    with jax.enable_x64(True):
        ref = run_mcmc(bench.flagship_model(jnp.float64), seed=2,
                       **dict(kw, n_chains=n_ref))
    say(f"float64 reference: {n_ref} chains x {N_ITER} iterations on the "
        "GPU, s: " + on_card(f"{time.time() - t0:.2f}"))
    m32, se32 = _posterior_means(out)
    m64, se64 = _posterior_means(ref)
    say("  tolerance posterior means: <= 4 combined standard errors "
        "(summary(return_se=True); independent runs)")
    for name in m32:
        gap = abs(m32[name] - m64[name]) / np.hypot(se32[name], se64[name])
        say(f"  {name}: f32 {m32[name]:.6g} (se {se32[name]:.2g}), f64 "
            f"{m64[name]:.6g} (se {se64[name]:.2g}), gap {gap:.2f} se")
        if not gap <= 4.0:
            raise AssertionError(f"posterior mean of {name}: {gap:.2f} se")


# ---------------------------------------------------------------------------
# (d) the paths whose own kernels were removed
# ---------------------------------------------------------------------------

def removed_kernel_paths():
    from bssm_tpu.core.priors import halfnormal_prior
    from bssm_tpu.models.bsm import bsm_lg
    rng = np.random.default_rng(13)
    n = 153
    ylg = np.cumsum(np.cumsum(rng.normal(0, 0.02, n))
                    + rng.normal(0, 0.3, n)) + rng.normal(0, 1.0, n)
    f32 = jnp.float32
    runs = (
        ("bsm_lg gaussian MCMC (former forward-loglik kernel)",
         bsm_lg(ylg, sd_y=halfnormal_prior(1.0, 5.0),
                sd_level=halfnormal_prior(0.3, 2.0),
                sd_slope=halfnormal_prior(0.02, 0.5), dtype=f32),
         dict(n_chains=512, iter=N_ITER)),
        ("is2 psi N=256 psi_resample_every=8 (former large-N psi kernel)",
         bench.flagship_model(f32),
         dict(n_chains=1024, iter=400, particles=256, mcmc_type="is2",
              psi_resample_every=8, corr_batch=4096, store_modes=False)),
        ("pm bsf N=200 (former large-N BSF kernel)", bench.bsf_model(f32),
         dict(n_chains=512, iter=400, particles=200, mcmc_type="pm",
              sampling_method="bsf")),
        ("is2 psi N=10 gamma airquality + xreg", bench.gamma_model(f32),
         dict(n_chains=1024, iter=400, particles=10, mcmc_type="is2",
              corr_batch=16384, store_modes=False)),
    )
    for label, model, kw in runs:
        t0 = time.time()
        out = run_mcmc(model, seed=4, output_type="theta", **kw)
        el = time.time() - t0
        acc = float(out.acceptance_rate)
        say(f"{label}: reduced to {kw['n_chains']} chains x {kw['iter']} "
            f"iterations (main path {N_CHAINS} x {N_ITER}); cold call s: "
            + on_card(f"{el:.2f}") + f"; acceptance {acc:.3f}")
        if not np.all(np.isfinite(out.posterior)):
            raise AssertionError(f"{label}: non-finite posterior")
        if not 0.05 <= acc <= 0.6:
            raise AssertionError(f"{label}: acceptance {acc:.3f} outside "
                                 "[0.05, 0.6]")


# ---------------------------------------------------------------------------
# --four: chains sharded over four GPUs
# ---------------------------------------------------------------------------

def four_gpus(devs):
    """is2 (summary output) and pm-BSF on a four-GPU mesh, laid out as
    (chains, draws) = (4, 1) and (2, 2), each compared with the one-GPU run
    at identical keys.  The comparison runs in float64: in float32 the
    sharded and one-GPU programs reduce in different orders, the rounding
    flips stratified-resampling choices and accept decisions, and the
    chains part ways, which says nothing about sharding.  The float32
    runs of the same cells give samples/s per GPU."""
    from bssm_tpu.parallel.mesh import make_mesh
    if len(devs) < 4:
        raise SystemExit(f"--four needs 4 GPUs, JAX found {len(devs)}")
    cells = (
        ("is2 psi N=10 summary", bench.flagship_model,
         dict(iter=FOUR_ITER, particles=10, mcmc_type="is2",
              n_chains=N_CHAINS, output_type="summary", corr_batch=16384,
              seed=5)),
        ("pm bsf N=200", bench.bsf_model,
         dict(iter=FOUR_ITER, particles=200, mcmc_type="pm",
              sampling_method="bsf", n_chains=N_CHAINS // 4,
              output_type="theta", seed=6)),
    )
    meshes = {shape: make_mesh(4, axes=("chains", "draws"), shape=shape)
              for shape in ((4, 1), (2, 2))}
    say("  tolerance sharded vs one GPU (float64): theta rtol 1e-4 atol "
        "1e-4; posterior rtol 3e-3 atol 0.15; alphahat rtol 3e-3 atol 0.05 "
        "(the multi-device dry run's limits)")
    for label, mk, kw in cells:
        say(f"{label}: {kw['n_chains']} chains x {kw['iter']} iterations "
            f"(iterations reduced from {N_ITER})")
        with jax.enable_x64(True):
            model = mk(jnp.float64)
            t0 = time.time()
            ref = run_mcmc(model, mesh=None, **kw)
            say("  float64 one GPU, cold call s: "
                + on_card(f"{time.time() - t0:.2f}"))
            for shape, mesh in meshes.items():
                t0 = time.time()
                out = run_mcmc(model, mesh=mesh, **kw)
                say(f"  float64 mesh {shape}, cold call s: "
                    + on_card(f"{time.time() - t0:.2f}"))
                if not np.all(np.isfinite(out.posterior)):
                    raise AssertionError(f"{label} {shape}: non-finite")
                np.testing.assert_allclose(out.theta, ref.theta, rtol=1e-4,
                                           atol=1e-4)
                np.testing.assert_allclose(out.posterior, ref.posterior,
                                           rtol=3e-3, atol=0.15)
                if out.alphahat is not None:
                    np.testing.assert_allclose(out.alphahat, ref.alphahat,
                                               rtol=3e-3, atol=0.05)
                dth = float(np.abs(out.theta - ref.theta).max())
                say(f"  float64 mesh {shape}: sharded == one GPU within "
                    f"tolerance (max |d theta| {dth:.3g})")
        model = mk(jnp.float32)
        for shape, mesh in meshes.items():
            run_mcmc(model, mesh=mesh, **kw)
            t0 = time.time()
            out = run_mcmc(model, mesh=mesh, **kw)
            warm = time.time() - t0
            if not np.all(np.isfinite(out.posterior)):
                raise AssertionError(f"{label} {shape}: non-finite")
            say(f"  float32 mesh {shape}: warm call s "
                + on_card(f"{warm:.2f}") + ", samples/s per GPU "
                + on_card(f"{kw['n_chains'] * kw['iter'] / warm / 4:.1f}"))


# ---------------------------------------------------------------------------
# --trace: one profiler trace of a phase-1 window
# ---------------------------------------------------------------------------

WINDOW = "phase1_laplace_window"


def _union_ns(spans):
    total, end = 0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def trace_phase1(logdir):
    """Trace one phase-1 evaluation at full width: the vmapped Laplace
    solve of 4096 chains (each RAM iteration runs one).  Every solve
    iteration is two `lax.scan`s of n = 153 steps (filter, smoother), and
    the vmapped while-loop runs the batch's largest iteration count."""
    model = bench.flagship_model(jnp.float32)
    th = jnp.asarray(_thetas(model, N_CHAINS, seed=3), jnp.float32)
    solve = jax.jit(jax.vmap(
        lambda t: approx_mod.approximate(model.build(t)).niter))
    niter = int(np.max(jax.device_get(solve(th))))       # compile + warm
    n = model.build(model.theta_init).n
    steps = niter * 2 * n
    with jax.profiler.trace(logdir):
        with jax.profiler.TraceAnnotation(WINDOW):
            jax.block_until_ready(solve(th))
    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    # device activity: the GPU plane's per-stream lines (kernels and
    # copies); its "XLA Ops" line repeats the same kernels by HLO op
    window, streams, ops = None, [], []
    for plane in pd.planes:
        for line in plane.lines:
            evs = list(line.events)
            say(f"  trace plane {plane.name!r} line {line.name!r}: "
                f"{len(evs)} events")
            if window is None:
                for ev in evs:
                    if ev.name == WINDOW:
                        window = (ev.start_ns, ev.start_ns + ev.duration_ns)
            spans = [(ev.start_ns, ev.start_ns + ev.duration_ns)
                     for ev in evs]
            if plane.name.startswith("/device:GPU"):
                if line.name.startswith("Stream"):
                    streams += spans
                elif line.name == "XLA Ops":
                    ops += spans
    kernels = streams or ops
    if window is None or not kernels:
        raise AssertionError(f"trace {path}: window found {window is not None}"
                             f", {len(kernels)} device events")
    inside = [(max(s, window[0]), min(e, window[1])) for s, e in kernels
              if e > window[0] and s < window[1]]
    span = window[1] - window[0]
    busy = _union_ns(inside)
    say(f"trace {path}")
    say(f"phase-1 window: Laplace solve of {N_CHAINS} chains, {niter} solve "
        f"iterations x 2 scans x {n} steps = {steps} scan steps")
    say("  window ms: " + on_card(f"{span / 1e6:.3f}"))
    say("  device kernels in window: " + on_card(f"{len(inside)}"))
    say("  device kernels per scan step: "
        + on_card(f"{len(inside) / steps:.2f}"))
    say("  us per scan step: " + on_card(f"{span / 1e3 / steps:.2f}"))
    say("  device busy ms: " + on_card(f"{busy / 1e6:.3f}"))
    say("  device idle share: " + on_card(f"{1.0 - busy / span:.4f}"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharding check")
    ap.add_argument("--trace", metavar="DIR",
                    help="run only the phase-1 profiler trace, into DIR")
    args = ap.parse_args()
    devs = check_device(use_compile_cache())
    if args.four:
        four_gpus(devs)
    elif args.trace:
        trace_phase1(args.trace)
    else:
        clock = CompileClock()
        op_checks()
        main_path(clock)
        removed_kernel_paths()
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
