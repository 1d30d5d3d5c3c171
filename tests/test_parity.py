"""Correctness-parity targets from BASELINE.md, on the reference's own data
(loaded from `/root/reference/data/*.rda` with the built-in RDX reader).

- negbin_series bsm_ng: published posterior means theta = (beta -0.912,
  phi 5.392, sd_level 0.092, sd_slope 0.003), alpha_200 = (6.962, 0.006)
  (`/root/reference/tests/testthat/test_mcmc.R:39-65`)
- poisson_series bsm_ng: sd_level ~= 0.093, sd_slope ~= 0.016,
  level_1 ~= -0.075, level_100 ~= 2.618 (`/root/reference/R/models.R:864-871`)

Run lengths are reduced vs the reference's 6e4-1e5 iterations to keep CPU
CI practical; tolerances widened accordingly (MC error dominates).
"""
import numpy as np
import pytest

from bssm_tpu.core.priors import halfnormal_prior, normal_prior, uniform_prior
from bssm_tpu.diagnostics.summary import weighted_mean
from bssm_tpu.inference.mcmc import run_mcmc
from bssm_tpu.models.bsm import bsm_ng
from bssm_tpu.utils.rdata import load_rda
from parity_record import record

DATA = "/root/reference/data"


@pytest.mark.slow
def test_negbin_paper_parity():
    d = load_rda(f"{DATA}/negbin_series.rda")["negbin_series"]
    y, x = d[:, 0], d[:, 1]
    model = bsm_ng(y, xreg=x, beta=normal_prior(0.0, 0.0, 10.0),
                   phi=halfnormal_prior(1.0, 10.0),
                   sd_level=halfnormal_prior(0.1, 1.0),
                   sd_slope=halfnormal_prior(0.01, 0.1),
                   a1=np.zeros(2), P1=np.diag([10.0, 0.1]) ** 2,
                   distribution="negative binomial")
    out = run_mcmc(model, iter=20000, burnin=4000, particles=10,
                   mcmc_type="is2", seed=1, output_type="full", n_chains=2)
    w = out.flat_weights()
    th = out.flat_theta()
    names = list(out.theta_names)
    means = {nm: weighted_mean(th[:, j], w) for j, nm in enumerate(names)}
    assert abs(means["beta"] - (-0.912)) < 0.05
    assert abs(means["phi"] - 5.392) < 0.35
    assert abs(means["sd_level"] - 0.092) < 0.02
    assert abs(means["sd_slope"] - 0.003) < 0.006
    # smoothed state at t=200 (1-based) = index 199
    a = out.alpha.reshape((-1,) + out.alpha.shape[2:])
    lvl = weighted_mean(a[:, 199, 0], w)
    slp = weighted_mean(a[:, 199, 1], w)
    record("negbin_paper_parity",
           dict(means, level_200=lvl, slope_200=slp),
           {"beta": [-0.912, 0.05], "phi": [5.392, 0.35],
            "sd_level": [0.092, 0.02], "sd_slope": [0.003, 0.006],
            "level_200": [6.962, 0.05], "slope_200": [0.006, 0.01]})
    assert abs(lvl - 6.962) < 0.05
    assert abs(slp - 0.006) < 0.01


@pytest.mark.slow
def test_poisson_series_doc_parity():
    y = load_rda(f"{DATA}/poisson_series.rda")["poisson_series"]
    y = np.asarray(y, dtype=float)
    s = np.std(np.log(np.maximum(0.1, y)))
    model = bsm_ng(y, sd_level=uniform_prior(0.115, 0.0, 2 * s),
                   sd_slope=uniform_prior(0.004, 0.0, 2 * s),
                   P1=np.eye(2) * 0.1, distribution="poisson")
    out = run_mcmc(model, iter=20000, burnin=4000, particles=10,
                   mcmc_type="is2", seed=2, output_type="full", n_chains=2)
    w = out.flat_weights()
    th = out.flat_theta()
    means = dict(zip(out.theta_names,
                     [weighted_mean(th[:, j], w) for j in range(2)]))
    a = out.alpha.reshape((-1,) + out.alpha.shape[2:])
    lvl1 = weighted_mean(a[:, 0, 0], w)
    lvl100 = weighted_mean(a[:, 99, 0], w)
    record("poisson_series_doc_parity",
           dict(means, level_1=lvl1, level_100=lvl100),
           {"sd_level": [0.093, 0.02], "sd_slope": [0.016, 0.012],
            "level_1": [-0.075, 0.12], "level_100": [2.618, 0.12]})
    assert abs(means["sd_level"] - 0.093) < 0.02
    assert abs(means["sd_slope"] - 0.016) < 0.012
    assert abs(lvl1 - (-0.075)) < 0.12
    assert abs(lvl100 - 2.618) < 0.12


@pytest.mark.slow
def test_airquality_bsm_lg_parity():
    """The reference README flagship example (`/root/reference/README.md:
    116-159`): bsm_lg on airquality Ozone with Wind+Temp regressors, 20k
    iterations / 5k burn-in.  Published posterior: Temp 1.027 (SD 0.206),
    Wind -2.518 (SD 0.576), sd_level 6.373 (SD 2.80), sd_slope 0.339
    (SD 0.283), sd_y 20.862 (SD 1.94); alpha_154 level -28.32, slope
    -0.374; acceptance 0.239; theta ESS 613-808 on 15k kept draws."""
    from bssm_tpu.core.priors import gamma_prior
    from bssm_tpu.diagnostics.summary import estimate_ess
    from bssm_tpu.models.bsm import bsm_lg
    from bssm_tpu.utils.datasets import airquality

    d = airquality()
    xreg = np.column_stack([d["Wind"], d["Temp"]])
    model = bsm_lg(d["Ozone"], xreg=xreg,
                   beta=normal_prior(np.zeros(2), 0.0, 1.0),
                   sd_y=gamma_prior(1.0, 2.0, 0.01),
                   sd_level=gamma_prior(1.0, 2.0, 0.01),
                   sd_slope=gamma_prior(1.0, 2.0, 0.01))
    out = run_mcmc(model, iter=20000, burnin=5000, seed=1, n_chains=2,
                   output_type="summary")
    th = out.flat_theta()
    means = dict(zip(out.theta_names, th.mean(axis=0)))
    sds = dict(zip(out.theta_names, th.std(axis=0)))
    lvl, slp = float(out.alphahat[-1, 0]), float(out.alphahat[-1, 1])
    # per-chain IACT-based ESS on the Wind coefficient, published 613-808
    # (per 15000 kept draws; wide band, ESS estimates are noisy)
    ess = [estimate_ess(out.theta[c, :, 3]) for c in range(2)]
    targets = {"Temp": [1.027, 0.08], "Wind": [-2.518, 0.20],
               "sd_level": [6.373, 0.8], "sd_slope": [0.339, 0.10],
               "sd_y": [20.862, 0.6], "level_154": [-28.32, 4.0],
               "slope_154": [-0.374, 0.4],
               "acceptance": [0.239, 0.05], "ess_wind": [700, "in 250..3000"]}
    record("airquality_bsm_lg_parity",
           {"Temp": means["beta_2"], "Wind": means["beta_1"],
            "sd_level": means["sd_level"], "sd_slope": means["sd_slope"],
            "sd_y": means["sd_y"], "sd_Temp": sds["beta_2"],
            "sd_Wind": sds["beta_1"], "level_154": lvl, "slope_154": slp,
            "acceptance": float(out.acceptance_rate),
            "ess_wind_chain0": ess[0], "ess_wind_chain1": ess[1]}, targets)
    assert abs(means["beta_2"] - 1.027) < 0.08          # Temp
    assert abs(means["beta_1"] - (-2.518)) < 0.20       # Wind
    assert abs(means["sd_level"] - 6.373) < 0.8
    assert abs(means["sd_slope"] - 0.339) < 0.10
    assert abs(means["sd_y"] - 20.862) < 0.6
    # posterior SDs are parity targets too (README prints them)
    assert abs(sds["beta_2"] - 0.206) < 0.05
    assert abs(sds["beta_1"] - 0.576) < 0.15
    assert abs(lvl - (-28.32)) < 4.0
    assert abs(slp - (-0.374)) < 0.4
    assert abs(out.acceptance_rate - 0.239) < 0.05
    for e in ess:
        assert 250 < e < 3000, ess


def test_datasets_load():
    for name, shape in [("poisson_series", (100,)), ("drownings", (51, 4)),
                        ("exchange", (945,)), ("negbin_series", (200, 2))]:
        d = load_rda(f"{DATA}/{name}.rda")[name]
        assert np.asarray(d).shape == shape


@pytest.mark.slow
def test_drownings_poisson_consistency():
    """Drownings config (BASELINE.md): bsm_ng Poisson with exposure u;
    cross-method consistency is2 == da within MC error
    (`/root/reference/tests/testthat/` strategy #2)."""
    d = load_rda(f"{DATA}/drownings.rda")["drownings"]
    # columns: deaths, population (1e5), summer_temp (demeaned), raw temp
    # (`/root/reference/R/bssm-package.R:141-145`)
    deaths, population, summer_temp = d[:, 0], d[:, 1], d[:, 2]
    model = bsm_ng(deaths, u=population, xreg=summer_temp,
                   beta=normal_prior(0.0, 0.0, 1.0),
                   sd_level=halfnormal_prior(0.05, 1.0),
                   sd_slope=halfnormal_prior(0.005, 0.1),
                   distribution="poisson")
    o1 = run_mcmc(model, iter=20000, burnin=4000, particles=10,
                  mcmc_type="is2", seed=1, output_type="theta", n_chains=2)
    o2 = run_mcmc(model, iter=20000, burnin=4000, particles=10,
                  mcmc_type="da", seed=2, output_type="theta", n_chains=2)
    m1 = np.average(o1.flat_theta(), axis=0, weights=o1.flat_weights())
    m2 = o2.flat_theta().mean(axis=0)
    record("drownings_poisson_consistency",
           {f"is2_{nm}": v for nm, v in zip(o1.theta_names, m1)}
           | {f"da_{nm}": v for nm, v in zip(o2.theta_names, m2)},
           {"agreement": ["is2 == da", "rtol 0.1 atol 0.005"]})
    np.testing.assert_allclose(m1, m2, rtol=0.1, atol=0.005)
    assert np.all(np.isfinite(m1))


@pytest.mark.slow
def test_exchange_svm_consistency():
    """Exchange-rate SV config (BASELINE.md): psi-APF IS2 vs PM agree."""
    from bssm_tpu.models.svm import svm
    y = np.asarray(load_rda(f"{DATA}/exchange.rda")["exchange"], float)
    model = svm(y, rho=uniform_prior(0.98, -0.999, 0.999),
                sd_ar=halfnormal_prior(0.15, 5.0),
                sigma=halfnormal_prior(0.6, 2.0))
    o1 = run_mcmc(model, iter=12000, burnin=3000, particles=10,
                  mcmc_type="is2", seed=3, output_type="theta", n_chains=2)
    o2 = run_mcmc(model, iter=12000, burnin=3000, particles=10,
                  mcmc_type="pm", seed=4, output_type="theta", n_chains=2)
    m1 = np.average(o1.flat_theta(), axis=0, weights=o1.flat_weights())
    m2 = o2.flat_theta().mean(axis=0)
    record("exchange_svm_consistency",
           {f"is2_{nm}": v for nm, v in zip(o1.theta_names, m1)}
           | {f"pm_{nm}": v for nm, v in zip(o2.theta_names, m2)},
           {"agreement": ["is2 == pm", "tols (0.025, 0.025, 0.06)"]})
    assert 0.8 < m1[0] < 1.0          # persistent volatility on full data
    for a, b, tol in zip(m1, m2, (0.025, 0.025, 0.06)):
        assert abs(a - b) < tol, (m1, m2)


@pytest.mark.slow
def test_poisson_series_f32_fused_parity():
    """The production configuration — a float32 model — must reproduce
    the same published posterior as the x64 path."""
    import jax.numpy as jnp
    y = load_rda(f"{DATA}/poisson_series.rda")["poisson_series"]
    y = np.asarray(y, dtype=float)
    s = np.std(np.log(np.maximum(0.1, y)))
    model = bsm_ng(y, sd_level=uniform_prior(0.115, 0.0, 2 * s),
                   sd_slope=uniform_prior(0.004, 0.0, 2 * s),
                   P1=np.eye(2) * 0.1, distribution="poisson",
                   dtype=jnp.float32)
    out = run_mcmc(model, iter=20000, burnin=4000, particles=10,
                   mcmc_type="is2", seed=2, output_type="theta", n_chains=2)
    w = out.flat_weights()
    th = out.flat_theta()
    means = dict(zip(out.theta_names,
                     [weighted_mean(th[:, j], w) for j in range(2)]))
    from bssm_tpu.diagnostics.summary import ess_is
    eff = ess_is(w) / w.size
    record("poisson_series_f32_fused_parity",
           dict(means, ess_is_frac=eff),
           {"sd_level": [0.093, 0.02], "sd_slope": [0.016, 0.012],
            "ess_is_frac": ["> 0.9", 0.9]})
    assert abs(means["sd_level"] - 0.093) < 0.02
    assert abs(means["sd_slope"] - 0.016) < 0.012
    assert eff > 0.9, eff


@pytest.mark.slow
def test_drownings_f32_fused_parity():
    """Drownings config in f32: weighted means match the x64 is2 run
    within MC tolerance, IS weights non-degenerate."""
    import jax.numpy as jnp
    d = load_rda(f"{DATA}/drownings.rda")["drownings"]
    deaths, population, summer_temp = d[:, 0], d[:, 1], d[:, 2]
    kw = dict(u=population, xreg=summer_temp,
              beta=normal_prior(0.0, 0.0, 1.0),
              sd_level=halfnormal_prior(0.05, 1.0),
              sd_slope=halfnormal_prior(0.005, 0.1),
              distribution="poisson")
    m32 = bsm_ng(deaths, dtype=jnp.float32, **kw)
    m64 = bsm_ng(deaths, **kw)
    run = dict(iter=8000, burnin=2000, particles=10, mcmc_type="is2",
               seed=1, output_type="theta", n_chains=2)
    o32 = run_mcmc(m32, **run)
    o64 = run_mcmc(m64, **run)
    a = np.average(o32.flat_theta(), axis=0, weights=o32.flat_weights())
    b = np.average(o64.flat_theta(), axis=0, weights=o64.flat_weights())
    from bssm_tpu.diagnostics.summary import ess_is
    eff = ess_is(o32.flat_weights()) / o32.flat_weights().size
    record("drownings_f32_fused_parity",
           {f"f32_{nm}": v for nm, v in zip(o32.theta_names, a)}
           | {f"x64_{nm}": v for nm, v in zip(o64.theta_names, b)}
           | {"ess_is_frac": eff},
           {"agreement": ["f32 == x64", "rtol 0.1 atol 0.005"],
            "ess_is_frac": ["> 0.9", 0.9]})
    np.testing.assert_allclose(a, b, rtol=0.1, atol=0.005)
    assert eff > 0.9, eff


@pytest.mark.slow
def test_negbin_f32_fused_parity():
    """negbin + xreg in f32: covers the phi path of the family math
    (poisson/drownings tests cover u and D)."""
    from bssm_tpu.diagnostics.summary import ess_is
    import jax.numpy as jnp
    d = load_rda(f"{DATA}/negbin_series.rda")["negbin_series"]
    y, x = d[:, 0], d[:, 1]
    kw = dict(xreg=x, beta=normal_prior(0.0, 0.0, 10.0),
              phi=halfnormal_prior(1.0, 10.0),
              sd_level=halfnormal_prior(0.1, 1.0),
              sd_slope=halfnormal_prior(0.01, 0.1),
              a1=np.zeros(2), P1=np.diag([10.0, 0.1]) ** 2,
              distribution="negative binomial")
    run = dict(iter=6000, burnin=1500, particles=10, mcmc_type="is2",
               seed=1, output_type="theta", n_chains=2)
    m32 = bsm_ng(y, dtype=jnp.float32, **kw)
    o32 = run_mcmc(m32, **run)
    o64 = run_mcmc(bsm_ng(y, **kw), **run)
    a = np.average(o32.flat_theta(), axis=0, weights=o32.flat_weights())
    b = np.average(o64.flat_theta(), axis=0, weights=o64.flat_weights())
    eff = ess_is(o32.flat_weights()) / o32.flat_weights().size
    record("negbin_f32_fused_parity",
           {f"f32_{nm}": v for nm, v in zip(o32.theta_names, a)}
           | {f"x64_{nm}": v for nm, v in zip(o64.theta_names, b)}
           | {"ess_is_frac": eff},
           {"agreement": ["f32 == x64", "rtol 0.1 atol 0.005"],
            "ess_is_frac": ["> 0.9", 0.9]})
    np.testing.assert_allclose(a, b, rtol=0.1, atol=0.005)
    assert eff > 0.9, eff


@pytest.mark.slow
def test_airquality_bsm_ng_gamma_parity():
    """The reference README Gamma example — the 7.71 s baseline anchor
    (`/root/reference/README.md:177-228`): bsm_ng gamma on airquality
    Ozone with Wind+Temp regressors, IS2 with 10 psi-APF particles, 20k
    iterations / 5k burn-in.  Published weighted posterior: Temp 0.0528
    (SD 0.0087), Wind -0.0574 (SD 0.0154), phi 4.007 (SD 0.536),
    sd_level 0.0572 (SD 0.0354), sd_slope 0.0039 (SD 0.0037); alpha_154
    level -0.2007, slope -0.0027; acceptance 0.257; ESS_IS 7766-14611 of
    15000 kept draws (>= 52%)."""
    from bssm_tpu.core.priors import gamma_prior
    from bssm_tpu.diagnostics.summary import ess_is
    from bssm_tpu.utils.datasets import airquality

    d = airquality()
    xreg = np.column_stack([d["Wind"], d["Temp"]])
    model = bsm_ng(d["Ozone"], xreg=xreg,
                   beta=normal_prior(np.zeros(2), 0.0, 1.0),
                   distribution="gamma",
                   phi=gamma_prior(1.0, 2.0, 0.01),
                   sd_level=gamma_prior(1.0, 2.0, 0.1),
                   sd_slope=gamma_prior(1.0, 2.0, 0.1))
    out = run_mcmc(model, iter=20000, burnin=5000, particles=10,
                   mcmc_type="is2", seed=1, n_chains=2,
                   output_type="summary")
    w = out.flat_weights()
    th = out.flat_theta()
    wm = dict(zip(out.theta_names,
                  np.sum(w[:, None] * th, axis=0) / np.sum(w)))
    lvl, slp = float(out.alphahat[-1, 0]), float(out.alphahat[-1, 1])
    eif = float(ess_is(w)) / w.size
    targets = {"Temp": [0.0528, 0.005], "Wind": [-0.0574, 0.01],
               "phi": [4.007, 0.4], "sd_level": [0.0572, 0.03],
               "sd_slope": [0.0039, 0.006], "level_154": [-0.2007, 0.2],
               "slope_154": [-0.0027, 0.02],
               "acceptance": [0.257, 0.06], "ess_is_frac": [0.7, ">0.5"]}
    record("airquality_bsm_ng_gamma_parity",
           {"Temp": wm["beta_2"], "Wind": wm["beta_1"], "phi": wm["phi"],
            "sd_level": wm["sd_level"], "sd_slope": wm["sd_slope"],
            "level_154": lvl, "slope_154": slp,
            "acceptance": float(out.acceptance_rate),
            "ess_is_frac": eif}, targets)
    assert abs(wm["beta_2"] - 0.0528) < 0.005           # Temp
    assert abs(wm["beta_1"] - (-0.0574)) < 0.01         # Wind
    assert abs(wm["phi"] - 4.007) < 0.4
    assert abs(wm["sd_level"] - 0.0572) < 0.03
    assert abs(wm["sd_slope"] - 0.0039) < 0.006
    assert abs(lvl - (-0.2007)) < 0.2
    assert abs(slp - (-0.0027)) < 0.02
    assert abs(out.acceptance_rate - 0.257) < 0.06
    assert eif > 0.5
