"""bssm_tpu — accelerator-native Bayesian inference for state-space models.

A from-scratch JAX/XLA re-design of the capabilities of the
`bssm` R package (helske/bssm): Kalman-filter marginal MCMC for
linear-Gaussian models, Laplace/Gaussian approximations, psi-APF and
bootstrap particle filters, EKF/UKF/EKPF, Milstein-discretised SDEs, and
approximate MCMC with IS-type post-correction — built for `vmap`-parallel
chains and particle ensembles sharded over a GPU mesh.
"""

__version__ = "0.1.0"

import jax as _jax

# Kalman covariance recursions are numerically meaningless at reduced matmul
# precision (NaN log-likelihoods, non-converging Laplace iterations); on
# Hopper, JAX's default f32 matmul precision may run on the tensor cores in
# TF32 (10-bit mantissa).  The system matrices here are tiny (m <= ~20), so
# full-f32 multiplication costs nothing; force it globally.
_jax.config.update("jax_default_matmul_precision", "highest")

from .core.spec import (LGSpec, MVLGSpec, NGSpec, MVNGSpec,
                        SVM, POISSON, BINOMIAL, NEGBIN, GAMMA, GAUSSIAN)
from .core.priors import (uniform_prior, halfnormal_prior, normal_prior,
                          tnormal_prior, gamma_prior, PriorStack)
from .models.bsm import bsm_lg, bsm_ng
from .models.ar1 import ar1_lg, ar1_ng
from .models.svm import svm
from .models.ssm import ssm_ulg, ssm_ung, ssm_mlg, ssm_mng, as_bssm
from .models.nlg import ssm_nlg
from .models.sde import ssm_sde, sde_gbm, sde_poisson_ou
from .models import examples as example_models
from .inference.mcmc import run_mcmc, McmcOutput
from .inference.filters import (kfilter, bootstrap_filter, particle_smoother,
                                ekf, ukf, ekf_smoother, ekf_fast_smoother,
                                ekpf_filter)
from .inference.smoothers import fast_smoother, smoother, sim_smoother
from .inference.approx import gaussian_approx
from .inference.loglik import logLik
from .inference.importance import importance_sample
from .inference.predict import predict, fitted
from .inference.postcorrect import post_correct, suggest_N
from .diagnostics.summary import (summary, check_diagnostics, iact,
                                  asymptotic_var, estimate_ess, ess_is, rhat,
                                  ess_bulk, ess_tail, rhat_rank)
from .parallel.mesh import make_mesh
