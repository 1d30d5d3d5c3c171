"""Sharded-chain tests on the virtual 8-device CPU mesh."""
import numpy as np

import jax

from bssm_tpu.core.priors import halfnormal_prior, uniform_prior
from bssm_tpu.inference.mcmc import run_mcmc
from bssm_tpu.models.ar1 import ar1_ng
from bssm_tpu.models.bsm import bsm_lg
from bssm_tpu.parallel.mesh import make_mesh


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8


def test_sharded_gaussian_chains(rng):
    n = 40
    y = np.cumsum(rng.normal(0, 0.3, n)) + rng.normal(0, 1.0, n)
    model = bsm_lg(y, sd_y=halfnormal_prior(1.0, 5.0),
                   sd_level=halfnormal_prior(0.3, 5.0))
    mesh = make_mesh(8, axes=("chains", "draws"), shape=(8, 1))
    out = run_mcmc(model, iter=500, seed=1, output_type="theta",
                   n_chains=16, mesh=mesh)
    assert out.theta.shape[0] == 16
    assert np.all(np.isfinite(out.theta))


def test_sharded_is2_correction(rng):
    n = 24
    alpha = np.zeros(n)
    for t in range(1, n):
        alpha[t] = 0.7 * alpha[t - 1] + 0.4 * rng.normal()
    y = rng.poisson(np.exp(alpha)).astype(float)
    model = ar1_ng(y, rho=uniform_prior(0.6, -0.99, 0.99),
                   sigma=halfnormal_prior(0.4, 1.0),
                   distribution="poisson")
    mesh = make_mesh(8, axes=("chains", "draws"), shape=(4, 2))
    out = run_mcmc(model, iter=400, particles=8, mcmc_type="is2", seed=5,
                   output_type="summary", n_chains=4, mesh=mesh,
                   corr_batch=64)
    assert np.all(np.isfinite(out.posterior))
    assert np.all(out.flat_weights() > 0)
    assert out.alphahat is not None and np.all(np.isfinite(out.alphahat))


def test_sharded_is2_equals_unsharded(rng):
    """mesh-sharded is2 reproduces the unsharded run at identical keys —
    the correction is embarrassingly parallel, so sharding must be a pure
    placement decision (`/root/reference/src/approx_mcmc.cpp:364-368`)."""
    n = 20
    y = rng.poisson(np.exp(np.cumsum(rng.normal(0, 0.2, n)))).astype(float)
    model = ar1_ng(y, rho=uniform_prior(0.6, -0.99, 0.99),
                   sigma=halfnormal_prior(0.4, 1.0),
                   distribution="poisson")
    mesh = make_mesh(8, axes=("chains", "draws"), shape=(4, 2))
    kw = dict(iter=200, particles=4, mcmc_type="is2", seed=5,
              output_type="summary", n_chains=4, corr_batch=64)
    sharded = run_mcmc(model, mesh=mesh, **kw)
    plain = run_mcmc(model, mesh=None, **kw)
    np.testing.assert_allclose(sharded.theta, plain.theta, rtol=1e-12)
    np.testing.assert_allclose(sharded.posterior, plain.posterior,
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(sharded.alphahat, plain.alphahat,
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(sharded.Vt, plain.Vt, rtol=1e-7, atol=1e-9)


def test_distributed_helpers_single_process():
    """initialize() is a no-op single-process; global_mesh covers all
    devices; local_chain_slice owns the whole axis; an explicit coordinator
    without a process count raises instead of silently running standalone."""
    from bssm_tpu.parallel.distributed import (global_mesh, initialize,
                                               local_chain_slice)
    assert initialize() is False
    mesh = global_mesh(("chains", "draws"), shape=(4, 2))
    assert dict(mesh.shape) == {"chains": 4, "draws": 2}
    assert local_chain_slice(100) == slice(0, 100)
    import pytest
    with pytest.raises(ValueError):
        initialize(coordinator_address="10.0.0.1:1234")


def test_two_process_distributed():
    """Two REAL processes + a coordinator: each
    owns 4 virtual CPU devices; the global 8-device chains mesh runs the
    production sharded programs (gaussian RAM chains, is2 psi correction)
    and every process asserts its addressable shards equal the unsharded
    single-process reference.  Exercises
    `parallel/distributed.py:initialize` across a process boundary."""
    import os
    import socket
    import subprocess
    import sys as _sys
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__),
                          "distributed_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen([_sys.executable, worker, str(port), str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert f"OK process {i}" in out
