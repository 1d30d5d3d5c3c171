"""Multi-process bootstrap: jax.distributed + a global (chains x draws) mesh.

The reference's parallelism stops at single-node OpenMP
(`reference/src/approx_mcmc.cpp:364-368`); here the same sharded
programs run over a mesh of every process's GPUs.  Chains and
IS-correction draws are independent, so the only cross-device traffic is
the final weighted-moment reduction.

Typical SPMD launch (one process per host, each with its local GPUs):

    from bssm_tpu.parallel.distributed import initialize, global_mesh
    initialize()                       # no-op on a single process
    mesh = global_mesh(("chains", "draws"))
    out = run_mcmc(model, ..., n_chains=8192, mesh=mesh)

Nothing detects a cluster: the coordinator address, process count and
process id come from the arguments or the ``JAX_*`` environment variables.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Initialise jax.distributed when running multi-process.

    Arguments default from the standard env vars
    (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID``).  Returns True when a multi-process runtime was
    initialised, False for the single-process fast path (nothing to do).
    """
    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else \
        int(os.environ.get("JAX_NUM_PROCESSES", "0") or 0)
    pid = process_id if process_id is not None else \
        int(os.environ.get("JAX_PROCESS_ID", "-1") or -1)
    if coordinator_address is not None and nproc in (0, 1):
        # an explicit coordinator with no process count would silently run
        # every host standalone (duplicated chains, clashing checkpoints)
        raise ValueError(
            "initialize(coordinator_address=...) needs num_processes (and "
            "process_id) or the JAX_NUM_PROCESSES/JAX_PROCESS_ID env vars")
    if not addr or nproc in (0, 1):
        return False
    kwargs = {"coordinator_address": addr, "num_processes": nproc}
    if pid >= 0:
        kwargs["process_id"] = pid
    jax.distributed.initialize(**kwargs)
    return True


def global_mesh(axes: Sequence[str] = ("chains", "draws"),
                shape: Optional[Sequence[int]] = None) -> "jax.sharding.Mesh":
    """A mesh over ALL global devices (every host's GPUs).

    With no ``shape``, all devices go on the first axis.  Prefer putting the
    host boundary on the "chains" axis: chains never communicate, so the
    link between hosts carries no hot-loop traffic.
    """
    from .mesh import make_mesh
    import numpy as np
    from jax.sharding import Mesh

    devs = jax.devices()               # global across processes
    if shape is None:
        return make_mesh(len(devs), axes=axes)
    arr = np.array(devs).reshape(tuple(shape))
    return Mesh(arr, tuple(axes))


def local_chain_slice(n_chains: int) -> slice:
    """The [start, stop) block of a global chain axis owned by this process
    (for host-side data loading / checkpoint writes)."""
    p = jax.process_index()
    np_ = jax.process_count()
    per = -(-n_chains // np_)
    return slice(p * per, min((p + 1) * per, n_chains))
