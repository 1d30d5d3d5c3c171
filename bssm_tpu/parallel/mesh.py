"""Device-mesh utilities: chain- and draw-parallel sharding.

The reference's only parallelism is single-node OpenMP over stored draws
(`reference/src/approx_mcmc.cpp:364-368`).  This design
(SURVEY.md §2.3, §5.8) shards

  - phase 1: independent RAM chains over the whole mesh (axis "chains"),
  - phase 2: the IS post-correction over the product mesh
    ("chains" x "draws") — thousands of independent psi-APF runs,

with XLA inserting the collectives; weighted-moment reductions are plain
`jnp` reductions over sharded axes (psum under the hood).
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("chains", "draws"),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    With no ``shape``, all devices go on the first axis and the rest are 1.
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = (n_devices,) + (1,) * (len(axes) - 1)
    arr = np.array(devs).reshape(tuple(shape))
    return Mesh(arr, tuple(axes))


def chains_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading chain axis over the first ("chains") mesh axis."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def flat_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a flattened (chains*draws) axis over the full mesh."""
    return NamedSharding(mesh, P(mesh.axis_names))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def pad_to_multiple(x, mult: int, axis: int = 0):
    """Pad axis length up to a multiple (for even sharding); returns
    (padded, original_len)."""
    import jax.numpy as jnp
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths, mode="edge"), n
