"""Frozen dataclasses registered as JAX pytrees, with static fields.

``field(pytree_node=False)`` marks a trace-time constant (an observation
family code, a user model function): it belongs to the tree's structure,
not to its leaves, so jit retraces when it changes.  Instances are
immutable; ``spec.replace(**changes)`` returns a modified copy.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields
                     if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields
                     if not f.metadata.get("pytree_node", True)])
    cls.replace = dataclasses.replace
    return cls
