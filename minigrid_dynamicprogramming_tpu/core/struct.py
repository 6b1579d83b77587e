"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` makes a frozen dataclass and registers it with
``jax.tree_util.register_dataclass``: fields are pytree leaves unless
declared ``field(pytree_node=False)``, in which case they are static
metadata (part of the treedef, so they must be hashable).  Instances get a
``.replace(**changes)`` method.  Equality and hashing are the dataclass
defaults over all fields, so a dataclass whose fields are all static (for
example :class:`..core.state.EnvParams`) can be a ``jit`` static argument.
"""

from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(*, pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that records whether the field is a leaf."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    leaf = {
        f.name: f.metadata.get("pytree_node", True)
        for f in dataclasses.fields(cls)
    }
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[name for name, is_leaf in leaf.items() if is_leaf],
        meta_fields=[name for name, is_leaf in leaf.items() if not is_leaf],
    )
    cls.replace = dataclasses.replace
    return cls
