"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` makes a frozen dataclass whose fields are pytree
children, registered with ``jax.tree_util.register_dataclass``; a field
declared with ``struct.field(pytree_node=False)`` is static metadata
instead (part of the tree structure, so it must be hashable and is a
compile-time constant under ``jit``).  ``obj.replace(**changes)`` returns
a copy with fields swapped, as ``dataclasses.replace`` does.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` makes it static metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
