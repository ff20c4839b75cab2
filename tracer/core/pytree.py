"""Frozen dataclasses registered as JAX pytrees.

``@pytree.dataclass`` turns a class into a frozen dataclass whose fields are
pytree leaves, except fields declared with ``pytree.field(static=True)``:
those are hashed into the treedef, so they are compile-time constants under
``jax.jit`` (leaf sizes, counts). Instances get ``.replace(**changes)``.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """``dataclasses.field`` plus ``static``: keep the value out of the
    pytree leaves (it becomes part of the treedef)."""
    metadata = dict(kwargs.pop("metadata", None) or {}, static=static)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + ``jax.tree_util.register_dataclass``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (meta if f.metadata.get("static", False) else data).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
