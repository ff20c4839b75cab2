"""Core pytree dataclasses: rays and hit records.

The reference's ``Ray {origin, direction}`` (include/Custom/ray.h:5-8) and
``HitRecord {t, point, normal, hit_something, object*}`` (include/Custom/hit.h:8-14)
become struct-of-arrays pytrees over arbitrary batch shapes: one ``Ray`` value
holds a whole wavefront. The object pointer becomes an int32 sphere index
(-1 on miss) so hit records are dense arrays that shard/vmap cleanly.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array
from tracer.core import pytree


@pytree.dataclass
class Ray:
    """A batch of rays; fields have shape ``(..., 3)``."""

    origin: Array
    direction: Array

    @property
    def batch_shape(self):
        return self.origin.shape[:-1]

    def at(self, t: Array) -> Array:
        """Point along the ray: ``origin + t * direction``."""
        return self.origin + t[..., None] * self.direction


@pytree.dataclass
class HitRecord:
    """A batch of closest-hit results; batch shape ``(...,)``.

    ``t`` is +inf on miss; ``index`` is the sphere index into the scene arrays
    (-1 on miss); ``hit`` is the boolean mask. ``point``/``normal`` are only
    meaningful where ``hit`` is True.
    """

    t: Array            # (...,) f32, +inf on miss
    index: Array        # (...,)  i32, -1 on miss
    hit: Array          # (...,)  bool
    point: Array        # (..., 3) f32
    normal: Array       # (..., 3) f32

    @classmethod
    def miss(cls, batch_shape) -> "HitRecord":
        return cls(
            t=jnp.full(batch_shape, jnp.inf, dtype=jnp.float32),
            index=jnp.full(batch_shape, -1, dtype=jnp.int32),
            hit=jnp.zeros(batch_shape, dtype=bool),
            point=jnp.zeros((*batch_shape, 3), dtype=jnp.float32),
            normal=jnp.zeros((*batch_shape, 3), dtype=jnp.float32),
        )
