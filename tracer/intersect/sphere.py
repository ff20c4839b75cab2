"""Vectorized ray-sphere intersection with the reference's exact semantics.

Reference: ``ray_sphere_intersect`` (src/hit.c:19-39). Its acceptance rule
is kept (it shapes secondary-bounce behavior, SURVEY.md 3.4):
  - quadratic a = d.d, b = 2 oc.d, c = oc.oc - r^2; disc = b^2 - 4ac
  - accept only when disc > 0 (grazing disc == 0 is a miss)
  - only the NEAR root t = (-b - sqrt(disc)) / 2a is considered; a ray starting
    inside a sphere therefore misses it
  - accept only t > EPSILON (1e-6)
The discriminant is evaluated as disc/4 = a r^2 - |oc x d|^2 (Lagrange's
identity), not as b^2 - 4ac: with |oc| ~ 500 and r = 0.5 (the benchmark
world) the reference form cancels two ~2.5e5 terms and leaves an f32
rounding band of ~0.04 around disc = 0 against r^2 = 0.25, so the hit/miss
decision on ~1/6 of a sphere's silhouette area was rounding noise. The
cross-product form keeps disc to ~1e-4 there, and every intersector in the
repo (brute force, dense sweep, leaf-cull kernel and its plain version)
uses it, so they agree on grazes.

Instead of an early-return struct, the batched form returns t with +inf on
miss, which composes with min-reductions across spheres, BVH leaves, and
device shards.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from tracer.core import vecmath
from tracer.core.types import Ray, HitRecord

EPSILON = 1e-6  # include/Custom/constants.h:6


def ray_sphere_t(origin: Array, direction: Array, center: Array,
                 radius: Array, eps: float = EPSILON) -> Array:
    """Hit distance t, +inf on miss. Broadcasts over any batch shape:
    origin/direction ``(..., 3)`` against center ``(..., 3)``/radius ``(...,)``.
    """
    oc = origin - center
    a = vecmath.dot(direction, direction)
    bh = vecmath.dot(oc, direction)                     # b / 2
    cr = vecmath.cross(oc, direction)
    disc = a * (radius * radius) - vecmath.dot(cr, cr)  # (b^2 - 4ac) / 4
    # Safe sqrt: miss lanes (disc <= 0) substitute 1.0 under the sqrt so the
    # backward pass sees a finite local derivative there (0.5/sqrt(0) = inf
    # would turn the masked-out 0 cotangent into NaN); valid lanes are
    # untouched (src/hit.c:25-31).
    # max(a, tiny) guards a degenerate zero-direction ray (reference would
    # divide by zero -> inf/nan miss).
    pos = disc > 0.0
    t = (-bh - jnp.sqrt(jnp.where(pos, disc, 1.0))) / jnp.maximum(a, 1e-30)
    valid = pos & (t > eps)
    return jnp.where(valid, t, jnp.inf)


def hit_record_from_t(rays: Ray, t: Array, index: Array, centers: Array) -> HitRecord:
    """Assemble a full HitRecord from per-ray (t, sphere index).

    point/normal per src/hit.c:32-34: point = o + t*d, normal =
    normalize(point - center). Uses a gather of the hit sphere's center;
    gradients flow to ``centers`` through the gather.
    """
    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    point = rays.at(t_safe)
    center = centers[jnp.maximum(index, 0)]
    normal = vecmath.normalize(point - center)
    return HitRecord(
        t=jnp.where(hit, t, jnp.inf),
        index=jnp.where(hit, index, -1),
        hit=hit,
        point=point,
        normal=jnp.where(hit[..., None], normal, 0.0),
    )
