"""Branch-free stochastic sampling on counter-based PRNG keys.

The reference samples bounce directions with a rejection loop
(``random_in_unit_sphere``, src/sphere.c:19-24) then flips to the normal's
hemisphere (``random_on_hemisphere``, src/sphere.c:26-32). Rejection loops are
data-dependent control flow -- poison for XLA -- so we draw a 3-D standard
normal and normalize it, which yields the identical uniform-on-sphere
distribution in fixed time, then do the same sign flip.

All samplers take explicit ``jax.random`` keys: deterministic, splittable,
reproducible across hosts -- the batched replacement for the reference's
global ``rand()`` stream (``srand(time(NULL))``, src/main.c:90).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from tracer.core import vecmath


def uniform_on_sphere(key: Array, batch_shape=()) -> Array:
    """Uniform direction on the unit sphere, shape ``(*batch_shape, 3)``.

    Distribution-equivalent to the reference's rejection sampler
    (src/sphere.c:19-24) but branch-free and O(1).
    """
    v = jax.random.normal(key, (*batch_shape, 3), dtype=jnp.float32)
    # Guard the measure-zero all-zeros draw the same way the reference guards
    # ``vec3_dot(p,p) != 0`` -- fall back to +x.
    deg = vecmath.dot(v, v)[..., None] == 0.0
    v = jnp.where(deg, jnp.array([1.0, 0.0, 0.0], jnp.float32), v)
    return vecmath.normalize(v)


def uniform_on_hemisphere(key: Array, normal: Array) -> Array:
    """Uniform direction on the hemisphere around ``normal``.

    Matches ``random_on_hemisphere`` (src/sphere.c:26-32) including its edge
    case: a sample exactly perpendicular to the normal (dot == 0) is negated.
    ``normal`` has shape ``(..., 3)``; the batch shape is taken from it.
    """
    s = uniform_on_sphere(key, normal.shape[:-1])
    keep = vecmath.dot(s, normal) > 0.0
    return jnp.where(keep[..., None], s, -s)


def hemisphere_from_noise(noise: Array, normal: Array) -> Array:
    """Hemisphere sample from pre-drawn Gaussian ``noise (..., 3)`` -- the
    deterministic form used when noise is threaded in as an operand (for
    shard-invariant rendering; see integrator.bounce_noise)."""
    deg = vecmath.dot(noise, noise)[..., None] == 0.0
    v = jnp.where(deg, jnp.array([1.0, 0.0, 0.0], jnp.float32), noise)
    s = vecmath.normalize(v)
    keep = vecmath.dot(s, normal) > 0.0
    return jnp.where(keep[..., None], s, -s)
