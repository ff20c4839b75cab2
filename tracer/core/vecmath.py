"""Batched 3-vector math over ``(..., 3)`` arrays.

Batched re-expression of the reference's scalar vec3 helpers
(``src/vec3.c:17-73``): every function is elementwise over arbitrary batch
dimensions with the vector components in the trailing axis, so the whole
wavefront of rays is one vectorized array op. No per-element loops anywhere.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def dot(a: Array, b: Array) -> Array:
    """Batched dot product; reference ``vec3_dot`` (src/vec3.c:25-27)."""
    return jnp.sum(a * b, axis=-1)


def length(a: Array) -> Array:
    """Euclidean norm; reference ``vec3_len`` (src/vec3.c:71-73)."""
    return jnp.sqrt(dot(a, a))


def normalize(a: Array) -> Array:
    """Normalize with the reference's zero-guard (src/vec3.c:20-23):
    a zero vector normalizes to zero, not NaN.

    Double-where form so the *backward* pass is NaN-free too: sqrt has an
    infinite derivative at 0, and a plain where() still backprops it."""
    d2 = dot(a, a)[..., None]
    zero = d2 == 0.0
    len_ = jnp.sqrt(jnp.where(zero, 1.0, d2))
    return jnp.where(zero, 0.0, a / len_)


def cross(a: Array, b: Array) -> Array:
    """Cross product; reference ``vec3_cross`` (src/vec3.c:37-43)."""
    return jnp.cross(a, b)


def reflect(v: Array, n: Array) -> Array:
    """Mirror reflection; reference ``vec3_reflect`` (src/vec3.c:46-49)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: Array, n: Array, etai_over_etat: Array) -> Array:
    """Snell refraction; reference ``vec3_refract`` (src/vec3.c:51-62).
    (Unused by the reference renderer but part of its public math API.)"""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)[..., None]
    r_out_perp = etai_over_etat * (uv + cos_theta * n)
    r_out_parallel = -jnp.sqrt(
        jnp.abs(1.0 - dot(r_out_perp, r_out_perp))
    )[..., None] * n
    return r_out_perp + r_out_parallel
