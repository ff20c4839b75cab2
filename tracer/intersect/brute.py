"""Brute-force closest hit over all spheres: the permanent correctness oracle.

Reference: the ``bvh == NULL`` path of ``trace_ray`` (src/renderer.c:36-44), a
per-ray linear scan. Here it is one dense (B, N) computation -- all rays vs
all spheres -- reduced with argmin. For small scenes this path is itself
fast; it doubles as the baseline side of the benchmark sweep
(src/benchmark.c:172-223).

Tie-breaking matches the reference: the scan keeps the first strictly-smaller
t (src/renderer.c:38-42), and jnp.argmin also returns the first minimum.
"""

from __future__ import annotations

import jax.numpy as jnp

from tracer.core.types import Ray, HitRecord
from tracer.intersect.sphere import ray_sphere_t, hit_record_from_t
from tracer.scene.scene import Scene


def nearest_hit_brute(rays: Ray, scene: Scene) -> HitRecord:
    """Closest hit for a wavefront of rays, O(B*N) dense.

    rays: batch shape (...,); returns a HitRecord with the same batch shape.
    """
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 1, 3)
    d = rays.direction.reshape(-1, 1, 3)
    t = ray_sphere_t(o, d, scene.centers[None, :, :], scene.radii[None, :])  # (B, N)
    idx = jnp.argmin(t, axis=-1).astype(jnp.int32)
    t_best = jnp.take_along_axis(t, idx[:, None], axis=-1)[:, 0]
    flat_rays = Ray(origin=o[:, 0, :], direction=d[:, 0, :])
    rec = hit_record_from_t(flat_rays, t_best, idx, scene.centers)
    return jtree_reshape(rec, batch_shape)


def jtree_reshape(rec: HitRecord, batch_shape) -> HitRecord:
    import jax

    def rs(x):
        return x.reshape(*batch_shape, *x.shape[1:])

    return jax.tree_util.tree_map(rs, rec)


def any_hit_brute(rays: Ray, scene: Scene, t_max) -> jnp.ndarray:
    """Occlusion oracle: True where ANY sphere blocks (EPSILON, t_max).

    The reference has no shadow rays (its renderer is bounce+sky only);
    this is the any-hit query BASELINE config 3 adds, defined as "a
    closest hit would exist with t < t_max" under the exact reference
    acceptance rule (src/hit.c:19-39). Dense O(B*N); the hierarchical
    path is tracer/kernels/leafcull.occluded_leafcull.
    """
    o = rays.origin.reshape(-1, 1, 3)
    d = rays.direction.reshape(-1, 1, 3)
    t = ray_sphere_t(o, d, scene.centers[None, :, :], scene.radii[None, :])
    occ = jnp.any(t < jnp.reshape(t_max, (-1, 1)), axis=-1)
    return occ.reshape(rays.batch_shape)


def brute_t_fast(o, d, centers, radii, block: int = 8192):
    """(t, idx) closest hit, dense O(B*N), scalar-decomposed.

    The small-scene path (tracer/intersect/select.py, "dense"): at a few
    thousand spheres the hierarchical pipeline's fixed cost (sort + bucket
    + cull tables) outweighs the work it saves. Differences vs
    :func:`nearest_hit_brute`:

      * per-sphere attributes are (1, N) rows (cx, cy, cz, r^2) and per-ray
        scalars (B', 1) columns, so every pairwise op is a (B', N)
        broadcast with no (B, N, 3) intermediates;
      * rays are processed in ``block``-row chunks under ``lax.map`` so
        peak temporaries stay ~block*N*4 bytes;
      * the quadratic is the leaf-cull intersector's u-form (u = oc.d +
        sqrt(disc), t = -u/a, the reference's near root, src/hit.c:19-39)
        with the same cross-product discriminant as ray_sphere_t.

    Tie-break: equal t => equal u; argmax returns the first maximal lane,
    matching the reference's first-strictly-smaller scan.
    """
    import jax

    cx, cy, cz = centers[:, 0][None], centers[:, 1][None], centers[:, 2][None]
    r2 = (radii * radii)[None]

    b = o.shape[0]
    pad = (-b) % block
    o2 = jnp.pad(o, ((0, pad), (0, 0)))
    d2 = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
    o3 = o2.reshape(-1, block, 3)
    d3 = d2.reshape(-1, block, 3)
    _BIG = 3.0e38

    def one(args):
        ob, db = args
        dx, dy, dz = db[:, 0:1], db[:, 1:2], db[:, 2:3]
        a = jnp.sum(db * db, axis=-1, keepdims=True)
        ocx, ocy, ocz = ob[:, 0:1] - cx, ob[:, 1:2] - cy, ob[:, 2:3] - cz
        bp = ocx * dx + ocy * dy + ocz * dz           # oc.d     (blk, N)
        crx = ocy * dz - ocz * dy                     # oc x d
        cry = ocz * dx - ocx * dz
        crz = ocx * dy - ocy * dx
        disc = a * r2 - (crx * crx + cry * cry + crz * crz)
        u = bp + jnp.sqrt(jnp.maximum(disc, 0.0))
        from tracer.intersect.sphere import EPSILON
        ok = (disc > 0.0) & (u < -EPSILON * a)
        uv = jnp.where(ok, u, -_BIG)
        ubest = jnp.max(uv, axis=1)
        idx = jnp.argmax(uv, axis=1).astype(jnp.int32)
        hit = ubest > -_BIG
        t = jnp.where(hit, -ubest / a[:, 0], jnp.inf)
        return t, jnp.where(hit, idx, -1)

    ts, idxs = jax.lax.map(one, (o3, d3))
    return ts.reshape(-1)[:b], idxs.reshape(-1)[:b]


def nearest_hit_brute_fast(rays: Ray, scene: Scene,
                           block: int = 8192) -> HitRecord:
    """HitRecord wrapper over :func:`brute_t_fast` (same contract as
    nearest_hit_brute; t recomputed from the winning id with the exact
    reference formulation so gradients flow like the kernel paths)."""
    batch_shape = rays.batch_shape
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    _, idx = brute_t_fast(o, d, scene.centers, scene.radii, block=block)
    safe = jnp.maximum(idx, 0)
    t = ray_sphere_t(o, d, scene.centers[safe], scene.radii[safe])
    t = jnp.where(idx >= 0, t, jnp.inf)
    rec = hit_record_from_t(Ray(origin=o, direction=d), t, idx,
                            scene.centers)
    return jtree_reshape(rec, batch_shape)
