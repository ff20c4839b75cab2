"""Wavefront path-tracing integrator.

The reference's recursive integrator (``trace_ray``, src/renderer.c:21-77)
computes, per pixel::

    radiance(d) = black                      if d == 0          (renderer.c:23-24)
    radiance(d) = base + 0.5 * radiance(d-1) on a hit           (renderer.c:56-58)
    radiance(d) = sky(dir.y)                 on a miss          (renderer.c:65-70)

Unrolled iteratively that is ``L = sum_k 0.5^k * albedo_k`` plus
``0.5^m * sky`` if the path escapes at bounce m -- a throughput form that maps
to a fixed-depth wavefront loop: every bounce is one batched nearest-hit over
the whole ray wavefront, then one batched shading/sampling step. No recursion,
no per-pixel control flow; masks carry ray liveness.

Color is float32 in [0,1] end-to-end. The reference accumulates in Uint8 and
its ``base + 0.5*reflected`` can overflow-wrap (renderer.c:56-58); we clamp at
the very end instead -- a documented fix, not a port of the bug (SURVEY.md 7).

The depth loop is a static Python unroll (max_depth is jit-static and small,
default 5): XLA sees 5 fused stages and can overlap gathers with compute
across bounces.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import Array

from tracer.config import TracerConfig, DEFAULT_CONFIG
from tracer.core import sampling
from tracer.core.types import Ray, HitRecord
from tracer.scene.camera import Camera, camera_rays
from tracer.scene.scene import Scene
from tracer.core import pytree

# Reference sky gradient endpoints (src/renderer.c:65-70), in [0,1] scale.
_SKY_HORIZON = (1.0, 1.0, 1.0)
_SKY_ZENITH = (128.0 / 255.0, 178.0 / 255.0, 1.0)

NearestHitFn = Callable[[Ray], HitRecord]


def sky_color(direction: Array) -> Array:
    """Sky gradient keyed to direction.y (src/renderer.c:65-70):
    t = 0.5*(dir.y + 1); white at the horizon, light blue at the zenith."""
    t = 0.5 * (direction[..., 1] + 1.0)
    a = jnp.array(_SKY_HORIZON, jnp.float32)
    b = jnp.array(_SKY_ZENITH, jnp.float32)
    return (1.0 - t[..., None]) * a + t[..., None] * b


def bounce_noise(key: Array, batch_shape, max_depth: int) -> Array:
    """Pre-drawn Gaussian bounce noise, shape (max_depth-1, *batch, 3).

    Drawing the noise *outside* the integrator makes sharded rendering
    bitwise-identical to single-device rendering: the noise array shards
    along the ray axes like any other operand, whereas in-loop
    ``jax.random.normal(key, shard_shape)`` would draw different values per
    shard (counter-based PRNG is shape-dependent)."""
    if max_depth <= 1:
        return jnp.zeros((0, *batch_shape, 3), jnp.float32)
    return jax.random.normal(key, (max_depth - 1, *batch_shape, 3), jnp.float32)


def _compact_rays(rays: Ray, active: Array):
    """Wavefront compaction permutation for one bounce (SURVEY.md section 2
    row 7): reorder the flat wavefront so dead rays pack into contiguous
    trailing subpackets and live rays cluster by direction.

    Dead lanes are *parked* (origin far outside every scene, +x direction):
    the frustum cull then assigns their subpackets empty candidate lists and
    the adaptive kernels skip them in O(1), which is the static-shape
    analog of shrinking the batch. Returns (rays', inverse_permutation).
    """
    from tracer.core.sort import direction_morton_codes
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    a = active.reshape(-1)
    code = direction_morton_codes(d).astype(jnp.uint32)
    # dead bit above the 24 morton bits -> dead rays sort to the tail.
    key = jnp.where(a, code, jnp.uint32(1 << 25) | code)
    perm = jnp.argsort(key)
    inv = jnp.argsort(perm)
    ap = a[perm]
    park_o = jnp.full((1, 3), 1.0e18, jnp.float32)
    park_d = jnp.array([[1.0, 0.0, 0.0]], jnp.float32)
    return Ray(origin=jnp.where(ap[:, None], o[perm], park_o),
               direction=jnp.where(ap[:, None], d[perm], park_d)), inv


def trace_radiance(nearest_hit: NearestHitFn, scene: Scene, rays: Ray,
                   key: Array = None, max_depth: int = 5,
                   noise: Array = None, compact: bool = False) -> Array:
    """Radiance for a wavefront of rays; batch shape (...,) -> (..., 3).

    ``nearest_hit`` is pluggable: brute force (the oracle) or BVH traversal.
    Matches the reference semantics in float space (see module docstring).
    Bounce directions come from ``noise`` (see :func:`bounce_noise`) if given,
    else are drawn from ``key`` per bounce. ``compact=True`` re-sorts the
    wavefront between bounces (see :func:`_compact_rays`); results are
    unchanged, bounce cost tracks the live-ray count.
    """
    batch_shape = rays.batch_shape
    radiance = jnp.zeros((*batch_shape, 3), jnp.float32)
    throughput = jnp.ones(batch_shape, jnp.float32)
    active = jnp.ones(batch_shape, dtype=bool)

    for bounce in range(max_depth):
        if compact and bounce > 0:
            crays, inv = _compact_rays(rays, active)
            rec = nearest_hit(crays)
            rec = jax.tree_util.tree_map(
                lambda x: x[inv].reshape(*batch_shape, *x.shape[1:]), rec)
            rec = rec.replace(hit=rec.hit & active,
                              index=jnp.where(active, rec.index, -1))
        else:
            rec = nearest_hit(rays)
        hit_now = active & rec.hit
        miss_now = active & ~rec.hit

        albedo = scene.albedo[jnp.maximum(rec.index, 0)]  # (..., 3)
        radiance = radiance + jnp.where(
            hit_now[..., None], throughput[..., None] * albedo, 0.0)
        radiance = radiance + jnp.where(
            miss_now[..., None],
            throughput[..., None] * sky_color(rays.direction), 0.0)

        active = hit_now
        throughput = throughput * 0.5

        if bounce + 1 < max_depth:
            if noise is not None:
                new_dir = sampling.hemisphere_from_noise(noise[bounce], rec.normal)
            else:
                key, sub = jax.random.split(key)
                new_dir = sampling.uniform_on_hemisphere(sub, rec.normal)
            # Bounce ray starts exactly at the hit point (renderer.c:54); the
            # t > EPSILON acceptance plays the role of the self-hit offset.
            rays = Ray(origin=rec.point, direction=new_dir)

    # Paths still alive after max_depth bounces contribute black
    # (renderer.c:23-24): nothing to add.
    return radiance


def render(scene: Scene, camera: Camera, key: Array,
           nearest_hit_for: Callable[[Scene], NearestHitFn],
           config: TracerConfig = DEFAULT_CONFIG, noise: Array = None,
           compact: bool = False) -> Array:
    """One frame: (H, W, 3) float32 radiance in [0,1] (clamped).

    The whole frame is a single wavefront; this is the jit unit replacing the
    per-pixel loop at src/main.c:358-374.
    """
    rays = camera_rays(camera, config)
    nearest = nearest_hit_for(scene)
    img = trace_radiance(nearest, scene, rays, key, config.max_depth,
                         noise=noise, compact=compact)
    return jnp.clip(img, 0.0, 1.0)


OccludedFn = Callable[[Ray, Array], Array]


def trace_direct(nearest_hit: NearestHitFn, occluded: OccludedFn,
                 scene: Scene, rays: Ray, light_pos: Array,
                 light_intensity: float = 1.0, ambient: float = 0.1,
                 compact: bool = False) -> Array:
    """Primary + shadow rays (BASELINE config 3); batch (...,) -> (..., 3).

    One wavefront closest-hit for the primary rays, then one wavefront
    ANY-HIT query along the segments hit-point -> point light, then a
    Lambertian direct term::

        L = albedo * (ambient + intensity * visible * max(0, n.l))

    on hits, sky on misses. The reference has no lights or shadows (its
    trace_ray is bounce+sky only, src/renderer.c:21-77); the sky/albedo
    conventions here match its float semantics, the shadow query is the
    config-3 extension. Shadow segments use the UNNORMALIZED direction
    (light - point) with t_max = 1, so one any-hit covers exactly the
    segment; the reference t > EPSILON acceptance doubles as the self-hit
    offset. ``compact=True`` re-sorts the shadow wavefront so rays from
    miss pixels park into empty subpackets (same scheme as
    :func:`_compact_rays`).
    """
    batch_shape = rays.batch_shape
    rec = nearest_hit(rays)

    to_light = light_pos - rec.point                       # (..., 3)
    tmax = jnp.ones(batch_shape, jnp.float32)
    srays = Ray(origin=rec.point, direction=to_light)
    if compact:
        crays, inv = _compact_rays(srays, rec.hit)
        occ = occluded(crays, tmax.reshape(-1))
        occ = occ.reshape(-1)[inv].reshape(batch_shape)
    else:
        occ = occluded(srays, tmax)

    dist = jnp.linalg.norm(to_light, axis=-1, keepdims=True)
    l = to_light / jnp.maximum(dist, 1e-12)
    ndotl = jnp.maximum(jnp.sum(rec.normal * l, axis=-1), 0.0)
    vis = jnp.where(rec.hit & ~occ, ndotl, 0.0)

    albedo = scene.albedo[jnp.maximum(rec.index, 0)]
    lit = albedo * (ambient + light_intensity * vis)[..., None]
    return jnp.where(rec.hit[..., None], lit, sky_color(rays.direction))


def render_direct(scene: Scene, camera: Camera, light_pos,
                  nearest_hit_for: Callable[[Scene], NearestHitFn],
                  occluded_for: Callable[[Scene], OccludedFn],
                  config: TracerConfig = DEFAULT_CONFIG,
                  light_intensity: float = 1.0, ambient: float = 0.1,
                  compact: bool = False) -> Array:
    """One direct-lit frame: (H, W, 3) float32 in [0,1] (clamped)."""
    rays = camera_rays(camera, config)
    img = trace_direct(nearest_hit_for(scene), occluded_for(scene), scene,
                       rays, jnp.asarray(light_pos, jnp.float32),
                       light_intensity=light_intensity, ambient=ambient,
                       compact=compact)
    return jnp.clip(img, 0.0, 1.0)


@pytree.dataclass
class Accumulator:
    """Temporal accumulation state: running sum + frame count.

    Replaces the reference's accumulated_colors buffer and its reset-on-move /
    average-while-static logic (src/main.c:241-273, 376-408). Functional: each
    frame returns a new state; ``mean`` is the display image.
    """

    total: Array   # (H, W, 3) f32 running sum
    frames: Array  # () i32

    @classmethod
    def zero(cls, height: int, width: int) -> "Accumulator":
        return cls(total=jnp.zeros((height, width, 3), jnp.float32),
                   frames=jnp.int32(0))

    def add(self, frame: Array) -> "Accumulator":
        return Accumulator(total=self.total + frame, frames=self.frames + 1)

    def reset_to(self, frame: Array) -> "Accumulator":
        """Camera moved: restart accumulation from this frame (main.c:376-380)."""
        return Accumulator(total=frame, frames=jnp.int32(1))

    @property
    def mean(self) -> Array:
        n = jnp.maximum(self.frames, 1).astype(jnp.float32)
        return jnp.clip(self.total / n, 0.0, 1.0)
