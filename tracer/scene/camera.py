"""Differentiable pinhole fly-camera and vectorized primary-ray generation.

The reference stores a precomputed basis in the camera struct and rebuilds it
imperatively on input (``camera_update``, src/camera.c:10-18). Here the camera
is a minimal pytree ``{position, yaw, pitch, fov}`` and the basis is derived
*functionally* inside ray generation, so ``d(image)/d(camera pose)`` flows by
plain autodiff -- a requirement of the inverse-rendering path.

Ray generation produces the whole W x H wavefront in one broadcasted op: the
batched replacement for the per-pixel double loop at src/main.c:358-374.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from tracer.config import TracerConfig, DEFAULT_CONFIG
from tracer.core import vecmath
from tracer.core.types import Ray
from tracer.core import pytree

_WORLD_UP = (0.0, 1.0, 0.0)


@pytree.dataclass
class Camera:
    """Fly-camera pose; all fields are differentiable scalars/vectors.

    Defaults are the reference's interactive-mode camera (src/main.c:203-211):
    position (0,4,50), yaw -pi, pitch 0, fov 45 deg (which looks down -z).
    """

    position: Array  # (3,) f32
    yaw: Array       # () f32, radians
    pitch: Array     # () f32, radians
    fov: Array       # () f32, degrees

    @classmethod
    def default(cls) -> "Camera":
        return cls(
            position=jnp.array([0.0, 4.0, 50.0], jnp.float32),
            yaw=jnp.float32(-jnp.pi),
            pitch=jnp.float32(0.0),
            fov=jnp.float32(45.0),
        )

    def basis(self):
        """(forward, right, up) orthonormal basis from yaw/pitch.

        Matches ``camera_update`` (src/camera.c:10-18): forward from spherical
        coords, right = normalize(forward x world_up)... note the reference
        computes ``cross(forward, (0,1,0))`` which we reproduce exactly.
        """
        forward = jnp.stack([
            jnp.cos(self.pitch) * jnp.sin(self.yaw),
            jnp.sin(self.pitch),
            jnp.cos(self.pitch) * jnp.cos(self.yaw),
        ]).astype(jnp.float32)
        forward = vecmath.normalize(forward)
        right = vecmath.normalize(vecmath.cross(forward, jnp.array(_WORLD_UP, jnp.float32)))
        up = vecmath.normalize(vecmath.cross(right, forward))
        return forward, right, up


def pixel_uv(config: TracerConfig = DEFAULT_CONFIG):
    """(u, v) screen coordinates for every pixel, each shape (H, W).

    Reproduces the pixel loop mapping at src/main.c:362-365:
      u = (x / W - 0.5) * aspect      (the first of the two aspect applications)
      v = -(y / H - 0.5)              (the loop passes -v to get_camera_ray)
    With ``double_aspect_compat=False`` the aspect factor here is dropped
    (get_camera_ray already applies it once via half_width, src/ray.c:21-23).
    """
    x = jnp.arange(config.width, dtype=jnp.float32)
    y = jnp.arange(config.height, dtype=jnp.float32)
    u = x / config.width - 0.5
    if config.double_aspect_compat:
        u = u * config.aspect_ratio
    v = -(y / config.height - 0.5)
    uu, vv = jnp.meshgrid(u, v, indexing="xy")  # (H, W) each
    return uu, vv


def camera_rays(camera: Camera, config: TracerConfig = DEFAULT_CONFIG,
                uv=None) -> Ray:
    """All primary rays for the frame as one ``Ray`` with batch shape (H, W).

    Matches ``get_camera_ray`` (src/ray.c:17-32): direction =
    normalize(forward + right * 2*half_width*u + up * 2*half_height*v) with
    half_height = tan(fov/2), half_width = aspect * half_height.
    """
    forward, right, up = camera.basis()
    fov_rad = camera.fov * (jnp.pi / 180.0)
    half_height = jnp.tan(fov_rad / 2.0)
    half_width = config.aspect_ratio * half_height

    if uv is None:
        u, v = pixel_uv(config)
    else:
        u, v = uv
    direction = (
        forward
        + (2.0 * half_width) * u[..., None] * right
        + (2.0 * half_height) * v[..., None] * up
    )
    direction = vecmath.normalize(direction)
    origin = jnp.broadcast_to(camera.position, direction.shape)
    return Ray(origin=origin, direction=direction)
