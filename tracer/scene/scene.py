"""Struct-of-arrays scene representation and scene factories.

The reference's ``Sphere {Vec3 center; float radius; SDL_Color color}``
(include/Custom/sphere.h:7-11) array-of-structs becomes three dense arrays in
HBM -- ``centers (N,3)``, ``radii (N,)``, ``albedo (N,3)`` -- which are also the
differentiable parameters of the framework (inverse rendering optimizes them
directly). Color is float in [0,1] end-to-end; the reference's SDL_Color
leak into the scene layer (SURVEY.md section 1) is deliberately not repeated.

Factories mirror the reference's three constructors:
  - ``fixed_scene``      <- ``create_sphere``           (src/sphere.c:43-50)
  - ``random_scene``     <- ``create_random_sphere``    (src/sphere.c:52-59)
  - ``benchmark_scene``  <- ``create_benchmark_sphere`` + the benchmark sweep's
                            placement (src/sphere.c:34-41, src/benchmark.c:306-314)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array
from tracer.core import pytree


@pytree.dataclass
class Scene:
    """SoA sphere scene; the differentiable parameter pytree.

    centers: (N, 3) float32
    radii:   (N,)   float32
    albedo:  (N, 3) float32 in [0, 1]
    """

    centers: Array
    radii: Array
    albedo: Array

    @property
    def num_spheres(self) -> int:
        return self.centers.shape[0]


def fixed_scene(centers, radii, albedo=None) -> Scene:
    """Scene from explicit arrays; reference ``create_sphere`` (src/sphere.c:43-50)
    which zero-initializes color."""
    centers = jnp.asarray(centers, jnp.float32).reshape(-1, 3)
    radii = jnp.asarray(radii, jnp.float32).reshape(-1)
    if albedo is None:
        albedo = jnp.zeros_like(centers)
    else:
        albedo = jnp.asarray(albedo, jnp.float32).reshape(-1, 3)
    return Scene(centers=centers, radii=radii, albedo=albedo)


def random_scene(key: Array, n: int = 20) -> Scene:
    """The interactive-mode scene: n random spheres with the reference's
    distribution (src/sphere.c:52-59, defaults from src/main.c:18,218-221):
    center x in [-40,40], y in [-20,20], z in [-10,5]; radius in [0.5,5];
    albedo uniform (reference: ``rand()%256`` per channel / 255)."""
    kc, kr, ka = jax.random.split(key, 3)
    lo = jnp.array([-40.0, -20.0, -10.0], jnp.float32)
    hi = jnp.array([40.0, 20.0, 5.0], jnp.float32)
    centers = jax.random.uniform(kc, (n, 3), jnp.float32, 0.0, 1.0) * (hi - lo) + lo
    radii = jax.random.uniform(kr, (n,), jnp.float32, 0.5, 5.0)
    albedo = jax.random.uniform(ka, (n, 3), jnp.float32, 0.0, 1.0)
    return Scene(centers=centers, radii=radii, albedo=albedo)


def benchmark_scene(key: Array, n: int, world_size: float = 1000.0,
                    radius: float = 0.5) -> Scene:
    """The benchmark sweep's scene: n spheres of fixed radius placed uniformly
    in a centered cube of side ``world_size`` (src/benchmark.c:306-314 places
    centers in [-world/2, world/2]^3; radius 0.5 from src/sphere.c:34-41)."""
    kc, ka = jax.random.split(key)
    half = world_size / 2.0
    centers = jax.random.uniform(kc, (n, 3), jnp.float32, -half, half)
    radii = jnp.full((n,), radius, jnp.float32)
    albedo = jax.random.uniform(ka, (n, 3), jnp.float32, 0.0, 1.0)
    return Scene(centers=centers, radii=radii, albedo=albedo)
