"""The intersector selector: which closest-hit / any-hit path a scene gets.

Every entry point (CLI, benchmark harness, ``bench.py``, ``chip_smoke.py``)
resolves its intersector here, so the choice is made once:

  * ``"dense"``: at most ``DENSE_LIMIT`` spheres, the dense all-pairs sweep
    (``brute_t_fast``); the hierarchical pipeline's fixed cost (sort,
    tables, phase A) outweighs what it saves on small scenes.
  * ``"leafcull_triton"`` / ``"leafcull_xla"``: the hierarchical
    leaf-cull path (tracer/kernels/leafcull.py) with phase B as the
    Triton-route kernel or as its plain XLA version.

The platform enters in exactly one place, :func:`hierarchical_impl`: the
GPU runs the kernel, every other backend the plain version.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

DENSE_LIMIT = 4000              # spheres; at or below, the dense sweep
DEVICE_BUILD_MIN_N = 5_000_000  # spheres; at or above, the device LBVH
LEAF_SIZE = 32                  # leaf size of the hierarchical path


def hierarchical_impl(platform: str | None = None) -> str:
    """Phase-B implementation for ``platform`` (default: JAX's backend)."""
    platform = platform or jax.default_backend()
    return "triton" if platform == "gpu" else "xla"


def choose_path(n_spheres: int, platform: str | None = None,
                dense_limit: int = DENSE_LIMIT) -> str:
    if n_spheres <= dense_limit:
        return "dense"
    return "leafcull_" + hierarchical_impl(platform)


def build_bvh_for(scene, leaf_size: int = LEAF_SIZE,
                  device_build_min_n: int = DEVICE_BUILD_MIN_N,
                  near_point=None):
    """(bvh, info): host binned-SAH build below ``device_build_min_n``
    spheres, the on-device LBVH at or above it."""
    n = int(scene.centers.shape[0])
    if n >= device_build_min_n:
        from tracer.bvh.device import build_bvh_device
        build = jax.jit(lambda c, r: build_bvh_device(c, r,
                                                      leaf_size=leaf_size))
        jax.block_until_ready(build(scene.centers, scene.radii))  # compile
        t0 = time.perf_counter()
        bvh = jax.block_until_ready(build(scene.centers, scene.radii))
        kind = "device_lbvh"
    else:
        from tracer.bvh.builder import build_bvh
        centers = np.asarray(scene.centers)
        radii = np.asarray(scene.radii)
        t0 = time.perf_counter()
        bvh = build_bvh(centers, radii, leaf_size=leaf_size,
                        near_point=near_point)
        kind = "host_sah"
    return bvh, {"bvh_build": kind,
                 "bvh_build_ms": (time.perf_counter() - t0) * 1e3}


@dataclasses.dataclass(frozen=True)
class Intersector:
    """``nearest_for(scene) -> (rays -> HitRecord)`` and
    ``occluded_for(scene) -> ((rays, t_max) -> bool)``, the factories the
    integrator takes, plus ``path`` (the implementation that runs), build
    info, and the hierarchical path's cull tables (None otherwise)."""

    path: str
    nearest_for: Callable
    occluded_for: Callable
    info: dict
    tables: object = None


def make_intersector(scene, path: str | None = None,
                     near_point=None) -> Intersector:
    """Intersector for ``scene`` on ``path`` (default: :func:`choose_path`).

    The hierarchical path builds its BVH and cull tables here and queries
    them with the default phase-A budgets, which no subpacket can overflow
    at any scene size (tracer/kernels/leafcull.py ``default_budgets``).
    """
    from tracer.intersect.brute import brute_t_fast, nearest_hit_brute_fast

    n = int(scene.centers.shape[0])
    path = path or choose_path(n)
    if path == "dense":
        def occluded_dense(s):
            def f(rays, t_max):
                o = rays.origin.reshape(-1, 3)
                d = rays.direction.reshape(-1, 3)
                t, _ = brute_t_fast(o, d, s.centers, s.radii)
                return (t < jnp.reshape(t_max, (-1,))).reshape(
                    rays.batch_shape)
            return f
        return Intersector(
            path=path,
            nearest_for=lambda s: (lambda r: nearest_hit_brute_fast(r, s)),
            occluded_for=occluded_dense, info={"path": path})

    if not path.startswith("leafcull_"):
        raise ValueError(f"unknown intersector path {path!r}")
    impl = path[len("leafcull_"):]
    from tracer.kernels.leafcull import (build_cull_tables,
                                         nearest_hit_leafcull,
                                         occluded_leafcull)
    bvh, info = build_bvh_for(scene, near_point=near_point)
    tables = build_cull_tables(scene, bvh)

    def nearest_for(s):
        return lambda r: nearest_hit_leafcull(r, s, tables, impl=impl)[0]

    def occluded_for(s):
        return lambda r, t_max: occluded_leafcull(r, tables, t_max,
                                                  impl=impl)[0]

    return Intersector(path=path, nearest_for=nearest_for,
                       occluded_for=occluded_for,
                       info={"path": path, **info}, tables=tables)
