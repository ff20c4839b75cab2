"""tracer: a differentiable SAH-BVH ray tracer in JAX.

JAX/XLA/Pallas framework with the capabilities of the reference C
project ShivangNagta/CS201_SAH-BVH_Ray_Tracer (see SURVEY.md): SoA sphere
scenes, binned-SAH flat BVH, batched wavefront path tracing, brute-force
oracle, benchmark harness, and multi-device sharding -- all differentiable.
"""

from tracer.config import TracerConfig, DEFAULT_CONFIG
from tracer.core.types import Ray, HitRecord
from tracer.scene import Scene, Camera, camera_rays, random_scene, benchmark_scene
from tracer.intersect import nearest_hit_brute
from tracer.integrator import render, trace_radiance, sky_color

__all__ = [
    "TracerConfig",
    "DEFAULT_CONFIG",
    "Ray",
    "HitRecord",
    "Scene",
    "Camera",
    "camera_rays",
    "random_scene",
    "benchmark_scene",
    "nearest_hit_brute",
    "render",
    "trace_radiance",
    "sky_color",
]
