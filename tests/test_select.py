"""The intersector selector (tracer/intersect/select.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.config import TracerConfig
from tracer.core.types import Ray
from tracer.integrator.wavefront import bounce_noise, render
from tracer.intersect import select
from tracer.intersect.brute import any_hit_brute, nearest_hit_brute
from tracer.scene.camera import Camera
from tracer.scene.scene import benchmark_scene


@pytest.mark.parametrize("n,platform,path", [
    (20, "gpu", "dense"),
    (4000, "gpu", "dense"),
    (4001, "gpu", "leafcull_triton"),
    (100_000, "gpu", "leafcull_triton"),
    (4001, "cpu", "leafcull_xla"),
    (10_000_000, "gpu", "leafcull_triton"),
])
def test_choose_path_by_size_and_platform(n, platform, path):
    assert select.choose_path(n, platform=platform) == path


def test_hierarchical_impl_defaults_to_backend():
    assert select.hierarchical_impl() == "xla"          # tests run on CPU
    assert select.hierarchical_impl("gpu") == "triton"


@pytest.mark.parametrize("min_n,kind", [(10, "device_lbvh"),
                                        (10_000, "host_sah")])
def test_build_bvh_for_switches_builder(min_n, kind):
    scene = benchmark_scene(jax.random.PRNGKey(0), 300, world_size=40.0)
    bvh, info = select.build_bvh_for(scene, device_build_min_n=min_n)
    assert info["bvh_build"] == kind and info["bvh_build_ms"] >= 0
    assert bvh.leaf_size == select.LEAF_SIZE


def _rays(n, seed=0, span=5.0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    return Ray(origin=jnp.asarray(o), direction=jnp.asarray(d))


@pytest.mark.parametrize("path", ["dense", "leafcull_xla",
                                  "leafcull_interpret"])
def test_intersector_matches_brute(path):
    scene = benchmark_scene(jax.random.PRNGKey(1), 800, world_size=50.0)
    isect = select.make_intersector(scene, path)
    assert isect.path == path and isect.info["path"] == path
    assert (isect.tables is None) == (path == "dense")
    rays = _rays(512)
    rec = isect.nearest_for(scene)(rays)
    ref = nearest_hit_brute(rays, scene)
    np.testing.assert_array_equal(np.asarray(rec.index),
                                  np.asarray(ref.index))
    tm = jnp.full((512,), 20.0, jnp.float32)
    occ = isect.occluded_for(scene)(rays, tm)
    np.testing.assert_array_equal(np.asarray(occ),
                                  np.asarray(any_hit_brute(rays, scene, tm)))


def test_intersector_renders_like_brute():
    cfg = TracerConfig(width=32, height=24, max_depth=3)
    scene = benchmark_scene(jax.random.PRNGKey(2), 5000, world_size=60.0)
    isect = select.make_intersector(scene)
    assert isect.path == "leafcull_xla"
    noise = bounce_noise(jax.random.PRNGKey(3), (24, 32), 3)
    cam = Camera.default()
    img = render(scene, cam, None, isect.nearest_for, cfg, noise=noise)
    ref = render(scene, cam, None,
                 lambda s: (lambda r: nearest_hit_brute(r, s)), cfg,
                 noise=noise)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-5)


def test_unknown_path_is_an_error():
    scene = benchmark_scene(jax.random.PRNGKey(1), 100, world_size=50.0)
    with pytest.raises(ValueError, match="unknown intersector path"):
        select.make_intersector(scene, "tilecull")
