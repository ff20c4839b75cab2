"""On-device LBVH builder (tracer/bvh/device.py) — CI coverage.

Build-quality contract: same FlatBVH consumers as the host binned-SAH
builder, verified by the structural invariants and the brute-force oracle
(the reference's own validation idea, src/benchmark.c:220,252, upgraded to
per-ray equality as SURVEY.md §4 prescribes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.device import build_bvh_device, morton_codes_3d
from tracer.bvh.flat import validate_bvh
from tracer.core.types import Ray
from tracer.intersect.brute import nearest_hit_brute
from tracer.intersect.traverse import nearest_hit_bvh
from tracer.scene.scene import benchmark_scene


def _rand_rays(rng, n, span=0.0):
    d = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-span, span, size=(n, 3)).astype(np.float32)
    return Ray(origin=jnp.array(o), direction=jnp.array(d))


def _assert_matches_brute(got, ref, rtol=2e-4):
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(got.index)[hit],
                                  np.asarray(ref.index)[hit])
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit],
                               rtol=rtol, atol=1e-5)


def test_morton_codes_order_locality():
    pts = jnp.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                     [0.01, 0.0, 0.0], [0.99, 1.0, 1.0]], jnp.float32)
    lo = jnp.zeros(3)
    hi = jnp.ones(3)
    c = np.asarray(morton_codes_3d(pts, lo, hi))
    assert c[0] < c[1]
    assert abs(int(c[0]) - int(c[2])) < abs(int(c[0]) - int(c[3]))


@pytest.mark.parametrize("n,leaf", [(1000, 8), (1000, 32), (37, 4), (3, 8)])
def test_device_bvh_structure(n, leaf):
    scene = benchmark_scene(jax.random.PRNGKey(1), n, world_size=100.0)
    bvh = build_bvh_device(scene.centers, scene.radii, leaf_size=leaf)
    # Sanity: leaf count padded to a power of two, escape DFS valid, every
    # sphere in exactly one leaf, boxes contain prims (NaN pads skipped).
    validate_bvh(bvh, np.asarray(scene.centers), np.asarray(scene.radii))


@pytest.mark.parametrize("n,span", [(500, 0.0), (2000, 25.0)])
def test_device_bvh_traversal_equals_brute(rng, n, span):
    scene = benchmark_scene(jax.random.PRNGKey(n), n, world_size=80.0)
    bvh = build_bvh_device(scene.centers, scene.radii, leaf_size=8)
    rays = _rand_rays(rng, 700, span=span)
    ref = nearest_hit_brute(rays, scene)
    got = nearest_hit_bvh(rays, scene, bvh)
    _assert_matches_brute(got, ref)


@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_device_bvh_cull_tables_equal_brute(rng, impl):
    # The leafcull hot path must accept device-built trees end to end.
    from tracer.core.sort import sort_rays_octahedral
    from tracer.kernels.leafcull import (build_cull_tables,
                                         nearest_hit_leafcull)
    n = 1200
    scene = benchmark_scene(jax.random.PRNGKey(3), n, world_size=70.0)
    bvh = build_bvh_device(scene.centers, scene.radii, leaf_size=8)
    tables = build_cull_tables(scene, bvh, leaves_per_group=16)
    rays = _rand_rays(rng, 1024, span=15.0)
    sorted_rays, inv = sort_rays_octahedral(rays)
    ref = nearest_hit_brute(rays, scene)
    rec, overflow = nearest_hit_leafcull(sorted_rays, scene, tables,
                                         subpacket=64, impl=impl)
    assert not bool(overflow)
    got = jax.tree_util.tree_map(lambda x: x[inv], rec)
    _assert_matches_brute(got, ref)


def test_device_bvh_is_jittable_and_gradsafe():
    # The builder jits (static shapes) and its output feeds the jnp
    # traversal inside one jit without host sync.
    n = 300
    scene = benchmark_scene(jax.random.PRNGKey(9), n, world_size=50.0)

    @jax.jit
    def t_of(centers, radii, rays):
        bvh = build_bvh_device(centers, radii, leaf_size=8)
        return nearest_hit_bvh(rays, scene, bvh).t

    rng = np.random.default_rng(4)
    rays = _rand_rays(rng, 256)
    t = t_of(scene.centers, scene.radii, rays)
    ref = nearest_hit_brute(rays, scene)
    np.testing.assert_allclose(np.asarray(t)[np.asarray(ref.hit)],
                               np.asarray(ref.t)[np.asarray(ref.hit)],
                               rtol=2e-4, atol=1e-5)
