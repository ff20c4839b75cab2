"""Card-only tests: the compiled Triton-route kernels against the plain XLA
version and brute force. Each skips (inside the ``gpu`` fixture) unless
JAX's backend is the GPU; ``chip_smoke.py`` runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.builder import build_bvh
from tracer.core.sort import sort_rays_octahedral
from tracer.core.types import Ray
from tracer.intersect.brute import any_hit_brute, nearest_hit_brute
from tracer.kernels.leafcull import (build_cull_tables, leaf_candidates,
                                     nearest_hit_leafcull,
                                     occluded_leafcull)
from tracer.scene.scene import benchmark_scene

pytestmark = pytest.mark.gpu


def _setup(n=4000, world=120.0, span=20.0, nrays=4096, leaf=32):
    scene = benchmark_scene(jax.random.PRNGKey(n), n, world_size=world)
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii),
                    leaf_size=leaf)
    rng = np.random.default_rng(0)
    d = rng.uniform(-1, 1, (nrays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-span, span, (nrays, 3)).astype(np.float32)
    rays = Ray(origin=jnp.asarray(o), direction=jnp.asarray(d))
    return scene, build_cull_tables(scene, bvh), rays


@pytest.mark.parametrize("sp", [64, 128])
def test_triton_closest_equals_plain_and_brute(gpu, sp):
    scene, tables, rays = _setup()
    rs, inv = sort_rays_octahedral(rays)
    got = {impl: nearest_hit_leafcull(rs, scene, tables, subpacket=sp,
                                      impl=impl)[0]
           for impl in ("triton", "xla")}
    np.testing.assert_array_equal(np.asarray(got["triton"].index),
                                  np.asarray(got["xla"].index))
    with jax.default_matmul_precision("highest"):
        ref = nearest_hit_brute(rays, scene)
    np.testing.assert_array_equal(np.asarray(got["triton"].index)[inv],
                                  np.asarray(ref.index))


@pytest.mark.parametrize("t_max", [30.0, 1e9])
def test_triton_anyhit_equals_plain_and_brute(gpu, t_max):
    scene, tables, rays = _setup()
    rs, inv = sort_rays_octahedral(rays)
    tm = jnp.full((rays.origin.shape[0],), t_max, jnp.float32)
    occ = {impl: occluded_leafcull(rs, tables, tm, impl=impl)[0]
           for impl in ("triton", "xla")}
    np.testing.assert_array_equal(np.asarray(occ["triton"]),
                                  np.asarray(occ["xla"]))
    with jax.default_matmul_precision("highest"):
        ref = any_hit_brute(rays, scene, tm)
    np.testing.assert_array_equal(np.asarray(occ["triton"])[inv],
                                  np.asarray(ref))


def test_triton_group_mode_rows(gpu):
    scene, tables, rays = _setup(n=2000, world=40.0, span=0.0, nrays=2048,
                                 leaf=8)
    rec, overflow = nearest_hit_leafcull(rays, scene, tables, max_groups=1,
                                         max_candidates=tables.num_groups,
                                         impl="triton")
    assert not bool(overflow)
    rows, _ = leaf_candidates(rays.origin, rays.direction, tables, 1,
                              tables.num_groups, 64)
    assert (np.asarray(rows)[:, 0] < 0).any(), "expected group-mode rows"
    with jax.default_matmul_precision("highest"):
        ref = nearest_hit_brute(rays, scene)
    np.testing.assert_array_equal(np.asarray(rec.index),
                                  np.asarray(ref.index))
