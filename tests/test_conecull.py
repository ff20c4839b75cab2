"""Phase A and the feature-plane entry points of the leaf-cull intersector.

Phase A (``candidate_rows`` from the packed feature planes) is a
conservative cull: every leaf holding a brute-force hit must be in its
subpacket's row. The feature-plane queries (``nearest_hit_feats``, the
call bench.py times) must return brute force's hits in flat stream order,
with both phase-B implementations. Strategy per SURVEY.md §4: brute force
is ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.builder import build_bvh
from tracer.core.sort import prep_rays_bucketed
from tracer.core.types import Ray
from tracer.intersect.brute import nearest_hit_brute
from tracer.kernels.leafcull import (bounds_from_feats, build_cull_tables,
                                     candidate_rows, nearest_hit_feats,
                                     nearest_hit_leafcull_t,
                                     pack_ray_features, prep_feats_bucketed)
from tracer.scene.scene import benchmark_scene

IMPLS = ["interpret", "xla"]


def _scene_tables(n=600, seed=3, world=60.0, leaf_size=8):
    scene = benchmark_scene(jax.random.PRNGKey(seed), n, world_size=world)
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii),
                    leaf_size=leaf_size)
    return scene, build_cull_tables(scene, bvh)


def _origin_rays(b, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Ray(origin=jnp.zeros((b, 3), jnp.float32), direction=jnp.asarray(d))


@pytest.mark.parametrize("max_candidates", [119, 7])
def test_cone_candidates_cover_brute_hits(max_candidates):
    # Leaf rows (generous budget) and group rows (budget 7 forces some).
    scene, tables = _scene_tables(n=500)
    rays = _origin_rays(512)
    padded, _ = prep_rays_bucketed(rays, 64, cell_bits=4)
    feats = pack_ray_features(padded.origin, padded.direction, 64)
    rows, overflow = candidate_rows(bounds_from_feats(feats), tables, 64,
                                    max_candidates)
    rows = np.asarray(rows)
    assert not bool(overflow)
    if max_candidates == 7:
        assert (rows[:, 0] < 0).any(), "expected group-mode rows"

    hit_id = np.asarray(nearest_hit_brute(padded, scene).index)
    slot_of = {}
    for slot, sph in enumerate(np.asarray(tables.slot_to_sphere)):
        if sph >= 0:
            slot_of.setdefault(sph, slot)
    lpg = tables.leaves_per_group
    for i in np.nonzero(hit_id >= 0)[0]:
        row = rows[i // 64]
        leaf = slot_of[hit_id[i]] // tables.leaf_size
        cnt = row[0]
        if cnt >= 0:
            assert leaf in row[1:1 + cnt], (i, leaf, row[:10])
        else:
            assert leaf // lpg in row[1:1 - cnt], (i, leaf, row[:10])


@pytest.mark.parametrize("impl", IMPLS)
def test_hybrid_raw_order_matches_t(impl):
    """Flat-stream results of the fused prep + query, mapped back through
    ``dest``, equal the rays-API lite query on the same rays."""
    scene, tables = _scene_tables(n=500)
    rays = _origin_rays(512)
    feats, dest = prep_feats_bucketed(rays.origin, rays.direction, 64,
                                      cell_bits=4)
    t_raw, slot_raw, _ = nearest_hit_feats(feats, tables, impl=impl)
    t_ref, sid_ref, _ = nearest_hit_leafcull_t(rays, tables, impl=impl)
    dest = np.asarray(dest)
    np.testing.assert_allclose(np.asarray(t_raw)[dest], np.asarray(t_ref),
                               rtol=1e-6)
    # slot ids map back to input-order sphere ids via slot_to_sphere
    s2s = np.asarray(tables.slot_to_sphere)
    sr = np.asarray(slot_raw)[dest]
    sid = np.where(sr >= 0, s2s[np.maximum(sr, 0)], -1)
    np.testing.assert_array_equal(sid, np.asarray(sid_ref))


@pytest.mark.parametrize("impl", IMPLS)
def test_hybrid_matches_brute(impl):
    scene, tables = _scene_tables(n=700)
    rays = _origin_rays(1024)
    feats, dest = prep_feats_bucketed(rays.origin, rays.direction, 64,
                                      cell_bits=4)
    t, slot, ovf = nearest_hit_feats(feats, tables, impl=impl)
    assert not bool(ovf)
    ref = nearest_hit_brute(rays, scene)
    dest = np.asarray(dest)
    slot = np.asarray(slot)[dest]
    s2s = np.asarray(tables.slot_to_sphere)
    sid = np.where(slot >= 0, s2s[np.maximum(slot, 0)], -1)
    np.testing.assert_array_equal(sid, np.asarray(ref.index))
    hit = sid >= 0
    np.testing.assert_allclose(np.asarray(t)[dest][hit],
                               np.asarray(ref.t)[hit], rtol=1e-4)


def test_bounds_from_feats_match_ray_bounds():
    rng = np.random.default_rng(1)
    o = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (256, 3)).astype(np.float32)
    feats = pack_ray_features(jnp.asarray(o), jnp.asarray(d), 64)
    assert feats.shape == (4, 64, 16)
    got = bounds_from_feats(feats)
    want = (o.reshape(4, 64, 3).min(1), o.reshape(4, 64, 3).max(1),
            d.reshape(4, 64, 3).min(1), d.reshape(4, 64, 3).max(1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-6)
