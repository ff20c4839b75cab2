"""CI coverage for the leaf-cull intersector (tracer/kernels/leafcull.py).

Brute force on the identical scene is the oracle (the reference's own
validation idea, src/benchmark.c:220,252, upgraded to per-ray equality).
Phase B runs both ways: the Triton-route kernel body in Pallas's
interpreter, and the plain XLA walk. Also covered: group-mode rows, budget
escalation, the lite (t, id) path, ragged tails, the FD gradient of the
recompute wrapper, the phase-A compactor, the CUDA lowering of the kernel,
and the cell-bucketed padding pre-pass (tracer/core/sort.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.builder import build_bvh
from tracer.core.sort import (bucket_pad_sorted, octahedral_codes,
                              sort_rays_octahedral)
from tracer.core.types import Ray
from tracer.intersect.brute import nearest_hit_brute
from tracer.kernels import leafcull
from tracer.kernels.leafcull import (build_cull_tables, compact_rows,
                                     default_budgets, leaf_candidates,
                                     nearest_hit_leafcull,
                                     nearest_hit_leafcull_t)
from tracer.scene.scene import benchmark_scene

IMPLS = ["interpret", "xla"]


def _rand_rays(rng, n, origin_span=0.0):
    d = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-origin_span, origin_span, size=(n, 3)).astype(np.float32)
    return Ray(origin=jnp.array(o), direction=jnp.array(d))


def _assert_matches_brute(got, ref, rtol=2e-4):
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(got.index)[hit],
                                  np.asarray(ref.index)[hit])
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit],
                               rtol=rtol, atol=1e-5)


def _tables(scene, leaf=8, lpg=16):
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii),
                    leaf_size=leaf)
    return build_cull_tables(scene, bvh, leaves_per_group=lpg)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,world,span,sp,nrays", [
    (512, 60.0, 0.0, 64, 1024),          # origin rays
    (2048, 120.0, 30.0, 64, 1024 + 300),  # spread origins, ragged tail
    (512, 60.0, 10.0, 128, 700),         # SP=128, ragged
])
def test_leafcull_equals_brute(rng, n, world, span, sp, nrays, impl):
    scene = benchmark_scene(jax.random.PRNGKey(7 * n + sp), n,
                            world_size=world)
    tables = _tables(scene)
    rays = _rand_rays(rng, nrays, origin_span=span)
    sorted_rays, inv = sort_rays_octahedral(rays)

    ref = nearest_hit_brute(rays, scene)
    rec, overflow = nearest_hit_leafcull(sorted_rays, scene, tables,
                                         subpacket=sp, impl=impl)
    assert not bool(overflow)
    got = jax.tree_util.tree_map(lambda x: x[inv], rec)
    _assert_matches_brute(got, ref)


@pytest.mark.parametrize("impl", IMPLS)
def test_leafcull_group_mode_fallback_correct(rng, impl):
    # A one-group refine budget forces subpackets into group-mode rows
    # (negated counts); the walk over whole groups must still match brute
    # force. The rows hold every group, so nothing overflows.
    n = 600
    scene = benchmark_scene(jax.random.PRNGKey(3), n, world_size=30.0)
    tables = _tables(scene)
    budgets = dict(max_groups=1, max_candidates=tables.num_groups)

    rays = _rand_rays(rng, 1024)  # unsorted -> wide frustums
    rows, _ = leaf_candidates(rays.origin, rays.direction, tables,
                              subpacket=64, **budgets)
    assert (np.asarray(rows)[:, 0] < 0).any(), "expected group-mode rows"

    ref = nearest_hit_brute(rays, scene)
    got, overflow = nearest_hit_leafcull(rays, scene, tables, subpacket=64,
                                         impl=impl, **budgets)
    assert not bool(overflow)
    _assert_matches_brute(got, ref)


def _wide_table_scene():
    # More groups than 119 (leaf_size 2), for incoherent subpackets.
    scene = benchmark_scene(jax.random.PRNGKey(23), 5000, world_size=25.0)
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii),
                    leaf_size=2)
    tables = build_cull_tables(scene, bvh, leaves_per_group=16)
    assert tables.num_groups > 119
    return scene, tables


@pytest.mark.parametrize("impl", IMPLS)
def test_leafcull_default_budgets_never_overflow(rng, impl):
    # The same wide table and incoherent rays that overflow small budgets
    # (below) must neither overflow nor lose a hit under the defaults.
    scene, tables = _wide_table_scene()
    rays = _rand_rays(rng, 256)
    got, overflow = nearest_hit_leafcull(rays, scene, tables, impl=impl)
    assert not bool(overflow)
    _assert_matches_brute(got, nearest_hit_brute(rays, scene))


@pytest.mark.parametrize("groups,want", [(1, (64, 119)), (268, (67, 268)),
                                         (2764, (691, 2764)),
                                         (19532, (1024, 19532))])
def test_default_budgets_follow_table_size(groups, want):
    class _Tables:
        num_groups = groups
    assert default_budgets(_Tables()) == want


def test_leafcull_overflow_flag_on_wide_group_rows(rng):
    # Group rows narrower than the subpacket's surviving groups (one id
    # per row here) plus incoherent subpackets must raise the overflow
    # flag from phase A.
    scene, tables = _wide_table_scene()
    rays = _rand_rays(rng, 256)  # unsorted: frustums span the sphere
    _, overflow = leaf_candidates(rays.origin, rays.direction, tables,
                                  max_groups=1, max_candidates=1,
                                  subpacket=64)
    assert bool(overflow)


@pytest.mark.parametrize("impl", IMPLS)
def test_leafcull_lite_matches_full(rng, impl):
    n = 800
    scene = benchmark_scene(jax.random.PRNGKey(5), n, world_size=60.0)
    tables = _tables(scene)
    rays = _rand_rays(rng, 1024, origin_span=15.0)
    sorted_rays, _ = sort_rays_octahedral(rays)

    rec, ovf_full = nearest_hit_leafcull(sorted_rays, scene, tables,
                                         impl=impl)
    t, sid, ovf_lite = nearest_hit_leafcull_t(sorted_rays, tables,
                                              impl=impl)
    assert bool(ovf_full) == bool(ovf_lite)
    np.testing.assert_array_equal(np.asarray(sid), np.asarray(rec.index))
    hit = np.isfinite(np.asarray(rec.t))
    np.testing.assert_array_equal(np.isfinite(np.asarray(t)), hit)
    # Same discriminant, rearranged root (u = oc.d + sqrt(disc), t = -u/a)
    # vs the full path's exact-brute recomputation: f32 rounding only.
    np.testing.assert_allclose(np.asarray(t)[hit], np.asarray(rec.t)[hit],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_benchmark_scale_mismatches_are_grazes(impl):
    """At the benchmark's scale (r = 0.5, |oc| ~ 300-900) the f32
    discriminant cannot decide rays that graze a silhouette. Rays aimed
    at silhouettes: every ray on which the kernel differs from f32 brute
    force, or from an f64 nearest hit over every sphere, must be a graze
    or a tie under chip_smoke's f64 classification, and t must agree to
    1e-4 where the sphere does."""
    import chip_smoke as cs
    n, b = 10_000, 2048
    scene = benchmark_scene(jax.random.PRNGKey(11), n, world_size=1000.0)
    tables = _tables(scene, leaf=32)
    c = np.asarray(scene.centers, np.float64)
    r = np.asarray(scene.radii, np.float64)
    rng = np.random.default_rng(5)
    tgt = rng.choice(np.nonzero(np.linalg.norm(c, axis=1) > 300)[0], b)
    u = np.cross(c[tgt], rng.normal(size=(b, 3)))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    rel = rng.choice([-1.0, 1.0], b) * 10.0 ** rng.uniform(-9, -1, b)
    d = c[tgt] + u * (r[tgt] * (1.0 + rel))[:, None]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.zeros((b, 3), np.float32)
    rays = Ray(origin=jnp.asarray(o), direction=jnp.asarray(d))
    assert cs._exact(o, d, c[tgt], r[tgt])[2].sum() > b // 4  # grazes

    sorted_rays, inv = sort_rays_octahedral(rays)
    t, sid, overflow = nearest_hit_leafcull_t(sorted_rays, tables, impl=impl)
    assert not bool(overflow)
    t, sid = np.asarray(t)[np.asarray(inv)], np.asarray(sid)[np.asarray(inv)]

    ref = nearest_hit_brute(rays, scene)
    vs_brute = cs.compare_closest(sid, t, np.asarray(ref.index),
                                  np.asarray(ref.t), o, d, c, r)
    assert vs_brute["unexplained"] == 0, vs_brute
    assert vs_brute["t_max_rel_err"] <= cs.T_RTOL, vs_brute

    ex_t = np.full(b, np.inf)
    ex_sid = np.full(b, -1)
    for s in range(0, b, 128):
        te, _, _ = cs._exact(o[s:s + 128, None], d[s:s + 128, None], c, r)
        ex_sid[s:s + 128] = np.where(np.isfinite(te.min(1)), te.argmin(1), -1)
        ex_t[s:s + 128] = te.min(1)
    vs_f64 = cs.compare_closest(sid, t, ex_sid, ex_t, o, d, c, r)
    assert vs_f64["unexplained"] == 0, vs_f64
    assert vs_f64["t_max_rel_err"] <= cs.T_RTOL, vs_f64


def test_leafcull_padding_leaves_not_candidates(rng):
    # Inverted padding boxes pass the symmetric slab test as all-space;
    # phase A must mask them via num_real_leaves so they never consume
    # candidate budget. 13 leaves at leaf_size=8 pad to a group multiple.
    n = 100
    scene = benchmark_scene(jax.random.PRNGKey(17), n, world_size=30.0)
    tables = _tables(scene)
    assert tables.num_real_leaves < tables.num_leaves

    rays = _rand_rays(rng, 128)
    sorted_rays, _ = sort_rays_octahedral(rays)
    rows, _ = leaf_candidates(sorted_rays.origin, sorted_rays.direction,
                              tables, max_groups=tables.num_groups,
                              max_candidates=tables.num_leaves, subpacket=64)
    for row in np.asarray(rows):
        cnt = row[0]
        assert cnt >= 0  # budgets maxed: no group mode
        assert (row[1:1 + cnt] < tables.num_real_leaves).all()


@pytest.mark.parametrize("impl", IMPLS)
def test_leafcull_gradients_match_fd(rng, impl):
    n = 64
    scene = benchmark_scene(jax.random.PRNGKey(13), n, world_size=20.0)
    tables = _tables(scene, leaf=4)
    rays = _rand_rays(rng, 512)
    sorted_rays, _ = sort_rays_octahedral(rays)

    def loss(radii):
        s2 = scene.replace(radii=radii)
        rec, _ = nearest_hit_leafcull(sorted_rays, s2, tables,
                                      max_groups=tables.num_groups,
                                      max_candidates=tables.num_leaves,
                                      impl=impl)
        t = jnp.where(jnp.isfinite(rec.t), rec.t, 0.0)
        return jnp.sum(t)

    g = jax.grad(loss)(scene.radii)
    mag = np.abs(np.asarray(g))
    eps = 1e-3
    for i in np.argsort(mag)[-3:]:
        e = jnp.zeros_like(scene.radii).at[i].set(eps)
        fd = (loss(scene.radii + e) - loss(scene.radii - e)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g)[i], float(fd),
                                   rtol=5e-2, atol=1e-4)


# ------------------------------------------------------ phase-A compactor

@pytest.mark.parametrize("frac,keep", [(0.0, 8), (0.1, 8), (0.5, 40),
                                       (0.9, 200), (1.0, 64)])
def test_compact_rows_matches_numpy(frac, keep):
    rng = np.random.default_rng(int(frac * 10) + keep)
    P, M, sentinel = 16, 128, 999
    mask = rng.random((P, M)) < frac
    ids = np.sort(rng.choice(500, (P, M)), axis=1).astype(np.int32)
    prefix, counts = compact_rows(jnp.asarray(mask), jnp.asarray(ids),
                                  keep, sentinel)
    prefix, counts = np.asarray(prefix), np.asarray(counts)
    for p in range(P):
        want = ids[p][mask[p]]
        assert counts[p] == want.size
        k = min(keep, want.size)
        np.testing.assert_array_equal(prefix[p, :k], want[:k])
        assert (prefix[p, k:] == sentinel).all()


# ------------------------------------------------------ the Triton kernel

@pytest.mark.parametrize("anyhit", [False, True])
def test_kernel_lowers_to_triton_for_cuda(anyhit):
    """The kernel's Pallas -> Triton lowering runs without a GPU: it fails
    here for any primitive the Triton route does not lower."""
    scene = benchmark_scene(jax.random.PRNGKey(3), 512, world_size=60.0)
    tables = _tables(scene, leaf=32)
    feats = jnp.zeros((8, 64, leafcull.FEAT), jnp.float32)
    rows = jnp.zeros((8, 128), jnp.int32)
    fn = jax.jit(lambda f, r, t: leafcull._kernel_walk(
        f, r, t, anyhit, interpret=False))
    text = fn.trace(feats, rows, tables).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert ("leafcull_anyhit" if anyhit else "leafcull_closest") in text


@pytest.mark.parametrize("sp,leaf,warps", [(64, 32, 4), (128, 32, 8),
                                           (64, 8, 1)])
def test_kernel_warps_follow_block_size(monkeypatch, sp, leaf, warps):
    seen = {}
    real = leafcull.pl.pallas_call

    def spy(*a, **kw):
        seen["warps"] = kw["compiler_params"].num_warps
        seen["backend"] = kw["backend"]
        return real(*a, **kw)

    monkeypatch.setattr(leafcull.pl, "pallas_call", spy)
    scene = benchmark_scene(jax.random.PRNGKey(3), 256, world_size=60.0)
    tables = _tables(scene, leaf=leaf)
    feats = jnp.zeros((2, sp, leafcull.FEAT), jnp.float32)
    rows = jnp.zeros((2, 16), jnp.int32)
    leafcull._kernel_walk(feats, rows, tables, False, interpret=True)
    assert seen == {"warps": warps, "backend": "triton"}


def test_phase_b_rejects_unknown_impl():
    scene = benchmark_scene(jax.random.PRNGKey(3), 64, world_size=60.0)
    tables = _tables(scene)
    with pytest.raises(ValueError, match="unknown phase-B impl"):
        leafcull.phase_b(jnp.zeros((1, 64, leafcull.FEAT)),
                         jnp.zeros((1, 16), jnp.int32), tables, "mosaic")


def test_prim_table_is_soa_with_sentinel_leaf():
    scene = benchmark_scene(jax.random.PRNGKey(2), 300, world_size=40.0)
    tables = _tables(scene)
    prims = np.asarray(tables.prims)
    L, ls = tables.num_leaves, tables.leaf_size
    assert prims.shape == (4, L + 1, ls)
    assert (prims[3, L] < 0).all()                   # sentinel never hits
    s2s = np.asarray(tables.slot_to_sphere).reshape(L, ls)
    real = s2s >= 0
    c = np.asarray(scene.centers)[s2s[real]]
    r = np.asarray(scene.radii)[s2s[real]]
    np.testing.assert_array_equal(prims[0, :L][real], c[:, 0])
    np.testing.assert_array_equal(prims[3, :L][real], r * r)
    assert (prims[3, :L][~real] < 0).all()


# ------------------------------------------------- cell-bucketed padding

def test_bucket_pad_sorted_roundtrip(rng):
    b = 1000
    rays = _rand_rays(rng, b, origin_span=5.0)
    o = rays.origin
    d = rays.direction
    codes = octahedral_codes(d)
    perm = jnp.argsort(codes)
    os_, ds_, cs_ = o[perm], d[perm], codes[perm]
    sp = 64
    op, dp, dest = bucket_pad_sorted(os_, ds_, cs_, sp, cell_bits=4)

    dest = np.asarray(dest)
    assert op.shape[0] == b + (1 << 4) * sp
    # Every real ray lands at its dest slot unchanged.
    np.testing.assert_allclose(np.asarray(op)[dest], np.asarray(os_))
    np.testing.assert_allclose(np.asarray(dp)[dest], np.asarray(ds_))
    # dest is strictly increasing (stream order preserved).
    assert (np.diff(dest) > 0).all()
    # No subpacket mixes rays from two cells.
    cells = np.asarray(cs_) >> (32 - 4)
    sub_of = dest // sp
    for i in range(1, b):
        if cells[i] != cells[i - 1]:
            assert sub_of[i] != sub_of[i - 1], \
                "cell boundary must start a new subpacket"


def test_bucket_pad_padding_replicates_prev_ray(rng):
    b = 300
    rays = _rand_rays(rng, b)
    codes = octahedral_codes(rays.direction)
    perm = jnp.argsort(codes)
    os_, ds_, cs_ = rays.origin[perm], rays.direction[perm], codes[perm]
    op, dp, dest = bucket_pad_sorted(os_, ds_, cs_, 64, cell_bits=3)
    dest = np.asarray(dest)
    opn, dpn = np.asarray(op), np.asarray(dp)
    # Each padding slot equals the nearest real ray before it (or ray 0).
    src = np.clip(np.searchsorted(dest, np.arange(opn.shape[0]),
                                  side="right") - 1, 0, b - 1)
    np.testing.assert_allclose(opn, np.asarray(os_)[src])
    np.testing.assert_allclose(dpn, np.asarray(ds_)[src])
