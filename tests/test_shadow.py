"""Shadow / any-hit coverage (BASELINE config 3).

The any-hit query (tracer/kernels/leafcull.occluded_leafcull) must agree
with the dense brute-force occlusion oracle exactly, including the far
clip t < t_max and the reference acceptance rule (disc > 0, near root,
t > EPSILON; src/hit.c:19-39). Phase B runs as the Triton kernel body in
Pallas's interpreter and as the plain XLA walk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.bvh.builder import build_bvh
from tracer.config import TracerConfig
from tracer.core.types import Ray
from tracer.intersect.brute import any_hit_brute, nearest_hit_brute
from tracer.kernels.leafcull import build_cull_tables, occluded_leafcull
from tracer.scene.camera import Camera
from tracer.scene.scene import benchmark_scene

IMPLS = ["interpret", "xla"]


def _tables(scene, leaf=8):
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii),
                    leaf_size=leaf)
    return build_cull_tables(scene, bvh)


def _rand_rays(rng, n, span=0.0):
    d = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-span, span, size=(n, 3)).astype(np.float32)
    return Ray(origin=jnp.array(o), direction=jnp.array(d))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n,world,span,tmax", [
    (512, 60.0, 0.0, 1.0e9),     # origin rays, effectively no far clip
    (512, 60.0, 10.0, 40.0),     # spread origins, finite t_max
    (2048, 120.0, 30.0, 25.0),
])
def test_anyhit_equals_brute(n, world, span, tmax, impl):
    rng = np.random.default_rng(n + int(span))
    scene = benchmark_scene(jax.random.PRNGKey(5 * n), n, world_size=world)
    tables = _tables(scene)
    rays = _rand_rays(rng, 1024, span)
    from tracer.core.sort import sort_rays_octahedral
    rs, inv = sort_rays_octahedral(rays)
    tm = jnp.full((1024,), tmax, jnp.float32)
    occ, ovf = occluded_leafcull(rs, tables, tm, impl=impl)
    occ = occ[inv]
    ref = any_hit_brute(rays, scene, tm)
    assert not bool(ovf)
    _assert_occ_matches(occ, ref, rays, scene, tmax)


@pytest.mark.parametrize("impl", IMPLS)
def test_anyhit_tmax_is_exclusive_of_farther_hits(impl):
    """A sphere strictly beyond t_max must not occlude."""
    scene = benchmark_scene(jax.random.PRNGKey(0), 8, world_size=20.0)
    # one ray straight at sphere 0's center
    c = np.asarray(scene.centers)[0]
    r = float(np.asarray(scene.radii)[0])
    dist = float(np.linalg.norm(c))
    d = jnp.asarray((c / dist)[None], jnp.float32)
    rays = Ray(origin=jnp.zeros((1, 3), jnp.float32), direction=d)
    tables = _tables(scene, leaf=2)
    near_t = dist - r
    for tm, expect in [(near_t * 0.5, None), (dist + 2 * r, True)]:
        occ, _ = occluded_leafcull(
            rays, tables, jnp.full((1,), tm, jnp.float32), impl=impl)
        ref = any_hit_brute(rays, scene, jnp.full((1,), tm, jnp.float32))
        assert bool(occ[0]) == bool(ref[0])
        if expect is not None:
            assert bool(occ[0]) == expect


def _assert_occ_matches(occ, ref, rays, scene, tmax):
    """Exact boolean equality, except rays whose closest disc/t sits within
    f32 rounding of the accept boundary (graze or t == t_max) — the same
    measure-zero flip class the closest-hit kernel tests tolerate."""
    occ = np.asarray(occ)
    ref = np.asarray(ref)
    bad = np.nonzero(occ != ref)[0]
    if len(bad) == 0:
        return
    o = np.asarray(rays.origin, np.float64).reshape(-1, 3)
    d = np.asarray(rays.direction, np.float64).reshape(-1, 3)
    c = np.asarray(scene.centers, np.float64)
    r = np.asarray(scene.radii, np.float64)
    tm = np.broadcast_to(np.asarray(tmax, np.float64), occ.shape)
    for i in bad:
        oc = o[i][None] - c
        a = float(d[i] @ d[i])
        bp = oc @ d[i]
        cq = (oc * oc).sum(1) - r * r
        disc = bp * bp - a * cq
        # boundary distance: graze band |disc| ~ f32 ulp of bp^2, or
        # closest t within f32 rounding of t_max
        graze = np.abs(disc) <= 4e-7 * np.maximum(bp * bp, np.abs(a * cq))
        with np.errstate(invalid="ignore"):
            t = np.where(disc > 0, (-bp - np.sqrt(np.maximum(disc, 0))) / a,
                         np.inf)
        near_tmax = np.abs(t - tm[i]) <= 1e-5 * tm[i]
        assert bool(graze.any() or near_tmax.any()), \
            f"ray {i}: kernel {occ[i]} vs brute {ref[i]}, no boundary case"
    assert len(bad) <= max(2, occ.size // 200), f"{len(bad)} flips is too many"


@pytest.mark.parametrize("impl", IMPLS)
def test_render_direct_matches_oracle_composition(impl):
    """render_direct through the leaf-cull any-hit == the same composition
    through brute closest-hit + brute any-hit."""
    from tracer.integrator.wavefront import render_direct
    from tracer.intersect.traverse import nearest_hit_bvh

    scene = benchmark_scene(jax.random.PRNGKey(2), 128, world_size=60.0)
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii),
                    leaf_size=4)
    tables = _tables(scene, leaf=8)
    cfg = TracerConfig(width=32, height=24, max_depth=1)
    cam = Camera.default()
    light = jnp.asarray([0.0, 80.0, 0.0], jnp.float32)

    img_oracle = render_direct(
        scene, cam, light,
        lambda s: (lambda r: nearest_hit_brute(r, s)),
        lambda s: (lambda r, tm: any_hit_brute(r, s, tm)),
        cfg)

    def occ_kernel(s):
        def f(r, tm):
            occ, _ = occluded_leafcull(r, tables, tm, impl=impl)
            return occ
        return f

    img_kernel = render_direct(
        scene, cam, light,
        lambda s: (lambda r: nearest_hit_bvh(r, s, bvh)),
        occ_kernel, cfg)
    # BVH traversal and brute closest-hit agree on ids but recompute t in
    # different op orders; the ~1 ulp hit-point shift moves n.l by ~1e-3
    # on a handful of pixels.
    np.testing.assert_allclose(np.asarray(img_oracle),
                               np.asarray(img_kernel), atol=3e-3)

    # shadows actually darken something vs an unshadowed composition
    img_noshadow = render_direct(
        scene, cam, light,
        lambda s: (lambda r: nearest_hit_brute(r, s)),
        lambda s: (lambda r, tm: jnp.zeros(r.batch_shape, bool)),
        cfg)
    assert np.asarray(img_noshadow).sum() >= np.asarray(img_oracle).sum()
