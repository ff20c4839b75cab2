"""Tests for ray sorting, viz, bench harness, and the native builder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tracer.config import TracerConfig
from tracer.core.types import Ray
from tracer.core.sort import direction_morton_codes, sort_rays_by_direction
from tracer.scene.camera import Camera, camera_rays
from tracer.scene.scene import benchmark_scene, random_scene


def test_morton_sort_roundtrip(rng):
    d = rng.uniform(-1, 1, (257, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-5, 5, (257, 3)).astype(np.float32)
    rays = Ray(origin=jnp.array(o), direction=jnp.array(d))
    sorted_rays, inv = sort_rays_by_direction(rays)
    # Inverse permutation restores the caller's order.
    np.testing.assert_array_equal(np.asarray(sorted_rays.direction)[np.asarray(inv)], d)
    np.testing.assert_array_equal(np.asarray(sorted_rays.origin)[np.asarray(inv)], o)
    # Sorted codes are non-decreasing.
    codes = np.asarray(direction_morton_codes(sorted_rays.direction))
    assert (np.diff(codes.astype(np.int64)) >= 0).all()


def test_morton_improves_locality(rng):
    d = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Ray(origin=jnp.zeros((4096, 3)), direction=jnp.array(d))
    s, _ = sort_rays_by_direction(rays)
    ds = np.asarray(s.direction)
    # Mean angular distance between neighbors shrinks a lot after sorting.
    before = np.mean(np.linalg.norm(np.diff(d, axis=0), axis=1))
    after = np.mean(np.linalg.norm(np.diff(ds, axis=0), axis=1))
    assert after < before * 0.25


def test_projection_inverts_raygen():
    # Points along a pixel's ray must project back to that pixel.
    from tracer.viz.wireframe import project_points
    cfg = TracerConfig(width=64, height=48)
    cam = Camera.default()
    rays = camera_rays(cam, cfg)
    for (py, px) in [(5, 7), (24, 32), (40, 60)]:
        p = np.asarray(rays.origin[py, px]) + 12.3 * np.asarray(
            rays.direction[py, px])
        x, y, ok = project_points(p[None], cam, cfg)
        assert ok[0]
        assert abs(x[0] - px) < 0.75 and abs(y[0] - py) < 0.75, (x, y, px, py)


def test_wireframe_draws_something():
    from tracer.bvh.builder import build_bvh
    from tracer.viz.wireframe import draw_bvh_wireframe
    cfg = TracerConfig(width=64, height=48)
    scene = random_scene(jax.random.PRNGKey(0), 8)
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii))
    img = np.zeros((48, 64, 3), np.float32)
    out = draw_bvh_wireframe(img, bvh, Camera.default(), cfg, max_draw_depth=4)
    assert out.sum() > 0.0
    assert out.shape == img.shape


def test_native_builder_matches_numpy_semantics():
    from tracer.bvh.builder import build_bvh
    from tracer.bvh.flat import validate_bvh
    from tracer.bvh import native
    if not native.native_available():
        pytest.skip("no g++")
    scene = benchmark_scene(jax.random.PRNGKey(0), 500, world_size=60.0)
    c = np.asarray(scene.centers)
    r = np.asarray(scene.radii)
    bvh = build_bvh(c, r, backend="native")
    validate_bvh(bvh, c, r)

    # Same closest hits as the numpy-built tree (trees may differ; results
    # must not).
    from tracer.intersect.traverse import nearest_hit_bvh
    from tracer.intersect.brute import nearest_hit_brute
    rng = np.random.default_rng(1)
    d = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = Ray(origin=jnp.zeros((128, 3)), direction=jnp.array(d))
    ref = nearest_hit_brute(rays, scene)
    got = jax.jit(nearest_hit_bvh)(rays, scene, bvh)
    np.testing.assert_array_equal(np.asarray(got.index), np.asarray(ref.index))


def test_complexity_fit_shapes():
    from tracer.bench.harness import complexity_fit
    n = [1e3, 1e4, 1e5, 1e6]
    brute = [1e-3 * x / 1e3 for x in n]            # O(n)
    bvh = [1e-4 * np.log(x) for x in n]            # O(log n)
    fit = complexity_fit(n, brute, bvh)
    assert abs(fit["brute_loglog_slope"] - 1.0) < 0.05
    assert fit["bvh_loglog_slope"] < 0.25


def test_cli_render_smoke(tmp_path):
    from tracer import cli
    out = tmp_path / "r.png"
    cli.main(["render", "--width", "32", "--height", "24", "--depth", "2",
              "--spheres", "6", "--frames", "2", "--out", str(out)])
    assert out.exists()


def test_cli_viz_smoke(tmp_path):
    from tracer import cli
    out = tmp_path / "v.png"
    cli.main(["viz", "--width", "32", "--height", "24", "--spheres", "6",
              "--viz-depth", "3", "--out", str(out)])
    assert out.exists()


# ---------------------------------------------------------- PNG writer

@pytest.mark.parametrize("shape,dtype", [((7, 5, 3), np.float32),
                                         ((1, 64, 3), np.uint8)])
def test_png_writer_roundtrip(tmp_path, shape, dtype):
    """Decode the written file with zlib and check every pixel."""
    import struct
    import zlib
    from tracer.viz.png import write_png

    rng = np.random.default_rng(0)
    img = (rng.random(shape) if dtype == np.float32
           else rng.integers(0, 256, shape)).astype(dtype)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (h, w, depth, ctype) == (shape[0], shape[1], 8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()                    # filter type none
    want = img if dtype == np.uint8 else (img * 255).astype(np.uint8)
    np.testing.assert_array_equal(raw[:, 1:].reshape(shape), want)


def test_png_clips_out_of_range_floats():
    from tracer.viz.png import encode_png
    a = encode_png(np.full((2, 2, 3), 2.0, np.float32))
    b = encode_png(np.full((2, 2, 3), 1.0, np.float32))
    assert a == b


# ------------------------------------------------- pytree dataclass helper

def test_pytree_dataclass_leaves_and_static_fields():
    from tracer.core import pytree

    @pytree.dataclass
    class Box:
        lo: jnp.ndarray
        hi: jnp.ndarray
        depth: int = pytree.field(static=True, default=3)

    b = Box(lo=jnp.zeros(3), hi=jnp.ones(3))
    leaves, treedef = jax.tree_util.tree_flatten(b)
    assert len(leaves) == 2
    assert jax.tree_util.tree_unflatten(treedef, leaves).depth == 3
    # Static fields are part of the treedef: a different value retraces.
    traces = []

    @jax.jit
    def f(box):
        traces.append(box.depth)
        return box.hi - box.lo

    f(b)
    f(b.replace(lo=jnp.full(3, 0.5, jnp.float32)))
    f(b.replace(depth=4))
    assert traces == [3, 4]


def test_pytree_dataclass_is_frozen_and_replace_copies():
    import dataclasses
    from tracer.core import pytree

    @pytree.dataclass
    class P2:
        x: jnp.ndarray
        y: jnp.ndarray = pytree.field(default_factory=lambda: jnp.float32(2))

    p = P2(x=jnp.float32(1))
    q = p.replace(x=jnp.float32(5))
    assert float(p.x) == 1 and float(q.x) == 5 and float(q.y) == 2
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.x = jnp.float32(3)


def test_pytree_dataclass_grad_and_vmap():
    from tracer.scene.scene import benchmark_scene
    scene = benchmark_scene(jax.random.PRNGKey(0), 4, world_size=10.0)
    g = jax.grad(lambda s: jnp.sum(s.centers ** 2) + jnp.sum(s.radii))(scene)
    np.testing.assert_allclose(np.asarray(g.centers),
                               2 * np.asarray(scene.centers), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(g.radii), 1.0)
    rays = Ray(origin=jnp.zeros((5, 3)), direction=jnp.ones((5, 3)))
    pts = jax.vmap(lambda r: r.at(jnp.float32(2.0)))(rays)
    np.testing.assert_allclose(np.asarray(pts), 2.0)
