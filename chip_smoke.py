"""Smoke test of the tracer's main path on the GPU, at the reference's scale.

    python chip_smoke.py            # default phases on one GPU
    python chip_smoke.py --four     # the multi-device path on four GPUs

Default phases, each compared on the card with the plain reference:

  0. the repo's card-only tests (``pytest -m gpu``, tests/test_gpu.py);
  1. closest hit at 100k spheres, 512 * 1024 origin rays, through the
     intersector the selector picks (the call bench.py times), against
     ``nearest_hit_brute`` on 16,384 sampled rays;
  2. the same query at 10M spheres on the device-built LBVH, against brute
     force on 4,096 sampled rays;
  3. shadow rays at 100k with t_max = 500 against ``any_hit_brute``;
  4. ``tracer.cli render`` at 800x600, depth 5: the reference's 20-sphere
     interactive scene, and one frame of the 100k benchmark scene, each
     against a brute-nearest render on the same noise;
  5. the sparse differentiable forward + backward at 100k spheres and
     131,072 rays; gradients finite, and equal to the exact sparse path's
     on an 8k-ray slice.

``--four`` runs only the sharded path on a 2 x 2 (rays x scene) mesh: one
``dist.train`` step at 1M spheres against the same step on one card;
``nearest_hit_sharded`` through the selector's intersector at 1M spheres
against one card and brute force; ``nearest_hit_ring`` at 1M spheres
against brute force; and a microbatched ``fit_scene`` step against one
card, its gradient judged against the f64 gradient.

Every line but the last reports a phase. The last line of stdout is one
JSON object, ``{"ok": true, "device": {...}}``. No phase's failure is
caught: an exception or a failed comparison exits non-zero without that
line, and so does a platform other than ``gpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# Tolerances. Every comparison below is against a plain reference run on
# the same card; where f32 cannot decide, the f64 recomputation decides
# whether a difference is rounding.
ID_MISMATCH_FRAC = 1e-4   # ids / occlusion flags: at most 0.01 % differ,
#                           and each difference must be a graze or a tie.
GRAZE_BAND = 2.0 ** -18   # |disc| below this fraction of a |oc| r is a
#                           graze: the f32 discriminant a r^2 - |oc x d|^2
#                           carries ~2 r sqrt(a) ulp(|oc| sqrt(a)) of
#                           rounding, so its sign is not decided there.
TIE_RTOL = 1e-5           # two spheres whose exact t agree this closely
T_RTOL = 1e-4             # t from the kernel's own quadratic vs brute
TMAX_RTOL = 1e-5          # occluder within rounding of t_max
IMG_MEAN_TOL = 1e-4       # renders: mean |delta| over all pixels
IMG_PX_TOL = 1e-3         # ... and at most IMG_PX_FRAC of pixels off by
IMG_PX_FRAC = 1e-3        #     more than IMG_PX_TOL
GRAD_ATOL_REL = 0.02      # sparse gradients: atol = 0.02 max|g_ref| + 1e-7
#                           (tests/test_sparse_diff.py): the leaf-ordered
#                           composite shares one order per subpacket.


def emit(name: str, result: dict) -> dict:
    print(f"{name}: " + json.dumps(result, default=float), flush=True)
    return result


# ---------------------------------------------------------------------------
# Comparisons (numpy; f64 where rounding must be judged)
# ---------------------------------------------------------------------------

def _exact(o, d, c, r):
    """f64 (t, disc, graze) of rays o/d (n, 3) against spheres c (n, 3)."""
    o, d, c = (np.asarray(x, np.float64) for x in (o, d, c))
    r = np.asarray(r, np.float64)
    oc = o - c
    a = (d * d).sum(-1)
    cr = np.cross(oc, d)
    disc = a * r * r - (cr * cr).sum(-1)
    with np.errstate(invalid="ignore"):
        t = (-(oc * d).sum(-1) - np.sqrt(np.maximum(disc, 0.0))) / a
    t = np.where((disc > 0) & (t > 1e-6), t, np.inf)
    graze = np.abs(disc) <= GRAZE_BAND * a * np.sqrt((oc * oc).sum(-1)) * r
    return t, disc, graze


def compare_closest(sid, t, ref_sid, ref_t, o, d, centers, radii) -> dict:
    """Kernel (sid, t) vs brute (ref_sid, ref_t) on the same rays."""
    sid, ref_sid = np.asarray(sid), np.asarray(ref_sid)
    t, ref_t = np.asarray(t, np.float64), np.asarray(ref_t, np.float64)
    o, d = np.asarray(o), np.asarray(d)
    centers, radii = np.asarray(centers), np.asarray(radii)
    n = sid.shape[0]
    bad = np.nonzero(sid != ref_sid)[0]
    unexplained = 0
    for i in bad:
        ids = [s for s in (sid[i], ref_sid[i]) if s >= 0]
        te, _, gz = _exact(np.repeat(o[i:i + 1], len(ids), 0),
                           np.repeat(d[i:i + 1], len(ids), 0),
                           centers[ids], radii[ids])
        tie = len(ids) == 2 and abs(te[0] - te[1]) <= TIE_RTOL * te.min()
        unexplained += not (tie or gz.any())
    both = (sid == ref_sid) & (sid >= 0)
    rel = np.abs(t[both] - ref_t[both]) / ref_t[both]
    res = {"rays": n, "hit_fraction": float((ref_sid >= 0).mean()),
           "id_mismatches": int(bad.size), "unexplained": unexplained,
           "t_max_rel_err": float(rel.max()) if rel.size else 0.0}
    res["ok"] = bool(bad.size <= ID_MISMATCH_FRAC * n and unexplained == 0
                     and res["t_max_rel_err"] <= T_RTOL)
    return res


def compare_occlusion(occ, ref_occ, o, d, centers, radii, t_max) -> dict:
    """Kernel vs brute occlusion flags; each differing ray must have an
    occluder that grazes or sits within rounding of t_max."""
    occ, ref_occ = np.asarray(occ, bool), np.asarray(ref_occ, bool)
    o, d = np.asarray(o), np.asarray(d)
    centers, radii = np.asarray(centers), np.asarray(radii)
    bad = np.nonzero(occ != ref_occ)[0]
    unexplained = 0
    for i in bad:
        te, disc, gz = _exact(o[i][None], d[i][None], centers, radii)
        near = np.abs(te - t_max) <= TMAX_RTOL * t_max
        unexplained += not bool((gz | near).any())
    res = {"rays": int(occ.size), "occluded_fraction": float(ref_occ.mean()),
           "flag_mismatches": int(bad.size), "unexplained": unexplained}
    res["ok"] = bool(bad.size <= ID_MISMATCH_FRAC * occ.size
                     and unexplained == 0)
    return res


def compare_images(img, ref) -> dict:
    diff = np.abs(np.asarray(img, np.float64) - np.asarray(ref, np.float64))
    px = diff.max(axis=-1)
    res = {"mean_abs_diff": float(diff.mean()),
           "frac_px_over": float((px > IMG_PX_TOL).mean()),
           "finite": bool(np.isfinite(np.asarray(img)).all())}
    res["ok"] = bool(res["finite"] and res["mean_abs_diff"] <= IMG_MEAN_TOL
                     and res["frac_px_over"] <= IMG_PX_FRAC)
    return res


def compare_grads(g, g_ref) -> dict:
    g, g_ref = np.asarray(g, np.float64), np.asarray(g_ref, np.float64)
    atol = GRAD_ATOL_REL * np.abs(g_ref).max() + 1e-7
    err = np.abs(g - g_ref).max()
    res = {"max_abs_err": float(err), "atol": float(atol),
           "finite": bool(np.isfinite(g).all())}
    res["ok"] = bool(res["finite"] and err <= atol)
    return res


def compare_close(x, ref, rtol: float, atol: float = 0.0) -> dict:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    same = x == ref                                  # equal infinities too
    with np.errstate(invalid="ignore"):
        err = np.where(same, 0.0, np.abs(x - ref))
    scale = float(np.abs(ref[np.isfinite(ref)]).max()) if err.size else 0.0
    res = {"max_abs_err": float(err.max()) if err.size else 0.0,
           "max_err_over_max_ref": float(err.max()) / scale if scale else 0.0,
           "nan": bool(np.isnan(x).any())}
    tol = atol + rtol * np.abs(np.where(same, 0.0, ref))
    res["ok"] = bool(not res["nan"] and (same | (err <= tol)).all())
    return res


# ---------------------------------------------------------------------------
# References on the card
# ---------------------------------------------------------------------------

def brute_nearest_for(block: int):
    """``nearest_for`` for the integrator: nearest_hit_brute over ray
    blocks of ``block`` rays."""
    import jax
    from tracer.core.types import Ray
    from tracer.intersect.brute import nearest_hit_brute

    def nearest_for(s):
        def nearest(rays):
            shape = rays.batch_shape
            o = rays.origin.reshape(-1, block, 3)
            d = rays.direction.reshape(-1, block, 3)
            rec = jax.lax.map(lambda x: nearest_hit_brute(
                Ray(origin=x[0], direction=x[1]), s), (o, d))
            return jax.tree_util.tree_map(
                lambda x: x.reshape(*shape, *x.shape[2:]), rec)
        return nearest
    return nearest_for


def brute_closest(o, d, scene, block: int):
    """(t, sphere id) of nearest_hit_brute on rays o/d, in ray blocks."""
    import jax
    from tracer.core.types import Ray

    nearest = brute_nearest_for(block)
    run = jax.jit(lambda o, d, s: nearest(s)(Ray(origin=o, direction=d)))
    with jax.default_matmul_precision("highest"):
        rec = jax.block_until_ready(run(o, d, scene))
    return rec.t, rec.index


def _sample(n_total: int, n: int, seed: int) -> np.ndarray:
    return np.sort(np.random.default_rng(seed).choice(n_total, n,
                                                      replace=False))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def _hierarchical(n_spheres, seed_scene, n_rays, ray_seed):
    """(scene, Intersector, impl, o, d): the benchmark scene through the
    selector, as ``bench.py`` builds it."""
    import jax
    from tracer.bench import workload as W
    from tracer.intersect.select import make_intersector
    from tracer.scene.scene import benchmark_scene

    scene = benchmark_scene(jax.random.PRNGKey(seed_scene), n_spheres,
                            world_size=W.WORLD)
    isect = make_intersector(scene)
    assert isect.path.startswith("leafcull_"), isect.path
    o, d = W.origin_rays(n_rays, seed=ray_seed)
    return scene, isect, isect.path[len("leafcull_"):], o, d


def _through_selector(query, o, d, *extra):
    """``query(rays, *extra)`` (an Intersector factory's function) on rays
    o/d, direction-sorted as its callers sort them, back in input order."""
    import jax
    import jax.numpy as jnp
    from tracer.core.sort import sort_rays_octahedral
    from tracer.core.types import Ray

    rays, inv = sort_rays_octahedral(Ray(origin=jnp.asarray(o),
                                         direction=jnp.asarray(d)))
    perm = jnp.argsort(inv)
    extra = [x[perm] for x in extra]
    out = jax.block_until_ready(jax.jit(query)(rays, *extra))
    return jax.tree_util.tree_map(lambda x: np.asarray(x)[np.asarray(inv)],
                                  out)


def _closest_phase(name, n_spheres, n_rays, n_check, seed_scene):
    import jax
    from tracer.bench import workload as W
    from tracer.bench.timing import time_calls

    scene, isect, impl, o, d = _hierarchical(n_spheres, seed_scene, n_rays,
                                             ray_seed=0)
    tables = isect.tables
    res = {"spheres": n_spheres, "rays": n_rays, **isect.info}
    fn = jax.jit(W.closest_oneshot(impl))
    timing, (t, slot, ovf) = time_calls(fn, o, d, tables, n=5)
    res.update(overflow=bool(ovf), kernel=timing.to_json(),
               kernel_mrays=n_rays / timing.median_s / 1e6,
               compile_s=timing.first_call_s - timing.median_s)
    fx = jax.jit(W.closest_oneshot("xla"))
    tx, (t_x, slot_x, _) = time_calls(fx, o, d, tables, n=5)
    res.update(xla=tx.to_json(), xla_mrays=n_rays / tx.median_s / 1e6)

    idx = _sample(n_rays, n_check, seed=7)
    s2s = np.asarray(tables.slot_to_sphere)
    slot = np.asarray(slot)[idx]
    sid = np.where(slot >= 0, s2s[np.maximum(slot, 0)], -1)
    o_s, d_s = np.asarray(o)[idx], np.asarray(d)[idx]
    block = max(16, min(256, (1 << 28) // n_spheres // 16 * 16))
    ref_t, ref_sid = brute_closest(jax.numpy.asarray(o_s),
                                   jax.numpy.asarray(d_s), scene, block)
    ref_t, ref_sid = np.asarray(ref_t), np.asarray(ref_sid)
    cmp = compare_closest(sid, np.asarray(t)[idx], ref_sid, ref_t, o_s, d_s,
                          scene.centers, scene.radii)
    # The plain version must agree with the kernel exactly on ids.
    same = bool((np.asarray(slot_x)[idx] == slot).all())
    # What the integrator and the CLI call: the selector's nearest_for.
    rec = _through_selector(isect.nearest_for(scene), o_s, d_s)
    sel = compare_closest(rec.index, rec.t, ref_sid, ref_t, o_s, d_s,
                          scene.centers, scene.radii)
    res.update(compare=cmp, xla_equals_kernel=same, selector_compare=sel)
    res["ok"] = bool(cmp["ok"] and sel["ok"] and not res["overflow"]
                     and same)
    return emit(name, res)


def phase_closest(n_spheres=100_000, n_rays=512 * 1024, n_check=16_384):
    return _closest_phase("closest", n_spheres, n_rays, n_check, 1)


def phase_closest_10m(n_spheres=10_000_000, n_rays=512 * 1024,
                      n_check=4_096):
    return _closest_phase("closest_10m", n_spheres, n_rays, n_check, 2)


def phase_shadow(n_spheres=100_000, n_rays=512 * 1024, n_check=16_384):
    import jax
    import jax.numpy as jnp
    from tracer.bench import workload as W
    from tracer.bench.timing import time_calls
    from tracer.intersect.brute import any_hit_brute
    from tracer.core.types import Ray

    t_max = 500.0
    scene, isect, impl, o, d = _hierarchical(n_spheres, 1, n_rays,
                                             ray_seed=3)
    tables = isect.tables
    tk, (occ, ovf) = time_calls(jax.jit(W.shadow_oneshot(impl, t_max)),
                                o, d, tables, n=5)
    tx, (occ_x, _) = time_calls(jax.jit(W.shadow_oneshot("xla", t_max)),
                                o, d, tables, n=5)
    idx = _sample(n_rays, n_check, seed=8)
    o_s, d_s = o[idx], d[idx]
    tm = jnp.full((idx.size,), t_max, jnp.float32)

    @jax.jit
    def ref(o, d, s):
        return jax.lax.map(lambda x: any_hit_brute(
            Ray(origin=x[0], direction=x[1]), s, x[2]),
            (o.reshape(-1, 256, 3), d.reshape(-1, 256, 3),
             tm.reshape(-1, 256))).reshape(-1)
    with jax.default_matmul_precision("highest"):
        ref_occ = ref(o_s, d_s, scene)
    cmp = compare_occlusion(np.asarray(occ)[idx], ref_occ, o_s, d_s,
                            scene.centers, scene.radii, t_max)
    same = bool((np.asarray(occ_x) == np.asarray(occ)).all())
    sel = compare_occlusion(
        _through_selector(isect.occluded_for(scene), o_s, d_s, tm), ref_occ,
        o_s, d_s, scene.centers, scene.radii, t_max)
    res = {"spheres": n_spheres, "rays": n_rays, "t_max": t_max,
           "path": isect.path, "overflow": bool(ovf),
           "kernel": tk.to_json(), "kernel_mrays": n_rays / tk.median_s / 1e6,
           "xla": tx.to_json(), "xla_mrays": n_rays / tx.median_s / 1e6,
           "compare": cmp, "xla_equals_kernel": same,
           "selector_compare": sel}
    res["ok"] = bool(cmp["ok"] and sel["ok"] and not res["overflow"]
                     and same)
    return emit("shadow", res)


def _render(argv, ref_block):
    import jax
    from tracer import cli
    from tracer.intersect.select import Intersector

    args = cli.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    img, isect, times = cli.render_frames(args)
    wall = time.perf_counter() - t0
    ref_isect = Intersector(path="brute_blocked",
                            nearest_for=brute_nearest_for(ref_block),
                            occluded_for=None, info={})
    with jax.default_matmul_precision("highest"):
        ref, _, _ = cli.render_frames(args, isect=ref_isect)
    res = {"argv": " ".join(argv), "path": isect.path,
           "frame_s_first_call": times[0], "wall_s": wall,
           "compare": compare_images(img, ref)}
    res["ok"] = res["compare"]["ok"]
    return res


def phase_render(width=800, height=600, n_big=100_000):
    common = ["render", "--width", str(width), "--height", str(height),
              "--depth", "5", "--frames", "1"]
    small = _render(common + ["--spheres", "20"], ref_block=width * 6)
    big = _render(common + ["--scene", "benchmark", "--spheres", str(n_big)],
                  ref_block=width * 6 // 5)
    return emit("render", {"interactive": small, "benchmark": big,
                           "ok": bool(small["ok"] and big["ok"])})


def phase_diff(n_spheres=100_000, n_rays=131_072, n_slice=8192):
    import jax
    import jax.numpy as jnp
    from tracer.bench.timing import time_calls
    from tracer.core.sort import prep_rays_bucketed
    from tracer.core.types import Ray
    from tracer.diff.soft import SoftParams
    from tracer.diff.sparse import (soft_render_sparse_leaforder,
                                    soft_render_sparse_packets)

    scene, isect, _, o, d = _hierarchical(n_spheres, 1, n_rays, ray_seed=0)
    tables = isect.tables
    padded, _ = jax.jit(lambda o, d: prep_rays_bucketed(
        Ray(origin=o, direction=d), 64))(o, d)
    sp = SoftParams()

    def loss_fn(render_fn, po, pd):
        def loss(centers, tb):
            img, _ = render_fn(scene.replace(centers=centers), po, pd, tb,
                               sp, max_leaves=16, subpacket=64)
            return jnp.mean(img)
        return jax.jit(jax.grad(loss))

    g_full = loss_fn(soft_render_sparse_leaforder, padded.origin,
                     padded.direction)
    timing, g = time_calls(g_full, scene.centers, tables, n=3)
    # 8k-ray slice: the fast leaf-ordered path vs the exact per-ray
    # composite on the same candidates.
    so, sd = padded.origin[:n_slice], padded.direction[:n_slice]
    g_s = loss_fn(soft_render_sparse_leaforder, so, sd)(scene.centers,
                                                        tables)
    with jax.default_matmul_precision("highest"):
        g_ref = loss_fn(soft_render_sparse_packets, so, sd)(scene.centers,
                                                            tables)
    res = {"spheres": n_spheres, "rays": n_rays,
           "fwd_bwd": timing.to_json(),
           "fwd_bwd_mrays": n_rays / timing.median_s / 1e6,
           "grads_finite": bool(np.isfinite(np.asarray(g)).all()),
           "slice": n_slice, "slice_grads": compare_grads(g_s, g_ref)}
    res["ok"] = bool(res["grads_finite"] and res["slice_grads"]["ok"])
    return emit("sparse_diff", res)


def phase_gpu_tests():
    """The repo's card-only tests (``pytest -m gpu``), in this process so
    that one process holds the card."""
    import os
    import pytest

    root = os.path.dirname(os.path.abspath(__file__))
    os.environ["TRACER_TESTS_ON_GPU"] = "1"
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:xdist", "--rootdir", root,
                      os.path.join(root, "tests", "test_gpu.py")])
    return emit("gpu_tests", {"pytest_exit": int(rc),
                              "seconds": time.perf_counter() - t0,
                              "ok": int(rc) == 0})


DEFAULT_PHASES = [phase_gpu_tests, phase_closest, phase_closest_10m,
                  phase_shadow, phase_render, phase_diff]


# ---------------------------------------------------------------------------
# Four devices
# ---------------------------------------------------------------------------

def _devices_of(tree) -> list:
    import jax
    return sorted({d.id for x in jax.tree_util.tree_leaves(tree)
                   for d in x.devices()})


def _rel_err(x, ref) -> float:
    """max |x - ref| over max |ref| (absolute where ref is all zero)."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


def phase_four(n_big=1_000_000, n_rays=65_536, ring_rays=8192,
               n_check=4096):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tracer.config import TracerConfig
    from tracer.core.sort import sort_rays_octahedral
    from tracer.core.types import Ray
    from tracer.diff.fit import (fit_scene, make_loss_fn,
                                 make_value_and_grad, scene_to_params)
    from tracer.diff.soft import SoftParams
    from tracer.dist.mesh import RAY_AXIS, SCENE_AXIS, scene_mesh
    from tracer.dist.ring import build_sharded_bvh, nearest_hit_ring
    from tracer.dist.shard import nearest_hit_sharded
    from tracer.dist.train import make_train_step
    from tracer.bench.workload import origin_rays
    from tracer.intersect.select import make_intersector
    from tracer.scene.camera import Camera, camera_rays
    from tracer.scene.scene import benchmark_scene, random_scene

    n_dev = len(jax.devices())
    mesh = scene_mesh(ray_shards=2, scene_shards=2)
    one = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
               (RAY_AXIS, SCENE_AXIS))
    out = {"devices": n_dev, "mesh": dict(mesh.shape)}
    scene = benchmark_scene(jax.random.PRNGKey(4), n_big, world_size=1000.0)

    # (a) one sharded training step vs the same step on one card.
    cfg = TracerConfig(width=16, height=8, max_depth=1)
    cam = Camera.default().replace(position=jnp.zeros(3, jnp.float32))
    rays = camera_rays(cam, cfg)
    ray_o, ray_d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    target = jnp.zeros_like(ray_o)

    def train(m):
        init_fn, factory = make_train_step(m)
        params, opt_state = init_fn(scene)
        put = lambda x, spec: jax.device_put(x, NamedSharding(m, spec))
        params = jax.tree_util.tree_map(lambda x: put(x, P(SCENE_AXIS)),
                                        params)
        opt_state = jax.tree_util.tree_map(
            lambda x: put(x, P(SCENE_AXIS) if x.ndim else P()), opt_state)
        args = (params, opt_state, put(ray_o, P(RAY_AXIS)),
                put(ray_d, P(RAY_AXIS)), put(target, P(RAY_AXIS)))
        devs = {"params": _devices_of(params), "rays": _devices_of(args[2])}
        new_params, new_opt, loss = jax.block_until_ready(
            factory(opt_state)(*args))
        mu = jax.tree_util.tree_leaves(new_opt[0].mu)
        return float(loss), [np.asarray(x) for x in mu], devs

    loss4, mu4, devs4 = train(mesh)
    with jax.default_matmul_precision("highest"):
        loss1, mu1, _ = train(one)
    # Gradients (Adam's first moment after one step, 0.1 g) summed over
    # rays in another order (per shard, then the all-reduce): 1e-3 of the
    # largest component is far above the reordering seen on the card
    # (PERF.md) and far below the factor 2 of a double-counted all-reduce.
    mus = [compare_close(a, b, rtol=0.0,
                         atol=1e-3 * np.abs(b).max() + 1e-12)
           for a, b in zip(mu4, mu1)]
    out["train_step"] = {
        "spheres": n_big, "rays": int(ray_o.shape[0]), "loss": loss4,
        "loss_one_card": loss1, "operand_devices": devs4,
        "grad_moments": [m["max_err_over_max_ref"] for m in mus],
        "grad_moments_ok": all(m["ok"] for m in mus),
        "ok": bool(abs(loss4 - loss1) <= 1e-4 * abs(loss1) + 1e-12
                   and all(m["ok"] for m in mus))}

    # (b) ray-sharded closest hit through the selector's intersector, vs
    # the same on one card and vs brute force on sampled rays.
    isect = make_intersector(scene)
    o, d = origin_rays(n_rays, seed=5)
    rays, _ = sort_rays_octahedral(Ray(origin=o, direction=d))
    nearest = isect.nearest_for(scene)
    sharded = jax.jit(lambda r, s: nearest_hit_sharded(
        r, s, mesh, lambda rr, ss: nearest(rr)))
    put_r = jax.device_put(rays, NamedSharding(mesh, P(RAY_AXIS)))
    rec4 = jax.block_until_ready(sharded(put_r, scene))
    rec1 = jax.block_until_ready(jax.jit(nearest)(rays))
    idx = _sample(n_rays, n_check, seed=9)
    o_s, d_s = rays.origin[idx], rays.direction[idx]
    ref_t, ref_sid = brute_closest(o_s, d_s, scene, 64)
    cmp = compare_closest(np.asarray(rec4.index)[idx],
                          np.asarray(rec4.t)[idx], np.asarray(ref_sid),
                          np.asarray(ref_t), o_s, d_s, scene.centers,
                          scene.radii)
    same = bool((np.asarray(rec4.index) == np.asarray(rec1.index)).all()
                and compare_close(rec4.t, rec1.t, rtol=0.0, atol=0.0)["ok"])
    out["nearest_hit_sharded"] = {
        "spheres": n_big, "rays": n_rays, "path": isect.path,
        "equals_one_card": same, "compare": cmp,
        "operand_devices": {"rays": _devices_of(put_r),
                            "result": _devices_of(rec4.t)},
        "ok": bool(same and cmp["ok"])}

    # (c) ring scene sharding (per-shard BVHs) vs brute force on one card.
    rr = Ray(origin=rays.origin[:ring_rays],
             direction=rays.direction[:ring_rays])
    sbvh = build_sharded_bvh(np.asarray(scene.centers),
                             np.asarray(scene.radii), num_shards=2,
                             leaf_size=8)
    ring = jax.jit(lambda r, s: nearest_hit_ring(r, s, mesh,
                                                 axis=SCENE_AXIS, sbvh=sbvh))
    rec_ring = jax.block_until_ready(ring(rr, scene))
    ref_t, ref_sid = brute_closest(rr.origin, rr.direction, scene, 64)
    cmp = compare_closest(rec_ring.index, rec_ring.t, ref_sid, ref_t,
                          rr.origin, rr.direction, scene.centers,
                          scene.radii)
    out["nearest_hit_ring"] = {
        "spheres": n_big, "rays": ring_rays, "compare": cmp,
        "operand_devices": {"result": _devices_of(rec_ring.t)},
        "ok": cmp["ok"]}

    # (d) one microbatched, ray-sharded fit step vs the same on one card.
    small = random_scene(jax.random.PRNGKey(6), 20)
    cfg3 = TracerConfig(width=64, height=32, max_depth=1)
    target_img = jnp.zeros((cfg3.height, cfg3.width, 3))
    fit4 = fit_scene(target_img, small, Camera.default(), steps=2,
                     mesh=mesh, grad_microbatch=2, config=cfg3)
    with jax.default_matmul_precision("highest"):
        fit1 = fit_scene(target_img, small, Camera.default(), steps=2,
                         config=cfg3)
    cmp = compare_close(fit4.losses, fit1.losses, rtol=1e-4)
    # The step's gradient itself (Adam's first step hides its scale).
    lf = make_loss_fn(Camera.default(), SoftParams(), cfg3, False)
    params = (scene_to_params(small), {"position": Camera.default().position,
                                       "yaw": Camera.default().yaw,
                                       "pitch": Camera.default().pitch})
    r3 = camera_rays(Camera.default(), cfg3)
    fargs = (params, r3.origin.reshape(-1, 3), r3.direction.reshape(-1, 3),
             target_img.reshape(-1, 3))
    _, g4 = make_value_and_grad(lf, mesh, grad_microbatch=2)(*fargs)
    with jax.default_matmul_precision("highest"):
        _, g1 = make_value_and_grad(lf)(*fargs)
        with jax.enable_x64(True):
            f64 = jax.tree_util.tree_map(
                lambda x: jnp.asarray(x, jnp.float64), fargs)
            _, g64 = make_value_and_grad(lf)(*f64)
    leaves = [jax.tree_util.tree_leaves(g) for g in (g4, g1, g64)]
    # This gradient is ill-conditioned in f32 (large terms of both signs
    # cancel), so two f32 summation orders may differ by about f32's own
    # error. Both are judged against the f64 gradient: the sharded one
    # may be off by at most twice the one-card f32 error, where a
    # double-counted all-reduce is off by 100 %.
    err1 = [_rel_err(a, b) for a, b in zip(leaves[1], leaves[2])]
    err4 = [_rel_err(a, b) for a, b in zip(leaves[0], leaves[2])]
    bound = 2.0 * max(err1) + 1e-6
    out["fit_microbatched"] = {"losses": fit4.losses.tolist(),
                               "losses_one_card": fit1.losses.tolist(),
                               "grad_err_vs_f64": err4,
                               "grad_err_vs_f64_one_card": err1,
                               "grad_bound": bound,
                               "grad_4_vs_1": [_rel_err(a, b) for a, b in
                                               zip(leaves[0], leaves[1])],
                               "operand_devices": _devices_of(
                                   fit4.scene.centers),
                               "ok": bool(cmp["ok"]
                                          and max(err4) <= bound)}
    out["ok"] = all(v["ok"] for v in out.values() if isinstance(v, dict)
                    and "ok" in v)
    return emit("four_devices", out)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-device sharded path")
    args = p.parse_args(argv)

    import jax
    from tracer.bench.workload import device_info, gpu_card
    from tracer.compile_cache import enable_compile_cache

    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's platform is "
              f"{dev['platform']}", file=sys.stderr)
        return 2
    if args.four and dev["count"] < 4:
        print(f"--four needs four GPUs; JAX sees {dev['count']}",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    print(gpu_card(), flush=True)        # nvidia-smi's name, power.limit
    print(f"device: {json.dumps(dev)}; compile cache: {cache}", flush=True)

    t0 = time.perf_counter()
    phases = [phase_four] if args.four else DEFAULT_PHASES
    results = [ph() for ph in phases]
    stats = jax.devices()[0].memory_stats() or {}
    print(f"total_s: {time.perf_counter() - t0:.1f}; peak_bytes_in_use: "
          f"{stats.get('peak_bytes_in_use')}", flush=True)
    if not all(r["ok"] for r in results):
        print("FAILED: " + ", ".join(
            ph.__name__ for ph, r in zip(phases, results) if not r["ok"]),
            file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
