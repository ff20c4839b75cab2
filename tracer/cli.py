"""Command-line interface: ``render | bench | fit | viz``.

Replaces the reference's interactive scanf menu (src/main.c:92-100) and key
bindings (README.md:85-110). Interactive SDL windowing is out of scope on
accelerator hosts (SURVEY.md section 2 item 8); rendering writes PNG frames,
the fly-through becomes a scripted pose trajectory, and the benchmark writes
the reference's gnuplot-format data file plus a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _save_png(img, path):
    from tracer.viz.png import write_png
    write_png(path, img)
    print(f"wrote {path}")


def _make_scene_camera(args):
    import jax
    from tracer.scene.scene import random_scene, benchmark_scene
    from tracer.scene.camera import Camera
    import jax.numpy as jnp

    key = jax.random.PRNGKey(args.seed)
    if args.scene == "interactive":
        scene = random_scene(key, args.spheres)       # src/main.c:213-221
    else:
        scene = benchmark_scene(key, args.spheres, world_size=args.world_size)
    cam = Camera.default()
    if args.camera_pos:
        cam = cam.replace(position=jnp.asarray(
            [float(x) for x in args.camera_pos.split(",")], jnp.float32))
    if args.yaw is not None:
        cam = cam.replace(yaw=jnp.float32(args.yaw))
    if args.pitch is not None:
        cam = cam.replace(pitch=jnp.float32(args.pitch))
    return scene, cam


def _config(args):
    from tracer.config import TracerConfig
    return TracerConfig(width=args.width, height=args.height,
                        max_depth=args.depth)


def _make_intersector(args, scene, cam):
    """Resolve --impl to an Intersector (tracer/intersect/select.py).

    'auto' lets the selector choose from the scene size (dense sweep or the
    hierarchical leaf-cull path); 'brute' is the reference's bvh == NULL
    toggle (src/renderer.c:29-44); 'traverse' is the per-ray jnp BVH walk.
    """
    from tracer.intersect.brute import nearest_hit_brute, any_hit_brute
    from tracer.intersect.select import (Intersector, hierarchical_impl,
                                         make_intersector)

    impl = args.impl
    if not args.bvh or impl == "brute":
        return Intersector(
            path="brute",
            nearest_for=lambda s: (lambda r: nearest_hit_brute(r, s)),
            occluded_for=lambda s: (lambda r, tm: any_hit_brute(r, s, tm)),
            info={"path": "brute"})
    if impl == "auto":
        path = None                       # the selector's choice by size
    elif impl == "leafcull":
        path = "leafcull_" + hierarchical_impl()
    else:
        path = impl
    near = tuple(np.asarray(cam.position))
    if path == "traverse":
        from tracer.bvh.builder import build_bvh
        from tracer.intersect.traverse import nearest_hit_bvh
        bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii),
                        leaf_size=args.leaf_size, near_point=near)
        dense = make_intersector(scene, "dense")
        return Intersector(
            path=path,
            nearest_for=lambda s: (lambda r: nearest_hit_bvh(r, s, bvh)),
            occluded_for=dense.occluded_for, info={"path": path})
    isect = make_intersector(scene, path, near_point=near)
    if "bvh_build_ms" in isect.info:
        print(f"BVH built in {isect.info['bvh_build_ms']:.1f} ms "
              f"({isect.info['bvh_build']})")         # src/main.c:223-228
    return isect


def render_frames(args, isect=None):
    """Render ``args.frames`` frames as ``render`` would: returns
    (accumulated image (H, W, 3), Intersector, per-frame seconds). Pass
    ``isect`` to render the same scene, camera and noise through another
    intersector."""
    import jax
    import jax.numpy as jnp
    from tracer.bench.timing import time_calls
    from tracer.integrator.wavefront import render, Accumulator, bounce_noise

    cfg = _config(args)
    scene, cam = _make_scene_camera(args)
    if isect is None:
        isect = _make_intersector(args, scene, cam)
    nearest = isect.nearest_for
    print(f"intersector: {isect.path}")

    if args.mode == "direct":
        # Primary + shadow rays (BASELINE config 3): one closest hit, one
        # any-hit toward a point light, Lambertian direct term.
        from tracer.integrator.wavefront import render_direct
        light = jnp.asarray([float(x) for x in args.light.split(",")],
                            jnp.float32)
        occluded = isect.occluded_for
        frame = jax.jit(lambda s, c, noise: render_direct(
            s, c, light, nearest, occluded, cfg,
            light_intensity=args.light_intensity, compact=args.compact))
    else:
        frame = jax.jit(lambda s, c, noise: render(s, c, None, nearest, cfg,
                                                   noise=noise,
                                                   compact=args.compact))

    # Fly-through trajectory: move along the camera's forward axis by
    # --fly-speed per frame (the scripted analog of WASD, src/main.c:288-315);
    # accumulation resets on motion and averages when still
    # (src/main.c:241-273).
    acc = Accumulator.zero(cfg.height, cfg.width)
    key = jax.random.PRNGKey(args.seed + 1)
    start_frame = 0
    if args.resume and args.checkpoint:
        import os
        if os.path.exists(args.checkpoint):
            from tracer.checkpoint import load_pytree
            (acc, key), meta = load_pytree(args.checkpoint, (acc, key))
            start_frame = int(meta["frame"])
            print(f"resumed accumulation at frame {start_frame}")

    profiler_cm = None
    if args.profile:
        jax.profiler.start_trace(args.profile)
        profiler_cm = True

    times = []
    for i in range(start_frame, args.frames):
        key, sub = jax.random.split(key)
        noise = bounce_noise(sub, (cfg.height, cfg.width), cfg.max_depth)
        moving = args.fly_speed != 0.0 and i > 0
        if moving:
            f, _, _ = cam.basis()
            cam = cam.replace(position=cam.position + args.fly_speed * f)
        timing, img = time_calls(frame, scene, cam, noise, n=1, warmup=0)
        times.append(timing.median_s)
        acc = acc.reset_to(img) if (moving or i == 0) else acc.add(img)
        if args.checkpoint:
            from tracer.checkpoint import save_pytree
            save_pytree(args.checkpoint, (acc, key), meta={"frame": i + 1})

    if profiler_cm:
        jax.profiler.stop_trace()
        print(f"profiler trace written to {args.profile}")
    return acc.mean, isect, times


def cmd_render(args):
    import jax

    img, isect, times = render_frames(args)
    cfg = _config(args)
    _save_png(img, args.out)
    times = times[1:] or times
    mean_t = float(np.mean(times))
    rays_per_frame = cfg.width * cfg.height * cfg.max_depth
    print(f"frames: {args.frames}, mean frame time {mean_t:.4f} s "
          f"({1.0 / mean_t:.2f} FPS)")           # src/main.c:416-421
    if args.metrics:
        with open(args.metrics, "w") as f:
            json.dump({
                "width": cfg.width, "height": cfg.height,
                "max_depth": cfg.max_depth, "spheres": args.spheres,
                "frames": args.frames, "compact": bool(args.compact),
                "mean_frame_s": round(mean_t, 5),
                "fps": round(1.0 / mean_t, 2),
                "mrays_per_s": round(rays_per_frame / mean_t / 1e6, 2),
                "platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                **isect.info,
            }, f, indent=2)
        print(f"wrote {args.metrics}")


def cmd_bench(args):
    from tracer.bench.harness import run_sweep

    sizes = ([int(s) for s in args.sizes.split(",")] if args.sizes else None)
    kwargs = dict(num_rays=args.rays, world_size=args.world_size)
    if sizes:
        kwargs["sizes"] = tuple(sizes)
    res = run_sweep(**kwargs)
    res.save_data_txt("benchmark_data.txt")      # src/benchmark.c:160-170
    with open("benchmark_results.json", "w") as f:
        json.dump(res.to_json(), f, indent=2)
    print(json.dumps(res.to_json()["complexity"], indent=2))
    print("wrote benchmark_data.txt benchmark_results.json")


def cmd_fit(args):
    import jax
    import jax.numpy as jnp
    from tracer.diff.soft import soft_render, SoftParams
    from tracer.diff.fit import fit_scene

    cfg = _config(args)
    scene, cam = _make_scene_camera(args)
    soft = SoftParams(edge_sharpness=jnp.float32(args.sharpness),
                      tau_depth=jnp.float32(args.tau))
    target = soft_render(scene, cam, soft, cfg)
    _save_png(target, "fit_target.png")

    key = jax.random.PRNGKey(args.seed + 7)
    init = scene.replace(
        centers=scene.centers + 0.1 * jax.random.normal(
            key, scene.centers.shape) * jnp.mean(scene.radii),
        albedo=jnp.clip(scene.albedo + 0.2, 0.05, 0.95),
    )
    _save_png(soft_render(init, cam, soft, cfg), "fit_init.png")

    res = fit_scene(target, init, cam, steps=args.steps, lr=args.lr,
                    soft=soft, config=cfg,
                    checkpoint_path=args.checkpoint,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume)
    _save_png(soft_render(res.scene, cam, soft, cfg), "fit_final.png")
    print(f"loss: {res.losses[0]:.6f} -> {res.losses[-1]:.6f} "
          f"({args.steps} steps)")
    np.savetxt("fit_losses.txt", res.losses)


def cmd_viz(args):
    import jax
    from tracer.bvh.builder import build_bvh
    from tracer.bvh.flat import bvh_stats
    from tracer.integrator.wavefront import render, bounce_noise
    from tracer.intersect.brute import nearest_hit_brute
    from tracer.viz.wireframe import draw_bvh_wireframe

    cfg = _config(args)
    scene, cam = _make_scene_camera(args)
    bvh = build_bvh(np.asarray(scene.centers), np.asarray(scene.radii))
    stats = bvh_stats(bvh, scene.num_spheres)
    print(json.dumps(stats, indent=2))

    noise = bounce_noise(jax.random.PRNGKey(1), (cfg.height, cfg.width),
                         cfg.max_depth)
    img = render(scene, cam, None,
                 lambda s: (lambda r: nearest_hit_brute(r, s)), cfg,
                 noise=noise)
    overlay = draw_bvh_wireframe(np.asarray(img), bvh, cam, cfg,
                                 max_draw_depth=args.viz_depth)
    _save_png(overlay, args.out)


def build_parser():
    p = argparse.ArgumentParser(prog="tracer",
                                description="differentiable SAH-BVH ray tracer")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--width", type=int, default=800)    # constants.h:7
        sp.add_argument("--height", type=int, default=600)   # constants.h:8
        sp.add_argument("--depth", type=int, default=5)      # main.c:19
        sp.add_argument("--spheres", type=int, default=20)   # main.c:18
        sp.add_argument("--scene", choices=["interactive", "benchmark"],
                        default="interactive")
        sp.add_argument("--world-size", type=float, default=1000.0)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--camera-pos", default=None,
                        help="x,y,z (default 0,4,50; src/main.c:203-211)")
        sp.add_argument("--yaw", type=float, default=None)
        sp.add_argument("--pitch", type=float, default=None)

    sp = sub.add_parser("render", help="render frames to PNG")
    common(sp)
    sp.add_argument("--frames", type=int, default=1)
    sp.add_argument("--fly-speed", type=float, default=0.0,
                    help="forward units/frame (scripted fly-through)")
    sp.add_argument("--bvh", action=argparse.BooleanOptionalAction,
                    default=True, help="the 'B' toggle (src/main.c:317-320)")
    sp.add_argument("--impl", default="auto",
                    choices=["auto", "brute", "dense", "traverse", "leafcull"],
                    help="intersector (auto: chosen from the scene size)")
    sp.add_argument("--leaf-size", type=int, default=16,
                    help="leaf size of the --impl traverse BVH")
    sp.add_argument("--compact", action=argparse.BooleanOptionalAction,
                    default=False, help="wavefront compaction between bounces")
    sp.add_argument("--mode", choices=["path", "direct"], default="path",
                    help="path = reference bounce integrator; direct = "
                         "primary + shadow rays (BASELINE config 3)")
    sp.add_argument("--light", default="0,200,0",
                    help="point light position x,y,z (direct mode)")
    sp.add_argument("--light-intensity", type=float, default=1.0)
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace into DIR")
    sp.add_argument("--checkpoint", default=None,
                    help="accumulation checkpoint path (npz)")
    sp.add_argument("--resume", action="store_true",
                    help="resume accumulation from --checkpoint")
    sp.add_argument("--metrics", default=None,
                    help="write frame-time/FPS JSON here")
    sp.add_argument("--out", default="render.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("bench", help="BVH vs brute sweep")
    common(sp)
    sp.add_argument("--sizes", default=None,
                    help="comma-separated sphere counts")
    sp.add_argument("--rays", type=int, default=131072)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("fit", help="inverse-rendering demo")
    common(sp)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--lr", type=float, default=3e-2)
    sp.add_argument("--sharpness", type=float, default=12.0)
    sp.add_argument("--tau", type=float, default=0.3)
    sp.add_argument("--checkpoint", default=None,
                    help="optimizer-state checkpoint path (npz)")
    sp.add_argument("--checkpoint-every", type=int, default=50)
    sp.add_argument("--resume", action="store_true")
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("viz", help="BVH wireframe overlay + stats")
    common(sp)
    sp.add_argument("--viz-depth", type=int, default=8)
    sp.add_argument("--out", default="bvh_viz.png")
    sp.set_defaults(fn=cmd_viz)
    return p


def main(argv=None):
    # TRACER_DEBUG=1 -> jax_debug_nans for the whole run (tracer/debug.py).
    from tracer.compile_cache import enable_compile_cache
    from tracer.debug import maybe_enable_debug
    enable_compile_cache()
    maybe_enable_debug()
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
