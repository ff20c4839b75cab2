"""CI coverage for the distributed pieces: the scaling harness, the
sharded train step called directly (loss and gradients), the
microbatched-overlap gradient path, and a real fault-injection resume
(child process SIGKILLed mid-fit).
"""

import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tracer.bench.scaling import measure_scaling
from tracer.config import TracerConfig
from tracer.core.types import Ray
from tracer.diff.fit import fit_scene
from tracer.diff.soft import SoftParams
from tracer.dist.mesh import RAY_AXIS, SCENE_AXIS, ray_mesh
from tracer.scene.camera import Camera
from tracer.scene.scene import benchmark_scene


def _rays(rng, n):
    d = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return Ray(origin=jnp.zeros((n, 3), jnp.float32), direction=jnp.array(d))


def test_scaling_harness_runs_on_virtual_mesh(rng):
    from tracer.intersect.brute import nearest_hit_brute
    scene = benchmark_scene(jax.random.PRNGKey(0), 64, world_size=40.0)
    rays = _rays(rng, 1024)
    rows = measure_scaling(scene, rays, nearest_hit_brute,
                           device_counts=[1, 2, 8], reps=2)
    assert [r["devices"] for r in rows] == [1, 2, 8]
    assert all(np.isfinite(r["mrays_per_s"]) and r["mrays_per_s"] > 0
               for r in rows)
    assert rows[0]["efficiency"] == 1.0
    # No perf assertion on a shared-CPU virtual mesh; structure only.


def test_train_step_direct():
    # The dist/train.py step exercised directly (not only via the dryrun):
    # two steps on a 4x2 mesh, loss finite and decreasing-or-equal, params
    # actually move.
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tracer.dist.train import make_train_step
    from tracer.scene.camera import camera_rays

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs).reshape(4, 2), (RAY_AXIS, SCENE_AXIS))
    # radius 4 so the 16x8 image actually covers spheres (r=0.5 ones are
    # subpixel from the default camera and leave the soft grads at ~0).
    scene = benchmark_scene(jax.random.PRNGKey(0), 16, world_size=40.0,
                            radius=4.0)
    cfg = TracerConfig(width=16, height=8, max_depth=1)
    rays = camera_rays(Camera.default(), cfg)
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    target = jnp.zeros_like(o)

    init_fn, step_factory = make_train_step(mesh, lr=1e-2)
    params, opt_state = init_fn(scene)
    step = step_factory(opt_state)

    shard = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    params = jax.tree_util.tree_map(lambda x: shard(x, P(SCENE_AXIS)), params)
    opt_state = jax.tree_util.tree_map(
        lambda x: shard(x, P(SCENE_AXIS) if getattr(x, "ndim", 0) > 0
                        else P()), opt_state)
    o, d, target = (shard(x, P(RAY_AXIS)) for x in (o, d, target))

    p0 = np.asarray(params["centers"])
    params, opt_state, l1 = step(params, opt_state, o, d, target)
    params, opt_state, l2 = step(params, opt_state, o, d, target)
    assert np.isfinite(float(l1)) and np.isfinite(float(l2))
    assert float(l2) <= float(l1) + 1e-6
    assert not np.allclose(p0, np.asarray(params["centers"]))


def test_sharded_train_loss_equals_unsharded_soft_render():
    """VERDICT r4 task 5: the scene-sharded trainer must optimize the SAME
    model the renderer evaluates. With per-shard top-K >= shard size the
    merged ordered composite is exact, so the sharded step's loss must
    equal the single-device soft_render loss on the same params."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tracer.diff.soft import SoftParams, soft_render
    from tracer.dist.train import make_train_step
    from tracer.scene.camera import camera_rays

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs).reshape(2, 4), (RAY_AXIS, SCENE_AXIS))
    scene = benchmark_scene(jax.random.PRNGKey(3), 32, world_size=40.0,
                            radius=4.0)
    cfg = TracerConfig(width=16, height=8, max_depth=1)
    rays = camera_rays(Camera.default(), cfg)
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    target = jnp.zeros_like(o)
    soft = SoftParams()

    # k_top = shard size (32/4 = 8): every local sphere is a candidate,
    # the merge holds the WHOLE scene -> exact equality.
    init_fn, step_factory = make_train_step(mesh, soft=soft, k_top=8)
    params, opt_state = init_fn(scene)
    step = step_factory(opt_state)

    shard = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
    params_s = jax.tree_util.tree_map(lambda x: shard(x, P(SCENE_AXIS)),
                                      params)
    opt_state = jax.tree_util.tree_map(
        lambda x: shard(x, P(SCENE_AXIS) if getattr(x, "ndim", 0) > 0
                        else P()), opt_state)
    os_, ds_, ts_ = (shard(x, P(RAY_AXIS)) for x in (o, d, target))
    _, _, loss_sharded = step(params_s, opt_state, os_, ds_, ts_)

    # Unsharded reference loss through the shipped renderer on the same
    # (sigmoid/softplus round-tripped) parameters.
    from tracer.diff.fit import params_to_scene
    scene_rt = params_to_scene(params)
    img = soft_render(scene_rt, Camera.default(), soft, cfg,
                      rays=Ray(origin=o, direction=d))
    loss_ref = float(jnp.mean((img.reshape(-1, 3) - target) ** 2))
    np.testing.assert_allclose(float(loss_sharded), loss_ref, rtol=1e-5)


def test_fit_microbatched_overlap_matches_single():
    # The overlapped per-tile psum path must compute the same optimization
    # trajectory as the single all-reduce (same grads up to fp reassoc).
    scene = benchmark_scene(jax.random.PRNGKey(3), 24, world_size=40.0)
    cfg = TracerConfig(width=16, height=16, max_depth=1)
    cam = Camera.default()
    from tracer.diff.soft import soft_render
    target = soft_render(
        benchmark_scene(jax.random.PRNGKey(4), 24, world_size=40.0),
        cam, None, cfg)
    mesh = ray_mesh(8)

    r1 = fit_scene(target, scene, cam, steps=3, mesh=mesh,
                   grad_microbatch=1, config=cfg)
    r2 = fit_scene(target, scene, cam, steps=3, mesh=mesh,
                   grad_microbatch=4, config=cfg)
    np.testing.assert_allclose(r1.losses, r2.losses, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(r1.scene.centers),
                               np.asarray(r2.scene.centers), atol=1e-5)


def test_sharded_train_gradients_equal_unsharded():
    """The gradient all-reduce counts every device once: the sharded step's
    gradient (Adam's first moment after one step, 0.1 g) equals the same
    step's on a one-device mesh, not a multiple of it."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from tracer.dist.train import make_train_step
    from tracer.scene.camera import camera_rays

    scene = benchmark_scene(jax.random.PRNGKey(3), 64, world_size=40.0,
                            radius=3.0)
    cfg = TracerConfig(width=16, height=8, max_depth=1)
    rays = camera_rays(Camera.default(), cfg)
    o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    target = jnp.zeros_like(o)

    def moments(mesh):
        init_fn, factory = make_train_step(mesh, k_top=16)
        params, opt_state = init_fn(scene)
        put = lambda x, spec: jax.device_put(x, NamedSharding(mesh, spec))
        params = jax.tree_util.tree_map(lambda x: put(x, P(SCENE_AXIS)),
                                        params)
        opt_state = jax.tree_util.tree_map(
            lambda x: put(x, P(SCENE_AXIS) if x.ndim else P()), opt_state)
        _, new_opt, _ = factory(opt_state)(
            params, opt_state, put(o, P(RAY_AXIS)), put(d, P(RAY_AXIS)),
            put(target, P(RAY_AXIS)))
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(
            new_opt[0].mu)]

    devs = np.array(jax.devices()[:8])
    sharded = moments(Mesh(devs.reshape(2, 4), (RAY_AXIS, SCENE_AXIS)))
    single = moments(Mesh(devs[:1].reshape(1, 1), (RAY_AXIS, SCENE_AXIS)))
    for a, b in zip(sharded, single):
        np.testing.assert_allclose(a, b, atol=1e-4 * np.abs(b).max())


def test_fit_sharded_gradients_equal_unsharded():
    """fit_scene's ray-sharded (and microbatched) gradient equals the
    single-device gradient of the same mean loss."""
    from tracer.diff.fit import (make_loss_fn, make_value_and_grad,
                                 scene_to_params)
    from tracer.scene.camera import camera_rays

    scene = benchmark_scene(jax.random.PRNGKey(3), 24, world_size=40.0)
    cfg = TracerConfig(width=16, height=16, max_depth=1)
    cam = Camera.default()
    rays = camera_rays(cam, cfg)
    o, d = rays.origin.reshape(-1, 3), rays.direction.reshape(-1, 3)
    target = jnp.zeros_like(o)
    params = (scene_to_params(scene), {"position": cam.position,
                                       "yaw": cam.yaw, "pitch": cam.pitch})
    loss_fn = make_loss_fn(cam, SoftParams(), cfg, False)
    v1, g1 = make_value_and_grad(loss_fn)(params, o, d, target)
    for micro in (1, 4):
        v8, g8 = make_value_and_grad(loss_fn, ray_mesh(8), micro)(
            params, o, d, target)
        np.testing.assert_allclose(float(v8), float(v1), rtol=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(g8),
                        jax.tree_util.tree_leaves(g1)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1e-5 * np.abs(b).max() + 1e-12)


_CHILD = r"""
import os
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_num_cpu_devices", 1)
import jax.numpy as jnp
from tracer.config import TracerConfig
from tracer.diff.fit import fit_scene
from tracer.diff.soft import soft_render
from tracer.scene.camera import Camera
from tracer.scene.scene import benchmark_scene

cfg = TracerConfig(width=48, height=48, max_depth=1)
cam = Camera.default()
scene = benchmark_scene(jax.random.PRNGKey(3), 12, world_size=40.0)
target = soft_render(benchmark_scene(jax.random.PRNGKey(4), 12,
                                     world_size=40.0), cam, None, cfg)
import sys
print("START", flush=True)
fit_scene(target, scene, cam, steps=10000, lr=1e-2, config=cfg,
          checkpoint_path=sys.argv[1], checkpoint_every=1)
"""


def _ckpt_step(path):
    import json
    try:
        with np.load(path) as z:
            return int(json.loads(bytes(z["__meta__"]))["step"])
    except Exception:
        return -1


def test_fault_injection_kill_and_resume(tmp_path):
    """Kill a fitting process mid-run (SIGKILL), resume from its last
    checkpoint, and verify the continuation is bitwise identical to an
    uninterrupted run — SURVEY.md §5's elastic-recovery contract."""
    ckpt = str(tmp_path / "fit.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.getcwd() + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, ckpt], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    # Wait until a few checkpoints have landed, then SIGKILL mid-flight.
    deadline = time.time() + 300
    while time.time() < deadline and _ckpt_step(ckpt) < 3:
        time.sleep(0.1)
        if proc.poll() is not None:
            raise AssertionError("child exited before writing checkpoints")
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    s = _ckpt_step(ckpt)
    assert s >= 3, f"no usable checkpoint before kill (step={s})"

    cfg = TracerConfig(width=48, height=48, max_depth=1)
    cam = Camera.default()
    scene = benchmark_scene(jax.random.PRNGKey(3), 12, world_size=40.0)
    from tracer.diff.soft import soft_render
    target = soft_render(benchmark_scene(jax.random.PRNGKey(4), 12,
                                         world_size=40.0), cam, None, cfg)

    total = s + 5
    resumed = fit_scene(target, scene, cam, steps=total, lr=1e-2, config=cfg,
                        checkpoint_path=ckpt, resume=True)
    clean = fit_scene(target, scene, cam, steps=total, lr=1e-2, config=cfg)
    np.testing.assert_array_equal(np.asarray(resumed.scene.centers),
                                  np.asarray(clean.scene.centers))
    np.testing.assert_allclose(resumed.losses[-1], clean.losses[-1],
                               rtol=0, atol=0)
