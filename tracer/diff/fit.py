"""Inverse rendering: optimize scene geometry/material/camera to match a
target image (BASELINE config 4).

Gradient descent on the smoothed forward model (tracer/diff/soft.py):
pixels -> MSE loss -> jax.grad -> optax updates to sphere centers, radii,
albedo, and (optionally) camera pose. Radii are parameterized through
softplus to stay positive; albedo through a sigmoid to stay in [0, 1].

On a device mesh the loss is computed on sharded rays and the parameter
gradients are psum'd across the ray axis -- the DP-gradient all-reduce of
this framework (SURVEY.md section 2, parallelism item 3).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import Array
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tracer.checkpoint import save_pytree, load_pytree
from tracer.config import TracerConfig, DEFAULT_CONFIG
from tracer.core.types import Ray
from tracer.diff.soft import soft_render, SoftParams
from tracer.dist.mesh import RAY_AXIS
from tracer.scene.camera import Camera, camera_rays
from tracer.scene.scene import Scene


class FitResult(NamedTuple):
    scene: Scene
    camera: Camera
    losses: np.ndarray


def scene_to_params(scene: Scene) -> dict:
    """Unconstrained parameterization: radii > 0 via softplus^-1, albedo in
    [0, 1] via logit."""
    inv_softplus = lambda y: jnp.log(jnp.expm1(jnp.maximum(y, 1e-6)))
    clip = lambda p: jnp.clip(p, 1e-5, 1 - 1e-5)
    logit = lambda p: jnp.log(clip(p) / (1 - clip(p)))
    return {
        "centers": scene.centers,
        "radii_raw": inv_softplus(scene.radii),
        "albedo_raw": logit(scene.albedo),
    }


def params_to_scene(params: dict) -> Scene:
    return Scene(
        centers=params["centers"],
        radii=jax.nn.softplus(params["radii_raw"]),
        albedo=jax.nn.sigmoid(params["albedo_raw"]),
    )


def make_loss_fn(camera: Camera, soft: SoftParams, config: TracerConfig,
                 optimize_camera: bool):
    def loss_fn(all_params, ray_o, ray_d, target):
        scene_params, cam_params = all_params
        cam = camera.replace(**cam_params) if optimize_camera else camera
        rays = Ray(origin=ray_o, direction=ray_d)
        img = soft_render(params_to_scene(scene_params), cam, soft, config,
                          rays=rays)
        return jnp.mean((img - target) ** 2)
    return loss_fn


def make_value_and_grad(loss_fn, mesh: Mesh = None,
                        grad_microbatch: int = 1):
    """Jitted ``(params, ray_o, ray_d, target) -> (loss, grads)`` of the
    mean loss over all rays; with ``mesh``, rays shard over its ray axis
    and ``params`` replicate."""
    vg = jax.value_and_grad(loss_fn)
    if mesh is None:
        return jax.jit(vg)

    def local(all_params, ray_o, ray_d, target):
        # all_params are replicated (invariant over the ray axis), so
        # autodiff already sums their cotangents over the ray shards
        # (the transpose of the implicit broadcast): grads need only
        # the 1/n of the mean; the loss value is psum'd explicitly.
        scale = 1.0 / mesh.shape[RAY_AXIS]
        T = max(1, grad_microbatch)
        if T == 1:
            val, grads = vg(all_params, ray_o, ray_d, target)
            return (jax.lax.psum(val * scale, RAY_AXIS),
                    jax.tree_util.tree_map(lambda g: g * scale, grads))
        # Gradient all-reduce overlapped with backward (SURVEY.md §2
        # parallelism item 3): the ray shard splits into T tile
        # microbatches; tile k's gradient sum is issued as soon as its
        # backward finishes and has no data dependence on tile k+1's
        # forward/backward, so XLA's async collectives run it while
        # tile k+1 computes. The Python loop is unrolled at trace
        # time (T is static): a lax.scan would serialize the
        # collective into the loop carry and forbid the overlap.
        o_t = ray_o.reshape(T, -1, 3)
        d_t = ray_d.reshape(T, -1, 3)
        tg_t = target.reshape(T, -1, 3)
        val_acc = jnp.float32(0)
        g_acc = None
        for t in range(T):
            val, grads = vg(all_params, o_t[t], d_t[t], tg_t[t])
            part = (jax.lax.psum(val * (scale / T), RAY_AXIS),
                    jax.tree_util.tree_map(lambda g: g * (scale / T),
                                           grads))
            val_acc = val_acc + part[0]
            g_acc = part[1] if g_acc is None else jax.tree_util.tree_map(
                jnp.add, g_acc, part[1])
        return val_acc, g_acc

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=(P(), P()),
    ))


def fit_scene(target: Array, init_scene: Scene, camera: Camera,
              steps: int = 200, lr: float = 3e-2,
              soft: SoftParams = None,
              config: TracerConfig = DEFAULT_CONFIG,
              optimize_camera: bool = False,
              mesh: Mesh = None,
              grad_microbatch: int = 1,
              checkpoint_path: str = None,
              checkpoint_every: int = 50,
              resume: bool = False) -> FitResult:
    """Fit scene (and optionally camera pose) to ``target`` (H, W, 3).

    With ``checkpoint_path``, the full optimization state (params, optimizer
    moments, step counter, loss history) is persisted every
    ``checkpoint_every`` steps (atomic npz, tracer/checkpoint.py); with
    ``resume=True`` a killed run continues from the last checkpoint and the
    remaining steps are bitwise identical to an uninterrupted run
    (tests/test_checkpoint.py).
    """
    if soft is None:
        soft = SoftParams()

    all_params = (scene_to_params(init_scene),
                  {"position": camera.position, "yaw": camera.yaw,
                   "pitch": camera.pitch})
    loss_fn = make_loss_fn(camera, soft, config, optimize_camera)
    compute = make_value_and_grad(loss_fn, mesh, grad_microbatch)

    opt = optax.adam(lr)
    opt_state = opt.init(all_params)

    start_step = 0
    losses = []
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        (all_params, opt_state), meta = load_pytree(
            checkpoint_path, (all_params, opt_state))
        start_step = int(meta["step"])
        losses = list(meta["losses"])

    rays = camera_rays(camera, config)
    ray_o = rays.origin.reshape(-1, 3)
    ray_d = rays.direction.reshape(-1, 3)
    target_flat = target.reshape(-1, 3)

    @jax.jit
    def apply(all_params, opt_state, grads):
        if not optimize_camera:
            grads = (grads[0], jax.tree_util.tree_map(jnp.zeros_like, grads[1]))
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(all_params, updates), opt_state

    def save(step):
        save_pytree(checkpoint_path, (all_params, opt_state),
                    meta={"step": step, "losses": losses})

    for step in range(start_step, steps):
        val, grads = compute(all_params, ray_o, ray_d, target_flat)
        all_params, opt_state = apply(all_params, opt_state, grads)
        losses.append(float(val))
        if checkpoint_path and (step + 1) % checkpoint_every == 0 \
                and step + 1 < steps:
            save(step + 1)
    if checkpoint_path:
        save(steps)

    scene_params, cam_params = all_params
    cam = camera.replace(**cam_params) if optimize_camera else camera
    return FitResult(scene=params_to_scene(scene_params), camera=cam,
                     losses=np.asarray(losses))
