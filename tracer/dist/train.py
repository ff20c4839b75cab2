"""Fully-sharded inverse-rendering training step on a 2-D device mesh.

This is the framework's "full training step" -- the analog of a DP x TP
sharded model update:

  * ``rays`` axis (DP): rays and target pixels shard; every device computes
    the loss on its ray shard; parameter gradients **sum over the ray axis**
    (the gradient all-reduce).
  * ``scene`` axis (TP): sphere arrays shard; the ORDERED composite (the
    model the renderer actually ships, tracer/diff/soft.py
    composite_sorted) decomposes across shards by per-shard top-K
    selection: every device scores its sphere shard, keeps its K largest-
    sigma candidates as (sigma, t, shade) triples, **all_gathers the K*S
    candidate sets over the scene axis**, and runs the exact depth-ordered
    composite on the merged set. With K >= the per-ray overlap depth the
    sharded loss EQUALS the unsharded soft_render loss (tests assert
    this); dropped candidates have sigma below every shard's K-th value —
    the same truncation class as the sparse single-device paths. (An
    earlier depth-softmax decomposition was replaced because a near sphere
    with microscopic coverage could outweigh a real hit; diff/soft.py
    records why. The trainer optimizes the model the renderer ships.)
    Parameters and optimizer state stay sharded; each device updates only
    its sphere shard.

One jitted ``shard_map`` contains render + loss + backward + gradient
all-reduce + optimizer update, so XLA schedules the collectives against
compute.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax import Array
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tracer.diff.fit import params_to_scene, scene_to_params
from tracer.diff.soft import SoftParams, _logits_and_shade, composite_sorted
from tracer.dist.mesh import RAY_AXIS, SCENE_AXIS
from tracer.scene.scene import Scene


def make_train_step(mesh: Mesh, soft: SoftParams = None, lr: float = 1e-2,
                    k_top: int = 16):
    """Build (init_fn, step_fn) for the sharded training step.

    init_fn(scene) -> (params, opt_state)   [caller shards them onto the mesh]
    step_fn(params, opt_state, ray_o, ray_d, target) -> (params, opt_state, loss)

    Shardings: params/opt_state P(scene) on the sphere dim; ray_o/ray_d/target
    P(rays) on the ray dim; loss replicated. ``k_top`` = per-shard candidate
    budget for the ordered-composite merge (exact when >= the per-ray
    overlap depth of any single shard).
    """
    if soft is None:
        soft = SoftParams()
    opt = optax.adam(lr)

    def init_fn(scene: Scene):
        params = scene_to_params(scene)
        return params, opt.init(params)

    def local_step(params, opt_state, o, d, target):
        def loss_fn(params):
            scene = params_to_scene(params)
            # Per-shard top-K (sigma, t, shade) candidates; indices are
            # piecewise constant (argmin class), values carry gradients.
            _, shade, sigma, t = _logits_and_shade(scene, o, d, soft)
            k = min(k_top, sigma.shape[1])
            sig_k, idx = jax.lax.top_k(sigma, k)           # (B, k)
            t_k = jnp.take_along_axis(t, idx, axis=1)
            shade_k = jnp.take_along_axis(shade, idx[..., None], axis=1)
            # Merge the K*S candidates across scene shards and run the
            # EXACT ordered composite the renderer ships.
            sig_all = jax.lax.all_gather(sig_k, SCENE_AXIS, axis=1,
                                         tiled=True)
            t_all = jax.lax.all_gather(t_k, SCENE_AXIS, axis=1, tiled=True)
            shade_all = jax.lax.all_gather(shade_k, SCENE_AXIS, axis=1,
                                           tiled=True)
            img = composite_sorted(sig_all, shade_all, t_all, d)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        # The gradient all-reduce is inside the backward pass: params are
        # invariant over the ray axis, so autodiff sums their cotangents
        # over it (the transpose of the implicit broadcast), and the
        # all_gather's transpose sums the identical per-scene-device
        # copies of the replicated loss's cotangent. Both sums count every
        # device once; dividing by the device count leaves the gradient of
        # the mean-over-ray-shards loss.
        n = mesh.shape[RAY_AXIS] * mesh.shape[SCENE_AXIS]
        grads = jax.tree_util.tree_map(lambda g: g / n, grads)
        # loss is already identical across scene shards (the all_gathered
        # candidate sets are); the pmean just proves replication to
        # shard_map's static checker (numerically a no-op).
        loss = jax.lax.pmean(jax.lax.pmean(loss, RAY_AXIS), SCENE_AXIS)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    param_spec = {"centers": P(SCENE_AXIS), "radii_raw": P(SCENE_AXIS),
                  "albedo_raw": P(SCENE_AXIS)}

    def step_fn_factory(opt_state_example):
        # Optimizer moments shard like the params (dim 0 = sphere dim);
        # scalar state (step count) replicates.
        ospec = jax.tree_util.tree_map(lambda leaf: P(SCENE_AXIS)
                                       if getattr(leaf, "ndim", 0) > 0 else P(),
                                       opt_state_example)
        return jax.jit(shard_map(
            local_step, mesh=mesh,
            in_specs=(param_spec, ospec, P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
            out_specs=(param_spec, ospec, P()),
        ))

    return init_fn, step_fn_factory
