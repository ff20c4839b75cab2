"""Ring scene-sharding: closest hit over sphere shards via ``ppermute``.

For scenes too large to replicate (the 1M-sphere multi-host config,
BASELINE config 5), sphere arrays shard across the ``scene`` mesh axis and
stay resident; *ray blocks* rotate around the ring instead. Structurally this
is ring attention's KV-rotation with the softmax-accumulate replaced by a
(t, index) min-reduction (SURVEY.md section 5, long-context entry):

    step s on device d: test resident sphere shard d against the ray block
    that originated on device (d - s) mod P, fold (t, idx) into that block's
    running best, then ppermute the block (and its running best) to d + 1.

After P steps every ray block has visited every shard and carries the global
closest hit; blocks arrive back at their home device. Per-step compute
overlaps the next permute under XLA's async collectives, and the interconnect
carries the ray traffic (O(rays) per step, independent of scene size).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from tracer.core.types import Ray, HitRecord
from tracer.dist.mesh import SCENE_AXIS
from tracer.intersect.sphere import ray_sphere_t, hit_record_from_t
from tracer.intersect.traverse import traverse_flat
from tracer.scene.scene import Scene
from tracer.core import pytree

# Finite "never hit" node-box padding: inverted boxes whose slab interval is
# always empty (tmax < tmin), without inf arithmetic hazards.
_PAD_BOX = 3.0e37


@pytree.dataclass
class ShardedBVH:
    """Per-shard flat BVHs, stacked and padded to a common size.

    This is SURVEY.md section 2 parallelism strategy 2's per-shard BLAS: each
    device holds the BVH of its contiguous sphere range, so a ring step costs
    O(block * log(N/P)) instead of the brute O(block * N/P). Arrays carry a
    leading shard axis sharded with ``P(axis)`` under shard_map:

    node_min/node_max: (P, M, 3); escape/leaf_start: (P, M) i32;
    prim_idx: (P, S) i32 in *shard-local* sphere indices, padded slots hold
    ``shard_size`` (the per-shard sentinel). Padding nodes (per-shard trees
    differ in size) are inverted boxes with escape = M, leaf_start = -1.
    """

    node_min: Array
    node_max: Array
    escape: Array
    leaf_start: Array
    prim_idx: Array
    shard_size: int = pytree.field(static=True)
    leaf_size: int = pytree.field(static=True)


def build_sharded_bvh(centers: np.ndarray, radii: np.ndarray,
                      num_shards: int, leaf_size: int = 8,
                      **build_kw) -> ShardedBVH:
    """Build one BVH per contiguous sphere shard (host-side, once).

    Sphere i lives on shard i // (n / num_shards) -- the same contiguous
    split ``P(axis)`` applies to the scene arrays, so shard-local prim ids
    map to global ids by adding the shard offset.
    """
    from tracer.bvh.builder import build_bvh

    n = len(radii)
    assert n % num_shards == 0, (n, num_shards)
    ssz = n // num_shards
    parts = []
    for s in range(num_shards):
        sl = slice(s * ssz, (s + 1) * ssz)
        parts.append(build_bvh(centers[sl], radii[sl], leaf_size=leaf_size,
                               **build_kw))
    m = max(p.num_nodes for p in parts)
    slots = max(p.prim_idx.shape[0] for p in parts)

    def pad_nodes(p):
        k = m - p.num_nodes
        nmin = jnp.pad(p.node_min, ((0, k), (0, 0)),
                       constant_values=_PAD_BOX)
        nmax = jnp.pad(p.node_max, ((0, k), (0, 0)),
                       constant_values=-_PAD_BOX)
        esc = jnp.pad(p.escape, (0, k), constant_values=m)
        lst = jnp.pad(p.leaf_start, (0, k), constant_values=-1)
        pidx = jnp.pad(p.prim_idx, (0, slots - p.prim_idx.shape[0]),
                       constant_values=ssz)
        # Real escapes pointing at "done" (num_nodes) retarget to m.
        esc = jnp.where(esc >= p.num_nodes, m, esc)
        return nmin, nmax, esc, lst, pidx

    stk = [jnp.stack(x) for x in zip(*(pad_nodes(p) for p in parts))]
    return ShardedBVH(node_min=stk[0], node_max=stk[1],
                      escape=stk[2].astype(jnp.int32),
                      leaf_start=stk[3].astype(jnp.int32),
                      prim_idx=stk[4].astype(jnp.int32),
                      shard_size=ssz, leaf_size=leaf_size)


def _local_best(o: Array, d: Array, centers: Array, radii: Array,
                idx_offset: Array):
    """Brute-force best (t, global index) of a ray block vs a sphere shard."""
    t = ray_sphere_t(o[:, None, :], d[:, None, :], centers[None], radii[None])
    j = jnp.argmin(t, axis=-1).astype(jnp.int32)
    tb = jnp.take_along_axis(t, j[:, None], axis=-1)[:, 0]
    return tb, j + idx_offset


def _local_best_bvh(o: Array, d: Array, centers: Array, radii: Array,
                    idx_offset: Array, sbvh_local, shard_size: int,
                    leaf_size: int):
    """BVH-accelerated best (t, global index) vs the resident shard's BLAS."""
    from tracer.bvh.flat import SENTINEL_CENTER, SENTINEL_RADIUS
    nmin, nmax, esc, lst, pidx = sbvh_local
    centers_p = jnp.concatenate(
        [centers, jnp.full((1, 3), SENTINEL_CENTER, centers.dtype)], axis=0)
    radii_p = jnp.concatenate(
        [radii, jnp.full((1,), SENTINEL_RADIUS, radii.dtype)])
    tb, ib = traverse_flat(o, d, nmin, nmax, esc, lst, pidx,
                           centers_p, radii_p, leaf_size)
    ib = jnp.where(ib >= 0, ib + idx_offset, ib)
    tb = jnp.where(ib >= 0, tb, jnp.inf)
    return tb, ib


def nearest_hit_ring(rays: Ray, scene: Scene, mesh: Mesh,
                     axis: str = SCENE_AXIS,
                     sbvh: ShardedBVH = None) -> HitRecord:
    """Closest hit with BOTH rays and spheres sharded over ``axis``.

    rays: flat batch (B, 3) fields, B divisible by the axis size;
    scene: the FULL scene (this function shards it; callers with
    already-sharded scenes can pass shard-local arrays through shard_map
    directly). With ``sbvh`` (build_sharded_bvh) each ring step traverses the
    resident shard's BVH -- O(log(N/P)) per ray -- instead of brute force.
    Returns a HitRecord equal to the unsharded brute-force result.
    """
    p = mesh.shape[axis]
    n = scene.num_spheres
    assert n % p == 0, f"spheres {n} must divide scene shards {p}"
    shard_size = n // p
    if sbvh is not None:
        assert sbvh.shard_size == shard_size, (sbvh.shard_size, shard_size)

    def local(o, d, centers, radii, *sbvh_local):
        # ppermute moves data from device i to i+1; the block resident here
        # at step s originated on device (my - s). Sphere indices offset by
        # this device's shard start to produce global ids.
        my = jax.lax.axis_index(axis)
        offset = (my * shard_size).astype(jnp.int32)
        sloc = tuple(x[0] for x in sbvh_local)  # drop the unit shard dim

        def step(carry, _):
            o_blk, d_blk, tb, ib = carry
            if sloc:
                t_new, i_new = _local_best_bvh(
                    o_blk, d_blk, centers, radii, offset, sloc,
                    shard_size, sbvh.leaf_size)
            else:
                t_new, i_new = _local_best(o_blk, d_blk, centers, radii,
                                           offset)
            better = t_new < tb
            tb = jnp.where(better, t_new, tb)
            ib = jnp.where(better, i_new, ib)
            perm = [(i, (i + 1) % p) for i in range(p)]
            o_blk, d_blk, tb, ib = jax.tree_util.tree_map(
                lambda x: jax.lax.ppermute(x, axis, perm),
                (o_blk, d_blk, tb, ib))
            return (o_blk, d_blk, tb, ib), None

        tb0 = jax.lax.pcast(jnp.full(o.shape[0], jnp.inf, jnp.float32),
                            (axis,), to="varying")
        ib0 = jax.lax.pcast(jnp.full(o.shape[0], -1, jnp.int32), (axis,),
                            to="varying")
        (o_blk, d_blk, tb, ib), _ = jax.lax.scan(
            step, (o, d, tb0, ib0), None, length=p)
        # After p rotations each block is back home with the global best.
        return tb, ib

    sbvh_arrays = () if sbvh is None else (
        sbvh.node_min, sbvh.node_max, sbvh.escape, sbvh.leaf_start,
        sbvh.prim_idx)
    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis))
        + tuple(P(axis) for _ in sbvh_arrays),
        out_specs=(P(axis), P(axis)),
        )
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    tb, ib = fn(o, d, scene.centers, scene.radii, *sbvh_arrays)
    tb = jnp.where(ib >= 0, tb, jnp.inf)
    rec = hit_record_from_t(Ray(origin=o, direction=d), tb, ib, scene.centers)
    return jax.tree_util.tree_map(
        lambda x: x.reshape(*rays.batch_shape, *x.shape[1:]), rec)
