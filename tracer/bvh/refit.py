"""On-device BVH refit: update bounds for moved/resized spheres.

The reference rebuilds its BVH only at startup (src/main.c:223-228); geometry
never moves. In this framework geometry is a *parameter* (inverse rendering,
tracer/diff/fit.py), so bounds must track it every optimizer step without a
host round trip. Refit keeps the tree TOPOLOGY (a host-built artifact, cheap
to rebuild occasionally as quality degrades) and recomputes every node's AABB
from the current centers/radii entirely on device:

  * leaf boxes: one vectorized gather + masked min/max over each leaf's
    ``leaf_size`` primitive slots;
  * internal boxes: union of the two children, processed level-by-level from
    the deepest height upward. In escape-indexed preorder a node's children
    are ``i+1`` and ``escape[i+1]``, and heights are a static property of the
    topology, so the host precomputes a :class:`RefitPlan` once (padded
    per-level index lists) and the device pass is ``max_height`` fully
    vectorized scatter/gather steps -- no sequential M-step scan.

Correctness invariant (tests/test_refit.py): refitted boxes contain their
primitives/children exactly like a fresh build's, so traversal over a
refitted tree equals brute force on the moved scene.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array

from tracer.bvh.flat import FlatBVH
from tracer.core import pytree

_EMPTY = 3.0e37  # collapsed box for sentinel-only slots


@pytree.dataclass
class RefitPlan:
    """Static topology schedule for :func:`refit_bvh`.

    levels: (H, W) i32 -- internal-node indices grouped by height (1 =
        parents of leaves), each row padded with node 0 and masked by
        ``level_mask``. Height-h nodes only depend on heights < h.
    level_mask: (H, W) bool
    left/right: (M,) i32 -- children indices (left = i+1; right =
        escape[i+1]); arbitrary for leaves.
    leaf_ids: (L,) i32 -- preorder indices of the leaves, in leaf_start order.
    """

    levels: Array
    level_mask: Array
    left: Array
    right: Array
    leaf_ids: Array


def build_refit_plan(bvh: FlatBVH) -> RefitPlan:
    """Host-side, once per topology (NumPy)."""
    escape = np.asarray(bvh.escape)
    leaf_start = np.asarray(bvh.leaf_start)
    M = bvh.num_nodes
    is_leaf = leaf_start >= 0

    left = np.minimum(np.arange(M) + 1, M - 1)
    right = escape[left]
    right = np.minimum(right, M - 1)

    height = np.zeros(M, np.int32)
    for i in range(M - 1, -1, -1):          # children are always > parent
        if not is_leaf[i]:
            height[i] = 1 + max(height[left[i]], height[right[i]])

    hmax = int(height.max()) if M else 0
    per_level = [np.where(~is_leaf & (height == h))[0] for h in
                 range(1, hmax + 1)]
    w = max((len(x) for x in per_level), default=1)
    levels = np.zeros((len(per_level), max(w, 1)), np.int32)
    mask = np.zeros_like(levels, bool)
    for h, idx in enumerate(per_level):
        levels[h, :len(idx)] = idx
        mask[h, :len(idx)] = True

    order = np.argsort(leaf_start[is_leaf], kind="stable")
    leaf_ids = np.where(is_leaf)[0][order].astype(np.int32)
    return RefitPlan(levels=jnp.asarray(levels),
                     level_mask=jnp.asarray(mask),
                     left=jnp.asarray(left.astype(np.int32)),
                     right=jnp.asarray(right.astype(np.int32)),
                     leaf_ids=jnp.asarray(leaf_ids))


def refit_bvh(bvh: FlatBVH, plan: RefitPlan, centers: Array,
              radii: Array) -> FlatBVH:
    """New FlatBVH with bounds recomputed for ``centers``/``radii``
    (jit-compatible; topology/escape/prim_idx unchanged)."""
    n = centers.shape[0]
    L = bvh.leaf_size

    # Leaf boxes: (n_leaves, leaf_size) prim slots, sentinel-masked.
    slots = plan.leaf_ids.shape[0]
    pid = bvh.prim_idx.reshape(slots, L)
    real = pid < n
    safe = jnp.minimum(pid, n - 1)
    c = centers[safe]                              # (L_leaves, leaf_size, 3)
    r = radii[safe][..., None]
    lo = jnp.where(real[..., None], c - r, _EMPTY).min(axis=1)
    hi = jnp.where(real[..., None], c + r, -_EMPTY).max(axis=1)

    node_min = jnp.full_like(bvh.node_min, _EMPTY).at[plan.leaf_ids].set(lo)
    node_max = jnp.full_like(bvh.node_max, -_EMPTY).at[plan.leaf_ids].set(hi)

    def level(h, carry):
        nmin, nmax = carry
        idx = plan.levels[h]
        m = plan.level_mask[h][:, None]
        l, rgt = plan.left[idx], plan.right[idx]
        new_lo = jnp.minimum(nmin[l], nmin[rgt])
        new_hi = jnp.maximum(nmax[l], nmax[rgt])
        # Scatter-min/max, not scatter-set: level rows are padded with node 0
        # and a plain .set with duplicate indices would let a masked padding
        # write clobber a real one. min/max folds are order-independent, and
        # masked lanes contribute the identity (internal nodes start at the
        # collapsed box).
        nmin = nmin.at[idx].min(jnp.where(m, new_lo, _EMPTY))
        nmax = nmax.at[idx].max(jnp.where(m, new_hi, -_EMPTY))
        return nmin, nmax

    # Rows must apply in height order; a Python loop keeps each level a
    # fused scatter (H is small, <= max_depth ~ 40-64).
    for h in range(plan.levels.shape[0]):
        node_min, node_max = level(h, (node_min, node_max))

    return bvh.replace(node_min=node_min, node_max=node_max)
