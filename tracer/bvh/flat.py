"""Flat, struct-of-arrays BVH: the accelerator-side acceleration structure.

The reference stores a heap of pointer-linked ``BVHNode``s traversed by
recursion (include/Custom/bvh.h:12-18, src/hit.c:91-109). Pointer chasing and
recursion do not vectorize; instead the tree is flattened to dense arrays
in DFS **preorder** with an *escape index* per node:

  - an internal node's left child is always ``i + 1`` (preorder), so no child
    pointers are stored at all;
  - ``escape[i]`` is the preorder index of the next node *after* i's subtree:
    traversal jumps there when the ray misses i's box or finishes i's leaf.
    ``escape == num_nodes`` means traversal is done.

This makes traversal a loop over a single integer per ray -- no stack, no
recursion -- which vectorizes over a whole wavefront (see
tracer/intersect/traverse.py) and feeds the Pallas kernel directly.

Leaves are padded to a fixed ``leaf_size`` with a sentinel primitive slot
(index == num_spheres) so every leaf test is the same static-shape batch of
sphere tests; scene arrays are padded with one never-hit sphere (far-away
center, radius 0). Unlike the reference -- which stores ``sphere_count`` but
then tests only the first sphere of a leaf (src/hit.c:98-99) -- every real
primitive in a leaf is tested.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import Array
from tracer.core import pytree

# Sentinel "never hits" primitive used to pad leaves: radius 0 makes the
# discriminant strictly negative for any ray not passing exactly through the
# (absurdly remote) center.
SENTINEL_CENTER = 3.0e37
SENTINEL_RADIUS = 0.0


@pytree.dataclass
class FlatBVH:
    """Escape-indexed flat BVH over a sphere scene.

    node_min/node_max: (M, 3) f32 -- node AABBs (enclose child/prim AABBs,
                       reference semantics src/bvh.c:120-125)
    escape:     (M,) i32 -- preorder index after the node's subtree (M = done)
    leaf_start: (M,) i32 -- offset into prim_idx for leaves, -1 for internal
    prim_idx:   (P,) i32 -- per-leaf primitive slots, padded to leaf_size with
                num_spheres (the sentinel); values index the *original* scene
                arrays, so gradients flow to them through the gather.
    leaf_size:  static int
    """

    node_min: Array
    node_max: Array
    escape: Array
    leaf_start: Array
    prim_idx: Array
    leaf_size: int = pytree.field(static=True, default=4)

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def padded_scene_arrays(centers: Array, radii: Array):
    """Scene arrays with the sentinel primitive appended at index N."""
    c = jnp.concatenate(
        [centers, jnp.full((1, 3), SENTINEL_CENTER, centers.dtype)], axis=0)
    r = jnp.concatenate([radii, jnp.full((1,), SENTINEL_RADIUS, radii.dtype)])
    return c, r


def validate_bvh(bvh: FlatBVH, centers: np.ndarray, radii: np.ndarray) -> None:
    """Structural invariants (the checks SURVEY.md section 4 calls for; the
    union-of-leaves check would have caught the reference's off-by-one at
    src/benchmark.c:317). Raises AssertionError on violation."""
    M = bvh.num_nodes
    n = len(radii)
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    escape = np.asarray(bvh.escape)
    leaf_start = np.asarray(bvh.leaf_start)
    prim_idx = np.asarray(bvh.prim_idx)

    # Escape indices form a valid DFS: escape[i] in (i, M].
    assert ((escape > np.arange(M)) & (escape <= M)).all(), "bad escape indices"

    # Union of leaves covers every sphere exactly once.
    real = prim_idx[prim_idx < n]
    assert len(real) == n and len(np.unique(real)) == n, \
        "leaves must partition the primitive set"

    # Every leaf's spheres lie inside the leaf AABB; every node's box
    # contains its children's boxes.
    L = bvh.leaf_size
    for i in range(M):
        if leaf_start[i] >= 0:
            slots = prim_idx[leaf_start[i]: leaf_start[i] + L]
            slots = slots[slots < n]
            lo = centers[slots] - radii[slots, None]
            hi = centers[slots] + radii[slots, None]
            assert (lo >= node_min[i] - 1e-4).all(), f"leaf {i} prim below box"
            assert (hi <= node_max[i] + 1e-4).all(), f"leaf {i} prim above box"
        else:
            left, right = i + 1, escape[i + 1]
            for ch in (left, right):
                # NaN boxes mark padding subtrees of the device LBVH
                # (tracer/bvh/device.py): no containment to check.
                if np.isnan(node_min[ch]).any():
                    continue
                assert (node_min[ch] >= node_min[i] - 1e-4).all()
                assert (node_max[ch] <= node_max[i] + 1e-4).all()


def bvh_stats(bvh: FlatBVH, num_spheres: int) -> dict:
    """Introspection dump: depth histogram, leaf occupancy, SAH cost -- the
    analytical counterpart of the reference's debug visualizer / printfs
    (src/bvh_visualiser.c, src/bvh.c:111-115)."""
    M = bvh.num_nodes
    escape = np.asarray(bvh.escape)
    leaf_start = np.asarray(bvh.leaf_start)
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    prim_idx = np.asarray(bvh.prim_idx)

    # Depth of each preorder node = number of still-open ancestor subtrees.
    depth = np.zeros(M, np.int32)
    open_subtrees: list[int] = []
    for i in range(M):
        while open_subtrees and i >= open_subtrees[-1]:
            open_subtrees.pop()
        depth[i] = len(open_subtrees)
        open_subtrees.append(int(escape[i]))

    is_leaf = leaf_start >= 0
    ext = np.maximum(node_max - node_min, 0.0)
    sa = 2.0 * (ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0])
    root_sa = max(float(sa[0]), 1e-12)
    leaf_counts = np.array([
        int((prim_idx[s: s + bvh.leaf_size] < num_spheres).sum())
        for s in leaf_start[is_leaf]
    ]) if is_leaf.any() else np.zeros(0, np.int32)

    # Standard SAH cost with C_trav = 1, C_isect = 1 (relative units).
    sah = float((sa[~is_leaf].sum() + (sa[is_leaf] * leaf_counts).sum()) / root_sa)

    return {
        "num_nodes": int(M),
        "num_leaves": int(is_leaf.sum()),
        "max_depth": int(depth.max()) if M else 0,
        "mean_leaf_occupancy": float(leaf_counts.mean()) if len(leaf_counts) else 0.0,
        "sah_cost": sah,
        "leaf_depth_histogram": np.bincount(depth[is_leaf]).tolist() if M else [],
    }
