"""On-device BVH construction (JAX, jittable).

The reference builds its BVH in its own compute language — recursive
top-down SAH partitioning on the CPU (src/bvh.c:117-207). This module is
the on-device equivalent for the "BVH build ms" metric (SURVEY.md §2 row
5): an **LBVH** built entirely from vectorized XLA ops, no host loops:

  1. Morton-encode sphere centroids (10 bits/axis, the classic LBVH
     linearization) and argsort — one XLA sort.
  2. Leaves = runs of ``leaf_size`` consecutive prims in Morton order,
     padded to a power-of-two leaf count with sentinel slots.
  3. Internal nodes form a COMPLETE binary tree over the leaves; AABBs
     are computed bottom-up with log2(L) pairwise min/max reductions.
  4. The escape-indexed preorder layout of tracer/bvh/flat.py is emitted
     in closed form: in a complete tree, a node at depth d / position p
     has preorder index  d + sum_i bit_i(p) * (2^(D-i+1) - 1)  (every
     right turn skips the left sibling's whole subtree) and escape index
     idx + 2^(D-d+1) - 1. One small scatter per level writes the arrays.

Build = O(n log n) work in vectorized ops; far faster than the host
binned-SAH builder at large n (PERF.md), at the cost of a somewhat less
tight tree (Morton order ignores surface area). Both
builders emit the same FlatBVH, so every consumer (pure-jnp traversal,
Pallas kernels, cull tables, refit) accepts either.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from tracer.bvh.flat import FlatBVH

_BIG = 3.0e38


def _expand_bits10(v: Array) -> Array:
    """Spread 10 bits over 30 (2 zero bits between each), uint32."""
    v = v.astype(jnp.uint32) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes_3d(pts: Array, lo: Array, hi: Array) -> Array:
    """30-bit Morton codes of points normalized to [lo, hi], (N,) uint32."""
    q = (pts - lo) / jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip(q * 1024.0, 0.0, 1023.0).astype(jnp.uint32)
    return (_expand_bits10(q[:, 0])
            | (_expand_bits10(q[:, 1]) << 1)
            | (_expand_bits10(q[:, 2]) << 2))


@functools.partial(jax.jit, static_argnames=("leaf_size",))
def build_bvh_device(centers: Array, radii: Array,
                     leaf_size: int = 32) -> FlatBVH:
    """Vectorized LBVH build; returns a FlatBVH of jnp arrays.

    All shapes are static functions of (n, leaf_size), so this compiles
    once per scene size and runs entirely on device — suitable for
    per-frame rebuilds of dynamic scenes (the role src/main.c:223-228
    fills by rebuilding on launch).
    """
    n = centers.shape[0]
    ls = leaf_size

    lo = jnp.min(centers - radii[:, None], axis=0)
    hi = jnp.max(centers + radii[:, None], axis=0)
    codes = morton_codes_3d(centers, lo, hi)
    order = jnp.argsort(codes).astype(jnp.int32)

    # Pad to a power-of-two leaf count (>= 1).
    num_leaves = 1
    while num_leaves * ls < n:
        num_leaves *= 2
    P = num_leaves * ls
    slots = jnp.full((P,), n, jnp.int32).at[:n].set(order)

    # Leaf AABBs (padding slots contribute inverted boxes).
    real = slots < n
    safe = jnp.where(real, slots, 0)
    pmin = jnp.where(real[:, None],
                     centers[safe] - radii[safe, None], _BIG)
    pmax = jnp.where(real[:, None],
                     centers[safe] + radii[safe, None], -_BIG)
    lmin = pmin.reshape(num_leaves, ls, 3).min(1)
    lmax = pmax.reshape(num_leaves, ls, 3).max(1)

    # Bottom-up levels: levels[d] has 2^d nodes; leaves sit at depth D.
    D = int(np.log2(num_leaves))
    level_min = [lmin]
    level_max = [lmax]
    for _ in range(D):
        level_min.append(level_min[-1].reshape(-1, 2, 3).min(1))
        level_max.append(level_max[-1].reshape(-1, 2, 3).max(1))
    level_min.reverse()                     # level_min[d]: (2^d, 3)
    level_max.reverse()

    # Closed-form preorder emission.
    M = 2 * num_leaves - 1
    node_min = jnp.zeros((M, 3), jnp.float32)
    node_max = jnp.zeros((M, 3), jnp.float32)
    escape = jnp.zeros((M,), jnp.int32)
    leaf_start = jnp.full((M,), -1, jnp.int32)
    for d in range(D + 1):
        p = jnp.arange(1 << d, dtype=jnp.int32)
        idx = jnp.full((1 << d,), d, jnp.int32)
        for i in range(1, d + 1):
            bit = (p >> (d - i)) & 1
            idx = idx + bit * ((1 << (D - i + 1)) - 1)
        sub = (1 << (D - d + 1)) - 1
        # Nodes covering only padding slots get NaN boxes: every slab
        # comparison is then false, so traversal skips them. (An inverted
        # +/-BIG box would pass the symmetric slab test as ALL-SPACE and
        # every ray would walk the padding subtree — at n just above a
        # power of two that is ~half the tree.)
        has_real = (p << (D - d)) * ls < n    # max value P < 2^31
        vmin = jnp.where(has_real[:, None], level_min[d], jnp.nan)
        vmax = jnp.where(has_real[:, None], level_max[d], jnp.nan)
        node_min = node_min.at[idx].set(vmin)
        node_max = node_max.at[idx].set(vmax)
        escape = escape.at[idx].set(idx + sub)
        if d == D:
            leaf_start = leaf_start.at[idx].set(p * ls)

    return FlatBVH(node_min=node_min, node_max=node_max, escape=escape,
                   leaf_start=leaf_start, prim_idx=slots, leaf_size=ls)
