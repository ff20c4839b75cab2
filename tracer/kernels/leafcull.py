"""Leaf-granular cull intersector: the hot path for closest hit and any hit.

The reference answers a closest-hit query by walking the SAH BVH per ray
(``ray_bvh_intersect``, src/hit.c:91-109). Here a query is two batched
phases over *subpackets* of ``SP`` consecutive rays (rays are sorted by
direction first, tracer/core/sort.py, so a subpacket is a thin frustum):

  * phase A (plain ``jnp``): each subpacket's interval bounds are tested
    against the boxes of groups of ``leaves_per_group`` consecutive leaves,
    then against the member-leaf boxes of the surviving groups. The result
    is one candidate row per subpacket: ``[count, leaf ids...]`` in
    ascending slot order, or, when the subpacket needs more leaves than
    the row holds, ``[-count, group ids...]`` (group mode: walk every
    member leaf). The default budgets (:func:`default_budgets`) make the
    row as wide as the table has groups, so no row can overflow at any
    scene size; smaller explicit budgets raise ``overflow`` wherever a
    group row does not fit.
  * phase B: every ray of the subpacket is tested against every prim of
    its candidate leaves. Two implementations with one contract:

      - ``"triton"``: a Pallas kernel on the Triton route. One program per
        subpacket keeps its rays in registers and loops over its own
        candidate leaves, so a subpacket pays only for its own list.
      - ``"xla"``: the plain version, a ``lax.while_loop`` over blocks of
        ``LEAF_BLOCK`` candidate positions vectorised over all
        subpackets (gather, fused quadratic test, max-reduce). It pays the
        longest list's trip count for every subpacket.

    ``"interpret"`` runs the Triton kernel body in Pallas's interpreter
    (CPU tests).

Prims live in one SoA table ``prims (4, L + 1, leaf_size)``: rows cx, cy,
cz, r^2 per slot, with leaf ``L`` a sentinel that never hits. The
quadratic is the reference acceptance rule (disc > 0, near root,
t > EPSILON; src/hit.c:19-39) in f32 on the CUDA cores, with the
discriminant as a r^2 - |oc x d|^2 like tracer/intersect/sphere.py: the
test resolves r = 0.5 at |oc| ~ 500, which neither TF32 nor bf16 can.
With u = oc.d + sqrt(disc) the near root is t = -u/a, so the closest hit
is the largest valid u; ties go to the lowest slot.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tracer.bvh.flat import FlatBVH
from tracer.core import pytree
from tracer.core.types import Ray, HitRecord
from tracer.intersect.sphere import ray_sphere_t, hit_record_from_t, EPSILON
from tracer.scene.scene import Scene

FEAT = 16           # per-ray feature columns (10 used)
LEAF_BLOCK = 16     # candidate positions per plain-walk iteration
EXIT_EVERY = 4      # leaves per any-hit kernel step between exit checks
#                     (1, 2, 4, 8 measured on H100: 4 fastest, PERF.md)
IMPLS = ("triton", "interpret", "xla")
_BIG = 3.0e38
_NOSLOT = 2 ** 30
_NEVER = -1.0       # r^2 of sentinel slots: disc < 0 for every ray


@pytree.dataclass
class CullTables:
    """Device tables of the leaf-cull intersector (build once per scene).

    prims:        (4, L + 1, leaf_size) f32 rows cx, cy, cz, r^2 in slot
                  order; padding slots and the sentinel leaf ``L`` hold
                  r^2 = -1 and can never hit.
    leaf_min/max: (L, 3) leaf AABBs in slot order. Padding leaves hold
                  inverted boxes, which the interval slab test would accept
                  as all-space, so phase A masks them with
                  ``num_real_leaves``.
    group_boxes:  (G, 6 * lpg) member-leaf AABBs of each group, attribute
                  major: [lpg lox | loy | loz | hix | hiy | hiz].
    group_min/max: (G, 3) boxes over each group's ``leaves_per_group``
                  consecutive leaves.
    slot_to_sphere: (L * leaf_size,) i32 prim slot -> sphere id (-1 pad).
    """

    prims: Array
    leaf_min: Array
    leaf_max: Array
    group_boxes: Array
    group_min: Array
    group_max: Array
    slot_to_sphere: Array
    leaf_size: int = pytree.field(static=True)
    leaves_per_group: int = pytree.field(static=True)
    num_leaves: int = pytree.field(static=True)
    num_real_leaves: int = pytree.field(static=True)

    @property
    def num_groups(self) -> int:
        return self.group_min.shape[0]


def build_cull_tables(scene: Scene, bvh: FlatBVH,
                      leaves_per_group: int = 16) -> CullTables:
    """CullTables from a FlatBVH (host numpy for the leaf order, device
    gathers for the prim table; call once per scene)."""
    ls = bvh.leaf_size
    lpg = leaves_per_group
    leaf_start = np.asarray(bvh.leaf_start)
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    prim_idx = np.asarray(bvh.prim_idx)
    n = scene.centers.shape[0]
    is_leaf = leaf_start >= 0
    order = leaf_start[is_leaf] // ls
    # Padding leaves of the device LBVH (tracer/bvh/device.py) carry NaN
    # boxes and only sentinel prims; they must not count as real (a NaN
    # member would poison its whole group box below).
    leaf_is_real = prim_idx[leaf_start[is_leaf]] < n
    num_real = int(leaf_is_real.sum())
    assert (order[leaf_is_real] < num_real).all(), \
        "real leaves must occupy the first slots"
    node_min = np.where(np.isnan(node_min), _BIG, node_min)
    node_max = np.where(np.isnan(node_max), -_BIG, node_max)

    L = max(-(-num_real // lpg), 1) * lpg
    lmin = np.full((L, 3), _BIG, np.float32)
    lmax = np.full((L, 3), -_BIG, np.float32)
    lmin[order[leaf_is_real]] = node_min[is_leaf][leaf_is_real]
    lmax[order[leaf_is_real]] = node_max[is_leaf][leaf_is_real]

    gmin = lmin.reshape(-1, lpg, 3).min(1)
    gmax = lmax.reshape(-1, lpg, 3).max(1)
    gboxes = np.concatenate(
        [lmin.reshape(-1, lpg, 3).transpose(0, 2, 1),
         lmax.reshape(-1, lpg, 3).transpose(0, 2, 1)], axis=1)
    gboxes = gboxes.reshape(L // lpg, 6 * lpg)

    # Real prims occupy the first num_real * ls slots; a device LBVH may
    # carry sentinel-only padding leaves past them, which are dropped.
    slots = np.full(L * ls, n, np.int64)
    take = min(prim_idx.shape[0], L * ls)
    slots[:take] = prim_idx[:take]

    sl = jnp.asarray(np.minimum(slots, n - 1), jnp.int32)
    pad = jnp.asarray(slots >= n)
    c = jnp.where(pad[:, None], 0.0, scene.centers[sl])
    r = scene.radii[sl]
    r2 = jnp.where(pad, _NEVER, r * r)
    prims = jnp.stack([c[:, 0], c[:, 1], c[:, 2], r2]).reshape(4, L, ls)
    sentinel = jnp.zeros((4, 1, ls), jnp.float32).at[3].set(_NEVER)
    prims = jnp.concatenate([prims.astype(jnp.float32), sentinel], axis=1)

    return CullTables(
        prims=prims,
        leaf_min=jnp.asarray(lmin), leaf_max=jnp.asarray(lmax),
        group_boxes=jnp.asarray(gboxes),
        group_min=jnp.asarray(gmin), group_max=jnp.asarray(gmax),
        slot_to_sphere=jnp.asarray(np.where(slots == n, -1, slots),
                                   jnp.int32),
        leaf_size=ls, leaves_per_group=lpg, num_leaves=L,
        num_real_leaves=num_real)


# ---------------------------------------------------------------------------
# Ray features
# ---------------------------------------------------------------------------

def _feature_rows(o: Array, d: Array, t_max: Array | None = None) -> Array:
    """(B, 3) rays -> (B, FEAT) f32 feature rows.

    Columns: [dx, dy, dz, ox, oy, oz, a, 1/a, EPSILON*a, -a*t_max, 0...]
    with a = |d|^2. Column 9 is the any-hit far clip
    (u > -a*t_max <=> t < t_max); -BIG when no t_max is given.
    """
    zeros = jnp.zeros_like(o[:, 0])
    a = jnp.sum(d * d, axis=-1)
    inva = 1.0 / jnp.maximum(a, 1e-30)
    if t_max is None:
        negat = jnp.full_like(a, -_BIG)
    else:
        negat = -a * t_max.reshape(-1)
    cols = [d[:, 0], d[:, 1], d[:, 2], o[:, 0], o[:, 1], o[:, 2],
            a, inva, EPSILON * a, negat]
    cols += [zeros] * (FEAT - len(cols))
    return jnp.stack(cols, axis=-1).astype(jnp.float32)


def pack_ray_features(o: Array, d: Array, subpacket: int,
                      t_max: Array | None = None) -> Array:
    """(B, 3) rays in stream order -> (P, SP, FEAT) features.

    The tail is padded by replicating the last ray (a coherent subpacket).
    """
    b = o.shape[0]
    pad = (-b) % subpacket
    if t_max is not None:
        t_max = jnp.pad(jnp.reshape(t_max, (-1,)), ((0, pad),), mode="edge")
    o = jnp.pad(o, ((0, pad), (0, 0)), mode="edge")
    d = jnp.pad(d, ((0, pad), (0, 0)), mode="edge")
    return _feature_rows(o, d, t_max).reshape(-1, subpacket, FEAT)


def prep_feats_bucketed(o: Array, d: Array, subpacket: int,
                        cell_bits: int = 8, t_max: Array | None = None):
    """Sort + cell-bucket pad + feature pack in one pass.

    Rays are sorted by octahedral direction code and padded at the
    boundaries of 2^cell_bits direction cells (tracer/core/sort.py
    plan_bucket_pad), so no subpacket straddles two cells. Feature rows
    are computed in input order and gathered once into the subpacket
    layout. Returns (feats (P, SP, FEAT), dest (B,) i32): ray i's result
    is at flat index dest[i] of the (P * SP,) outputs.
    """
    from tracer.core.sort import octahedral_codes, plan_bucket_pad

    b = o.shape[0]
    codes = octahedral_codes(d)
    iota = jnp.arange(b, dtype=jnp.int32)
    sc, perm = jax.lax.sort((codes, iota), dimension=0, num_keys=1)
    src, dest_sorted = plan_bucket_pad(sc, subpacket, cell_bits=cell_bits)
    # Invert the permutation with a second two-operand sort.
    _, dest = jax.lax.sort((perm, dest_sorted), dimension=0, num_keys=1)
    feats = _feature_rows(o, d, t_max)[perm[src]]
    tail = (-feats.shape[0]) % subpacket
    if tail:
        feats = jnp.pad(feats, ((0, tail), (0, 0)), mode="edge")
    return feats.reshape(-1, subpacket, FEAT), dest


# ---------------------------------------------------------------------------
# Phase A: hierarchical frustum culling -> one candidate row per subpacket
# ---------------------------------------------------------------------------

def subpacket_bounds(o: Array, d: Array, subpacket: int):
    """(P*SP, 3) rays -> per-subpacket interval bounds, four (P, 3)."""
    ot = o.reshape(-1, subpacket, 3)
    dt = d.reshape(-1, subpacket, 3)
    return ot.min(1), ot.max(1), dt.min(1), dt.max(1)


def bounds_from_feats(feats: Array):
    """(P, SP, FEAT) features -> per-subpacket interval bounds, four
    (P, 3): columns 0-2 hold d, 3-5 hold o."""
    lo = feats.min(axis=1)
    hi = feats.max(axis=1)
    return lo[:, 3:6], hi[:, 3:6], lo[:, 0:3], hi[:, 0:3]


def _slab_hit(o_lo, o_hi, d_lo, d_hi, blo, bhi) -> Array:
    """Conservative interval slab test of subpacket bounds against boxes.

    o_lo/o_hi/d_lo/d_hi: (P, 3). blo/bhi: 3-tuples of (1|P, M) box
    coordinates. Returns (P, M) bool: True whenever ANY ray inside the
    bounds COULD satisfy the reference AABB acceptance
    (tmax >= tmin && tmax > EPSILON, src/hit.c:81).
    """
    big = 1.0e18
    tnear, tfar = None, None
    for a in range(3):
        dl, dh = d_lo[:, a:a + 1], d_hi[:, a:a + 1]
        ol, oh = o_lo[:, a:a + 1], o_hi[:, a:a + 1]
        free = (dl <= 0.0) & (dh >= 0.0)
        i_lo = 1.0 / jnp.where(free, 1.0, dh)
        i_hi = 1.0 / jnp.where(free, 1.0, dl)

        def imul(al, ah, bl, bh):
            p1, p2, p3, p4 = al * bl, al * bh, ah * bl, ah * bh
            return (jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
                    jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)))

        t1_lo, t1_hi = imul(blo[a] - oh, blo[a] - ol, i_lo, i_hi)
        t2_lo, t2_hi = imul(bhi[a] - oh, bhi[a] - ol, i_lo, i_hi)
        tn = jnp.where(free, -big, jnp.minimum(t1_lo, t2_lo))
        tf = jnp.where(free, big, jnp.maximum(t1_hi, t2_hi))
        tnear = tn if tnear is None else jnp.maximum(tnear, tn)
        tfar = tf if tfar is None else jnp.minimum(tfar, tf)
    return (tfar >= tnear) & (tfar > EPSILON)


def compact_rows(mask: Array, ids: Array, keep: int, sentinel: int):
    """Stream-compact masked ids into per-row prefixes.

    mask/ids: (P, M), ids ascending along each row. Returns (prefix (P, keep)
    i32 ascending, sentinel-padded; counts (P,) i32, the full survivor
    count, possibly > keep). Each survivor's slot is its inclusive
    prefix-sum rank minus one; survivors past ``keep`` are dropped by the
    scatter.
    """
    P = mask.shape[0]
    pos = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1
    tgt = jnp.where(mask, pos, keep)
    rows = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32)[:, None],
                            mask.shape)
    prefix = jnp.full((P, keep), sentinel, jnp.int32).at[rows, tgt].set(
        ids.astype(jnp.int32), mode="drop", unique_indices=True)
    return prefix, pos[:, -1] + 1


def default_budgets(tables: CullTables) -> tuple[int, int]:
    """(max_groups, max_candidates) under which no row overflows.

    A row holds ``max(119, G)`` ids, so a group-mode row always has room
    for every group of the table. The refine takes G / 4 surviving groups,
    kept within [64, 1024]: on H100 that was the fastest of 64 / 256 /
    1024 at 100k, 1M and 10M spheres (PERF.md).
    """
    G = tables.num_groups
    return min(1024, max(64, G // 4)), max(119, G)


def candidate_rows(bounds, tables: CullTables, max_groups: int | None = None,
                   max_candidates: int | None = None):
    """Phase A: per-subpacket bounds -> (rows (P, 1 + W) i32, overflow).

    rows[p] = [count, ids...]: ``count >= 0`` lists that many candidate
    leaf ids; ``count < 0`` lists ``-count`` candidate group ids (group
    mode). Ids ascend, so walking a row visits slots in ascending order.
    A row holds W = min(max_candidates, L) ids of either kind; ``overflow``
    is True where a group-mode row needed more. Budgets left as None take
    :func:`default_budgets`, which cannot overflow.
    """
    o_lo, o_hi, d_lo, d_hi = bounds
    lpg = tables.leaves_per_group
    G = tables.num_groups
    L = tables.num_leaves
    mg, mc = default_budgets(tables)
    k0 = min(mg if max_groups is None else max_groups, G)
    k = min(mc if max_candidates is None else max_candidates, L)
    kg = min(G, k)
    P = o_lo.shape[0]

    # Dense level: slab test against every group box. Padding groups have
    # inverted boxes (accepted as all-space), so they are masked.
    ghit = _slab_hit(o_lo, o_hi, d_lo, d_hi,
                     tuple(tables.group_min[None, :, a] for a in range(3)),
                     tuple(tables.group_max[None, :, a] for a in range(3)))
    gids = jnp.arange(G, dtype=jnp.int32)
    ghit = ghit & (gids * lpg < tables.num_real_leaves)[None, :]
    gprefix, gtotal = compact_rows(ghit, jnp.broadcast_to(gids, ghit.shape),
                                   max(k0, kg), G)
    gcand = gprefix[:, :k0]

    # Refine: member-leaf boxes of the first k0 surviving groups, gathered
    # as whole attribute-major group rows.
    boxes = tables.group_boxes[jnp.minimum(gcand, G - 1)]  # (P, k0, 6*lpg)
    att = [boxes[:, :, a * lpg:(a + 1) * lpg].reshape(P, -1)
           for a in range(6)]
    member = (gcand[:, :, None] * lpg
              + jnp.arange(lpg, dtype=jnp.int32)[None, None]).reshape(P, -1)
    lhit = _slab_hit(o_lo, o_hi, d_lo, d_hi, tuple(att[0:3]),
                     tuple(att[3:6])) & (member < tables.num_real_leaves)
    lprefix, ltotal = compact_rows(lhit, member, k, L)

    # Group mode where the leaf list does not fit, or the refine saw only
    # part of the surviving groups.
    use_g = (ltotal > k) | (gtotal > k0)
    overflow = jnp.any(use_g & (gtotal > kg))
    count = jnp.where(use_g, -jnp.minimum(gtotal, kg), ltotal)
    body = jnp.where(
        use_g[:, None],
        jnp.pad(gprefix[:, :kg], ((0, 0), (0, k - kg)), constant_values=G),
        lprefix)
    return jnp.concatenate([count[:, None], body], axis=1), overflow


def leaf_candidates(o: Array, d: Array, tables: CullTables,
                    max_groups: int | None, max_candidates: int | None,
                    subpacket: int):
    """Phase A from (P*SP, 3) ray arrays (see :func:`candidate_rows`)."""
    return candidate_rows(subpacket_bounds(o, d, subpacket), tables,
                          max_groups, max_candidates)


def row_leaf_count(rows: Array, lpg: int) -> Array:
    """Leaves a row walks: ``count`` in leaf mode, ``-count * lpg`` in
    group mode."""
    c = rows[:, 0]
    return jnp.where(c >= 0, c, -c * lpg)


# ---------------------------------------------------------------------------
# Phase B, plain version
# ---------------------------------------------------------------------------

def _quadratic(dx, dy, dz, ox, oy, oz, a, cx, cy, cz, r2):
    """Ray columns x prim rows -> (u, disc): disc = a r^2 - |oc x d|^2,
    u = oc.d + sqrt(disc); a valid near root is t = -u/a."""
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    crx = ocy * dz - ocz * dy
    cry = ocz * dx - ocx * dz
    crz = ocx * dy - ocy * dx
    disc = a * r2 - (crx * crx + cry * cry + crz * crz)
    u = ocx * dx + ocy * dy + ocz * dz + jnp.sqrt(jnp.maximum(disc, 0.0))
    return u, disc


def _block_leaf_ids(rows: Array, j0, lpg: int, sentinel: int) -> Array:
    """(P, LEAF_BLOCK) leaf ids at candidate positions j0 .. j0 + 15;
    positions past a row's count read the sentinel leaf."""
    c = rows[:, 0:1]
    j = j0 + jnp.arange(LEAF_BLOCK, dtype=jnp.int32)[None, :]
    idx = jnp.where(c >= 0, 1 + j, 1 + j // lpg)
    e = jnp.take_along_axis(rows, jnp.minimum(idx, rows.shape[1] - 1),
                            axis=1)
    leaf = jnp.where(c >= 0, e, e * lpg + j % lpg)
    return jnp.where(j < row_leaf_count(rows, lpg)[:, None], leaf, sentinel)


def _plain_walk(feats: Array, rows: Array, tables: CullTables, anyhit: bool):
    """Plain phase B over all subpackets at once."""
    ls = tables.leaf_size
    L = tables.num_leaves
    P, SP, _ = feats.shape
    f = [feats[..., k][..., None] for k in range(FEAT)]     # (P, SP, 1)
    dx, dy, dz, ox, oy, oz = f[0:6]
    av, epsa, negat = f[6], f[8], f[9]
    iters = (jnp.max(row_leaf_count(rows, tables.leaves_per_group))
             + LEAF_BLOCK - 1) // LEAF_BLOCK
    lane = jnp.arange(ls, dtype=jnp.int32)
    # Carries derived from feats keep its varying axes under shard_map.
    zero = feats[..., 0] * 0.0                                # (P, SP)

    def block(j):
        leaf = _block_leaf_ids(rows, j * LEAF_BLOCK, tables.leaves_per_group,
                               L)                               # (P, 16)
        pr = tables.prims[:, leaf].reshape(4, P, 1, LEAF_BLOCK * ls)
        u, disc = _quadratic(dx, dy, dz, ox, oy, oz, av, *pr)
        ok = (disc > 0.0) & (u < -epsa)                         # (P, SP, 16ls)
        slot = (leaf[:, :, None] * ls + lane).reshape(P, 1, -1)
        return u, ok, slot

    if anyhit:
        def cond(c):
            j, occ = c
            return (j < iters) & ~jnp.all(occ)

        def body(c):
            j, occ = c
            u, ok, _ = block(j)
            return j + 1, occ | jnp.any(ok & (u > negat), axis=-1)

        _, occ = jax.lax.while_loop(cond, body, (jnp.int32(0), zero > 0.0))
        return occ

    def body(j, c):
        ub, ib = c
        u, ok, slot = block(j)
        uv = jnp.where(ok, u, -_BIG)
        bmax = jnp.max(uv, axis=-1)
        bslot = jnp.min(jnp.where(ok & (uv == bmax[..., None]), slot,
                                  _NOSLOT), axis=-1)
        # Blocks visit slots in ascending order: a tie keeps the earlier.
        better = bmax > ub
        return jnp.where(better, bmax, ub), jnp.where(better, bslot, ib)

    ub, ib = jax.lax.fori_loop(
        0, iters, body, (zero - _BIG, zero.astype(jnp.int32) + _NOSLOT))
    return -ub * feats[..., 7], ib


# ---------------------------------------------------------------------------
# Phase B, Triton-route kernel
# ---------------------------------------------------------------------------

def _hit_kernel(rows_ref, feats_ref, prims_ref, *out_refs, leaf_size: int,
                leaves_per_group: int, num_leaves: int, anyhit: bool):
    """One program = one subpacket: its SP rays stay in registers while it
    walks its own candidate leaves, one leaf (leaf_size prims) per step,
    carrying an elementwise (SP, leaf_size) running best. The any-hit walk
    tests EXIT_EVERY leaves per step and stops once every ray is occluded
    (the check is a block reduction, so not after every leaf)."""
    ls = leaf_size
    lpg = leaves_per_group
    p = pl.program_id(0)

    def col(k):
        return feats_ref[:, k][:, None]                       # (SP, 1)

    dx, dy, dz = col(0), col(1), col(2)
    ox, oy, oz = col(3), col(4), col(5)
    av, epsa = col(6), col(8)
    sp = dx.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, ls), 1)
    count = rows_ref[p, 0]
    n = jnp.where(count >= 0, count, -count * lpg)

    def leaf_at(i):
        # lax.div / lax.rem: i >= 0, and jnp's floor-division sign fix-up
        # does not lower on the Triton route.
        g = jax.lax.div(i, jnp.int32(lpg))
        e = rows_ref[p, jnp.where(count >= 0, 1 + i, 1 + g)]
        return jnp.where(count >= 0, e,
                         e * lpg + jax.lax.rem(i, jnp.int32(lpg)))

    def test(leaf):
        u, disc = _quadratic(dx, dy, dz, ox, oy, oz, av,
                             *(prims_ref[k, leaf, :][None, :]
                               for k in range(4)))          # (SP, ls)
        return u, (disc > 0.0) & (u < -epsa)

    if anyhit:
        (occ_ref,) = out_refs
        negat = col(9)

        def cond(c):
            i, _, done = c
            return (i < n) & (done == 0)

        def body(c):
            i, occ, _ = c
            for k in range(EXIT_EVERY):
                # Positions past the row's end read the sentinel leaf.
                j = i + k
                leaf = jnp.where(j < n, leaf_at(jnp.minimum(j, n - 1)),
                                 num_leaves)
                u, ok = test(leaf)
                occ = jnp.maximum(occ, (ok & (u > negat)).astype(jnp.int32))
            done = jnp.min(jnp.max(occ, axis=1))
            return i + EXIT_EVERY, occ, done

        _, occ, _ = jax.lax.while_loop(
            cond, body, (jnp.int32(0), jnp.zeros((sp, ls), jnp.int32),
                         jnp.int32(0)))
        occ_ref[...] = jnp.max(occ, axis=1)
        return

    t_ref, slot_ref = out_refs

    def body(i, c):
        ub, ib = c
        leaf = leaf_at(i)
        u, ok = test(leaf)
        ok = ok & (u > ub)
        return jnp.where(ok, u, ub), jnp.where(ok, leaf * ls + lane, ib)

    ub, ib = jax.lax.fori_loop(
        0, n, body, (jnp.full((sp, ls), -_BIG, jnp.float32),
                     jnp.full((sp, ls), _NOSLOT, jnp.int32)))
    umax = jnp.max(ub, axis=1)
    slot_ref[...] = jnp.min(jnp.where(ub == umax[:, None], ib, _NOSLOT),
                            axis=1)
    t_ref[...] = -umax * feats_ref[:, 7]


def _kernel_walk(feats: Array, rows: Array, tables: CullTables, anyhit: bool,
                 interpret: bool):
    P, SP, _ = feats.shape
    # 16 elements of the (SP, leaf_size) carry per thread: at 32 the kernel
    # runs 3x slower on H100 (PERF.md); stages 1-3 measured alike.
    num_warps = max(1, SP * tables.leaf_size // (32 * 16))
    kernel = functools.partial(_hit_kernel, leaf_size=tables.leaf_size,
                               leaves_per_group=tables.leaves_per_group,
                               num_leaves=tables.num_leaves, anyhit=anyhit)
    out_spec = pl.BlockSpec((None, SP), lambda p: (p, 0))
    # Under shard_map the outputs vary over whatever mesh axes the inputs do.
    vma = frozenset().union(*(jax.typeof(x).vma
                              for x in (feats, rows, tables.prims)))
    out = functools.partial(jax.ShapeDtypeStruct, (P, SP), vma=vma)
    if anyhit:
        out_shape = out(jnp.int32)
        out_specs = out_spec
    else:
        out_shape = (out(jnp.float32), out(jnp.int32))
        out_specs = (out_spec, out_spec)
    out = pl.pallas_call(
        kernel,
        grid=(P,),
        in_specs=[pl.no_block_spec,
                  pl.BlockSpec((None, SP, FEAT), lambda p: (p, 0, 0)),
                  pl.no_block_spec],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="leafcull_anyhit" if anyhit else "leafcull_closest",
    )(rows, feats, tables.prims)
    return out > 0 if anyhit else out


def phase_b(feats: Array, rows: Array, tables: CullTables, impl: str,
            anyhit: bool = False):
    """Phase B dispatch. Closest hit: (t (P, SP) from the kernel's own
    quadratic, slot (P, SP) with 2^30 on miss). Any hit: occluded (P, SP)
    bool (features must carry t_max)."""
    if impl == "xla":
        return _plain_walk(feats, rows, tables, anyhit)
    if impl not in IMPLS:
        raise ValueError(f"unknown phase-B impl {impl!r}; one of {IMPLS}")
    return _kernel_walk(feats, rows, tables, anyhit,
                        interpret=(impl == "interpret"))


# ---------------------------------------------------------------------------
# Queries
# ---------------------------------------------------------------------------

def _resolve(impl):
    if impl is None:
        from tracer.intersect.select import hierarchical_impl
        return hierarchical_impl()
    return impl


_STATIC = ("max_groups", "max_candidates", "impl")


@functools.partial(jax.jit, static_argnames=_STATIC)
def nearest_hit_feats(feats: Array, tables: CullTables,
                      max_groups: int | None = None,
                      max_candidates: int | None = None,
                      impl: str | None = None):
    """Closest hit from prebuilt (P, SP, FEAT) features, flat stream order:
    (t (P*SP,) +inf on miss, slot (P*SP,) -1 on miss, overflow). Map slots
    to sphere ids with ``tables.slot_to_sphere``. ``overflow`` is False
    under the default budgets (see :func:`candidate_rows`)."""
    rows, overflow = candidate_rows(bounds_from_feats(feats), tables,
                                    max_groups, max_candidates)
    t, slot = phase_b(feats, rows, tables, _resolve(impl))
    t, slot = t.reshape(-1), slot.reshape(-1)
    hit = slot < _NOSLOT
    return jnp.where(hit, t, jnp.inf), jnp.where(hit, slot, -1), overflow


@functools.partial(jax.jit, static_argnames=_STATIC)
def occluded_feats(feats: Array, tables: CullTables,
                   max_groups: int | None = None,
                   max_candidates: int | None = None,
                   impl: str | None = None):
    """Any hit from prebuilt features packed with a finite ``t_max``:
    (occluded (P*SP,) bool in flat stream order, overflow)."""
    rows, overflow = candidate_rows(bounds_from_feats(feats), tables,
                                    max_groups, max_candidates)
    occ = phase_b(feats, rows, tables, _resolve(impl), anyhit=True)
    return occ.reshape(-1), overflow


_STATIC_RAYS = _STATIC + ("subpacket",)


def _query_feats(rays: Ray, subpacket: int, t_max=None) -> Array:
    return pack_ray_features(rays.origin.reshape(-1, 3),
                             rays.direction.reshape(-1, 3), subpacket,
                             t_max=t_max)


@functools.partial(jax.jit, static_argnames=_STATIC_RAYS)
def nearest_hit_leafcull_t(rays: Ray, tables: CullTables,
                           max_groups: int | None = None,
                           max_candidates: int | None = None,
                           subpacket: int = 64, impl: str | None = None):
    """Lite closest hit: (t, sphere_id, overflow) in the rays' batch shape.
    t comes from the kernel's own quadratic (matches the exact reference
    formulation to ~1e-4 rtol). Rays should be direction-sorted."""
    t, slot, overflow = nearest_hit_feats(_query_feats(rays, subpacket),
                                          tables, max_groups, max_candidates,
                                          impl)
    b = rays.origin.reshape(-1, 3).shape[0]
    t, slot = t[:b], slot[:b]
    sphere_id = jnp.where(slot >= 0,
                          tables.slot_to_sphere[jnp.maximum(slot, 0)], -1)
    return (t.reshape(rays.batch_shape), sphere_id.reshape(rays.batch_shape),
            overflow)


@functools.partial(jax.jit, static_argnames=_STATIC_RAYS)
def nearest_hit_leafcull(rays: Ray, scene: Scene, tables: CullTables,
                         max_groups: int | None = None,
                         max_candidates: int | None = None,
                         subpacket: int = 64, impl: str | None = None):
    """Closest hit as a HitRecord: ``(HitRecord, overflow)``.

    t is recomputed from the winning sphere with the exact reference
    formulation, so gradients flow to the scene like the brute path.
    Rays should be direction-sorted for tight frustums.
    """
    _, sphere_id, overflow = nearest_hit_leafcull_t(
        rays, tables, max_groups, max_candidates, subpacket, impl)
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    sid = sphere_id.reshape(-1)
    safe = jnp.maximum(sid, 0)
    t = ray_sphere_t(o, d, scene.centers[safe], scene.radii[safe])
    t = jnp.where(sid >= 0, t, jnp.inf)
    rec = hit_record_from_t(Ray(origin=o, direction=d), t, sid,
                            scene.centers)
    rec = jax.tree_util.tree_map(
        lambda x: x.reshape(*rays.batch_shape, *x.shape[1:]), rec)
    return rec, overflow


@functools.partial(jax.jit, static_argnames=_STATIC_RAYS)
def occluded_leafcull(rays: Ray, tables: CullTables, t_max: Array,
                      max_groups: int | None = None,
                      max_candidates: int | None = None,
                      subpacket: int = 64, impl: str | None = None):
    """Shadow query: (occluded, overflow). True where a prim blocks the
    segment (EPSILON, t_max) under the reference acceptance rule."""
    occ, overflow = occluded_feats(_query_feats(rays, subpacket, t_max),
                                   tables, max_groups, max_candidates, impl)
    b = rays.origin.reshape(-1, 3).shape[0]
    return occ[:b].reshape(rays.batch_shape), overflow

