"""BVH-sparsified differentiable (soft) rendering.

The dense soft renderer (tracer/diff/soft.py) scores every ray against
every sphere — O(B*N) forward AND backward, intractable at the BASELINE
headline size (fwd+bwd at 100k spheres). This module restricts the soft
model to each ray packet's BVH cull candidates (tracer/kernels/leafcull.py
phase A), making the differentiable path O(B*K) with K = a few hundred:

  rays --octahedral sort + bucket--> subpackets
  subpackets --hierarchical frustum cull--> <= max_leaves candidate leaves
  leaves --slot tables--> (P, K) candidate sphere ids
  depth-ordered alpha compositing over the gathered (P, SP, K) set

Exactness: a sphere outside every candidate leaf box of its subpacket has
sigma ~ sigmoid(-edge_sharpness * sdf) ~ 0 and contributes nothing to the
composite or the transmittance, so the sparse image converges to the
dense one as the cull stays conservative. Because the SOFT silhouette extends a
little past the hard radius, build the cull tables from radii inflated by
``soft_radius_scale(params)`` (a few softness widths); the equality tests
in tests/test_sparse_diff.py verify image and gradient agreement with the
dense model under that inflation.

Gradients flow to centers/radii/albedo THROUGH the gathers (gather's
transpose is scatter-add, handled by AD) and to camera pose through the
ray values; the candidate index sets themselves are piecewise constant,
exactly like the hard path's argmin indices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array

from tracer.core import vecmath
from tracer.core.types import Ray
from tracer.diff.soft import SoftParams, _sigmoid, composite_sorted
from tracer.integrator.wavefront import sky_color
from tracer.kernels.leafcull import CullTables, leaf_candidates
from tracer.scene.scene import Scene


def soft_radius_scale(params: SoftParams, widths: float = 6.0) -> float:
    """Radius inflation factor so candidate leaf boxes cover the soft
    silhouette skirt: sigma at (1 + widths/sharpness) r is
    sigmoid(-widths) < 3e-3 of the edge value."""
    return 1.0 + widths / float(params.edge_sharpness)


def candidate_leaf_ids(o: Array, d: Array, tables: CullTables,
                       max_groups: int = 48, max_leaves: int = 16,
                       subpacket: int = 64):
    """Per-subpacket candidate LEAF ids (slot order).

    Returns (leaf_ids (P, max_leaves) i32 zero-padded, valid (P, max_leaves)
    bool, overflow () bool).
    """
    lpg = tables.leaves_per_group
    k = max_leaves
    row, overflow = leaf_candidates(o, d, tables, max_groups, k, subpacket)
    # Scenes with fewer than k leaves get narrower rows; pad to k ids.
    row = jnp.pad(row, ((0, 0), (0, max(0, k + 1 - row.shape[1]))))
    cnt = row[:, 0]
    j = jnp.arange(k, dtype=jnp.int32)
    ids_leaf = row[:, 1:k + 1]
    ids_group = row[:, 1 + j // lpg] * lpg + (j % lpg)
    n_eff = jnp.where(cnt >= 0, jnp.minimum(cnt, k),
                      jnp.minimum(-cnt * lpg, k))
    overflow = overflow | jnp.any((cnt < 0) & (-cnt * lpg > k))
    leaf_ids = jnp.where((cnt >= 0)[:, None], ids_leaf, ids_group)
    valid = (j[None, :] < n_eff[:, None]) & \
            (leaf_ids < tables.num_real_leaves) & (leaf_ids >= 0)
    return jnp.where(valid, leaf_ids, 0), valid, overflow


@functools.partial(jax.jit, static_argnames=("max_groups", "max_leaves",
                                             "subpacket"))
def candidate_sphere_ids(o: Array, d: Array, tables: CullTables,
                         max_groups: int = 48, max_leaves: int = 16,
                         subpacket: int = 64):
    """Per-subpacket candidate sphere ids.

    o/d: (Bp, 3) sorted+bucket-padded rays (tracer/core/sort.py
    prep_rays_bucketed). Returns (ids (P, K) i32 with -1 padding,
    overflow () bool) where K = max_leaves * leaf_size.
    """
    ls = tables.leaf_size
    lpg = tables.leaves_per_group
    k = max_leaves
    row, overflow = leaf_candidates(o, d, tables, max_groups, k, subpacket)
    # Scenes with fewer than k leaves get narrower rows; pad to k ids.
    row = jnp.pad(row, ((0, 0), (0, max(0, k + 1 - row.shape[1]))))
    cnt = row[:, 0]
    P = row.shape[0]

    j = jnp.arange(k, dtype=jnp.int32)
    # Leaf-mode rows list leaf ids; group-mode rows (negated count) list
    # group ids whose member leaves are enumerated here, truncated to k.
    leaf_mode = (cnt >= 0)[:, None]
    ids_leaf = row[:, 1:k + 1]
    ids_group = row[:, 1 + j // lpg] * lpg + (j % lpg)
    n_eff = jnp.where(cnt >= 0, jnp.minimum(cnt, k),
                      jnp.minimum(-cnt * lpg, k))
    # Group-mode rows truncated to k member leaves lose candidates: that
    # is this path's overflow condition (phase A's flag only covers group
    # rows wider than their row budget).
    overflow = overflow | jnp.any((cnt < 0) & (-cnt * lpg > k))
    leaf_ids = jnp.where(leaf_mode, ids_leaf, ids_group)
    valid = (j[None, :] < n_eff[:, None]) & \
            (leaf_ids < tables.num_real_leaves) & (leaf_ids >= 0)
    leaf_ids = jnp.where(valid, leaf_ids, 0)

    slots = leaf_ids[:, :, None] * ls + jnp.arange(ls, dtype=jnp.int32)
    ids = tables.slot_to_sphere[slots.reshape(P, -1)]   # (P, K)
    ids = jnp.where(valid[:, :, None].repeat(ls, 2).reshape(P, -1) &
                    (ids >= 0), ids, -1)
    return ids, overflow


def _sparse_logits(centers, radii, albedo, o, d, params: SoftParams):
    """Soft coverage/shade/depth for gathered candidates.

    centers (P, K, 3), radii (P, K), albedo (P, K, 3) vs rays o/d
    (P, SP, 3). Returns sigma, t_soft (P, SP, K) and shade
    (P, SP, K, 3) — identical math to tracer/diff/soft.py
    _logits_and_shade, feeding composite_sorted.
    """
    o_b = o[:, :, None, :]                              # (P, SP, 1, 3)
    d_b = d[:, :, None, :]
    c_b = centers[:, None, :, :]                        # (P, 1, K, 3)
    oc = c_b - o_b                                      # (P, SP, K, 3)
    a = vecmath.dot(d_b, d_b)
    t_ca = vecmath.dot(oc, d_b) / jnp.maximum(a, 1e-30)
    perp2 = jnp.maximum(vecmath.dot(oc, oc) - t_ca * t_ca * a, 0.0)
    r = radii[:, None, :]
    eps2 = (params.smooth_eps * r) ** 2
    perp = jnp.sqrt(perp2 + eps2)
    sdf = (perp - r) / jnp.maximum(r, 1e-6)
    sigma = _sigmoid(-sdf * params.edge_sharpness)

    disc = r * r - perp2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0) + eps2) - params.smooth_eps * r
    t_soft = t_ca - sq / jnp.sqrt(jnp.maximum(a, 1e-30))
    sigma = sigma * _sigmoid(t_soft * params.edge_sharpness)

    p = o_b + t_soft[..., None] * d_b
    n = vecmath.normalize(p - c_b)
    mirror = vecmath.reflect(jnp.broadcast_to(d_b, n.shape), n)
    shade = albedo[:, None] + 0.5 * sky_color(mirror)
    return sigma, shade, t_soft


def soft_render_sparse_packets(scene: Scene, o: Array, d: Array,
                               tables: CullTables,
                               params: SoftParams = None,
                               max_groups: int = 48, max_leaves: int = 16,
                               subpacket: int = 64):
    """Sparse soft image for sorted+padded rays, (Bp, 3) -> (Bp, 3).

    Returns (img, overflow). Rays must come from prep_rays_bucketed (use
    :func:`soft_render_sparse` for arbitrary ray order).
    """
    if params is None:
        params = SoftParams()
    ids, overflow = candidate_sphere_ids(o, d, tables, max_groups,
                                         max_leaves, subpacket)
    P, K = ids.shape
    safe = jnp.maximum(ids, 0)
    centers = scene.centers[safe]                       # (P, K, 3)
    # Padding rows keep a UNIT radius: a zero radius zeroes the smoothing
    # eps2 and puts sqrt at exactly 0, whose infinite derivative turns the
    # (weight=0) x shade product into NaN gradients for sphere 0 (the safe
    # gather target). The l/sigma masks below already erase padding rows'
    # contributions, values and gradients both.
    radii = jnp.where(ids >= 0, scene.radii[safe], 1.0)
    albedo = scene.albedo[safe]

    op = o.reshape(P, subpacket, 3)
    dp = d.reshape(P, subpacket, 3)
    sigma, shade, t_soft = _sparse_logits(centers, radii, albedo, op, dp,
                                          params)
    # Mask padding candidates out of the composite entirely (values AND
    # gradients): sigma 0 and t pushed past every real candidate.
    real = ids[:, None, :] >= 0
    sigma = jnp.where(real, sigma, 0.0)
    t_soft = jnp.where(real, t_soft, 3.0e38)

    img = composite_sorted(sigma, shade, t_soft, dp)
    return img.reshape(-1, 3), overflow


def soft_render_sparse(scene: Scene, rays: Ray, tables: CullTables,
                       params: SoftParams = None,
                       max_groups: int = 48, max_leaves: int = 16,
                       subpacket: int = 64):
    """Differentiable sparse soft image in the caller's ray order.

    Returns (img (batch..., 3), overflow). On overflow re-call with larger
    ``max_leaves`` (the candidates were clamped; the image is then an
    approximation on the affected subpackets).
    """
    from tracer.core.sort import prep_rays_bucketed
    batch_shape = rays.batch_shape
    flat = Ray(origin=rays.origin.reshape(-1, 3),
               direction=rays.direction.reshape(-1, 3))
    padded, dest = prep_rays_bucketed(flat, subpacket)
    img, overflow = soft_render_sparse_packets(
        scene, padded.origin, padded.direction, tables, params,
        max_groups, max_leaves, subpacket)
    return img[dest].reshape(*batch_shape, 3), overflow


# ---------------------------------------------------------------------------
# Fast sparse path: scalar-attr layout + top-M compositing
# ---------------------------------------------------------------------------
#
# The exact path above materializes (P, SP, K, 3) vector intermediates, and
# the K-wide sorted composite drags take_along gathers whose backward is an
# elementwise scatter. This path keeps every hot array 2-D (rays x
# candidates):
#
#   1. candidate leaves gathered as whole (leaf_size)-wide attribute rows
#      from slot-order tables (row gathers, row-scatter transposes);
#   2. sigma / t_soft for all K candidates from ~14 SCALAR broadcast ops
#      (no vectors anywhere);
#   3. per-ray top-M selection on sigma (M ~ 16) -- dropped candidates
#      have sigma <= the M-th value; with M >= the max overlap depth the
#      composite is exact to ~K * sigma_min;
#   4. the exact composite (sort by t, transmittance, shade) runs on the
#      tiny (B, M) set, shade computed channel-wise.
#
# Gradients flow through every gather; top-M indices are piecewise
# constant like the hard path's argmin.

def slot_attr_tables(scene: Scene, tables: CullTables):
    """Slot-order per-attr tables (L, leaf_size): cx cy cz c2 r alb0..2.

    Parked (padding) slots sit at 1e15 with unit radius: sigma underflows
    to exactly 0 through the logit clip and t_soft is huge, so they can
    never matter to values or gradients.
    """
    ls = tables.leaf_size
    s2s = tables.slot_to_sphere
    safe = jnp.maximum(s2s, 0)
    far = s2s < 0
    c = jnp.where(far[:, None], 1.0e15, scene.centers[safe])
    r = jnp.where(far, 1.0, scene.radii[safe])
    alb = jnp.where(far[:, None], 0.0, scene.albedo[safe])
    cols = [c[:, 0], c[:, 1], c[:, 2], jnp.sum(c * c, axis=1), r,
            alb[:, 0], alb[:, 1], alb[:, 2]]
    return [x.reshape(-1, ls) for x in cols]


def _sigma_t_scalar(cx, cy, cz, c2, r, ox, oy, oz, dx, dy, dz, od, oo, a,
                    params: SoftParams):
    """sigma, t_soft, mirror.y for broadcastable scalar operand layouts --
    identical math to _sparse_logits, decomposed into products of scalars.
    mirror.y is computed here (in K-space) so the top-M stage needs no
    gathers of the geometry attrs: per-element take_along gathers
    dominated the forward pass."""
    inva = 1.0 / jnp.maximum(a, 1e-30)
    ocd = cx * dx + cy * dy + cz * dz - od               # oc . d
    oc2 = c2 - 2.0 * (cx * ox + cy * oy + cz * oz) + oo  # |oc|^2
    t_ca = ocd * inva
    perp2 = jnp.maximum(oc2 - t_ca * t_ca * a, 0.0)
    eps2 = (params.smooth_eps * r) ** 2
    perp = jnp.sqrt(perp2 + eps2)
    sdf = (perp - r) / jnp.maximum(r, 1e-6)
    sigma = _sigmoid(-sdf * params.edge_sharpness)
    disc = r * r - perp2
    sq = jnp.sqrt(jnp.maximum(disc, 0.0) + eps2) - params.smooth_eps * r
    t_soft = t_ca - sq * jnp.sqrt(inva)
    sigma = sigma * _sigmoid(t_soft * params.edge_sharpness)
    # mirror.y = dy - 2 (d.n) ny with n = (o + t d - c)/|..| (channel-wise
    # shade needs only this scalar of the mirror vector).
    px = ox + t_soft * dx - cx
    py = oy + t_soft * dy - cy
    pz = oz + t_soft * dz - cz
    nn = jnp.sqrt(jnp.maximum(px * px + py * py + pz * pz, 1e-20))
    nx, ny, nz = px / nn, py / nn, pz / nn
    dn = dx * nx + dy * ny + dz * nz
    my = dy - 2.0 * dn * ny
    return sigma, t_soft, my


def soft_render_sparse_leaforder(scene: Scene, o: Array, d: Array,
                                 tables: CullTables,
                                 params: SoftParams = None,
                                 max_groups: int = 48, max_leaves: int = 16,
                                 subpacket: int = 64):
    """Leaf-ordered sparse soft image: the round-5 fast differentiable path.

    Returns (img (Bp, 3), overflow). The top-M path above
    (soft_render_sparse_fast) spends most of its time moving payload for
    the per-ray selection: every take_along_axis (B, K) -> (B, M) is a
    per-element gather and its backward a per-element scatter, seven of
    them. This path removes per-ray selection entirely:

      * candidate LEAVES (16 per subpacket) are sorted once per subpacket
        by the projection of their box center onto the packet's mean
        direction — a tiny (P, max_leaves) two-operand sort;
      * attribute rows are gathered in that order (the same row gathers
        as before, just with reordered ids — no extra movement);
      * the ordered composite then runs DIRECTLY along the K axis with a
        cumulative log-transmittance (cumsum) — no per-ray argsort, no
        approx_max_k, no take_along anywhere.

    Approximation: the composite order is shared per subpacket (leaf
    granularity) instead of exact per-ray t order. The orders differ only
    where two soft silhouettes overlap the same ray at commensurate t
    from different distance-ranked leaves — the same measure-small class
    as the top-M truncation it replaces; tests/test_sparse_diff.py bounds
    the image deviation against the exact composite. Gradients flow
    through every gather (row-scatter transposes); the leaf order is
    piecewise constant like argmin indices.
    """
    if params is None:
        params = SoftParams()
    ls = tables.leaf_size
    K = max_leaves * ls
    leaf_ids, lvalid, overflow = candidate_leaf_ids(
        o, d, tables, max_groups, max_leaves, subpacket)
    P = leaf_ids.shape[0]

    # Distance-rank the candidate leaves per subpacket: project leaf-box
    # centers on the packet's mean direction from the packet's mean origin.
    op = o.reshape(P, subpacket, 3)
    dp = d.reshape(P, subpacket, 3)
    o_mean = jnp.mean(op, axis=1)                        # (P, 3)
    d_mean = jnp.mean(dp, axis=1)
    lc = 0.5 * (tables.leaf_min + tables.leaf_max)       # (L, 3)
    lcg = lc[leaf_ids]                                   # (P, 16, 3)
    key = jnp.sum((lcg - o_mean[:, None]) * d_mean[:, None], axis=2)
    key = jnp.where(lvalid, key, 3.0e38)
    key, leaf_ids, lvalid_i = jax.lax.sort(
        (key, leaf_ids, lvalid.astype(jnp.int32)), dimension=1, num_keys=1)
    lvalid = lvalid_i > 0

    attrs = slot_attr_tables(scene, tables)
    cands = [t[leaf_ids].reshape(P, 1, K) for t in attrs]
    cx, cy, cz, c2, r, a0, a1, a2 = cands
    kvalid = jnp.repeat(lvalid, ls, axis=1).reshape(P, 1, K)

    ox, oy, oz = (op[:, :, i:i + 1] for i in range(3))
    dx, dy, dz = (dp[:, :, i:i + 1] for i in range(3))
    od = jnp.sum(op * dp, axis=2)[..., None]
    oo = jnp.sum(op * op, axis=2)[..., None]
    a = jnp.sum(dp * dp, axis=2)[..., None]

    sigma, t_soft, my = _sigma_t_scalar(cx, cy, cz, c2, r, ox, oy, oz,
                                        dx, dy, dz, od, oo, a, params)
    sigma = jnp.where(kvalid, sigma, 0.0)                # (P, SP, K)

    # Ordered composite along K (leaf-distance order, in-leaf slot order).
    log1m = jnp.log1p(-sigma * (1.0 - 1e-6))
    log_t = jnp.cumsum(log1m, axis=2) - log1m            # exclusive
    w = sigma * jnp.exp(log_t)
    tt = 0.5 * (my + 1.0)
    sky = [(1.0 - tt) + tt * (128.0 / 255.0),
           (1.0 - tt) + tt * (178.0 / 255.0),
           jnp.ones_like(tt)]
    albs = [a0, a1, a2]
    t_total = jnp.exp(jnp.sum(log1m, axis=2))            # (P, SP)
    dy_flat = dp[:, :, 1]
    sky_bg = [(1.0 - 0.5 * (dy_flat + 1.0)) + 0.5 * (dy_flat + 1.0) * c
              for c in (128.0 / 255.0, 178.0 / 255.0, 1.0)]
    img = [jnp.clip(jnp.sum(w * (albs[i] + 0.5 * sky[i]), axis=2)
                    + t_total * sky_bg[i], 0.0, 1.0)
           for i in range(3)]
    return jnp.stack(img, axis=-1).reshape(-1, 3), overflow


def soft_render_sparse_fast(scene: Scene, o: Array, d: Array,
                            tables: CullTables,
                            params: SoftParams = None,
                            max_groups: int = 48, max_leaves: int = 16,
                            subpacket: int = 64, top_m: int = 16,
                            recall: float = 0.99):
    """Fast sparse soft image for sorted+padded rays, (Bp, 3) -> (Bp, 3).

    Returns (img, overflow). Same model as soft_render_sparse_packets up
    to (a) top-M truncation of the composite (error <= sum of dropped
    sigmas, ~1e-4 at the defaults) and (b) the approximate
    top-M selection (jax.lax.approx_max_k, recall ~= ``recall``).
    """
    if params is None:
        params = SoftParams()
    ls = tables.leaf_size
    K = max_leaves * ls
    leaf_ids, lvalid, overflow = candidate_leaf_ids(
        o, d, tables, max_groups, max_leaves, subpacket)
    P = leaf_ids.shape[0]
    attrs = slot_attr_tables(scene, tables)
    # Row gathers: (P, max_leaves) leaf rows of ls lanes each -> (P, 1, K).
    # Invalid candidate rows redirect to the parked sentinel values via a
    # post-mask (sigma multiplied to 0), not index games.
    cands = [t[leaf_ids].reshape(P, 1, K) for t in attrs]
    cx, cy, cz, c2, r, a0, a1, a2 = cands
    kvalid = jnp.repeat(lvalid, ls, axis=1).reshape(P, 1, K)

    op = o.reshape(P, subpacket, 3)
    dp = d.reshape(P, subpacket, 3)
    ox, oy, oz = (op[:, :, i:i + 1] for i in range(3))
    dx, dy, dz = (dp[:, :, i:i + 1] for i in range(3))
    od = jnp.sum(op * dp, axis=2)[..., None]
    oo = jnp.sum(op * op, axis=2)[..., None]
    a = jnp.sum(dp * dp, axis=2)[..., None]

    sigma, t_soft, my_k = _sigma_t_scalar(cx, cy, cz, c2, r, ox, oy, oz,
                                          dx, dy, dz, od, oo, a, params)
    sigma = jnp.where(kvalid, sigma, 0.0)

    B = P * subpacket
    M = min(top_m, K)
    sflat = sigma.reshape(B, K)
    sig_m, idx = jax.lax.approx_max_k(sflat, M, recall_target=recall)
    take = lambda x: jnp.take_along_axis(
        jnp.broadcast_to(x, (P, subpacket, K)).reshape(B, K), idx, axis=1)
    t_m = take(t_soft)
    my = take(my_k)
    alb_m = [take(jnp.broadcast_to(x, (P, 1, K))) for x in (a0, a1, a2)]

    # Channel-wise shade on the M survivors (identical math to
    # _sparse_logits' shade, no (..., 3) arrays).
    tt = 0.5 * (my + 1.0)
    sky = [(1.0 - tt) * 1.0 + tt * (128.0 / 255.0),
           (1.0 - tt) * 1.0 + tt * (178.0 / 255.0),
           (1.0 - tt) * 1.0 + tt * 1.0]
    shade = [alb_m[i] + 0.5 * sky[i] for i in range(3)]

    # Exact ordered composite over the M survivors.
    order = jnp.argsort(t_m, axis=1)
    sig_s = jnp.take_along_axis(sig_m * (1.0 - 1e-6), order, axis=1)
    log1m = jnp.log1p(-sig_s)
    log_T = jnp.cumsum(log1m, axis=1) - log1m
    w_s = sig_s * jnp.exp(log_T)
    # Un-sort the weights so shade is consumed in ORIGINAL order (the
    # transpose of take_along on scalars only).
    inv = jnp.argsort(order, axis=1)
    w = jnp.take_along_axis(w_s, inv, axis=1)
    t_total = jnp.exp(jnp.sum(log1m, axis=1))[:, None]
    dflat_y = dp[:, :, 1].reshape(B, 1)
    sky_bg = [(1.0 - 0.5 * (dflat_y + 1.0)) * 1.0
              + 0.5 * (dflat_y + 1.0) * c
              for c in (128.0 / 255.0, 178.0 / 255.0, 1.0)]
    img = [jnp.clip(jnp.sum(w * shade[i], axis=1)[:, None]
                    + t_total * sky_bg[i], 0.0, 1.0) for i in range(3)]
    return jnp.concatenate(img, axis=1), overflow
