"""Ray sorting for packet coherence.

The Pallas traversal kernel shares one tree-walk cursor per 1024-ray packet
(tracer/kernels/traverse_pallas.py), so a packet's cost is the *union* of its
rays' visited nodes. Random ray order makes every packet visit the whole
tree; sorting rays so neighbors point the same way collapses the union back
toward the per-ray visit set. This is the wavefront analog of the reference's
implicit coherence (its pixel loop walks scanlines; src/main.c:358-365).

Rays are keyed by a Morton interleave of the quantized direction (and
optionally origin); sorting is one XLA sort; the inverse permutation restores
caller order afterwards.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from tracer.core.types import Ray


def _part_bits(v: Array) -> Array:
    """Spread 8 bits of v over 24 bits (2 zero bits between each)."""
    v = v.astype(jnp.uint32) & 0xFF
    v = (v | (v << 8)) & 0x00F00F
    v = (v | (v << 4)) & 0x0C30C3
    v = (v | (v << 2)) & 0x249249
    return v


def direction_morton_codes(d: Array, bits: int = 8) -> Array:
    """Morton code of unit directions, (B,) uint32. 8 bits per component."""
    q = jnp.clip((d * 0.5 + 0.5) * (2 ** bits - 1), 0, 2 ** bits - 1)
    q = q.astype(jnp.uint32)
    return (_part_bits(q[:, 0]) | (_part_bits(q[:, 1]) << 1)
            | (_part_bits(q[:, 2]) << 2))


def sort_rays_by_direction(rays: Ray):
    """Sort a flat ray batch by direction Morton code.

    Returns (sorted_rays, inverse_permutation): apply
    ``result[inverse_permutation]`` to map kernel outputs back to the
    caller's ray order.
    """
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    code = direction_morton_codes(d)
    perm = jnp.argsort(code)
    inv = jnp.argsort(perm)
    return Ray(origin=o[perm], direction=d[perm]), inv


def _part_bits16(v: Array) -> Array:
    """Spread 16 bits of v over 32 bits (1 zero bit between each)."""
    v = v.astype(jnp.uint32) & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def octahedral_codes(d: Array) -> Array:
    """32-bit Morton code of the octahedral direction mapping, (B,) uint32.

    The octahedral map folds the unit sphere onto a square with far better
    area uniformity than the per-component quantization above, so equal-code
    prefixes correspond to genuinely narrow direction cones — what the
    frustum-cull kernels (tilecull/leafcull) need for tight candidate sets.
    16 bits per octahedral axis.
    """
    s = jnp.abs(d).sum(-1)
    u = d[:, 0] / s
    v = d[:, 1] / s
    neg = d[:, 2] < 0
    uu = jnp.where(neg, (1 - jnp.abs(v)) * jnp.sign(u), u)
    vv = jnp.where(neg, (1 - jnp.abs(u)) * jnp.sign(v), v)
    qu = jnp.clip((uu * 0.5 + 0.5) * 65535, 0, 65535).astype(jnp.uint32)
    qv = jnp.clip((vv * 0.5 + 0.5) * 65535, 0, 65535).astype(jnp.uint32)
    return _part_bits16(qu) | (_part_bits16(qv) << 1)


def plan_bucket_pad(sorted_codes: Array, subpacket: int,
                    cell_bits: int = 8):
    """Padding plan for a code-sorted ray stream (see bucket_pad_sorted).

    sorted_codes: (B,) uint32, ascending. Returns (src, dest): src (Bp,)
    i32 maps each padded slot to the source ray (padding slots replicate
    the previous real ray of their cell), dest (B,) i32 maps each input
    ray to its padded slot; Bp = B + 2^cell_bits * subpacket (static).

    Every lookup here runs against the tiny (2^cell_bits,) cell table
    instead of searchsorting the full (B,) dest array.
    """
    b = sorted_codes.shape[0]
    ncells = 1 << cell_bits
    cid = jnp.arange(ncells, dtype=jnp.int32)
    # Per-cell boundaries by searchsorted with ncells+1 queries against the
    # sorted codes (a couple hundred binary-search gathers), rather than a
    # dense (B, ncells) compare-reduce or a per-ray searchsorted.
    edges = (cid.astype(jnp.uint32) << (32 - cell_bits))
    bounds = jnp.searchsorted(sorted_codes,
                              jnp.concatenate([edges, jnp.array(
                                  [jnp.uint32(0xFFFFFFFF)])]),
                              side="left").astype(jnp.int32)
    bounds = bounds.at[-1].set(b)
    cnt = bounds[1:] - bounds[:-1]
    start = bounds[:-1]
    pad = (subpacket - cnt % subpacket) % subpacket
    pad_before = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(pad)[:-1].astype(jnp.int32)])
    bp = b + ncells * subpacket
    # Per-element/per-slot tables WITHOUT per-element gathers: every
    # quantity we need is piecewise constant over at most ncells segments
    # (in b-space at `start`, in bp-space at `pstart`), so scatter the
    # ncells segment DELTAS and take one shared (3, bp) cumsum instead of
    # gathering `pad_before[cell]` per ray and a (bp, 3) table per slot.
    #
    # Padded cell c occupies [pstart[c], pstart[c+1]); both ends are
    # subpacket-aligned, so no subpacket straddles two cells.
    pstart = start + pad_before
    cap = start + jnp.maximum(cnt - 1, 0)   # last real ray of the cell
    d_shift = jnp.diff(pad_before, prepend=jnp.zeros((1,), jnp.int32))
    d_cap = jnp.diff(cap, prepend=jnp.zeros((1,), jnp.int32))
    rows = jnp.zeros((3, bp), jnp.int32)
    rows = rows.at[0, pstart].add(d_shift)          # pad_before per slot
    rows = rows.at[1, pstart].add(d_cap)            # cap per slot
    rows = rows.at[2, start].add(d_shift)           # pad_before per elem
    cum = jnp.cumsum(rows, axis=1)
    pos = jnp.arange(bp, dtype=jnp.int32)
    src = jnp.clip(jnp.minimum(pos - cum[0], cum[1]), 0, b - 1)
    dest = jnp.arange(b, dtype=jnp.int32) + cum[2, :b]
    return src, dest


def gather_rays(o: Array, d: Array, idx: Array):
    """Gather (o[idx], d[idx]) through one packed (B, 8) row gather
    (one row gather instead of two)."""
    packed = jnp.concatenate(
        [o, d, jnp.zeros((o.shape[0], 2), o.dtype)], axis=1)
    g = packed[idx]
    return g[:, 0:3], g[:, 3:6]


def bucket_pad_sorted(o: Array, d: Array, codes: Array, subpacket: int,
                      cell_bits: int = 8):
    """Pad a code-sorted ray stream at coarse direction-cell boundaries.

    The cull kernels (tilecull/leafcull) treat every ``subpacket``
    consecutive rays as one frustum. A pure Morton sort leaves occasional
    subpackets straddling big code gaps (quadrant seams / empty code
    ranges), whose "cone" then spans the whole sphere and whose candidate
    set explodes — measured at 100k spheres these ~4% of subpackets cost
    ~half the kernel time. Inserting <subpacket padding rays at the
    boundaries of 2^cell_bits Morton-prefix cells guarantees every
    subpacket lies inside one compact cell.

    o/d must already be sorted by ``codes`` (ascending). Padding slots
    replicate the previous real ray (coherent, harmless). Returns
    (o_padded, d_padded, dest) where dest (B,) i32 maps each input ray to
    its slot in the padded stream; padded length is the static
    B + 2^cell_bits * subpacket.
    """
    src, dest = plan_bucket_pad(codes, subpacket, cell_bits)
    op, dp = gather_rays(o, d, src)
    return op, dp, dest


def prep_rays_bucketed(rays: Ray, subpacket: int, cell_bits: int = 8):
    """One-shot cull-kernel pre-pass: octahedral sort + cell-bucket pad.

    Fuses the sort permutation into the bucket plan so the rays are
    gathered ONCE (the separate sort-then-pad pipeline gathers twice).
    Returns (padded Ray, dest) with dest (B,) i32 mapping each input ray
    to its slot in the padded stream.
    """
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    b = o.shape[0]
    codes = octahedral_codes(d)
    iota = jnp.arange(b, dtype=jnp.int32)
    sc, perm = jax.lax.sort((codes, iota), dimension=0, num_keys=1)
    src, dest_sorted = plan_bucket_pad(sc, subpacket, cell_bits)
    op, dp = gather_rays(o, d, perm[src])
    # dest_sorted maps sorted position -> slot; re-key by original index
    # by inverting the permutation with a second 2-operand sort.
    _, dest = jax.lax.sort((perm, dest_sorted), dimension=0, num_keys=1)
    return Ray(origin=op, direction=dp), dest


def sort_rays_octahedral(rays: Ray):
    """Sort a flat ray batch by octahedral-Morton direction code.

    Preferred pre-pass for the cull kernels: measured at 100k spheres /
    64-ray subpackets it cuts the p95 candidate count vs the cube-Morton
    sort above. Returns (sorted_rays, inverse_permutation) like
    ``sort_rays_by_direction``.
    """
    o = rays.origin.reshape(-1, 3)
    d = rays.direction.reshape(-1, 3)
    code = octahedral_codes(d)
    perm = jnp.argsort(code)
    inv = jnp.argsort(perm)
    return Ray(origin=o[perm], direction=d[perm]), inv
