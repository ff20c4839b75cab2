"""Runtime sanitizers (SURVEY.md §5 "Race detection / sanitizers").

The reference has no sanitizers at all (single-threaded C, no -fsanitize;
Makefile:43). In this framework races are designed out by construction
(pure-functional JAX), so "sanitizing" means catching numeric poison and
out-of-contract values early:

  * ``TRACER_DEBUG=1`` in the environment (or calling :func:`enable_debug`)
    turns on ``jax_debug_nans`` + ``jax_debug_infs`` — every jitted function
    re-runs op-by-op when a NaN/Inf appears in an output and raises with the
    offending primitive. The CLI calls :func:`maybe_enable_debug` at startup,
    so ``TRACER_DEBUG=1 python -m tracer.cli render ...`` sanitizes a whole
    run. NOTE: the closest-hit contract uses +inf as the miss sentinel
    (tracer/core/types.py HitRecord.t), so debug mode enables nan checking
    unconditionally but inf checking only when TRACER_DEBUG=2.

  * :func:`checked_nearest_hit` / :func:`checked_render` wrap the traversal
    and the integrator in ``jax.experimental.checkify`` with index/NaN
    checks enabled, returning ``(err, out)``; ``err.throw()`` raises on the
    first violated invariant. Used by tests/test_debug.py; available to
    users for bring-up of new scenes/kernels.

The Pallas-kernel analog of a sanitizer — interpret-mode execution — is
exercised throughout the kernel test suite (tests/test_leafcull.py,
tests/test_shadow.py and tests/test_conecull.py run the Triton kernel body
in Pallas's interpreter on CPU).
"""

from __future__ import annotations

import os

import jax
from jax.experimental import checkify


def enable_debug(level: int = 1) -> None:
    """Turn on NaN (level>=1) and Inf (level>=2) sanitizing globally."""
    if level >= 1:
        jax.config.update("jax_debug_nans", True)
    if level >= 2:
        jax.config.update("jax_debug_infs", True)


def maybe_enable_debug() -> int:
    """Enable sanitizers from the TRACER_DEBUG env var; returns the level."""
    level = int(os.environ.get("TRACER_DEBUG", "0") or "0")
    if level:
        enable_debug(level)
    return level


_CHECKS = checkify.index_checks | checkify.nan_checks


def checked_nearest_hit(rays, scene, bvh):
    """Checkify-wrapped pure-JAX BVH traversal.

    Returns ``(err, HitRecord)``; call ``err.throw()`` to raise on NaNs or
    out-of-bounds indexing anywhere inside the traversal (builder bugs,
    corrupt escape indices, poisoned ray data).
    """
    from tracer.intersect.traverse import nearest_hit_bvh

    f = checkify.checkify(
        lambda r, s: nearest_hit_bvh(r, s, bvh), errors=_CHECKS)
    return f(rays, scene)


def checked_render(scene, camera, nearest_for, config, noise):
    """Checkify-wrapped wavefront integrator (NaN + index checks)."""
    from tracer.integrator.wavefront import render

    f = checkify.checkify(
        lambda s, c, n: render(s, c, None, nearest_for, config, noise=n),
        errors=_CHECKS)
    return f(scene, camera, noise)
