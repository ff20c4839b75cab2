"""The benchmark workload and the device it runs on.

The reference's benchmark (src/benchmark.c:172-223, 283-332): n spheres of
r = 0.5 uniform in a 1000^3 world, rays from the origin with directions
uniform in the cube [-1, 1]^3, normalized. The headline size is 100k
spheres and 512 * 1024 rays; the reference CPU reaches 7.85 Mrays/s there
(results/benchmark_data.txt:3 of the reference).
"""

from __future__ import annotations

import subprocess

import numpy as np

BASELINE_MRAYS = 7.85
N_SPHERES = 100_000
WORLD = 1000.0
NUM_RAYS = 512 * 1024
SUBPACKET = 64      # rays per subpacket (one cull frustum)
CELL_BITS = 9       # direction cells of the bucket pad (tracer/core/sort.py)


def origin_rays(num_rays: int, seed: int = 0):
    """(origin, direction) device arrays of the reference's ray set."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    d = rng.uniform(-1, 1, (num_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.zeros((num_rays, 3), jnp.float32), jnp.asarray(d)


def closest_oneshot(impl: str):
    """``f(o, d, tables) -> (t, slot, overflow)`` in input ray order: ray
    prep + phase A + phase B, the whole query, for one jit."""
    from tracer.kernels.leafcull import nearest_hit_feats, prep_feats_bucketed

    def f(o, d, tables):
        feats, dest = prep_feats_bucketed(o, d, SUBPACKET,
                                          cell_bits=CELL_BITS)
        t, slot, ovf = nearest_hit_feats(feats, tables, impl=impl)
        return t[dest], slot[dest], ovf
    return f


def shadow_oneshot(impl: str, t_max: float):
    """``f(o, d, tables) -> (occluded, overflow)`` in input ray order for
    the segment (EPSILON, t_max)."""
    import jax.numpy as jnp
    from tracer.kernels.leafcull import occluded_feats, prep_feats_bucketed

    def f(o, d, tables):
        tm = jnp.full((o.shape[0],), t_max, jnp.float32)
        feats, dest = prep_feats_bucketed(o, d, SUBPACKET,
                                          cell_bits=CELL_BITS, t_max=tm)
        occ, ovf = occluded_feats(feats, tables, impl=impl)
        return occ[dest], ovf
    return f


def device_info() -> dict:
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def gpu_card() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    "not available" where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "not available"
    return out.strip().splitlines()[0] if out.strip() else "not available"
